"""Device selection for the entry points: CUDA unless the caller asks for
the CPU, and never a silent fallback from one to the other; and the copies
the training and serving loops make the host wait for, each counted in the
profiler's ``host_syncs``, ``h2d_bytes`` and ``d2h_bytes``."""

from __future__ import annotations

import numpy as np
import torch

from sin_inn_tpu_torch.core.profiler import count


def resolve_device(name) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            "available; pass --device cpu (or SRConfig(device='cpu')) to run "
            "on the CPU")
    return device


def to_card(a: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``, a copy the host waits for."""
    count("host_syncs")
    count("h2d_bytes", a.nbytes)
    return torch.from_numpy(a).to(device)


def to_host(t: torch.Tensor) -> np.ndarray:
    """A device tensor in host memory, a copy the host waits for."""
    count("host_syncs")
    count("d2h_bytes", t.numel() * t.element_size())
    return t.cpu().numpy()


def host_float(t: torch.Tensor) -> float:
    """The value of a one-element device tensor on the host."""
    count("host_syncs")
    count("d2h_bytes", t.element_size())
    return float(t)
