"""Device selection for the entry points: CUDA unless the caller asks for
the CPU, and never a silent fallback from one to the other; the copies
the training and serving loops make the host wait for; and the copies a
loop queues without a wait (through page-locked host memory on a CUDA
device) with the one wait that ends them. Each copy and wait is counted in
the profiler's ``host_syncs``, ``h2d_bytes`` and ``d2h_bytes``."""

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


def host_buffer(shape, dtype, device) -> torch.Tensor:
    """An empty host tensor to copy to or from ``device`` without a wait.
    On a CUDA device it is page-locked, from PyTorch's caching host
    allocator: a block freed is handed out again only once the copies
    queued on it have ended. Elsewhere it is plain host memory."""
    return torch.empty(shape, dtype=dtype,
                       pin_memory=torch.device(device).type == "cuda")


def to_card_async(a: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``, a copy the host does not wait for: on a
    CUDA device staged in a :func:`host_buffer` first."""
    count("h2d_bytes", a.nbytes)
    t = torch.from_numpy(a)
    if torch.device(device).type == "cuda":
        t = host_buffer(t.shape, t.dtype, device).copy_(t)
    return t.to(device, non_blocking=True)


def to_host_async(t: torch.Tensor, out: torch.Tensor) -> None:
    """Queue a copy of device tensor ``t`` into host tensor ``out`` (a
    :func:`host_buffer` or a slice of one); read ``out`` after
    :func:`wait_card`."""
    count("d2h_bytes", t.numel() * t.element_size())
    out.copy_(t, non_blocking=True)


def wait_card(device) -> None:
    """The host's wait for everything queued on ``device``'s current
    stream, the copies of :func:`to_card_async` and :func:`to_host_async`
    among it."""
    count("host_syncs")
    if torch.device(device).type == "cuda":
        torch.cuda.current_stream(device).synchronize()
