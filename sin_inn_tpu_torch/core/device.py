"""Device selection for the entry points: CUDA unless the caller asks for
the CPU, and never a silent fallback from one to the other."""

from __future__ import annotations

import torch


def resolve_device(name) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            "available; pass --device cpu (or SRConfig(device='cpu')) to run "
            "on the CPU")
    return device
