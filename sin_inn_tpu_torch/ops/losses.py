"""SR evaluation losses: reconstruction, latent NLL, PSNR.

Counterpart of ``sin_inn_tpu/ops/losses.py``; ``mmd`` comes with the
training slice.
"""

from __future__ import annotations

import torch


def reconstruction(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean squared error."""
    return torch.mean((x - y) ** 2)


def latent_nll(z: torch.Tensor) -> torch.Tensor:
    """Gaussian latent negative log-likelihood surrogate: mean(z^2)."""
    return torch.mean(z ** 2)


def psnr(x: torch.Tensor, y: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    mse = torch.mean((x - y) ** 2)
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(mse, min=1e-12))
