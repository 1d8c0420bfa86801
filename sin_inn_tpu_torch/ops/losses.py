"""SR losses: reconstruction, MMD, latent NLL, PSNR.

Counterpart of ``sin_inn_tpu/ops/losses.py``. The MMD gram products are
plain ``torch.matmul`` (the reference left them to XLA).
"""

from __future__ import annotations

from typing import Tuple

import torch

# Inverse-multiquadratic kernel sets: the forward-pass MMD uses wide
# kernels, the reverse pass narrow ones.
MMD_KERNELS_FWD: Tuple[Tuple[float, float], ...] = ((0.2, 2), (1.5, 2), (3.0, 2))
MMD_KERNELS_REV: Tuple[Tuple[float, float], ...] = ((0.2, 0.1), (0.2, 0.5), (0.2, 2))


def reconstruction(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean squared error."""
    return torch.mean((x - y) ** 2)


def mmd(x: torch.Tensor, y: torch.Tensor, rev: bool = False,
        group=None) -> torch.Tensor:
    """Inverse-multiquadratic maximum mean discrepancy over flattened
    samples. ``x``/``y`` are (N, ...) batches; trailing dims are flattened.

    With ``group`` (the data group of a sharded batch) ``x`` and ``y`` are
    this rank's shards: the N x N kernel is taken over the whole batch,
    gathered from every rank, and the gradient flows back to each shard."""
    if group is not None:
        from sin_inn_tpu_torch.parallel.mesh import gather_batch
        x, y = gather_batch(x, group), gather_batch(y, group)
    kernels = MMD_KERNELS_REV if rev else MMD_KERNELS_FWD
    n = x.shape[0]
    xf = x.reshape(n, -1)
    yf = y.reshape(n, -1)

    xx = xf @ xf.t()
    yy = yf @ yf.t()
    xy = xf @ yf.t()

    rx = torch.diagonal(xx)[None, :].expand_as(xx)
    ry = torch.diagonal(yy)[None, :].expand_as(yy)

    # max(d, 0), not clamp: the diagonal distances are exactly 0, where
    # torch.maximum (like the reference's jnp.clip) passes half the
    # gradient and torch.clamp all of it
    zero = torch.zeros_like(xx)
    dxx = torch.maximum(rx.t() + rx - 2.0 * xx, zero)
    dyy = torch.maximum(ry.t() + ry - 2.0 * yy, zero)
    dxy = torch.maximum(rx.t() + ry - 2.0 * xy, zero)

    XX = torch.zeros_like(xx)
    YY = torch.zeros_like(xx)
    XY = torch.zeros_like(xx)
    for ck, a in kernels:
        XX = XX + ck ** a * ((ck + dxx) / a) ** -a
        YY = YY + ck ** a * ((ck + dyy) / a) ** -a
        XY = XY + ck ** a * ((ck + dxy) / a) ** -a

    return torch.mean(XX + YY - 2.0 * XY)


def latent_nll(z: torch.Tensor) -> torch.Tensor:
    """Gaussian latent negative log-likelihood surrogate: mean(z^2)."""
    return torch.mean(z ** 2)


def psnr(x: torch.Tensor, y: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    mse = torch.mean((x - y) ** 2)
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(mse, min=1e-12))
