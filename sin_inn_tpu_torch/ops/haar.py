"""Haar wavelet squeeze with exact inverse, NHWC layout.

Counterpart of ``sin_inn_tpu/ops/haar.py``: the 2x2 Haar transform of the
IRN's ``HaarDownsampling`` as a reshape and explicit +- adds, output
channels component-major ``[LL * C, LH * C, HL * C, HH * C]`` with LL the
2x2 average. The forward is scaled by 1/4 and the inverse applies the
adjoint unscaled, so ``haar_unsqueeze(haar_squeeze(x)) == x`` up to fp32
rounding.
"""

from __future__ import annotations

import math

import torch


def haar_squeeze(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/2, W/2, 4C), component-major channel order."""
    n, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"spatial dims must be even, got {(h, w)}")
    blk = x.reshape(n, h // 2, 2, w // 2, 2, c)
    a, b = blk[:, :, 0, :, 0], blk[:, :, 0, :, 1]
    cc, d = blk[:, :, 1, :, 0], blk[:, :, 1, :, 1]
    ll = (a + b + cc + d) * 0.25
    lh = (a - b + cc - d) * 0.25
    hl = (a + b - cc - d) * 0.25
    hh = (a - b - cc + d) * 0.25
    return torch.cat([ll, lh, hl, hh], dim=-1)


def haar_unsqueeze(y: torch.Tensor) -> torch.Tensor:
    """Exact inverse of :func:`haar_squeeze`:
    (N, H, W, 4C) -> (N, 2H, 2W, C)."""
    n, h, w, c4 = y.shape
    if c4 % 4:
        raise ValueError(f"channel dim must be divisible by 4, got {c4}")
    ll, lh, hl, hh = torch.split(y, c4 // 4, dim=-1)
    a = ll + lh + hl + hh
    b = ll - lh + hl - hh
    cc = ll + lh - hl - hh
    d = ll - lh - hl + hh
    top = torch.stack([a, b], dim=3)
    bottom = torch.stack([cc, d], dim=3)
    blk = torch.stack([top, bottom], dim=3)               # (N, H, W, 2, 2, C)
    return blk.permute(0, 1, 3, 2, 4, 5).reshape(n, 2 * h, 2 * w, c4 // 4)


def haar_log_det(h: int, w: int, c: int) -> float:
    """Per-sample forward log|det J| of one squeeze of an (h, w, c) input."""
    return h * w * c / 4.0 * math.log(1.0 / 16.0)
