"""Invertible couplings (plain PyTorch), NHWC with the channel split on the
last axis.

Counterpart of ``sin_inn_tpu/ops/coupling.py``:

* the GLOW affine coupling of the SRF, FrEIA-style soft clamping, scale
  activation ``e(s) = exp(clamp * 2/pi * atan(s / clamp))``; the fused
  kernels of ``ops/cuda/coupling.py`` (1x1 subnets) and
  ``ops/cuda/coupling3x3.py`` (3x3 subnets) compute the same function;
* the IRN's ``InvBlockExp``: ``y1 = x1 + F(x2)``, ``s = clamp (2
  sigmoid(H(y1)) - 1)``, ``y2 = x2 exp(s) + G(y1)``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch

Subnet = Callable[[Dict, torch.Tensor], torch.Tensor]

_TWO_OVER_PI = 2.0 / math.pi


def glow_log_e(s: torch.Tensor, clamp: float) -> torch.Tensor:
    """Soft-clamped log-scale: ``clamp * (2/pi) * atan(s / clamp)``."""
    return clamp * _TWO_OVER_PI * torch.atan(s / clamp)


def glow_coupling_forward(params: Dict, x: torch.Tensor, subnet: Subnet,
                          clamp: float, len1: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GLOW coupling forward. Returns (y, log_det per sample).

    ``params["s2"]`` maps x2 -> 2*len1 (scale+shift for x1) and
    ``params["s1"]`` maps y1 -> 2*len2 (scale+shift for x2).
    """
    x1, x2 = x[..., :len1], x[..., len1:]
    len2 = x.shape[-1] - len1

    r2 = subnet(params["s2"], x2)
    s2, t2 = r2[..., :len1], r2[..., len1:]
    log_e2 = glow_log_e(s2, clamp)
    y1 = torch.exp(log_e2) * x1 + t2

    r1 = subnet(params["s1"], y1)
    s1, t1 = r1[..., :len2], r1[..., len2:]
    log_e1 = glow_log_e(s1, clamp)
    y2 = torch.exp(log_e1) * x2 + t1

    log_det = log_e2.sum(dim=(1, 2, 3)) + log_e1.sum(dim=(1, 2, 3))
    return torch.cat([y1, y2], dim=-1), log_det


def glow_coupling_inverse(params: Dict, y: torch.Tensor, subnet: Subnet,
                          clamp: float, len1: int) -> torch.Tensor:
    return glow_coupling_inverse_ld(params, y, subnet, clamp, len1)[0]


def glow_coupling_inverse_ld(params: Dict, y: torch.Tensor, subnet: Subnet,
                             clamp: float, len1: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse + its per-sample log|det J| (= -forward log-det)."""
    y1, y2 = y[..., :len1], y[..., len1:]
    len2 = y.shape[-1] - len1

    r1 = subnet(params["s1"], y1)
    s1, t1 = r1[..., :len2], r1[..., len2:]
    log_e1 = glow_log_e(s1, clamp)
    x2 = (y2 - t1) * torch.exp(-log_e1)

    r2 = subnet(params["s2"], x2)
    s2, t2 = r2[..., :len1], r2[..., len1:]
    log_e2 = glow_log_e(s2, clamp)
    x1 = (y1 - t2) * torch.exp(-log_e2)

    log_det = -(log_e1.sum(dim=(1, 2, 3)) + log_e2.sum(dim=(1, 2, 3)))
    return torch.cat([x1, x2], dim=-1), log_det


def inv_block_forward(params: Dict, x: torch.Tensor, subnet: Subnet,
                      clamp: float, len1: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """InvBlockExp forward. Returns (y, log_det per sample)."""
    x1, x2 = x[..., :len1], x[..., len1:]
    y1 = x1 + subnet(params["F"], x2)
    s = clamp * (torch.sigmoid(subnet(params["H"], y1)) * 2.0 - 1.0)
    y2 = x2 * torch.exp(s) + subnet(params["G"], y1)
    return torch.cat([y1, y2], dim=-1), s.sum(dim=(1, 2, 3))


def inv_block_inverse(params: Dict, y: torch.Tensor, subnet: Subnet,
                      clamp: float, len1: int) -> torch.Tensor:
    return inv_block_inverse_ld(params, y, subnet, clamp, len1)[0]


def inv_block_inverse_ld(params: Dict, y: torch.Tensor, subnet: Subnet,
                         clamp: float, len1: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """InvBlockExp inverse + its per-sample log|det J| (= -forward log-det)."""
    y1, y2 = y[..., :len1], y[..., len1:]
    s = clamp * (torch.sigmoid(subnet(params["H"], y1)) * 2.0 - 1.0)
    x2 = (y2 - subnet(params["G"], y1)) * torch.exp(-s)
    x1 = y1 - subnet(params["F"], x2)
    return torch.cat([x1, x2], dim=-1), -s.sum(dim=(1, 2, 3))
