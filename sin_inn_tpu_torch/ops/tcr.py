"""Transformation-consistency regularization (TCR) augmentation.

Counterpart of ``sin_inn_tpu/ops/tcr.py``: a random rotation (+-angle deg)
plus translation (+-trans px, divided by ``scale`` for LR-resolution
inputs), applied as one affine warp. The three uniforms per sample are
passed in, so LR and HR get the same transform. ``stop_grad`` detaches the
warped result (the reference's gradient-free transform).
"""

from __future__ import annotations

import torch

from sin_inn_tpu_torch.ops.warp import rotation_matrix_2d, warp_affine


def tcr_transform(img: torch.Tensor, random: torch.Tensor, angle: float,
                  trans: float, scale: float = 1.0,
                  stop_grad: bool = False) -> torch.Tensor:
    """img: (N, H, W, C); random: (N, 3) uniforms in [0, 1); angle: max
    rotation in degrees; trans: max translation in pixels; scale:
    translation divisor."""
    n, h, w, _ = img.shape
    center = torch.tensor([w / 2.0, h / 2.0], dtype=img.dtype,
                          device=img.device)[None, :].expand(n, 2)
    ang = (2.0 * angle) * random[:, 0] - angle
    zoom = torch.ones((n,), dtype=img.dtype, device=img.device)
    mat = rotation_matrix_2d(center, ang, zoom)
    tx = ((2.0 * trans) * random[:, 1] - trans) / scale
    ty = ((2.0 * trans) * random[:, 2] - trans) / scale
    shift = torch.zeros_like(mat)
    shift[:, 0, 2] = tx
    shift[:, 1, 2] = ty
    out = warp_affine(img, mat + shift)
    return out.detach() if stop_grad else out
