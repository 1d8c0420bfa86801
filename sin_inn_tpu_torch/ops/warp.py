"""Bilinear sampling and the affine warp of TCR, in plain PyTorch (NHWC).

Counterpart of the TCR half of ``sin_inn_tpu/ops/warp.py``
(``sample_bilinear``, ``rotation_matrix_2d``, ``warp_affine``), which the
reference computed as plain XLA outside any kernel. ``sample_bilinear``
masks each of the four taps on its own, as the reference does: a tap
outside the image contributes zero ('zeros') or reads the clamped edge
('border'). The flow warps (``grid_sample``, ``resample2d``, ``flow_warp``)
wait for the flow slice.
"""

from __future__ import annotations

import math

import torch


def _gather_2d(img: torch.Tensor, ix: torch.Tensor,
               iy: torch.Tensor) -> torch.Tensor:
    """img[n, iy, ix, :] for per-sample integer index maps (N, Ho, Wo)."""
    n, h, w, c = img.shape
    idx = (iy * w + ix).reshape(n, -1, 1).expand(-1, -1, c)
    out = torch.gather(img.reshape(n, h * w, c), 1, idx)
    return out.reshape(n, ix.shape[1], ix.shape[2], c)


def sample_bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                    padding: str = "zeros") -> torch.Tensor:
    """Bilinear sample of img (N, H, W, C) at continuous pixel coordinates
    x, y (N, Ho, Wo). padding: 'zeros' or 'border'."""
    if padding not in ("zeros", "border"):
        raise ValueError(f"padding must be 'zeros' or 'border', got "
                         f"{padding!r}")
    n, h, w, c = img.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0

    def tap(xi, yi, weight):
        xi_c = torch.clamp(xi, 0, w - 1).long()
        yi_c = torch.clamp(yi, 0, h - 1).long()
        val = _gather_2d(img, xi_c, yi_c)
        if padding == "zeros":
            valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
            weight = weight * valid.to(img.dtype)
        return val * weight[..., None]

    return (tap(x0, y0, (1 - wx) * (1 - wy))
            + tap(x0 + 1, y0, wx * (1 - wy))
            + tap(x0, y0 + 1, (1 - wx) * wy)
            + tap(x0 + 1, y0 + 1, wx * wy))


def rotation_matrix_2d(center: torch.Tensor, angle_deg: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """kornia.get_rotation_matrix2d equivalent (cv2 convention).

    center: (N, 2) as (cx, cy); angle_deg: (N,); scale: (N,) or (N, 2).
    Returns (N, 2, 3) affine matrices mapping src -> dst.
    """
    if scale.dim() == 2:
        scale = scale[:, 0]
    rad = angle_deg * (math.pi / 180.0)
    alpha = scale * torch.cos(rad)
    beta = scale * torch.sin(rad)
    cx, cy = center[:, 0], center[:, 1]
    row0 = torch.stack([alpha, beta, (1.0 - alpha) * cx - beta * cy], dim=-1)
    row1 = torch.stack([-beta, alpha, beta * cx + (1.0 - alpha) * cy], dim=-1)
    return torch.stack([row0, row1], dim=1)


def warp_affine(img: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """kornia.warp_affine equivalent: apply the src->dst affine ``mat``
    (N, 2, 3) to img (N, H, W, C): sample src at inv(mat) @ dst, bilinear,
    zeros padding."""
    n, h, w, c = img.shape
    a = mat[:, :, :2]
    b = mat[:, :, 2]
    det = a[:, 0, 0] * a[:, 1, 1] - a[:, 0, 1] * a[:, 1, 0]
    inv_a = torch.stack([
        torch.stack([a[:, 1, 1], -a[:, 0, 1]], dim=-1),
        torch.stack([-a[:, 1, 0], a[:, 0, 0]], dim=-1),
    ], dim=1) / det[:, None, None]
    inv_b = -torch.einsum("nij,nj->ni", inv_a, b)

    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=img.dtype, device=img.device),
        torch.arange(w, dtype=img.dtype, device=img.device), indexing="ij")
    dst = torch.stack([xs, ys], dim=-1)                       # (H, W, 2)
    src = torch.einsum("nij,hwj->nhwi", inv_a, dst) + inv_b[:, None, None, :]
    return sample_bilinear(img, src[..., 0], src[..., 1], padding="zeros")
