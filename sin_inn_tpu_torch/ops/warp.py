"""Bilinear sampling, the flow warps and the affine warp of TCR, in plain
PyTorch (NHWC).

Counterpart of ``sin_inn_tpu/ops/warp.py`` (``sample_bilinear``,
``grid_sample``, ``resample2d``, ``flow_warp``, ``rotation_matrix_2d``,
``warp_affine``), which the reference computed as plain XLA outside any
kernel. ``sample_bilinear`` masks each of the four taps on its own, as the
reference does: a tap outside the image contributes zero ('zeros') or reads
the clamped edge ('border'). ``resample2d`` and ``flow_warp`` are the exact,
unwindowed warps; ``resample2d_windowed`` is the reference's windowed form
(dense matmuls on the TPU, XLA there, so plain PyTorch here, differentiated
by autograd), and the windowed kernels are in ``ops/cuda/gather.py``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch


def _gather_2d(img: torch.Tensor, ix: torch.Tensor,
               iy: torch.Tensor) -> torch.Tensor:
    """img[n, iy, ix, :] for per-sample integer index maps (N, Ho, Wo)."""
    n, h, w, c = img.shape
    idx = (iy * w + ix).reshape(n, -1, 1).expand(-1, -1, c)
    out = torch.gather(img.reshape(n, h * w, c), 1, idx)
    return out.reshape(n, ix.shape[1], ix.shape[2], c)


def scale_shift(t: torch.Tensor, s: float, sh: float) -> torch.Tensor:
    """t s + sh rounded once to fp32, as a fused multiply-add rounds it (the
    reference's XLA forms and the gather kernel's ``__fmaf_rn``): the fp32
    product is exact in fp64. Differentiable."""
    return (t.double() * float(np.float32(s)) + sh).float()


def sample_bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                    padding: str = "zeros",
                    keep: Optional[Callable] = None) -> torch.Tensor:
    """Bilinear sample of img (N, H, W, C) at continuous pixel coordinates
    x, y (N, Ho, Wo). padding: 'zeros' or 'border'. ``keep(xi, yi)`` (with
    'zeros') also drops each tap whose (float) column and row it does not
    keep."""
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
            if keep is not None:
                valid = valid & keep(xi, yi)
            weight = weight * valid.to(img.dtype)
        return val * weight[..., None]

    return (tap(x0, y0, (1 - wx) * (1 - wy))
            + tap(x0 + 1, y0, wx * (1 - wy))
            + tap(x0, y0 + 1, (1 - wx) * wy)
            + tap(x0 + 1, y0 + 1, wx * wy))


def grid_sample(img: torch.Tensor, grid: torch.Tensor,
                align_corners: bool = False,
                padding: str = "zeros") -> torch.Tensor:
    """torch.nn.functional.grid_sample's function (bilinear), NHWC, as the
    reference writes it. grid: (N, Ho, Wo, 2) normalised (x, y) in
    [-1, 1]."""
    n, h, w, c = img.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        x = (gx + 1.0) * 0.5 * (w - 1)
        y = (gy + 1.0) * 0.5 * (h - 1)
    else:
        x = ((gx + 1.0) * w - 1.0) * 0.5
        y = ((gy + 1.0) * h - 1.0) * 0.5
    return sample_bilinear(img, x, y, padding=padding)


def _pixel_grid(h: int, w: int, like: torch.Tensor):
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=like.dtype, device=like.device),
        torch.arange(w, dtype=like.dtype, device=like.device), indexing="ij")
    return ys[None], xs[None]


def resample2d(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward warp by flow, out(p) = img(p + flow(p)), as the reference's
    ``Resample2d``: coordinates normalised by (size - 1) but sampled with
    align_corners=False and zeros padding. flow: (N, H, W, 2) (dx, dy)."""
    n, h, w, _ = flow.shape
    ys, xs = _pixel_grid(h, w, img)
    grid = torch.stack([(xs + flow[..., 0]) / (w - 1) * 2.0 - 1.0,
                        (ys + flow[..., 1]) / (h - 1) * 2.0 - 1.0], dim=-1)
    return grid_sample(img, grid, align_corners=False, padding="zeros")


def resample2d_windowed(img: torch.Tensor, flow: torch.Tensor, max_dy: int,
                        chunk: int = 8, max_dx: Optional[int] = None,
                        col_chunk: int = 128) -> torch.Tensor:
    """The reference's windowed ``resample2d`` (with its fused backward): the
    exact warp at p = (x + f) size / (size - 1) - 0.5, but a tap row counts
    only if it lies in [s - max_dy, s - max_dy + 2 max_dy + chunk + 1),
    s = chunk floor(y / chunk) the output pixel's row chunk, and with
    ``max_dx`` a tap column only if it lies in [b - max_dx, b - max_dx +
    2 max_dx + cw + 1), b = cw floor(x / cw), cw = min(col_chunk, W). Exact
    for |py - y| <= max_dy - 1 (and |px - x| <= max_dx - 1). Autograd gives
    the reference's hand-derived flow gradient (one-hot differences of the
    kept taps) and the image gradient (the scatter of the cotangent)."""
    n, h, w, _ = flow.shape
    dev = img.device
    ys = torch.arange(h, dtype=img.dtype, device=dev)[None, :, None]
    xs = torch.arange(w, dtype=img.dtype, device=dev)[None, None, :]
    px = scale_shift(xs + flow[..., 0], w / (w - 1), -0.5)
    py = scale_shift(ys + flow[..., 1], h / (h - 1), -0.5)
    r_lo = (torch.arange(h, device=dev) // chunk * chunk - max_dy
            ).to(img.dtype)[None, :, None]
    r_span = 2 * max_dy + chunk + 1
    if max_dx is None:
        keep = lambda xi, yi: (yi >= r_lo) & (yi < r_lo + r_span)
    else:
        cw = min(col_chunk, w)
        k_lo = (torch.arange(w, device=dev) // cw * cw - max_dx
                ).to(img.dtype)[None, None, :]
        k_span = 2 * max_dx + cw + 1
        keep = lambda xi, yi: ((yi >= r_lo) & (yi < r_lo + r_span)
                               & (xi >= k_lo) & (xi < k_lo + k_span))
    return sample_bilinear(img, px, py, padding="zeros", keep=keep)


def flow_warp(img: torch.Tensor, flow: torch.Tensor,
              padding: str = "border") -> torch.Tensor:
    """Backward warp with align_corners=True and border padding (the
    occlusion estimator's warp)."""
    n, h, w, _ = flow.shape
    ys, xs = _pixel_grid(h, w, img)
    return sample_bilinear(img, xs + flow[..., 0], ys + flow[..., 1],
                           padding=padding)


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
