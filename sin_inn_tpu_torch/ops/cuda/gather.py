"""Windowed bilinear gather (K6): CUDA kernel and plain version.

``gather_region`` replaces the TPU kernel ``_gather_kernel`` of
``sin_inn_tpu/ops/pallas/gather.py`` in forward mode (``_gather_region_call``
with ``grads=False``), and ``resample2d_region`` is the ``resample2d`` warp
on it, as there. The kernel is ``csrc/gather_region.cu``; its header states
what bounds it on an H100 and how the design deals with that.

The function, exactly as the TPU kernel computes it: output pixel (y, x)
samples the point p = ((x + fx) sx + shx, (y + fy) sy + shy) (one fused
multiply-add after the sum, as the TPU kernel's compiler forms it) with the
bilinear hat weights max(1 - |p - k|, 0) of its four taps. A tap counts only
if it lies in the image and in the window the TPU kernel read: rows
[c0 - dy, c0 + dy + 8) with c0 = 8 floor(y / 8), columns
[128 j - dx, 128 j + 128 + dx) with j = floor(x / 128), where dy and dx are
the bounds padded as ``_pad_geometry`` pads them. For flows within the
bounds this is ``resample2d``; beyond them the far taps are dropped.

Routing is by the tensor's device alone: a CUDA tensor launches the kernel
or raises, a CPU tensor takes :func:`gather_region_plain`. The TPU kernel's
flow-gradient mode (the resample2d backward and the splat backward) comes
with the training slice, and so does autograd through either route.
``gather_region.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from sin_inn_tpu_torch.ops.cuda import _build

_B = 128     # output-tile rows and columns
_RC = 8      # output rows per chunk of the TPU kernel

Coord = Tuple[Tuple[float, float], Tuple[float, float]]


def pad_geometry(max_dy: int, max_dx: int) -> Tuple[int, int]:
    """The window half-widths the TPU kernel uses: dy up to a multiple of 4,
    dx up to a multiple of 64 (``_pad_geometry``)."""
    return -(-max_dy // 4) * 4, -(-max_dx // 64) * 64


def resample_coord(h: int, w: int) -> Coord:
    """resample2d's transform: (size - 1)-normalised, sampled with
    align_corners=False, so p = (x + f) size / (size - 1) - 0.5."""
    return ((w / (w - 1), -0.5), (h / (h - 1), -0.5))


def _fma(t: torch.Tensor, s: float, sh: float) -> torch.Tensor:
    """t s + sh rounded once to fp32, as a fused multiply-add rounds it
    (the kernel's ``__fmaf_rn``): the fp32 product is exact in fp64."""
    return (t.double() * float(torch.tensor(s, dtype=torch.float32))
            + sh).float()


def _hat(d: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - torch.abs(d), min=0.0)


def gather_region_plain(a: torch.Tensor, flow: torch.Tensor, max_dy: int,
                        max_dx: int, coord: Coord) -> torch.Tensor:
    """Plain PyTorch version of K6's forward mode. a: (N, H, W, C) fp32,
    flow: (N, H, W, 2) (dx, dy). Returns (N, H, W, C)."""
    n, h, w, c = a.shape
    dy, dx = pad_geometry(max_dy, max_dx)
    (sx, shx), (sy, shy) = coord
    dev = a.device
    ys = torch.arange(h, device=dev)[None, :, None]
    xs = torch.arange(w, device=dev)[None, None, :]
    px = _fma(xs.float() + flow[..., 0], sx, shx)
    py = _fma(ys.float() + flow[..., 1], sy, shy)
    c0 = ys // _RC * _RC
    r_lo = torch.clamp(c0 - dy, min=0).float()
    r_hi = torch.clamp(c0 + dy + _RC, max=h).float()
    j0 = xs // _B * _B
    k_lo = torch.clamp(j0 - dx, min=0).float()
    k_hi = torch.clamp(j0 + _B + dx, max=w).float()

    r0, k0 = torch.floor(py), torch.floor(px)
    rows, cols = [], []
    for r in (r0, r0 + 1.0):
        ok = (r >= r_lo) & (r < r_hi)
        rows.append((torch.where(ok, _hat(py - r), 0.0),
                     torch.where(ok, r, 0.0).long()))
    for k in (k0, k0 + 1.0):
        ok = (k >= k_lo) & (k < k_hi)
        cols.append((torch.where(ok, _hat(px - k), 0.0),
                     torch.where(ok, k, 0.0).long()))
    flat = a.reshape(n, h * w, c)

    def tap(ri, ki):     # a[b, ri, ki, :], masked taps at index 0
        idx = (ri * w + ki).reshape(n, -1, 1).expand(-1, -1, c)
        return torch.gather(flat, 1, idx).reshape(n, h, w, c)

    out = None
    for wy, ri in rows:
        (wx0, k0i), (wx1, k1i) = cols
        v = tap(ri, k0i) * wx0[..., None] + tap(ri, k1i) * wx1[..., None]
        term = wy[..., None] * v
        out = term if out is None else out + term
    return out


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.library("gather_region")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sininn_gather_region.argtypes = (
        [ptr, ptr, ptr] + [i32] * 6 + [f32] * 4 + [ptr])
    lib.sininn_gather_region.restype = i32
    lib.sininn_error_string.argtypes = [i32]
    lib.sininn_error_string.restype = ctypes.c_char_p
    return lib


def _check(a: torch.Tensor, flow: torch.Tensor) -> None:
    if a.dim() != 4 or flow.shape != a.shape[:3] + (2,):
        raise ValueError(f"expected an NHWC image and an (N, H, W, 2) flow, "
                         f"got {tuple(a.shape)} and {tuple(flow.shape)}")
    if a.device.type not in ("cpu", "cuda") or flow.device != a.device:
        raise ValueError(f"no gather kernel for {a.device} / {flow.device}")
    if a.dtype != torch.float32 or flow.dtype != torch.float32:
        raise TypeError(f"gather kernel takes float32, got {a.dtype} and "
                        f"{flow.dtype}")
    if torch.is_grad_enabled() and (a.requires_grad or flow.requires_grad):
        raise RuntimeError(
            "the windowed gather has no gradient yet: its backward comes in "
            "the training slice (run under torch.no_grad())")


def _launch(a: torch.Tensor, flow: torch.Tensor, max_dy: int, max_dx: int,
            coord: Coord) -> torch.Tensor:
    if not (a.is_contiguous() and flow.is_contiguous()):
        raise ValueError("gather kernel needs contiguous NHWC tensors")
    n, h, w, c = a.shape
    dy, dx = pad_geometry(max_dy, max_dx)
    (sx, shx), (sy, shy) = coord
    out = torch.empty_like(a)
    lib = _lib()
    with torch.cuda.device(a.device):
        err = lib.sininn_gather_region(
            a.data_ptr(), flow.data_ptr(), out.data_ptr(), n, h, w, c, dy, dx,
            sx, shx, sy, shy, torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError("gather_region kernel launch failed: "
                           + lib.sininn_error_string(err).decode())
    return out


def gather_region(a: torch.Tensor, flow: torch.Tensor, max_dy: int,
                  max_dx: int, coord: Coord) -> torch.Tensor:
    """K6 forward: the windowed bilinear gather of ``a`` (N, H, W, C) at
    p = (x + flow) s + sh, ``coord = ((sx, shx), (sy, shy))``."""
    _check(a, flow)
    if a.device.type == "cpu":
        return gather_region_plain(a, flow, max_dy, max_dx, coord)
    if a.numel() == 0:
        return torch.empty_like(a)
    out = _launch(a, flow, max_dy, max_dx, coord)
    gather_region.launches += 1
    return out


def resample2d_region(img: torch.Tensor, flow: torch.Tensor, max_dy: int,
                      max_dx: int) -> torch.Tensor:
    """``ops.warp.resample2d`` on K6: exact for flows within the bounds."""
    h, w = img.shape[1:3]
    return gather_region(img, flow, max_dy, max_dx, resample_coord(h, w))


KERNELS = (gather_region,)
gather_region.launches = 0


def launch_counts() -> Dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
