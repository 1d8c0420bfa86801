"""Windowed bilinear gather (K6): CUDA kernels and plain versions.

``gather_region`` replaces the TPU kernel ``_gather_kernel`` of
``sin_inn_tpu/ops/pallas/gather.py`` in forward mode (``_gather_region_call``
with ``grads=False``), ``gather_region_grads`` replaces its gradient mode
(``grads=True``), and ``resample2d_region`` is the ``resample2d`` warp on
them, as there. The kernels are in ``csrc/gather_region.cu``; its header
states what bounds them on an H100 and how the design deals with that.

The function, exactly as the TPU kernel computes it: output pixel (y, x)
samples the point p = ((x + fx) sx + shx, (y + fy) sy + shy) (one fused
multiply-add after the sum, as the TPU kernel's compiler forms it) with the
bilinear hat weights max(1 - |p - k|, 0) of its four taps. A tap counts only
if it lies in the image and in the window the TPU kernel read: rows
[c0 - dy, c0 + dy + 8) with c0 = 8 floor(y / 8), columns
[128 j - dx, 128 j + 128 + dx) with j = floor(x / 128), where dy and dx are
the bounds padded as ``_pad_geometry`` pads them. For flows within the
bounds this is ``resample2d``; beyond them the far taps are dropped.

The gradient mode also returns, for a payload q of the image's shape,
dfx = sum_c q_c sum_taps hat(py - r) dhat(px - k) a_c and dfy with the roles
of the axes exchanged: d<q, out>/d(px, py), where dhat(d) = -sign(d) on
|d| < 1 and 0 at d = 0 and beyond. A dropped tap adds to neither.

``gather_region`` and ``resample2d_region`` are differentiable
(:class:`GatherRegion`): the flow gradient is one launch of the gradient
mode with the cotangent as the payload, the image gradient (computed only
when the image requires one) is the windowed splat (K5) of the cotangent
along p - (x, y).

``gather_region_local`` and ``gather_region_local_grads`` (K6 local)
replace the same TPU kernel as ``_gather_region_call_local`` runs it, in
both modes, and ``resample2d_region_local`` is the warp on them. The window
of output pixel (y, x) is shifted by (ox, oy) = off_src[n, y // 128,
x // 128], the rounded mean flow of the pixel's own tile
(``ops/offsets.py``): rows [c0 - dy + oy, c0 + dy + 8 + oy), columns
[128 j - dx + ox, 128 j + 128 + dx + ox), with dy, dx the local bounds
padded as above. The warp's image gradient is K5 local of the cotangent
along the effective displacement p - (x, y), with that displacement's own
``tile_flow_offsets(...).off_out``.

Routing is by the tensor's device alone: a CUDA tensor launches the kernel
or raises, a CPU tensor takes the plain version, in the forward and in the
backward alike. The profiler's counters ``launches.gather_region``,
``launches.gather_region_grads``, ``launches.gather_region_local`` and
``launches.gather_region_local_grads`` (``core/profiler.py``) count kernel
launches; :func:`launch_counts` reads them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch
from torch.autograd.function import once_differentiable

from sin_inn_tpu_torch.core.profiler import (count, counters,
                                             reset_counters)
from sin_inn_tpu_torch.ops.cuda import _build
from sin_inn_tpu_torch.ops.warp import scale_shift

_B = 128     # output-tile rows and columns
_RC = 8      # output rows per chunk of the TPU kernel

Coord = Tuple[Tuple[float, float], Tuple[float, float]]
RAW: Coord = ((1.0, 0.0), (1.0, 0.0))    # p = (x, y) + flow: the splat's taps


def pad_geometry(max_dy: int, max_dx: int) -> Tuple[int, int]:
    """The window half-widths the TPU kernel uses: dy up to a multiple of 4,
    dx up to a multiple of 64 (``_pad_geometry``)."""
    return -(-max_dy // 4) * 4, -(-max_dx // 64) * 64


def resample_coord(h: int, w: int) -> Coord:
    """resample2d's transform: (size - 1)-normalised, sampled with
    align_corners=False, so p = (x + f) size / (size - 1) - 0.5."""
    return ((w / (w - 1), -0.5), (h / (h - 1), -0.5))


def _hat(d: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - torch.abs(d), min=0.0)


def _dhat(d: torch.Tensor) -> torch.Tensor:
    """-sign(d) on |d| < 1, 0 at d = 0 and beyond (``_dhat`` of the TPU
    kernel)."""
    return torch.where(torch.abs(d) < 1.0, -torch.sign(d), 0.0)


def _plain_taps(a: torch.Tensor, flow: torch.Tensor, max_dy: int,
                max_dx: int, coord: Coord, off_src=None):
    """The four taps of every output pixel under the window rule, the
    window shifted by off_src of the pixel's tile when given:
    ``rows``/``cols`` are two (weight, derivative weight, index) triples
    each (a dropped tap has weights 0 and index 0), ``tap(ri, ki)`` reads
    a[b, ri, ki, :]."""
    n, h, w, c = a.shape
    dy, dx = pad_geometry(max_dy, max_dx)
    (sx, shx), (sy, shy) = coord
    dev = a.device
    ys = torch.arange(h, device=dev)[None, :, None]
    xs = torch.arange(w, device=dev)[None, None, :]
    px = scale_shift(xs.float() + flow[..., 0], sx, shx)
    py = scale_shift(ys.float() + flow[..., 1], sy, shy)
    c0 = ys // _RC * _RC
    j0 = xs // _B * _B
    if off_src is not None:
        nidx = torch.arange(n, device=dev)[:, None, None]
        o = off_src.long()[nidx, ys // _B, xs // _B]
        c0, j0 = c0 + o[..., 1], j0 + o[..., 0]
    r_lo = torch.clamp(c0 - dy, min=0).float()
    r_hi = torch.clamp(c0 + dy + _RC, max=h).float()
    k_lo = torch.clamp(j0 - dx, min=0).float()
    k_hi = torch.clamp(j0 + _B + dx, max=w).float()

    r0, k0 = torch.floor(py), torch.floor(px)
    rows, cols = [], []
    for r in (r0, r0 + 1.0):
        ok = (r >= r_lo) & (r < r_hi)
        rows.append((torch.where(ok, _hat(py - r), 0.0),
                     torch.where(ok, _dhat(py - r), 0.0),
                     torch.where(ok, r, 0.0).long()))
    for k in (k0, k0 + 1.0):
        ok = (k >= k_lo) & (k < k_hi)
        cols.append((torch.where(ok, _hat(px - k), 0.0),
                     torch.where(ok, _dhat(px - k), 0.0),
                     torch.where(ok, k, 0.0).long()))
    flat = a.reshape(n, h * w, c)

    def tap(ri, ki):     # a[b, ri, ki, :], masked taps at index 0
        idx = (ri * w + ki).reshape(n, -1, 1).expand(-1, -1, c)
        return torch.gather(flat, 1, idx).reshape(n, h, w, c)

    return rows, cols, tap


def gather_region_plain(a: torch.Tensor, flow: torch.Tensor, max_dy: int,
                        max_dx: int, coord: Coord,
                        off_src=None) -> torch.Tensor:
    """Plain PyTorch version of K6's forward mode (of K6 local with
    ``off_src``). a: (N, H, W, C) fp32, flow: (N, H, W, 2) (dx, dy).
    Returns (N, H, W, C)."""
    rows, cols, tap = _plain_taps(a, flow, max_dy, max_dx, coord, off_src)
    (wx0, _, k0i), (wx1, _, k1i) = cols
    out = None
    for wy, _, ri in rows:
        v = tap(ri, k0i) * wx0[..., None] + tap(ri, k1i) * wx1[..., None]
        term = wy[..., None] * v
        out = term if out is None else out + term
    return out


def gather_region_grads_plain(a: torch.Tensor, flow: torch.Tensor,
                              payload: torch.Tensor, max_dy: int, max_dx: int,
                              coord: Coord, off_src=None):
    """Plain PyTorch version of K6's gradient mode (of K6 local's with
    ``off_src``), tap by tap (no autograd). a, payload: (N, H, W, C) fp32,
    flow: (N, H, W, 2). Returns (out (N, H, W, C), dfx (N, H, W), dfy
    (N, H, W)): the gather and d<payload, out>/d(px, py)."""
    rows, cols, tap = _plain_taps(a, flow, max_dy, max_dx, coord, off_src)
    (wx0, gx0, k0i), (wx1, gx1, k1i) = cols
    out = s1 = s2 = None
    for wy, gy, ri in rows:
        t0, t1 = tap(ri, k0i), tap(ri, k1i)
        v = t0 * wx0[..., None] + t1 * wx1[..., None]
        d = t0 * gx0[..., None] + t1 * gx1[..., None]
        terms = (wy[..., None] * v, wy[..., None] * d, gy[..., None] * v)
        if out is None:
            out, s1, s2 = terms
        else:
            out, s1, s2 = out + terms[0], s1 + terms[1], s2 + terms[2]
    return out, (payload * s1).sum(-1), (payload * s2).sum(-1)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.library("gather_region")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sininn_gather_region.argtypes = (
        [ptr] * 4 + [i32] * 6 + [f32] * 4 + [ptr])
    lib.sininn_gather_region.restype = i32
    lib.sininn_gather_region_grads.argtypes = (
        [ptr] * 6 + [i32] * 6 + [f32] * 4 + [ptr])
    lib.sininn_gather_region_grads.restype = i32
    lib.sininn_error_string.argtypes = [i32]
    lib.sininn_error_string.restype = ctypes.c_char_p
    return lib


def _check(a: torch.Tensor, flow: torch.Tensor, payload=None) -> None:
    if a.dim() != 4 or flow.shape != a.shape[:3] + (2,):
        raise ValueError(f"expected an NHWC image and an (N, H, W, 2) flow, "
                         f"got {tuple(a.shape)} and {tuple(flow.shape)}")
    if a.device.type not in ("cpu", "cuda") or flow.device != a.device:
        raise ValueError(f"no gather kernel for {a.device} / {flow.device}")
    if a.dtype != torch.float32 or flow.dtype != torch.float32:
        raise TypeError(f"gather kernel takes float32, got {a.dtype} and "
                        f"{flow.dtype}")
    if payload is not None and (payload.shape != a.shape
                                or payload.device != a.device
                                or payload.dtype != torch.float32):
        raise ValueError(f"payload {tuple(payload.shape)} {payload.dtype} on "
                         f"{payload.device} does not match the image "
                         f"{tuple(a.shape)} float32 on {a.device}")


def check_offsets(off: torch.Tensor, a: torch.Tensor) -> None:
    """Tile offsets must be (N, ceil(H / 128), ceil(W / 128), 2) fp32 on the
    image's device."""
    n, h, w, _ = a.shape
    want = (n, -(-h // _B), -(-w // _B), 2)
    if (tuple(off.shape) != want or off.dtype != torch.float32
            or off.device != a.device):
        raise ValueError(f"offsets {tuple(off.shape)} {off.dtype} on "
                         f"{off.device}: want {want} float32 on {a.device}")


def aligned_offsets(off: torch.Tensor) -> torch.Tensor:
    """The offsets contiguous and 8-byte aligned: the kernels read each
    (ox, oy) pair as one 8-byte load."""
    off = off.contiguous()
    return off if off.data_ptr() % 8 == 0 else off.clone()


def _launch(a: torch.Tensor, flow: torch.Tensor, max_dy: int, max_dx: int,
            coord: Coord, payload=None, off_src=None):
    """One launch of the forward mode (payload None: returns out) or of the
    gradient mode (returns (out, dp), dp (N, H, W, 2) = (dfx, dfy)), of K6
    or, with ``off_src``, of K6 local."""
    tensors = (a, flow) if payload is None else (a, flow, payload)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("gather kernel needs contiguous NHWC tensors")
    n, h, w, c = a.shape
    dy, dx = pad_geometry(max_dy, max_dx)
    (sx, shx), (sy, shy) = coord
    out = torch.empty_like(a)
    dp = None if payload is None else torch.empty_like(flow)
    lib = _lib()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    geometry = (n, h, w, c, dy, dx, sx, shx, sy, shy, stream)
    off = None if off_src is None else aligned_offsets(off_src)
    off_ptr = None if off is None else off.data_ptr()
    with torch.cuda.device(a.device):
        if payload is None:
            err = lib.sininn_gather_region(
                a.data_ptr(), flow.data_ptr(), off_ptr, out.data_ptr(),
                *geometry)
        else:
            err = lib.sininn_gather_region_grads(
                a.data_ptr(), flow.data_ptr(), payload.data_ptr(), off_ptr,
                out.data_ptr(), dp.data_ptr(), *geometry)
    if err != 0:
        raise RuntimeError("gather_region kernel launch failed: "
                           + lib.sininn_error_string(err).decode())
    return out if payload is None else (out, dp)


def _gather_forward(a: torch.Tensor, flow: torch.Tensor, max_dy: int,
                    max_dx: int, coord: Coord) -> torch.Tensor:
    """K6 forward on detached tensors: the kernel on the card (counted), the
    plain version on the CPU."""
    _check(a, flow)
    if a.device.type == "cpu":
        return gather_region_plain(a, flow, max_dy, max_dx, coord)
    if a.numel() == 0:
        return torch.empty_like(a)
    out = _launch(a, flow, max_dy, max_dx, coord)
    count("launches.gather_region")
    return out


def gather_region_grads(a: torch.Tensor, flow: torch.Tensor,
                        payload: torch.Tensor, max_dy: int, max_dx: int,
                        coord: Coord):
    """K6 gradient mode: (out, dfx, dfy) with out (N, H, W, C) the windowed
    gather of ``a`` and dfx, dfy (N, H, W) = d<payload, out>/d(px, py) (the
    caller applies the coordinate scales). dfx and dfy are the two channels
    of one (N, H, W, 2) tensor. Not differentiable itself."""
    _check(a, flow, payload)
    if a.device.type == "cpu":
        return gather_region_grads_plain(a, flow, payload, max_dy, max_dx,
                                         coord)
    if a.numel() == 0:
        return (torch.empty_like(a), flow.new_zeros(flow.shape[:3]),
                flow.new_zeros(flow.shape[:3]))
    out, dp = _launch(a, flow, max_dy, max_dx, coord, payload)
    count("launches.gather_region_grads")
    return out, dp[..., 0], dp[..., 1]


class GatherRegion(torch.autograd.Function):
    """K6 forward; backward = one K6 gradient-mode launch for the flow, and
    the K5 splat of the cotangent for the image when it requires a
    gradient. ``apply(a, flow, max_dy, max_dx, coord)``."""

    @staticmethod
    def forward(ctx, a, flow, max_dy, max_dx, coord):
        ctx.geometry = (max_dy, max_dx, coord)
        ctx.save_for_backward(a, flow)
        return _gather_forward(a, flow, max_dy, max_dx, coord)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        from sin_inn_tpu_torch.ops.cuda.splat import splat_forward

        a, flow = ctx.saved_tensors
        max_dy, max_dx, coord = ctx.geometry
        (sx, _), (sy, _) = coord
        g = g.contiguous()
        d_flow = None
        if ctx.needs_input_grad[1]:
            _, dfx, dfy = gather_region_grads(a, flow, g, max_dy, max_dx,
                                              coord)
            d_flow = torch.stack([dfx * sx, dfy * sy], dim=-1)
        d_a = None
        if ctx.needs_input_grad[0]:
            # the adjoint of the gather in the image: the cotangent splatted
            # along the effective displacement p - (x, y)
            d_a = splat_forward(g, _effective_displacement(flow, coord),
                                max_dy, max_dx)
        return d_a, d_flow, None, None, None


def gather_region(a: torch.Tensor, flow: torch.Tensor, max_dy: int,
                  max_dx: int, coord: Coord) -> torch.Tensor:
    """K6: the windowed bilinear gather of ``a`` (N, H, W, C) at
    p = (x + flow) s + sh, ``coord = ((sx, shx), (sy, shy))``.
    Differentiable in ``a`` and ``flow``."""
    _check(a, flow)
    return GatherRegion.apply(a, flow, max_dy, max_dx, coord)


def resample2d_region(img: torch.Tensor, flow: torch.Tensor, max_dy: int,
                      max_dx: int) -> torch.Tensor:
    """``ops.warp.resample2d`` on K6: exact for flows within the bounds.
    Its flow gradient is one K6 gradient-mode launch; its image gradient
    (one K5 splat) is computed only when the image requires one."""
    h, w = img.shape[1:3]
    return gather_region(img, flow, max_dy, max_dx, resample_coord(h, w))


def _gather_local_forward(a: torch.Tensor, flow: torch.Tensor,
                          off_src: torch.Tensor, loc_dy: int, loc_dx: int,
                          coord: Coord) -> torch.Tensor:
    """K6 local forward on detached tensors: the kernel on the card
    (counted), the plain version on the CPU."""
    _check(a, flow)
    check_offsets(off_src, a)
    if a.device.type == "cpu":
        return gather_region_plain(a, flow, loc_dy, loc_dx, coord,
                                   off_src=off_src)
    if a.numel() == 0:
        return torch.empty_like(a)
    out = _launch(a, flow, loc_dy, loc_dx, coord, off_src=off_src)
    count("launches.gather_region_local")
    return out


def gather_region_local_grads(a: torch.Tensor, flow: torch.Tensor,
                              payload: torch.Tensor, off_src: torch.Tensor,
                              loc_dy: int, loc_dx: int, coord: Coord):
    """K6 local gradient mode: (out, dfx, dfy) as
    :func:`gather_region_grads`, on the windows shifted by ``off_src``."""
    _check(a, flow, payload)
    check_offsets(off_src, a)
    if a.device.type == "cpu":
        return gather_region_grads_plain(a, flow, payload, loc_dy, loc_dx,
                                         coord, off_src=off_src)
    if a.numel() == 0:
        return (torch.empty_like(a), flow.new_zeros(flow.shape[:3]),
                flow.new_zeros(flow.shape[:3]))
    out, dp = _launch(a, flow, loc_dy, loc_dx, coord, payload, off_src)
    count("launches.gather_region_local_grads")
    return out, dp[..., 0], dp[..., 1]


def _effective_displacement(flow: torch.Tensor, coord: Coord) -> torch.Tensor:
    """p - (x, y): the displacement along which the cotangent of a gather at
    p is splatted back onto the image."""
    (sx, shx), (sy, shy) = coord
    h, w = flow.shape[1:3]
    ys = torch.arange(h, dtype=torch.float32, device=flow.device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=flow.device)[None, None, :]
    px = (xs + flow[..., 0]) * sx + shx
    py = (ys + flow[..., 1]) * sy + shy
    return torch.stack([px - xs, py - ys], dim=-1)


class GatherRegionLocal(torch.autograd.Function):
    """K6 local forward; backward = one K6 local gradient-mode launch for
    the flow, and, when the image requires a gradient, K5 local of the
    cotangent along the effective displacement with that displacement's own
    output-tile offsets. ``apply(a, flow, off_src, loc_dy, loc_dx, cap_y,
    cap_x, coord)``."""

    @staticmethod
    def forward(ctx, a, flow, off_src, loc_dy, loc_dx, cap_y, cap_x, coord):
        ctx.geometry = (loc_dy, loc_dx, cap_y, cap_x, coord)
        ctx.save_for_backward(a, flow, off_src)
        return _gather_local_forward(a, flow, off_src, loc_dy, loc_dx, coord)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        from sin_inn_tpu_torch.ops.cuda.splat import splat_local_forward
        from sin_inn_tpu_torch.ops.offsets import tile_flow_offsets

        a, flow, off_src = ctx.saved_tensors
        loc_dy, loc_dx, cap_y, cap_x, coord = ctx.geometry
        (sx, _), (sy, _) = coord
        g = g.contiguous()
        d_flow = None
        if ctx.needs_input_grad[1]:
            _, dfx, dfy = gather_region_local_grads(a, flow, g, off_src,
                                                    loc_dy, loc_dx, coord)
            d_flow = torch.stack([dfx * sx, dfy * sy], dim=-1)
        d_a = None
        if ctx.needs_input_grad[0]:
            eff = _effective_displacement(flow, coord)
            off_out = tile_flow_offsets(eff, _B, _B, cap_y, cap_x).off_out
            d_a = splat_local_forward(g, eff, off_out, loc_dy, loc_dx)
        return d_a, d_flow, None, None, None, None, None, None


def gather_region_local(a: torch.Tensor, flow: torch.Tensor,
                        off_src: torch.Tensor, loc_dy: int, loc_dx: int,
                        cap_y: int, cap_x: int, coord: Coord) -> torch.Tensor:
    """K6 local: the local-window gather of ``a`` at p = (x + flow) s + sh,
    the windows shifted by ``off_src`` (``ops.offsets.tile_flow_offsets``
    of the flow). cap_y, cap_x: the offsets' caps, for the offsets of the
    image gradient's splat. Differentiable in ``a`` and ``flow``."""
    _check(a, flow)
    check_offsets(off_src, a)
    return GatherRegionLocal.apply(a, flow, off_src, loc_dy, loc_dx, cap_y,
                                   cap_x, coord)


def resample2d_region_local(img: torch.Tensor, flow: torch.Tensor,
                            off_src: torch.Tensor, loc_dy: int, loc_dx: int,
                            cap_y: int, cap_x: int) -> torch.Tensor:
    """``ops.warp.resample2d`` on K6 local. Its flow gradient is one K6
    local gradient-mode launch; its image gradient (offsets of the effective
    displacement and one K5 local splat) is computed only when the image
    requires one."""
    h, w = img.shape[1:3]
    return gather_region_local(img, flow, off_src, loc_dy, loc_dx, cap_y,
                               cap_x, resample_coord(h, w))


KERNELS = (gather_region, gather_region_grads, gather_region_local,
           gather_region_local_grads)


def launch_counts() -> Dict[str, int]:
    c = counters()
    return {k.__name__: c.get(f"launches.{k.__name__}", 0) for k in KERNELS}


def reset_launch_counts() -> None:
    reset_counters(tuple(f"launches.{k.__name__}" for k in KERNELS))
