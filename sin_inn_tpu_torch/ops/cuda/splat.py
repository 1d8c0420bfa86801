"""Windowed bilinear forward splat (K5): CUDA kernel and plain version.

``splat_region`` replaces the TPU kernel ``_region_kernel`` of
``sin_inn_tpu/ops/pallas/splat.py`` (``_splat_region_call``), and
``softsplat_region_with_coverage`` is the softmax splat with its coverage
channel on it, as there. The kernel is ``csrc/splat_region.cu``; its header
states what bounds it on an H100 and how the design deals with that.

The function, exactly as the TPU kernel computes it: source pixel s with
target t = s + flow(s) adds value max(1 - |ty - r|, 0) max(1 - |tx - k|, 0)
to each of its four bilinear taps (r, k) that lies in the image, but only
if s lies in the source window of the 128 x 128 output tile (i, j) holding
the tap: rows [128 i - dy, 128 i - dy + SH), columns [128 j - dx,
128 j - dx + SW), SH = 8 ceil((128 + 2 dy) / 8), SW = 128 ceil((128 + 2 dx)
/ 128). For |flow_y| <= dy - 1 and |flow_x| <= dx - 1 this is the exact
``splat_scatter``; farther taps are dropped.

The kernel sums in 64-bit fixed point, at a scale per channel taken from
the largest finite |value| on the device, so two launches give the same
bits, as the plain version and the JAX path do; it takes at most 8
channels. Where a value is Inf or NaN, every output pixel and channel it
reaches is NaN or Inf as in the plain version's fp32 sum.

What bounds it is bytes (21.4 MB a launch at the flow path's shape), and
what held it back were the sums: 8.9 M scattered 64-bit atomics into a
19.6 MB global accumulator that had to be zeroed and read back. The window
rule says before the launch which sources can reach an output tile, so a
block owns a sub-tile of outputs (:func:`splat_plan`: its rows and shared
memory by channel count), walks its tile's source window, sums what lands
in the sub-tile in shared memory and writes each output once. A launch is
two kernels (a summary of each 128-pixel chunk of a row: its targets' range
and the per-channel maxima; then the splat, which skips the chunks whose
targets miss its sub-tile) with a scratch under 64 KB at the flow path's
shape (:func:`scratch_bytes`), no global accumulator and no global atomic.

``splat_region`` is differentiable (:class:`SplatRegion`): its backward is
one launch of the gather kernel's gradient mode (``ops/cuda/gather.py``
``gather_region_grads``) with the cotangent as the image, the values as the
payload and raw coordinates: the gather is the values' gradient, (dfx, dfy)
the flow's. Note the anchoring, kept as the TPU package has it: the forward
keeps a tap by the window of the tile that holds the TAP, the backward by
the window around the SOURCE pixel. The two agree for flows within the
bounds and may differ for taps beyond them.

``splat_region_local`` (K5 local) replaces the same TPU kernel as
``_splat_region_call_local`` runs it, and
``softsplat_region_local_with_coverage`` is the softmax splat on it. Each
output tile (i, j) shifts its window by (ox, oy) = -off_out[n, i, j]
(``ops/offsets.py``): a tap (r, k) in tile (i, j) is kept iff s lies in
rows [128 i - dy + oy, ... + SH) and
columns [128 j - dx + ox, ... + SW), with dy, dx the local bounds and SH, SW
the window they give. The rule depends on both coordinates of the tap's
tile, so the plain version forms it per tap pair. Its backward is one launch
of K6 local in gradient mode with ``off_src`` and raw coordinates.

Routing is by the tensor's device alone: a CUDA tensor launches the kernel
or raises, a CPU tensor takes the plain versions, in the forward and in the
backward alike. The profiler's counters ``launches.splat_region`` and
``launches.splat_region_local`` (``core/profiler.py``) count K5 and K5
local launches; :func:`launch_counts` reads them.
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
from sin_inn_tpu_torch.ops.cuda.gather import (RAW, aligned_offsets,
                                               check_offsets,
                                               gather_region_grads,
                                               gather_region_local_grads)
from sin_inn_tpu_torch.ops.splat import softmax_coverage_via, splat_scatter

_B = 128     # output-tile rows and columns
MAX_CHANNELS = 8    # channels the kernel takes (three flag bits each)
_MAX_SMEM = 232448 - 1024   # a block's dynamic shared memory, at most
_QUEUES = 32 * 64 * 4       # a block's 32 warps' queues of 64 hits
_SLOT_CHUNKS = 16           # chunks of 128 pixels of a row a slot


def splat_plan(c: int) -> Tuple[int, int]:
    """(rows, shared bytes) of a K5 block on ``c`` channels, as
    ``csrc/splat_region.cu`` ``rows_of`` / ``smem_of`` give them: a sub-tile
    of rows x 128 outputs, 32 rows where their int64 sums (8 bytes a value),
    flags (4 a pixel) and the warps' queues fit in shared memory, else
    16."""
    if not 0 < c <= MAX_CHANNELS:
        raise ValueError(f"the splat kernel takes 1 to {MAX_CHANNELS} "
                         f"channels, got {c}")
    rows = 32
    while rows * _B * (8 * c + 4) + _QUEUES > _MAX_SMEM:
        rows //= 2
    return rows, rows * _B * (8 * c + 4) + _QUEUES


def scratch_bytes(n: int, h: int, w: int, c: int) -> int:
    """Bytes of a K5 launch's scratch, as ``csrc/splat_region.cu``
    ``layout_of`` gives them: a summary of 16 bytes (its targets' row and
    column range) for each chunk of 128 pixels of an image row, then c + 1
    words of 4 bytes (each channel's largest finite |value|, and whether
    any value is not finite) for each slot of 16 chunks."""
    chunks = n * h * -(-w // _B)
    return chunks * 16 + -(-chunks // _SLOT_CHUNKS) * (c + 1) * 4


def window_shape(max_dy: int, max_dx: int) -> Tuple[int, int]:
    """(SH, SW): the rows and columns of an output tile's source window."""
    return (-(-(_B + 2 * max_dy) // 8) * 8,
            -(-(_B + 2 * max_dx) // 128) * 128)


def _in_window(s, t, d: int, span: int, shift=0):
    """Whether source coordinate s lies in the window of the tile holding
    tap coordinate t, shifted by ``shift``."""
    lo = t // _B * _B - d + shift
    return (s >= lo) & (s < lo + span)


def splat_region_plain(values: torch.Tensor, flow: torch.Tensor,
                       max_dy: int, max_dx: int) -> torch.Tensor:
    """Plain PyTorch version of K5: the exact scatter with the window rule.
    values: (N, H, W, C) fp32, flow: (N, H, W, 2) (dx, dy). Returns
    (N, H, W, C)."""
    _, h, w, _ = values.shape
    sh, sw = window_shape(max_dy, max_dx)
    ys = torch.arange(h, device=values.device)[None, :, None]
    xs = torch.arange(w, device=values.device)[None, None, :]
    return splat_scatter(values, flow, lambda r, k: (
        _in_window(ys, r, max_dy, sh) & _in_window(xs, k, max_dx, sw)))


def splat_region_local_plain(values: torch.Tensor, flow: torch.Tensor,
                             off_out: torch.Tensor, loc_dy: int,
                             loc_dx: int) -> torch.Tensor:
    """Plain PyTorch version of K5 local: the exact scatter, each tap pair
    kept by the window of the tile holding it, shifted by -off_out of that
    tile. off_out: (N, HB, WB, 2) integer-valued fp32."""
    n, h, w, _ = values.shape
    sh, sw = window_shape(loc_dy, loc_dx)
    dev = values.device
    ys = torch.arange(h, device=dev)[None, :, None]
    xs = torch.arange(w, device=dev)[None, None, :]
    nidx = torch.arange(n, device=dev)[:, None, None]
    shift = (-off_out).long()

    def keep(r, k):
        o = shift[nidx, r // _B, k // _B]
        return (_in_window(ys, r, loc_dy, sh, o[..., 1])
                & _in_window(xs, k, loc_dx, sw, o[..., 0]))

    return splat_scatter(values, flow, keep)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.library("splat_region")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.sininn_splat_region_scratch.argtypes = [i32] * 4
    lib.sininn_splat_region_scratch.restype = ctypes.c_longlong
    lib.sininn_splat_region_plan.argtypes = [i32, ptr]
    lib.sininn_splat_region_plan.restype = i32
    lib.sininn_splat_region.argtypes = [ptr] * 4 + [i32] * 8 + [ptr]
    lib.sininn_splat_region.restype = i32
    lib.sininn_splat_region_local.argtypes = [ptr] * 5 + [i32] * 8 + [ptr]
    lib.sininn_splat_region_local.restype = i32
    lib.sininn_error_string.argtypes = [i32]
    lib.sininn_error_string.restype = ctypes.c_char_p
    return lib


def _check(values: torch.Tensor, flow: torch.Tensor, max_dy: int,
           max_dx: int) -> None:
    if values.dim() != 4 or flow.shape != values.shape[:3] + (2,):
        raise ValueError(f"expected NHWC values and an (N, H, W, 2) flow, "
                         f"got {tuple(values.shape)} and {tuple(flow.shape)}")
    if values.device.type not in ("cpu", "cuda") or flow.device != values.device:
        raise ValueError(f"no splat kernel for {values.device} / "
                         f"{flow.device}")
    if values.dtype != torch.float32 or flow.dtype != torch.float32:
        raise TypeError(f"splat kernel takes float32, got {values.dtype} and "
                        f"{flow.dtype}")
    if max_dy < 0 or max_dx < 0:
        raise ValueError(f"window bounds must be >= 0, got {max_dy}, "
                         f"{max_dx}")


def _launch(values: torch.Tensor, flow: torch.Tensor, max_dy: int,
            max_dx: int, off_out=None) -> torch.Tensor:
    """One launch of K5, or of K5 local when ``off_out`` is given, with
    the scratch of its max partials."""
    if not (values.is_contiguous() and flow.is_contiguous()):
        raise ValueError("splat kernel needs contiguous NHWC tensors")
    n, h, w, c = values.shape
    if c > MAX_CHANNELS:
        raise ValueError(f"the splat kernel takes at most {MAX_CHANNELS} "
                         f"channels, got {c}")
    sh, sw = window_shape(max_dy, max_dx)
    out = torch.empty_like(values)
    flow = aligned_offsets(flow)    # read as (dx, dy) pairs, as the offsets
    lib = _lib()
    scratch = torch.empty(lib.sininn_splat_region_scratch(n, h, w, c),
                          dtype=torch.int64, device=values.device)
    stream = torch.cuda.current_stream(values.device).cuda_stream
    with torch.cuda.device(values.device):
        if off_out is None:
            err = lib.sininn_splat_region(
                values.data_ptr(), flow.data_ptr(), out.data_ptr(),
                scratch.data_ptr(), n, h, w, c, max_dy, max_dx, sh, sw,
                stream)
        else:
            off_out = aligned_offsets(off_out)
            err = lib.sininn_splat_region_local(
                values.data_ptr(), flow.data_ptr(), off_out.data_ptr(),
                out.data_ptr(), scratch.data_ptr(), n, h, w, c, max_dy,
                max_dx, sh, sw, stream)
    if err != 0:
        raise RuntimeError("splat_region kernel launch failed: "
                           + lib.sininn_error_string(err).decode())
    return out


def splat_forward(values: torch.Tensor, flow: torch.Tensor, max_dy: int,
                  max_dx: int) -> torch.Tensor:
    """K5 on detached tensors: the kernel on the card (counted), the plain
    version on the CPU."""
    _check(values, flow, max_dy, max_dx)
    if values.device.type == "cpu":
        return splat_region_plain(values, flow, max_dy, max_dx)
    if values.numel() == 0:
        return torch.zeros_like(values)
    out = _launch(values, flow, max_dy, max_dx)
    count("launches.splat_region")
    return out


class SplatRegion(torch.autograd.Function):
    """K5 forward; backward = one K6 gradient-mode launch (the cotangent
    gathered along the same flow). ``apply(values, flow, max_dy, max_dx)``."""

    @staticmethod
    def forward(ctx, values, flow, max_dy, max_dx):
        ctx.bounds = (max_dy, max_dx)
        ctx.save_for_backward(values, flow)
        return splat_forward(values, flow, max_dy, max_dx)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        values, flow = ctx.saved_tensors
        d_values, dfx, dfy = gather_region_grads(
            g.contiguous(), flow, values, *ctx.bounds, RAW)
        return d_values, torch.stack([dfx, dfy], dim=-1), None, None


def splat_region(values: torch.Tensor, flow: torch.Tensor, max_dy: int,
                 max_dx: int) -> torch.Tensor:
    """K5: the windowed bilinear splat of ``values`` (N, H, W, C) along
    ``flow`` (N, H, W, 2). Differentiable in both."""
    _check(values, flow, max_dy, max_dx)
    return SplatRegion.apply(values, flow, max_dy, max_dx)


def softsplat_region_with_coverage(inp: torch.Tensor, flow: torch.Tensor,
                                   metric: torch.Tensor, max_dy: int,
                                   max_dx: int):
    """Softmax splat and coverage on K5 (one splat of [inp exp(metric),
    exp(metric), ones]). Returns (softmax_out, coverage)."""
    return softmax_coverage_via(
        lambda cat, fl: splat_region(cat, fl, max_dy, max_dx),
        inp, flow, metric)


def splat_local_forward(values: torch.Tensor, flow: torch.Tensor,
                        off_out: torch.Tensor, loc_dy: int,
                        loc_dx: int) -> torch.Tensor:
    """K5 local on detached tensors: the kernel on the card (counted), the
    plain version on the CPU."""
    _check(values, flow, loc_dy, loc_dx)
    check_offsets(off_out, values)
    if values.device.type == "cpu":
        return splat_region_local_plain(values, flow, off_out, loc_dy, loc_dx)
    if values.numel() == 0:
        return torch.zeros_like(values)
    out = _launch(values, flow, loc_dy, loc_dx, off_out)
    count("launches.splat_region_local")
    return out


class SplatRegionLocal(torch.autograd.Function):
    """K5 local forward; backward = one K6 local gradient-mode launch with
    the source-tile offsets and raw coordinates. ``apply(values, flow,
    off_out, off_src, loc_dy, loc_dx)``; the offsets get no gradient."""

    @staticmethod
    def forward(ctx, values, flow, off_out, off_src, loc_dy, loc_dx):
        ctx.bounds = (loc_dy, loc_dx)
        ctx.save_for_backward(values, flow, off_src)
        return splat_local_forward(values, flow, off_out, loc_dy, loc_dx)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        values, flow, off_src = ctx.saved_tensors
        d_values, dfx, dfy = gather_region_local_grads(
            g.contiguous(), flow, values, off_src, *ctx.bounds, RAW)
        return (d_values, torch.stack([dfx, dfy], dim=-1), None, None, None,
                None)


def splat_region_local(values: torch.Tensor, flow: torch.Tensor,
                       off_out: torch.Tensor, off_src: torch.Tensor,
                       loc_dy: int, loc_dx: int) -> torch.Tensor:
    """K5 local: the local-window splat of ``values`` (N, H, W, C) along
    ``flow`` (N, H, W, 2), with the offsets of ``ops.offsets.
    tile_flow_offsets(flow, ...)``. Differentiable in values and flow."""
    _check(values, flow, loc_dy, loc_dx)
    check_offsets(off_out, values)
    check_offsets(off_src, values)
    return SplatRegionLocal.apply(values, flow, off_out, off_src, loc_dy,
                                  loc_dx)


def softsplat_region_local_with_coverage(inp: torch.Tensor,
                                         flow: torch.Tensor,
                                         metric: torch.Tensor, loc_dy: int,
                                         loc_dx: int, off_out: torch.Tensor,
                                         off_src: torch.Tensor):
    """Softmax splat and coverage on K5 local. Returns (softmax_out,
    coverage)."""
    return softmax_coverage_via(
        lambda cat, fl: splat_region_local(cat, fl, off_out, off_src, loc_dy,
                                           loc_dx),
        inp, flow, metric)


KERNELS = (splat_region, splat_region_local)


def launch_counts() -> Dict[str, int]:
    c = counters()
    return {k.__name__: c.get(f"launches.{k.__name__}", 0) for k in KERNELS}


def reset_launch_counts() -> None:
    reset_counters(tuple(f"launches.{k.__name__}" for k in KERNELS))
