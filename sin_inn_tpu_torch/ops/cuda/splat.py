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

The kernel sums with atomics, so its result is not bitwise reproducible from
run to run; the plain version and the JAX path are deterministic.

Routing is by the tensor's device alone: a CUDA tensor launches the kernel
or raises, a CPU tensor takes :func:`splat_region_plain`. The backward (the
gather kernel's grads mode) comes with the training slice; until then a
splat of tensors that require a gradient raises. ``splat_region.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from sin_inn_tpu_torch.ops.cuda import _build
from sin_inn_tpu_torch.ops.splat import softmax_coverage_via, splat_scatter

_B = 128     # output-tile rows and columns


def window_shape(max_dy: int, max_dx: int) -> Tuple[int, int]:
    """(SH, SW): the rows and columns of an output tile's source window."""
    return (-(-(_B + 2 * max_dy) // 8) * 8,
            -(-(_B + 2 * max_dx) // 128) * 128)


def splat_region_plain(values: torch.Tensor, flow: torch.Tensor,
                       max_dy: int, max_dx: int) -> torch.Tensor:
    """Plain PyTorch version of K5: the exact scatter with the window rule.
    values: (N, H, W, C) fp32, flow: (N, H, W, 2) (dx, dy). Returns
    (N, H, W, C)."""
    return splat_scatter(values, flow,
                         (_B, max_dy, max_dx) + window_shape(max_dy, max_dx))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.library("splat_region")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.sininn_splat_region.argtypes = [ptr, ptr, ptr] + [i32] * 8 + [ptr]
    lib.sininn_splat_region.restype = i32
    lib.sininn_error_string.argtypes = [i32]
    lib.sininn_error_string.restype = ctypes.c_char_p
    return lib


def _check(values: torch.Tensor, flow: torch.Tensor) -> None:
    if values.dim() != 4 or flow.shape != values.shape[:3] + (2,):
        raise ValueError(f"expected NHWC values and an (N, H, W, 2) flow, "
                         f"got {tuple(values.shape)} and {tuple(flow.shape)}")
    if values.device.type not in ("cpu", "cuda") or flow.device != values.device:
        raise ValueError(f"no splat kernel for {values.device} / "
                         f"{flow.device}")
    if values.dtype != torch.float32 or flow.dtype != torch.float32:
        raise TypeError(f"splat kernel takes float32, got {values.dtype} and "
                        f"{flow.dtype}")
    if torch.is_grad_enabled() and (values.requires_grad
                                    or flow.requires_grad):
        raise RuntimeError(
            "the windowed splat has no gradient yet: its backward comes in "
            "the training slice (run under torch.no_grad())")


def _launch(values: torch.Tensor, flow: torch.Tensor, max_dy: int,
            max_dx: int) -> torch.Tensor:
    if not (values.is_contiguous() and flow.is_contiguous()):
        raise ValueError("splat kernel needs contiguous NHWC tensors")
    n, h, w, c = values.shape
    sh, sw = window_shape(max_dy, max_dx)
    out = torch.zeros_like(values)
    lib = _lib()
    with torch.cuda.device(values.device):
        err = lib.sininn_splat_region(
            values.data_ptr(), flow.data_ptr(), out.data_ptr(), n, h, w, c,
            max_dy, max_dx, sh, sw,
            torch.cuda.current_stream(values.device).cuda_stream)
    if err != 0:
        raise RuntimeError("splat_region kernel launch failed: "
                           + lib.sininn_error_string(err).decode())
    return out


def splat_region(values: torch.Tensor, flow: torch.Tensor, max_dy: int,
                 max_dx: int) -> torch.Tensor:
    """K5: the windowed bilinear splat of ``values`` (N, H, W, C) along
    ``flow`` (N, H, W, 2)."""
    _check(values, flow)
    if max_dy < 0 or max_dx < 0:
        raise ValueError(f"window bounds must be >= 0, got {max_dy}, "
                         f"{max_dx}")
    if values.device.type == "cpu":
        return splat_region_plain(values, flow, max_dy, max_dx)
    if values.numel() == 0:
        return torch.zeros_like(values)
    out = _launch(values, flow, max_dy, max_dx)
    splat_region.launches += 1
    return out


def softsplat_region_with_coverage(inp: torch.Tensor, flow: torch.Tensor,
                                   metric: torch.Tensor, max_dy: int,
                                   max_dx: int):
    """Softmax splat and coverage on K5 (one splat of [inp exp(metric),
    exp(metric), ones]). Returns (softmax_out, coverage)."""
    return softmax_coverage_via(
        lambda cat, fl: splat_region(cat, fl, max_dy, max_dx),
        inp, flow, metric)


KERNELS = (splat_region,)
splat_region.launches = 0


def launch_counts() -> Dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
