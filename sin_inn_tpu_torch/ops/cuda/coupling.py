"""Fused GLOW coupling with 1x1-conv subnets: CUDA kernels and plain versions.

``fused_glow_forward_1x1`` and ``fused_glow_inverse_1x1`` replace the TPU
kernels ``_coupling_fwd_kernel`` and ``_coupling_inv_kernel`` of
``sin_inn_tpu/ops/pallas/coupling.py`` (entry points of the same names). The
kernels live in ``csrc/coupling_1x1.cu``; its header states what bounds them
on an H100 (arithmetic: about 190 FLOP per byte of input and output at the
flagship shapes) and how the design deals with weights that do not fit in a
block's shared memory (one activation tile per block, weights streamed from
L2).

Routing is by the tensor's device alone: a CUDA tensor launches the kernel or
raises, a CPU tensor takes the plain version (four ``torch.matmul`` and the
elementwise chain, in the same module). Nothing falls back from one to the
other. These two kernels have no backward yet: under autograd with a tensor
that requires grad, the CUDA path raises instead of returning a result with
no gradient path.

Each wrapper counts its launches in a plain integer attribute,
``fused_glow_forward_1x1.launches`` and ``fused_glow_inverse_1x1.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Tuple

import torch

from sin_inn_tpu_torch.ops.coupling import glow_log_e
from sin_inn_tpu_torch.ops.cuda import _build

# dynamic shared memory a block may use on Hopper
_MAX_SMEM = 232_448


def _mats(params: Dict, c: int, len1: int) -> Tuple[List[torch.Tensor], int]:
    """1x1 conv params (OIHW) -> the kernel's operands and the hidden width:
    [w2a (len2, H), b2a, w2b (H, 2 len1), b2b, w1a (len1, H), b1a,
    w1b (H, 2 len2), b1b], with each weight as a (cin, cout) view."""
    if not 0 < len1 < c:
        raise ValueError(f"len1={len1} must lie in (0, {c})")
    len2 = c - len1
    hidden = params["s2"]["conv1"]["w"].shape[0]
    want = {"s2": (len2, 2 * len1), "s1": (len1, 2 * len2)}
    mats = []
    for sub in ("s2", "s1"):
        cin, cout = want[sub]
        for conv, shape in (("conv1", (hidden, cin, 1, 1)),
                            ("conv2", (cout, hidden, 1, 1))):
            w, b = params[sub][conv]["w"], params[sub][conv]["b"]
            if tuple(w.shape) != shape or tuple(b.shape) != (shape[0],):
                raise ValueError(
                    f"{sub}.{conv}: weight {tuple(w.shape)} / bias "
                    f"{tuple(b.shape)}, expected {shape} / ({shape[0]},) for "
                    f"C={c}, len1={len1}, hidden={hidden}")
            mats += [w[:, :, 0, 0].t(), b]
    return mats, hidden


def _plain(params: Dict, x: torch.Tensor, clamp: float, len1: int,
           inverse: bool) -> torch.Tensor:
    n, h, w, c = x.shape
    (w2a, b2a, w2b, b2b, w1a, b1a, w1b, b1b), _ = _mats(params, c, len1)
    len2 = c - len1
    v = x.reshape(-1, c).float()

    def r2(a):   # subnet s2 on x2 -> [s2 | t2], 2*len1 wide
        return torch.relu(a @ w2a + b2a) @ w2b + b2b

    def r1(a):   # subnet s1 on y1 -> [s1 | t1], 2*len2 wide
        return torch.relu(a @ w1a + b1a) @ w1b + b1b

    if not inverse:
        x1, x2 = v[:, :len1], v[:, len1:]
        r = r2(x2)
        y1 = torch.exp(glow_log_e(r[:, :len1], clamp)) * x1 + r[:, len1:]
        r = r1(y1)
        y2 = torch.exp(glow_log_e(r[:, :len2], clamp)) * x2 + r[:, len2:]
        out = torch.cat([y1, y2], dim=1)
    else:
        y1, y2 = v[:, :len1], v[:, len1:]
        r = r1(y1)
        x2 = (y2 - r[:, len2:]) * torch.exp(-glow_log_e(r[:, :len2], clamp))
        r = r2(x2)
        x1 = (y1 - r[:, len1:]) * torch.exp(-glow_log_e(r[:, :len1], clamp))
        out = torch.cat([x1, x2], dim=1)
    return out.to(x.dtype).reshape(n, h, w, c)


def fused_glow_forward_1x1_plain(params: Dict, x: torch.Tensor, clamp: float,
                                 len1: int) -> torch.Tensor:
    """Plain PyTorch version of the fused forward. x: (N, H, W, C)."""
    return _plain(params, x, clamp, len1, inverse=False)


def fused_glow_inverse_1x1_plain(params: Dict, y: torch.Tensor, clamp: float,
                                 len1: int) -> torch.Tensor:
    """Plain PyTorch version of the fused inverse. y: (N, H, W, C)."""
    return _plain(params, y, clamp, len1, inverse=True)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.library("coupling_1x1")
    ptr = ctypes.c_void_p
    lib.sininn_coupling_1x1.argtypes = (
        [ctypes.c_int, ctypes.c_int, ptr, ptr, ctypes.c_longlong,
         ctypes.c_int, ctypes.c_int, ctypes.c_int] + [ptr] * 8
        + [ctypes.c_float, ptr])
    lib.sininn_coupling_1x1.restype = ctypes.c_int
    lib.sininn_coupling_1x1_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.sininn_coupling_1x1_smem_bytes.restype = ctypes.c_longlong
    lib.sininn_error_string.argtypes = [ctypes.c_int]
    lib.sininn_error_string.restype = ctypes.c_char_p
    return lib


def _launch(params: Dict, x: torch.Tensor, clamp: float, len1: int,
            inverse: bool) -> torch.Tensor:
    """One kernel launch on the current stream. Returns the output; the
    caller counts the launch."""
    if x.dim() != 4:
        raise ValueError(f"expected NHWC input, got shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"coupling kernel takes float32 or bfloat16 "
                        f"activations, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("coupling kernel needs a contiguous NHWC input")
    c = x.shape[-1]
    mats, hidden = _mats(params, c, len1)
    if torch.is_grad_enabled() and (x.requires_grad or
                                    any(t.requires_grad for t in mats)):
        raise RuntimeError(
            "fused 1x1 coupling kernels have no gradient yet: backward "
            "kernels come in the training slice (run under "
            "torch.inference_mode() or torch.no_grad())")
    for t in mats:
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(f"coupling weights must be float32 on "
                             f"{x.device}, got {t.dtype} on {t.device}")
    mats = [t.contiguous() for t in mats]
    lib = _lib()
    smem = lib.sininn_coupling_1x1_smem_bytes(c, hidden)
    if smem > _MAX_SMEM:
        raise ValueError(f"C={c}, hidden={hidden} needs {smem} bytes of "
                         f"shared memory per block (max {_MAX_SMEM})")
    out = torch.empty_like(x)
    m = x.numel() // c
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.sininn_coupling_1x1(
            int(inverse), int(x.dtype == torch.bfloat16), x.data_ptr(),
            out.data_ptr(), m, c, len1, hidden,
            *[t.data_ptr() for t in mats], float(clamp), stream)
    if err != 0:
        raise RuntimeError("coupling_1x1 kernel launch failed: "
                           + lib.sininn_error_string(err).decode())
    return out


def fused_glow_forward_1x1(params: Dict, x: torch.Tensor, clamp: float,
                           len1: int) -> torch.Tensor:
    """Fused forward of a 1x1-subnet GLOW coupling. x: (N, H, W, C)."""
    if x.device.type == "cpu":
        return fused_glow_forward_1x1_plain(params, x, clamp, len1)
    if x.device.type != "cuda":
        raise ValueError(f"no coupling kernel for device {x.device}")
    if x.numel() == 0:
        return torch.empty_like(x)
    out = _launch(params, x, clamp, len1, inverse=False)
    fused_glow_forward_1x1.launches += 1
    return out


def fused_glow_inverse_1x1(params: Dict, y: torch.Tensor, clamp: float,
                           len1: int) -> torch.Tensor:
    """Fused inverse (exact inverse of the forward kernel). y: (N, H, W, C)."""
    if y.device.type == "cpu":
        return fused_glow_inverse_1x1_plain(params, y, clamp, len1)
    if y.device.type != "cuda":
        raise ValueError(f"no coupling kernel for device {y.device}")
    if y.numel() == 0:
        return torch.empty_like(y)
    out = _launch(params, y, clamp, len1, inverse=True)
    fused_glow_inverse_1x1.launches += 1
    return out


fused_glow_forward_1x1.launches = 0
fused_glow_inverse_1x1.launches = 0
KERNELS = (fused_glow_forward_1x1, fused_glow_inverse_1x1)


def launch_counts() -> Dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
