"""Coupling-block subnets: the plain conv stack of the SRF GLOW couplings
and the dense block of the IRN couplings.

Counterpart of ``sin_inn_tpu/ops/subnet.py`` (``conv2d``,
``conv_subnet_init``, ``conv_subnet_apply``, ``conv2d_shift``,
``dense_block_init`` and ``dense_block_apply``). Activations stay NHWC;
weights are OIHW, as ``torch.nn.Conv2d`` keeps them. An NHWC-contiguous
tensor viewed with ``.permute(0, 3, 1, 2)`` already has the
``channels_last`` memory format, so cuDNN takes it without a copy. The dense
block's measurement forms (``fused=True``: the lower-triangular piece form;
``shift=True``: each conv as nine shifted products, ``conv2d_shift``)
compute the default form's function in another summation order. The
reference keeps them as records of measured alternatives; no entry point
reaches them, in either package.

Compute modes (``SRConfig.compute_dtype``), mapped from the TPU's:

* ``float32``: fp32 tensors, TF32 allowed for the convolutions. This is the
  nearest counterpart of the TPU's default one-pass bf16 matmul.
* ``float32_highest``: full fp32, TF32 off for the call only (set with
  ``torch.backends.cudnn.flags`` around it, never as a global side effect).
* ``bfloat16``: bf16 conv inputs and weights, output cast back to fp32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F


def compute_mode(compute_dtype: str):
    """Config string -> the ``compute`` argument of :func:`conv2d`."""
    return {"float32": None, "float32_highest": "highest",
            "bfloat16": torch.bfloat16}[compute_dtype]


def _cudnn_tf32(allow: bool, benchmark: Optional[bool] = None):
    """cuDNN's TF32 switched to ``allow`` (and its autotuning to
    ``benchmark``, where given) for the block, restored after it."""
    cudnn = torch.backends.cudnn
    bench = cudnn.benchmark if benchmark is None else benchmark
    if cudnn.allow_tf32 == allow and cudnn.benchmark == bench:
        return contextlib.nullcontext()
    return cudnn.flags(enabled=cudnn.enabled, benchmark=bench,
                       deterministic=cudnn.deterministic, allow_tf32=allow)


@contextlib.contextmanager
def _matmul_tf32(allow: bool):
    """TF32 of cuBLAS's fp32 products switched to ``allow`` for the block
    and restored after it (PyTorch's default is off)."""
    m = torch.backends.cuda.matmul
    before = m.allow_tf32
    if before == allow:
        yield
        return
    m.allow_tf32 = allow
    try:
        yield
    finally:
        m.allow_tf32 = before


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           compute=None) -> torch.Tensor:
    """NHWC stride-1 SAME conv with an OIHW kernel; returns x's dtype.

    ``compute`` is None (fp32, TF32 allowed), ``"highest"`` (TF32 off) or a
    dtype the inputs are cast to (accumulation stays fp32 in cuDNN). The bias
    is added after the cast back, as the reference does.
    """
    out_dtype = x.dtype
    if isinstance(compute, torch.dtype):
        x = x.to(compute)
        w = w.to(compute)
    with _cudnn_tf32(compute != "highest"):
        out = F.conv2d(x.permute(0, 3, 1, 2), w, padding=w.shape[-1] // 2)
    out = out.permute(0, 2, 3, 1).to(out_dtype)
    if b is not None:
        out = out + b
    return out


def _torch_default_conv(gen: torch.Generator, k: int, cin: int, cout: int,
                        dtype=torch.float32) -> Dict:
    """torch.nn.Conv2d default: kaiming_uniform(a=sqrt(5)) => U(+-1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(cin * k * k)
    uniform = lambda shape: (torch.rand(shape, generator=gen, dtype=dtype,
                                        device=gen.device) * 2 - 1) * bound
    return {"w": uniform((cout, cin, k, k)), "b": uniform((cout,))}


def _xavier_normal_conv(gen: torch.Generator, cin: int, cout: int,
                        scale: float = 1.0, dtype=torch.float32) -> Dict:
    """xavier_normal_ 3x3 weight times ``scale``, zero bias."""
    std = math.sqrt(2.0 / (cin * 9 + cout * 9)) * scale
    w = torch.randn((cout, cin, 3, 3), generator=gen, dtype=dtype,
                    device=gen.device) * std
    return {"w": w, "b": torch.zeros((cout,), dtype=dtype, device=gen.device)}


def _zero_conv(cin: int, cout: int, device, dtype=torch.float32) -> Dict:
    """The dense block's last conv: its init scaled by 0, i.e. zeros."""
    return {"w": torch.zeros((cout, cin, 3, 3), dtype=dtype, device=device),
            "b": torch.zeros((cout,), dtype=dtype, device=device)}


def conv_subnet_init(gen: torch.Generator, c_in: int, c_out: int, kernel: int,
                     hidden: int = 256, dtype=torch.float32) -> Dict:
    return {
        "conv1": _torch_default_conv(gen, kernel, c_in, hidden, dtype),
        "conv2": _torch_default_conv(gen, kernel, hidden, c_out, dtype),
    }


def conv_subnet_apply(params: Dict, x: torch.Tensor,
                      compute=None) -> torch.Tensor:
    h = conv2d(x, params["conv1"]["w"], params["conv1"]["b"], compute)
    h = torch.relu(h)
    return conv2d(h, params["conv2"]["w"], params["conv2"]["b"], compute)


def conv2d_shift(x: torch.Tensor, w: torch.Tensor,
                 b: Optional[torch.Tensor] = None,
                 compute=None) -> torch.Tensor:
    """:func:`conv2d` for a 3x3 kernel as nine shifted (M, cin) @ (cin,
    cout) products over the zero-padded input: the same function up to
    summation order. ``compute`` as in :func:`conv2d` (TF32 of the products
    allowed unless ``"highest"``)."""
    if tuple(w.shape[2:]) != (3, 3):
        raise ValueError(f"conv2d_shift takes a 3x3 kernel, got "
                         f"{tuple(w.shape[2:])}")
    out_dtype = x.dtype
    if isinstance(compute, torch.dtype):
        x = x.to(compute)
        w = w.to(compute)
    _, hh, ww, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    out = None
    with _matmul_tf32(compute != "highest"):
        for i in range(3):
            for j in range(3):
                t = xp[:, i:i + hh, j:j + ww, :] @ w[:, :, i, j].t()
                out = t if out is None else out + t
    out = out.to(out_dtype)
    if b is not None:
        out = out + b
    return out


def dense_block_init(gen: torch.Generator, c_in: int, c_out: int,
                     gc: int = 32, dtype=torch.float32) -> Dict:
    """Five 3x3 convs: conv1-4 grow the concatenation by ``gc`` channels
    each (xavier-normal x 0.1), conv5 maps it to ``c_out`` (zeros), so a
    coupling starts as the identity."""
    params = {f"conv{i + 1}": _xavier_normal_conv(gen, c_in + i * gc, gc, 0.1,
                                                  dtype)
              for i in range(4)}
    params["conv5"] = _zero_conv(c_in + 4 * gc, c_out, gen.device, dtype)
    return params


def dense_block_apply(params: Dict, x: torch.Tensor, compute=None,
                      fused: bool = False,
                      shift: bool = False) -> torch.Tensor:
    """DenseBlock forward: four leaky-relu (0.2) convs, each on the
    concatenation of the input and every earlier output, then conv5.

    ``shift=True`` runs each conv as :func:`conv2d_shift`. ``fused=True``
    computes the same function in lower-triangular piece form: conv_i of
    the concatenation is the sum over its pieces of the piece's conv with
    that piece's input-channel slice of W_i, and each piece's contributions
    to every later conv run as one wide conv (output channels 4 gc + c_out,
    3 gc + c_out, ...), so no concatenation is built. The bias rides with
    the input's contribution, once per conv."""
    lrelu = lambda v: F.leaky_relu(v, 0.2)
    if not fused:
        base = conv2d_shift if shift else conv2d
        cat = x
        for i in range(1, 5):
            p = params[f"conv{i}"]
            out = lrelu(base(cat, p["w"], p["b"], compute))
            cat = torch.cat([cat, out], dim=-1)
        return base(cat, params["conv5"]["w"], params["conv5"]["b"], compute)

    c_in = x.shape[-1]
    gc = params["conv1"]["w"].shape[0]
    ws = [params[f"conv{i}"]["w"] for i in range(1, 6)]
    bs = [params[f"conv{i}"]["b"] for i in range(1, 6)]

    def contrib(piece, start_conv, lo, hi):
        """One wide conv: the piece's contribution to convs start_conv..5,
        [lo, hi) its input-channel slice in each of them."""
        w_cat = torch.cat([ws[i][:, lo:hi] for i in range(start_conv, 5)],
                          dim=0)
        return conv2d(piece, w_cat, None, compute)

    yx = contrib(x, 0, 0, c_in) + torch.cat(bs)
    x1 = lrelu(yx[..., :gc])
    y1 = contrib(x1, 1, c_in, c_in + gc)
    x2 = lrelu(yx[..., gc:2 * gc] + y1[..., :gc])
    y2 = contrib(x2, 2, c_in + gc, c_in + 2 * gc)
    x3 = lrelu(yx[..., 2 * gc:3 * gc] + y1[..., gc:2 * gc] + y2[..., :gc])
    y3 = contrib(x3, 3, c_in + 2 * gc, c_in + 3 * gc)
    x4 = lrelu(yx[..., 3 * gc:4 * gc] + y1[..., 2 * gc:3 * gc]
               + y2[..., gc:2 * gc] + y3[..., :gc])
    y4 = contrib(x4, 4, c_in + 3 * gc, c_in + 4 * gc)
    return (yx[..., 4 * gc:] + y1[..., 3 * gc:] + y2[..., 2 * gc:]
            + y3[..., gc:] + y4)
