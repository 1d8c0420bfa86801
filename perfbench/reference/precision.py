"""The reference's products in a stated precision.

``fp32``: full float32 (TF32 off in cuBLAS and cuDNN). ``tf32``: the
operands of every product rounded to TF32 (10 mantissa bits, to nearest
even), the products summed in float32, forward and backward alike: what the
tensor cores compute in TF32, the same on the CPU as on the card.
"""

from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("fp32", "tf32")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, ties to even."""
    i = x.contiguous().view(torch.int32)
    lsb = torch.bitwise_and(torch.bitwise_right_shift(i, 13), 1)
    i = torch.bitwise_and(i + (0x0FFF + lsb), ~0x1FFF)
    return i.view(torch.float32)


def rounder(prec: str):
    if prec not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {prec!r}")
    if prec == "fp32":
        return lambda t: t
    return round_tf32


@contextlib.contextmanager
def strict_fp32():
    """TF32 off in cuBLAS and cuDNN for the block, restored after it."""
    m = torch.backends.cuda.matmul
    before = m.allow_tf32
    m.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=False,
                                        allow_tf32=False):
            yield
    finally:
        m.allow_tf32 = before


class _Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, prec):
        r = rounder(prec)
        ra, rb = r(a), r(b)
        ctx.save_for_backward(ra, rb)
        ctx.prec = prec
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = rounder(ctx.prec)(g)
        return rg @ rb.t(), ra.reshape(-1, ra.shape[-1]).t() @ rg.reshape(
            -1, rg.shape[-1]), None


def matmul(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """a (..., K) @ b (K, N) in ``prec``."""
    if prec == "fp32":
        return a @ b
    return _Matmul.apply(a, b, prec)
