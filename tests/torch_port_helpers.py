"""Shared helpers of the tests that hold the PyTorch port against the JAX
package."""

import numpy as np
import torch


def np_params(spec, c=3, seed=11):
    """HWIO params drawn with numpy (torch-default uniform bounds) in the
    JAX package's layout; both packages get the same arrays. The IRN's
    dense blocks get random weights in every conv (conv5 too, which the
    packages' inits zero), so a coupling is not the identity."""
    rng = np.random.RandomState(seed)

    def conv(k, cin, cout):
        bound = 1.0 / np.sqrt(cin * k * k)
        return {"w": rng.uniform(-bound, bound, (k, k, cin, cout))
                .astype(np.float32),
                "b": rng.uniform(-bound, bound, cout).astype(np.float32)}

    def dense(cin, cout, gc):
        convs = {f"conv{i + 1}": conv(3, cin + i * gc, gc) for i in range(4)}
        convs["conv5"] = conv(3, cin + 4 * gc, cout)
        return convs

    params = []
    for layer in spec:
        if layer.kind in ("squeeze", "haar"):
            c *= 4
        if layer.kind == "invblock":
            len1, len2 = layer.split_len1, c - layer.split_len1
            params.append({"F": dense(len2, len1, layer.gc),
                           "G": dense(len1, len2, layer.gc),
                           "H": dense(len1, len2, layer.gc)})
            continue
        if layer.kind != "glow":
            params.append(None)
            continue
        len1, len2, k, h = layer.split_len1, c - layer.split_len1, \
            layer.kernel, layer.hidden
        params.append({
            "s1": {"conv1": conv(k, len1, h), "conv2": conv(k, h, 2 * len2)},
            "s2": {"conv1": conv(k, len2, h), "conv2": conv(k, h, 2 * len1)}})
    return params


# ---- the tensor cores' 3xTF32 arithmetic, modelled in plain PyTorch ----


def tf32_rna(a: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, as ``cvt.rna.tf32.f32``: add half of the dropped 13 bits to the
    magnitude, then clear them."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(a: torch.Tensor):
    hi = tf32_rna(a)
    return hi, tf32_rna(a - hi)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in 3xTF32: lo hi + hi lo + hi hi, in the kernels' order, each
    an fp32 matmul (the mma's truncating accumulation is not modelled)."""
    ah, al = split(a)
    bh, bl = split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One-pass TF32: hi hi alone."""
    return tf32_rna(a) @ tf32_rna(b)
