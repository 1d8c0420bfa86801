"""Shared helpers of the tests that hold the PyTorch port against the JAX
package."""

import math

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


def tf32_rz(a: torch.Tensor) -> torch.Tensor:
    """fp32 -> its top 19 bits (sign, exponent, 10 mantissa bits): the TF32
    value toward zero, as K7 forward splits its operands."""
    return (a.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split_rz(a: torch.Tensor):
    hi = tf32_rz(a)
    return hi, tf32_rz(a - hi)


def mm3_rz(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in 3xTF32 with the split toward zero (``split_rz``), lo hi +
    hi lo + hi hi in the kernel's order, each an fp32 matmul."""
    ah, al = split_rz(a)
    bh, bl = split_rz(b)
    return (al @ bh + ah @ bl) + ah @ bh


# ---- K5's fixed-point sums, modelled in plain PyTorch ----


def splat_fixed_point(values: torch.Tensor, flow: torch.Tensor, keep,
                      span: int, order=None) -> torch.Tensor:
    """K5's arithmetic (``csrc/splat_region.cu``): the taps, window rule and
    fp32 contributions of ``ops/splat.py`` ``splat_scatter``, each finite
    contribution rounded (half to even) to an integer at the scale 2^q_c and
    summed in int64, q_c = 62 - e with span max|v_c| < 2^e (``span``: SH x
    SW, the most sources one output pixel sums), clamped to [-126, 126];
    then sum 2^-q_c through float64, rounded once to fp32. A non-finite
    contribution makes its pixel NaN (a NaN, or both infinities) or the
    infinity. The same bits as the kernel, whatever the order: ``order``,
    a permutation of the n h w source pixels, adds their contributions in
    that order."""
    from sin_inn_tpu_torch.ops.splat import _hat

    n, h, w, c = values.shape
    v = values.float()
    biggest = torch.where(torch.isfinite(v), v.abs(),
                          torch.zeros_like(v)).amax(dim=(0, 1, 2))
    qs = []
    for m in biggest.tolist():
        q = 0 if m == 0.0 else 62 - math.frexp(span * m)[1]
        qs.append(min(max(q, -126), 126))
    scale = torch.tensor([2.0 ** q for q in qs], dtype=torch.float32)
    ys = torch.arange(h, dtype=torch.float32)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32)[None, None, :]

    def taps(t, size):
        t0 = torch.floor(t)
        out = []
        for tap in (t0, t0 + 1.0):
            ok = (tap >= 0) & (tap <= size - 1)
            out.append((torch.where(ok, _hat(t - tap), 0.0),
                        torch.where(ok, tap, 0.0).long()))
        return out

    rows = taps(ys + flow[..., 1], h)
    cols = taps(xs + flow[..., 0], w)
    base = torch.arange(n)[:, None, None] * (h * w)
    acc = torch.zeros((n * h * w, c), dtype=torch.int64)
    kinds = {k: torch.zeros((n * h * w, c), dtype=torch.int64)
             for k in ("pos", "neg", "nan")}
    for wy, ri in rows:
        vy = v * wy[..., None]
        for wx, ki in cols:
            wx = torch.where(keep(ri, ki), wx, 0.0)
            t = (vy * wx[..., None]).reshape(-1, c)
            idx = (base + ri * w + ki).reshape(-1)
            if order is not None:
                t, idx = t[order], idx[order]
            fin = torch.isfinite(t)
            fixed = torch.round(torch.where(fin, t, 0.0) * scale)
            acc.index_add_(0, idx, fixed.to(torch.int64))
            kinds["pos"].index_add_(0, idx, (t == math.inf).long())
            kinds["neg"].index_add_(0, idx, (t == -math.inf).long())
            kinds["nan"].index_add_(0, idx, torch.isnan(t).long())
    inv = torch.tensor([2.0 ** -q for q in qs], dtype=torch.float64)
    out = (acc.double() * inv).float()
    pos, neg = kinds["pos"] > 0, kinds["neg"] > 0
    out = torch.where(pos, math.inf, out)
    out = torch.where(neg, -math.inf, out)
    out = torch.where((kinds["nan"] > 0) | (pos & neg), math.nan, out)
    return out.reshape(n, h, w, c)


def k5_model(values, flow, max_dy: int, max_dx: int,
             order=None) -> torch.Tensor:
    """K5 (the static windows) as ``splat_fixed_point`` computes it."""
    from sin_inn_tpu_torch.ops.cuda.splat import _in_window, window_shape

    _, h, w, _ = values.shape
    sh, sw = window_shape(max_dy, max_dx)
    ys = torch.arange(h)[None, :, None]
    xs = torch.arange(w)[None, None, :]
    return splat_fixed_point(values, flow, lambda r, k: (
        _in_window(ys, r, max_dy, sh) & _in_window(xs, k, max_dx, sw)),
        sh * sw, order)


def k5_local_model(values, flow, off_out, loc_dy: int, loc_dx: int,
                   order=None) -> torch.Tensor:
    """K5 local as ``splat_fixed_point`` computes it: each tap pair kept by
    the window of the tile holding it, shifted by -off_out of that tile."""
    from sin_inn_tpu_torch.ops.cuda.splat import _B, _in_window, window_shape

    n, h, w, _ = values.shape
    sh, sw = window_shape(loc_dy, loc_dx)
    ys = torch.arange(h)[None, :, None]
    xs = torch.arange(w)[None, None, :]
    nidx = torch.arange(n)[:, None, None]
    shift = (-off_out).long()

    def keep(r, k):
        o = shift[nidx, r // _B, k // _B]
        return (_in_window(ys, r, loc_dy, sh, o[..., 1])
                & _in_window(xs, k, loc_dx, sw, o[..., 0]))

    return splat_fixed_point(values, flow, keep, sh * sw, order)
