"""Image resize of the port, in place of ``cv2.resize``.

:func:`resize` returns what ``cv2.resize`` (OpenCV 5.0 as its wheel ships
it) returns for the same call, in shape, dtype and value, for the modes
``nearest``, ``linear``, ``cubic``, ``area`` and ``lanczos4`` on uint8,
float32 and float64 images of 1-4 channels, (H, W) or (H, W, C), strided
views included. What it copies of OpenCV, each point read off the wheel:

  * the size: ``dsize`` as given, else ``round(w * fx)`` (ties to even); the
    scale that maps coordinates is ``1 / fx`` when ``fx`` is given, else
    ``w / dsize``; an unchanged size is a copy;
  * ``nearest``: source pixel ``min(floor(x / fx), w - 1)``;
  * ``linear``, ``cubic`` and ``lanczos4``: the half-pixel centre
    ``(x + 0.5) * scale - 0.5`` rounded to float32, the taps clamped at the
    borders (replicate); ``linear`` also pins the weight to the edge pixel
    along x, not along y; cubic's A is -0.75; Lanczos' eight taps are
    normalised to sum to 1 in float32 (at a whole-pixel position the centre
    tap takes 1e30 before that, so the others keep weights near 1e-30);
  * ``area`` when shrinking: at a whole ratio the mean of each block (a
    block the edge cuts over the pixels it holds); else OpenCV's table of
    fractional cell weights along x and y. When enlarging, ``area`` is the
    linear route with the cell-edge fraction; ``linear`` at exactly 2x
    shrinking is ``area``;
  * uint8 in fixed point: 11-bit coefficients, int32 horizontal sums, and
    the vertical rounding each route of the wheel takes (``linear``'s
    16-bit products, ``cubic``'s float sum on whole groups of eight, the
    exact integer form elsewhere); 2x2 blocks round up at 1, 3 and 4
    channels;
  * float32 sums in float32, float64 sums in float64 with float32
    coefficients.

cv2 hands some calls to Intel's IPP where the wheel has it: uint8 ``cubic``
on sources of at least 4 x 4, float32 ``linear`` / ``cubic`` and float64
``linear``. Those results are IPP's own arithmetic; this module gives
OpenCV's (``cv2.ipp.setUseIPP(False)``), which differs from IPP's in the
last bits of floats and, for uint8 ``cubic``, by 1 where the exact value is
within about 1e-4 of a half (measured in ``tests/test_torch_port_resize.py``).

The passes are ``io/codec.cpp``'s (C++ built with ``g++`` on first use);
where ``g++`` is absent a numpy route gives the same arrays, and
``codec.route_counts()`` tells which ran.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np

from sin_inn_tpu_torch.io import codec

MODES = ("nearest", "linear", "cubic", "area", "lanczos4")
COEF_BITS = 11
_COEF_SCALE = np.float32(1 << COEF_BITS)
_KSIZE = {"nearest": 1, "linear": 2, "area": 2, "cubic": 4, "lanczos4": 8}
_DBL_EPS = np.finfo(np.float64).eps
_F32 = np.float32
_S45 = 0.70710678118654752440084436210485
_LANCZOS_CS = ((1, 0), (-_S45, -_S45), (0, 1), (_S45, -_S45), (-1, 0),
               (_S45, _S45), (0, -1), (-_S45, _S45))


def _cubic(x: np.ndarray) -> np.ndarray:
    """OpenCV's cubic weights (A = -0.75) of the float32 fractions ``x``."""
    a, one = _F32(-0.75), _F32(1)
    x1, y = x + one, one - x
    c0 = ((a * x1 - _F32(5) * a) * x1 + _F32(8) * a) * x1 - _F32(4) * a
    c1 = ((a + _F32(2)) * x - (a + _F32(3))) * x * x + one
    c2 = ((a + _F32(2)) * y - (a + _F32(3))) * y * y + one
    return np.stack([c0, c1, c2, one - c0 - c1 - c2], -1)


def _lanczos4_one(x: np.float32):
    # OpenCV adds the tap offsets to the float32 x before going to double
    x3 = _F32(x + _F32(3))
    y0 = -float(x3) * math.pi * 0.25
    s0, c0 = math.sin(y0), math.cos(y0)
    co, total = [], _F32(0)
    for i, (cs, cc) in enumerate(_LANCZOS_CS):
        d = float(_F32(x3 - _F32(i)))
        if abs(d) >= 1e-6:
            y = -d * math.pi * 0.25
            v = _F32((cs * s0 + cc * c0) / (y * y))
        else:
            v = _F32(1e30)
        co.append(v)
        total = _F32(total + v)
    inv = _F32(_F32(1) / total)
    return [_F32(v * inv) for v in co]


def _lanczos4(x: np.ndarray) -> np.ndarray:
    """OpenCV's Lanczos weights of the float32 fractions ``x`` (each
    distinct fraction once: a whole ratio has a handful)."""
    uniq, inv = np.unique(x, return_inverse=True)
    table = np.array([_lanczos4_one(u) for u in uniq], np.float32)
    return table[inv.reshape(-1)]


@functools.lru_cache(maxsize=64)
def _taps(ssize: int, dsize: int, scale: float, inv_scale: float,
          mode: str, pin_edges: bool) -> Tuple[np.ndarray, np.ndarray]:
    """(first source tap of each output index, unclamped; (dsize, ksize)
    float32 coefficients) along one axis. Cached: a video's frames share
    them."""
    ks = _KSIZE[mode]
    d = np.arange(dsize, dtype=np.float64)
    if mode == "nearest":
        ofs = np.minimum(np.floor(d * scale), ssize - 1).astype(np.int32)
        return ofs, np.ones((dsize, 1), np.float32)
    if mode == "area":
        s = np.floor(d * scale)
        f = ((d + 1) - (s + 1) * inv_scale).astype(np.float32)
        f = np.where(f <= 0, _F32(0), f - np.floor(f)).astype(np.float32)
    else:
        f = ((d + 0.5) * scale - 0.5).astype(np.float32)
        s = np.floor(f)
        f = (f - s).astype(np.float32)
    s = s.astype(np.int64)
    if pin_edges and mode in ("linear", "area"):
        lo, hi = s < 0, s >= ssize - 1
        f = np.where(lo | hi, _F32(0), f).astype(np.float32)
        s = np.where(lo, 0, np.where(hi, ssize - 1, s))
    if mode == "cubic":
        coef = _cubic(f)
    elif mode == "lanczos4":
        coef = _lanczos4(f)
    else:
        coef = np.stack([_F32(1) - f, f], -1)
    ofs = (s - ks // 2 + 1).astype(np.int32)
    coef = coef.astype(np.float32)
    for a in (ofs, coef):
        a.setflags(write=False)
    return ofs, coef


def _fixed(coef: np.ndarray) -> np.ndarray:
    return np.rint(coef * _COEF_SCALE).astype(np.int16)


@functools.lru_cache(maxsize=64)
def _area_table(ssize: int, dsize: int, scale: float):
    """OpenCV's fractional cell weights: (dst, src, weight) rows."""
    di, si, wt = [], [], []
    for d in range(dsize):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, ssize - f1)
        s1, s2 = math.ceil(f1), math.floor(f2)
        s2 = min(s2, ssize - 1)
        s1 = min(s1, s2)
        if s1 - f1 > 1e-3:
            di.append(d), si.append(s1 - 1), wt.append((s1 - f1) / cell)
        for s in range(s1, s2):
            di.append(d), si.append(s), wt.append(1.0 / cell)
        if f2 - s2 > 1e-3:
            di.append(d), si.append(s2)
            wt.append(min(min(f2 - s2, 1.0), cell) / cell)
    out = (np.array(di, np.int32), np.array(si, np.int32),
           np.array(wt, np.float64).astype(np.float32))
    for a in out:
        a.setflags(write=False)
    return out


def output_size(shape: Sequence[int], dsize=None, fx=None,
                fy=None) -> Tuple[int, int, float, float]:
    """(width, height, inverse x scale, inverse y scale) as cv2 sizes a
    call: ``dsize`` (width, height) wins; else ``round(w * fx)``."""
    h, w = int(shape[0]), int(shape[1])
    if dsize is not None and tuple(dsize) != (0, 0):
        dw, dh = int(dsize[0]), int(dsize[1])
        return dw, dh, dw / w, dh / h
    if fx is None:
        raise ValueError("resize needs dsize or fx")
    fy = fx if fy is None else fy
    if fx <= 0 or fy <= 0:
        raise ValueError(f"resize factors must be positive, got {fx}, {fy}")
    return int(round(w * fx)), int(round(h * fy)), float(fx), float(fy)


def resize(src: np.ndarray, dsize: Optional[Sequence[int]] = None,
           fx: Optional[float] = None, fy: Optional[float] = None,
           mode: str = "linear") -> np.ndarray:
    """``cv2.resize(src, dsize, fx=fx, fy=fy, interpolation=INTER_<MODE>)``
    (module docstring). ``dsize`` is (width, height); without it ``fx`` and
    ``fy`` (default ``fx``) scale the size."""
    if mode not in MODES:
        raise ValueError(f"resize mode {mode!r} is not one of {MODES}")
    a = np.asarray(src)
    if a.dtype not in (np.uint8, np.float32, np.float64) or a.ndim not in (
            2, 3) or (a.ndim == 3 and not 1 <= a.shape[2] <= 4):
        raise ValueError(f"resize takes uint8, float32 or float64 (H, W) or "
                         f"(H, W, 1-4), got {a.dtype} {a.shape}")
    h, w = a.shape[:2]
    if h < 1 or w < 1:
        raise ValueError(f"resize of an empty image {a.shape}")
    dw, dh, isx, isy = output_size(a.shape, dsize, fx, fy)
    if dw < 1 or dh < 1:
        raise ValueError(f"resize of {a.shape} to {dw} x {dh}")
    cn = 1 if a.ndim == 2 else a.shape[2]
    out_shape = (dh, dw) if a.ndim == 2 else (dh, dw, cn)
    if (dw, dh) == (w, h):
        return a.copy()
    img = np.ascontiguousarray(a).reshape(h, w, cn)
    sx, sy = 1.0 / isx, 1.0 / isy
    if mode == "nearest":
        return _separable(img, dw, dh, mode, sx, sy, isx, isy).reshape(
            out_shape)
    ix, iy = int(round(sx)), int(round(sy))
    whole = abs(sx - ix) < _DBL_EPS and abs(sy - iy) < _DBL_EPS
    if (mode == "linear" and img.dtype != np.uint8 and cn != 2 and whole
            and w == dw * ix and h == dh * iy):
        # a whole shrinking ratio: cv2's IPP route, every fraction 0 or 1/2
        return _lerp(img, dw, dh).reshape(out_shape)
    if mode == "linear" and whole and ix == 2 and iy == 2:
        mode = "area"
    if mode == "area" and sx >= 1 and sy >= 1:
        if whole:
            out = _area_fast(img, dw, dh, ix, iy)
        else:
            out = _area_general(img, dw, dh, sx, sy)
        return out.reshape(out_shape)
    return _separable(img, dw, dh, mode, sx, sy, isx, isy).reshape(out_shape)


def _u8_vertical(mode: str, width: int) -> Tuple[int, int]:
    """(vmode, vend) of ``codec.cpp`` ``resize_sep_u8`` for a uint8 route."""
    if mode in ("linear", "area"):
        return 1, width
    if mode == "cubic":
        return 2, width // 8 * 8
    return 0, 0


def _separable(img, dw, dh, mode, sx, sy, isx, isy) -> np.ndarray:
    h, w, cn = img.shape
    xofs, xc = _taps(w, dw, sx, isx, mode, pin_edges=True)
    yofs, yc = _taps(h, dh, sy, isy, mode, pin_edges=False)
    ks = _KSIZE[mode]
    out = np.empty((dh, dw, cn), img.dtype)
    lib = codec.loaded()
    if img.dtype == np.uint8:
        xa, ya = _fixed(xc), _fixed(yc)
        vmode, vend = _u8_vertical(mode, dw * cn)
        if lib is None:
            return _separable_u8_numpy(img, out, xofs, xa, yofs, ya, vmode,
                                       vend)
        codec.count("native")
        lib.resize_sep_u8(codec.ptr(img), h, w, cn, codec.ptr(out), dh, dw,
                          codec.ptr(xofs), codec.ptr(xa), codec.ptr(yofs),
                          codec.ptr(ya), ks, vmode, vend)
        return out
    # cv2's float32 cubic and Lanczos sum four lanes from the last tap
    vend = (dw * cn // 4 * 4 if img.dtype == np.float32 and ks >= 4 else 0)
    if lib is None:
        return _separable_float_numpy(img, out, xofs, xc, yofs, yc, vend)
    codec.count("native")
    fn = lib.resize_sep_f32 if img.dtype == np.float32 else lib.resize_sep_f64
    fn(codec.ptr(img), h, w, cn, codec.ptr(out), dh, dw, codec.ptr(xofs),
       codec.ptr(xc), codec.ptr(yofs), codec.ptr(yc), ks, vend)
    return out


@functools.lru_cache(maxsize=64)
def _lerp_axis(ssize: int, dsize: int, dtype: str):
    """IPP's linear neighbours and fractions along one axis: the centre
    ``(d + 0.5) * ssize / dsize - 0.5`` in float64, the fraction in the
    image's type."""
    x = (np.arange(dsize, dtype=np.float64) + 0.5) * (ssize / dsize) - 0.5
    i = np.floor(x)
    f = (x - i).astype(dtype)
    i = i.astype(np.int64)
    out = (np.clip(i, 0, ssize - 1).astype(np.int32),
           np.clip(i + 1, 0, ssize - 1).astype(np.int32), f)
    for a in out:
        a.setflags(write=False)
    return out


def _lerp(img: np.ndarray, dw: int, dh: int) -> np.ndarray:
    h, w, cn = img.shape
    x0, x1, fx = _lerp_axis(w, dw, img.dtype.str)
    y0, y1, fy = _lerp_axis(h, dh, img.dtype.str)
    out = np.empty((dh, dw, cn), img.dtype)
    lib = codec.loaded()
    if lib is None:
        codec.count("numpy")
        a, b = img[:, x0], img[:, x1]
        hs = a + fx[None, :, None] * (b - a)
        a, b = hs[y0], hs[y1]
        out[:] = a + fy[:, None, None] * (b - a)
        return out
    codec.count("native")
    fn = lib.resize_lerp_f32 if img.dtype == np.float32 else lib.resize_lerp_f64
    fn(codec.ptr(img), h, w, cn, codec.ptr(out), dh, dw, codec.ptr(x0),
       codec.ptr(x1), codec.ptr(fx), codec.ptr(y0), codec.ptr(y1),
       codec.ptr(fy))
    return out


def _tap_index(ofs: np.ndarray, ks: int, n: int) -> np.ndarray:
    return np.clip(ofs.astype(np.int64)[:, None] + np.arange(ks), 0, n - 1)


def _separable_u8_numpy(img, out, xofs, xa, yofs, ya, vmode, vend):
    codec.count("numpy")
    h, w, cn = img.shape
    dh, dw = out.shape[:2]
    ks = xa.shape[1]
    xi, yi = _tap_index(xofs, ks, w), _tap_index(yofs, ks, h)
    s = img.astype(np.int64)
    hs = sum(s[:, xi[:, k]] * xa[None, :, k, None].astype(np.int64)
             for k in range(ks)).reshape(h, dw * cn)
    rows = [hs[yi[:, k]] for k in range(ks)]          # each (dh, dw * cn)
    b = ya.astype(np.int64)
    exact = np.clip((sum(rows[k] * b[:, k, None] for k in range(ks))
                     + (1 << 21)) >> 22, 0, 255)
    res = exact
    if vmode == 1:
        t = np.zeros_like(rows[0])
        for k in range(ks):
            t = np.clip(t + ((np.clip(rows[k] >> 4, -32768, 32767)
                              * b[:, k, None]) >> 16), -32768, 32767)
        res = np.clip(np.clip(t + 2, -32768, 32767) >> 2, 0, 255)
    elif vmode == 2:
        bf = ya.astype(np.float32) * _F32(1.0 / (1 << 22))
        t = rows[ks - 1].astype(np.float32) * bf[:, ks - 1, None]
        for k in range(ks - 2, -1, -1):
            t = rows[k].astype(np.float32) * bf[:, k, None] + t
        fl = np.clip(np.clip(np.rint(t).astype(np.int64), -32768, 32767),
                     0, 255)
        res = exact.copy()
        res[:, :vend] = fl[:, :vend]
    out[:] = res.astype(np.uint8).reshape(out.shape)
    return out


def _separable_float_numpy(img, out, xofs, xc, yofs, yc, vend):
    codec.count("numpy")
    h, w, cn = img.shape
    dh, dw = out.shape[:2]
    t = img.dtype.type
    ks = xc.shape[1]
    xi, yi = _tap_index(xofs, ks, w), _tap_index(yofs, ks, h)
    xa, ya = xc.astype(t), yc.astype(t)
    hs = img[:, xi[:, 0]] * xa[None, :, 0, None]
    for k in range(1, ks):
        hs = hs + img[:, xi[:, k]] * xa[None, :, k, None]
    hs = hs.reshape(h, dw * cn)
    acc = hs[yi[:, 0]] * ya[:, 0, None]
    for k in range(1, ks):
        acc = acc + hs[yi[:, k]] * ya[:, k, None]
    if vend:
        back = hs[yi[:, ks - 1], :vend] * ya[:, ks - 1, None]
        for k in range(ks - 2, -1, -1):
            back = hs[yi[:, k], :vend] * ya[:, k, None] + back
        acc[:, :vend] = back
    out[:] = acc.reshape(out.shape)
    return out


def _area_fast(img, dw, dh, sx, sy) -> np.ndarray:
    h, w, cn = img.shape
    out = np.empty((dh, dw, cn), img.dtype)
    fn = {np.dtype(np.uint8): "resize_area_fast_u8",
          np.dtype(np.float32): "resize_area_fast_f32",
          np.dtype(np.float64): "resize_area_fast_f64"}[img.dtype]
    lib = codec.loaded()
    if lib is None:
        return _area_fast_numpy(img, out, sx, sy)
    codec.count("native")
    getattr(lib, fn)(codec.ptr(img), h, w, cn, codec.ptr(out), dh, dw, sx,
                     sy)
    return out


def _round_u8(v: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)


def _area_fast_numpy(img, out, sx, sy):
    codec.count("numpy")
    h, w, cn = img.shape
    dh, dw = out.shape[:2]
    u8 = img.dtype == np.uint8
    fh, fw = min(h // sy, dh), min(w // sx, dw)
    # full blocks: taps in row-major order, added in groups of four
    blk = img[:fh * sy, :fw * sx].reshape(fh, sy, fw, sx, cn)
    taps = [blk[:, k // sx, :, k % sx] for k in range(sx * sy)]
    if u8:
        taps = [t.astype(np.int64) for t in taps]
    if u8 and sx == sy == 2 and cn in (1, 3, 4):
        full = ((taps[0] + taps[1] + taps[2] + taps[3] + 2) >> 2
                ).astype(np.uint8)
    else:
        acc = np.zeros_like(taps[0])
        k = 0
        while k <= len(taps) - 4:
            acc = acc + (((taps[k] + taps[k + 1]) + taps[k + 2])
                         + taps[k + 3])
            k += 4
        for t in taps[k:]:
            acc = acc + t
        scale = _F32(1.0 / (sx * sy))
        if u8:
            full = _round_u8(acc.astype(np.float32) * scale)
        else:
            full = acc * scale
            if img.dtype == np.float32 and sx == sy == 2 and cn in (1, 4):
                # the wheel's four-lane route adds each row's pair first
                pair = (((taps[0] + taps[1]) + (taps[2] + taps[3]))
                        * _F32(0.25))
                flat, pflat = full.reshape(fh, -1), pair.reshape(fh, -1)
                n4 = (fw * cn) // 4 * 4
                flat[:, :n4] = pflat[:, :n4]
    out[:fh, :fw] = full
    # blocks the edge cuts: the mean over the pixels they hold, in float
    for dy in range(dh):
        for dx in range(dw):
            if dy < fh and dx < fw:
                continue
            cell = img[dy * sy:dy * sy + sy, dx * sx:dx * sx + sx]
            cnt = cell.shape[0] * cell.shape[1]
            acc = np.zeros(cn, np.int64 if u8 else img.dtype)
            for r in cell:
                for px in r:
                    acc = acc + px
            v = acc.astype(np.float32) / _F32(cnt)
            out[dy, dx] = _round_u8(v) if u8 else v
    return out


def _area_general(img, dw, dh, sx, sy) -> np.ndarray:
    h, w, cn = img.shape
    xdi, xsi, xa = _area_table(w, dw, sx)
    ydi, ysi, ya = _area_table(h, dh, sy)
    out = np.empty((dh, dw, cn), img.dtype)
    lib = codec.loaded()
    if lib is None:
        return _area_general_numpy(img, out, xdi, xsi, xa, ydi, ysi, ya)
    codec.count("native")
    fn = {np.dtype(np.uint8): lib.resize_area_u8,
          np.dtype(np.float32): lib.resize_area_f32,
          np.dtype(np.float64): lib.resize_area_f64}[img.dtype]
    fn(codec.ptr(img), h, w, cn, codec.ptr(out), dh, dw, codec.ptr(xdi),
       codec.ptr(xsi), codec.ptr(xa), len(xdi), codec.ptr(ydi),
       codec.ptr(ysi), codec.ptr(ya), len(ydi))
    return out


def _area_general_numpy(img, out, xdi, xsi, xa, ydi, ysi, ya):
    codec.count("numpy")
    dh, dw, cn = out.shape
    wt = np.float64 if img.dtype == np.float64 else np.float32
    # the j-th table entry of every output column, j = 0, 1, ...: each
    # column's sum runs in table order, as the C++ loop's
    start = np.searchsorted(xdi, np.arange(dw))
    pos = np.arange(len(xdi)) - start[xdi]
    groups = [np.flatnonzero(pos == j) for j in range(int(pos.max()) + 1)]
    sums = np.zeros((dh, dw, cn), wt)
    for j in range(len(ydi)):
        s = img[ysi[j]].astype(wt)
        buf = np.zeros((dw, cn), wt)
        for g in groups:
            buf[xdi[g]] = buf[xdi[g]] + s[xsi[g]] * xa[g, None].astype(wt)
        d = ydi[j]
        sums[d] = sums[d] + wt(ya[j]) * buf
    out[:] = _round_u8(sums) if img.dtype == np.uint8 else sums
    return out
