"""The host loops of the port's image codecs, native or numpy.

``io/codec.cpp`` holds the PNG row unfilter, the GIF LZW encoder and
decoder, the passes of ``io/resize.py`` and the JPEG decoder of
``io/jpeg.py``. It is built on first use with ``g++`` into
``sin_inn_tpu_torch/build`` (listed in ``.gitignore``) under a name that
carries a hash of the source and the flags, as ``data/native.py`` builds the
batch loader (with ``-ffp-contract=off``, so that no multiply-add is fused
and the float resizes round as OpenCV's do), and is called through ctypes. Where ``g++`` is absent the numpy / Python routes below run instead;
:func:`route_counts` tells which route each call took. A compiler that is
present but fails on the source raises. This is host code, not a kernel.
"""

from __future__ import annotations

import ctypes
import shutil
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from sin_inn_tpu_torch.data import native

SOURCE = Path(__file__).resolve().with_name("codec.cpp")
FLAGS = native.CXX_FLAGS + ("-ffp-contract=off",)
LIBS = ("-lpthread",)

# calls taken by each route since the last reset
_ROUTES = {"native": 0, "numpy": 0}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def route_counts() -> Dict[str, int]:
    return dict(_ROUTES)


def reset_route_counts() -> None:
    for k in _ROUTES:
        _ROUTES[k] = 0


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    cxx = shutil.which("g++")
    if cxx is None:
        return None
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(native.build_library(
            SOURCE, "libsininn_codec", cxx, FLAGS, LIBS)))
        i64 = ctypes.c_int64
        u8p = ctypes.POINTER(ctypes.c_uint8)
        vp = ctypes.c_void_p
        lib.png_unfilter.argtypes = [u8p, i64, i64, i64, u8p]
        lib.png_unfilter.restype = i64
        lib.gif_lzw.argtypes = [u8p, i64, i64, u8p, i64]
        lib.gif_lzw.restype = i64
        for name in ("resize_sep_f32", "resize_sep_f64"):
            getattr(lib, name).argtypes = [vp, i64, i64, i64, vp, i64, i64,
                                           vp, vp, vp, vp, i64, i64]
            getattr(lib, name).restype = None
        lib.resize_sep_u8.argtypes = [vp, i64, i64, i64, vp, i64, i64, vp,
                                      vp, vp, vp, i64, i64, i64]
        lib.resize_sep_u8.restype = None
        lib.gif_unlzw.argtypes = [vp, i64, i64, vp, i64]
        lib.gif_unlzw.restype = i64
        for name in ("resize_lerp_f32", "resize_lerp_f64"):
            getattr(lib, name).argtypes = [vp, i64, i64, i64, vp, i64, i64,
                                           vp, vp, vp, vp, vp, vp]
            getattr(lib, name).restype = None
        lib.jpeg_scan.argtypes = [vp, i64, i64, i64, vp, vp, vp, i64, i64,
                                  i64, i64, i64, i64, i64]
        lib.jpeg_scan.restype = i64
        lib.jpeg_idct.argtypes = [vp, vp, i64, i64, vp]
        lib.jpeg_idct.restype = None
        lib.jpeg_upsample.argtypes = [vp, i64, i64, i64, i64, i64, vp, i64,
                                      i64]
        lib.jpeg_upsample.restype = None
        lib.jpeg_ycc_rgb.argtypes = [vp, vp, vp, i64, vp]
        lib.jpeg_ycc_rgb.restype = None
        for t in ("u8", "f32", "f64"):
            fast = getattr(lib, f"resize_area_fast_{t}")
            fast.argtypes = [vp, i64, i64, i64, vp, i64, i64, i64, i64]
            fast.restype = None
            gen = getattr(lib, f"resize_area_{t}")
            gen.argtypes = [vp, i64, i64, i64, vp, i64, i64, vp, vp, vp, i64,
                            vp, vp, vp, i64]
            gen.restype = None
        _lib = lib
    return _lib


def loaded() -> Optional[ctypes.CDLL]:
    """The native library, built on first use, or None without ``g++``.
    The caller counts the route it takes with :func:`count`."""
    return _load()


def count(route: str) -> None:
    _ROUTES[route] += 1


def ptr(a: np.ndarray) -> int:
    """The address of a C-contiguous array's first element."""
    if not a.flags.c_contiguous:
        raise ValueError("native codec buffers must be C-contiguous")
    return a.ctypes.data


def available() -> bool:
    """Whether the native codec is built (or can be): ``g++`` is found."""
    return _load() is not None


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def unfilter(filtered: np.ndarray, rows: int, stride: int,
             bpp: int) -> np.ndarray:
    """PNG rows ``filtered`` (rows x (1 + stride) uint8: each row its filter
    type, then its bytes) -> (rows, stride) uint8 reconstructed bytes.
    ``bpp`` is the bytes of one complete pixel, at least 1."""
    src = np.ascontiguousarray(filtered, np.uint8).reshape(rows, stride + 1)
    lib = _load()
    if lib is None:
        _ROUTES["numpy"] += 1
        return _unfilter_numpy(src, stride, bpp)
    _ROUTES["native"] += 1
    out = np.empty((rows, stride), np.uint8)
    bad = lib.png_unfilter(_u8p(src), rows, stride, bpp, _u8p(out))
    if bad >= 0:
        raise ValueError(f"PNG row {bad} has filter type {src[bad, 0]}")
    return out


def _unfilter_numpy(src: np.ndarray, stride: int, bpp: int) -> np.ndarray:
    rows = src.shape[0]
    out = np.empty((rows, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(rows):
        ft, s = int(src[y, 0]), src[y, 1:]
        if ft == 0:
            out[y] = s
        elif ft == 1:
            # each byte lane of a pixel is a running sum mod 256
            out[y] = np.cumsum(s.reshape(-1, bpp), axis=0,
                               dtype=np.uint8).reshape(-1)
        elif ft == 2:
            out[y] = s + prev
        elif ft in (3, 4):
            sl, pl = s.tolist(), prev.tolist()
            r = [0] * stride
            for i in range(stride):
                a = r[i - bpp] if i >= bpp else 0
                b = pl[i]
                if ft == 3:
                    r[i] = (sl[i] + ((a + b) >> 1)) & 0xff
                    continue
                c = pl[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                r[i] = (sl[i] + pred) & 0xff
            out[y] = r
        else:
            raise ValueError(f"PNG row {y} has filter type {ft}")
        prev = out[y]
    return out


def lzw(indices: np.ndarray, min_code: int) -> bytes:
    """The GIF LZW code stream of ``indices`` (uint8 palette indices, each
    below ``1 << min_code``), packed least significant bit first, without
    the sub-block framing."""
    if not 2 <= min_code <= 8:
        raise ValueError(f"GIF minimum code size {min_code} is not in 2-8")
    idx = np.ascontiguousarray(indices, np.uint8).reshape(-1)
    if idx.size and int(idx.max()) >= 1 << min_code:
        raise ValueError(f"palette index {int(idx.max())} needs more than "
                         f"{min_code} bits")
    lib = _load()
    if lib is None:
        _ROUTES["numpy"] += 1
        return _lzw_python(idx.tolist(), min_code)
    _ROUTES["native"] += 1
    # at most one 12-bit code a pixel, a clear code every 3,837 codes, the
    # first clear and the end code
    cap = (idx.size + idx.size // 1024 + 8) * 12 // 8
    out = np.empty(cap, np.uint8)
    n = lib.gif_lzw(_u8p(idx), idx.size, min_code, _u8p(out), cap)
    if n < 0:
        raise RuntimeError("GIF LZW output overflowed its buffer")
    return out[:n].tobytes()


def _lzw_python(idx, min_code: int) -> bytes:
    clear = 1 << min_code
    eoi = clear + 1
    out = bytearray()
    acc = bits = 0
    width = min_code + 1

    def put(code, w):
        nonlocal acc, bits
        acc |= code << bits
        bits += w
        while bits >= 8:
            out.append(acc & 0xff)
            acc >>= 8
            bits -= 8

    table = {}
    max_code = eoi
    put(clear, width)
    if idx:
        cur = idx[0]
        for v in idx[1:]:
            nxt = table.get((cur, v))
            if nxt is not None:
                cur = nxt
                continue
            put(cur, width)
            max_code += 1
            table[(cur, v)] = max_code
            if max_code >= 1 << width:
                width += 1
            if max_code == 4095:
                put(clear, width)
                table.clear()
                width = min_code + 1
                max_code = eoi
            cur = v
        put(cur, width)
    put(eoi, width)
    if bits:
        out.append(acc & 0xff)
    return bytes(out)


def unlzw(data: bytes, min_code: int, npix: int) -> np.ndarray:
    """The GIF LZW code stream ``data`` (sub-blocks joined) -> up to
    ``npix`` uint8 palette indices: fewer where the stream ends early."""
    if not 1 <= min_code <= 11:
        raise ValueError(f"GIF minimum code size {min_code} is not in 1-11")
    out = np.zeros(npix, np.uint8)
    lib = _load()
    if lib is None:
        _ROUTES["numpy"] += 1
        got = _unlzw_python(data, min_code, out)
    else:
        _ROUTES["native"] += 1
        src = np.frombuffer(data, np.uint8)
        got = lib.gif_unlzw(src.ctypes.data if src.size else None, src.size,
                            min_code, out.ctypes.data, npix)
    return out[:got]


def _unlzw_python(data: bytes, min_code: int, out: np.ndarray) -> int:
    clear, eoi = 1 << min_code, (1 << min_code) + 1
    table = [bytes([i]) for i in range(clear)] + [b"", b""]
    width, prev = min_code + 1, None
    acc = bits = pos = 0
    res = bytearray()
    npix = len(out)
    while len(res) < npix:
        while bits < width and pos < len(data):
            acc |= data[pos] << bits
            bits += 8
            pos += 1
        if bits < width:
            break
        code = acc & ((1 << width) - 1)
        acc >>= width
        bits -= width
        if code == clear:
            table = table[:eoi + 1]
            width, prev = min_code + 1, None
            continue
        if code == eoi:
            break
        if prev is None:
            if code >= clear:
                break
            res += table[code]
            prev = table[code]
            continue
        if code < len(table):
            cur = table[code]
        elif code == len(table):
            cur = prev + prev[:1]
        else:
            break
        res += cur
        if len(table) < 4096:
            table.append(prev + cur[:1])
            if len(table) == 1 << width and width < 12:
                width += 1
        prev = cur
    n = min(len(res), npix)
    out[:n] = np.frombuffer(bytes(res[:n]), np.uint8)
    return n
