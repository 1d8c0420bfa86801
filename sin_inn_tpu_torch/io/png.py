"""PNG reader and writer of the port: stdlib ``zlib`` and ``struct``, numpy.

:func:`imread` returns what ``imageio.v2.imread`` (through Pillow) returns
for the same file, in dtype, shape and value:

  * grey (colour type 0): 1 bit -> (H, W) bool; 2 and 4 bits -> (H, W)
    uint8 scaled to 0-255 (x 85, x 17); 8 bits -> uint8; 16 bits -> uint16;
  * RGB (2) -> (H, W, 3) uint8, RGBA (6) -> (H, W, 4) uint8, grey and alpha
    (4) at 8 bits -> (H, W, 2) uint8; at 16 bits these keep each sample's
    high byte, and grey and alpha becomes (H, W, 4) (grey, grey, grey,
    alpha);
  * palette (3, 1-8 bits) -> (H, W, 3) uint8 through the palette, an index
    past its end black; ``tRNS`` is ignored here as there.

All five row filters, Adam7 interlace and split ``IDAT`` chunks are read;
every chunk's CRC is checked. The row unfilter is ``io/codec.py``'s (C++
where ``g++`` is found). :func:`imwrite` writes uint8 (H, W), (H, W, 2),
(H, W, 3), (H, W, 4) and uint16 (H, W), each row under the filter with the
least sum of absolute residues.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np

from sin_inn_tpu_torch.io import codec

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# samples a pixel, and the bit depths allowed, of each colour type
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
          6: (8, 16)}
# Adam7 passes: first row, first column, row step, column step
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
         (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


def _chunks(data: bytes, name: str) -> List[Tuple[bytes, bytes]]:
    if data[:8] != SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    out, pos = [], 8
    while pos < len(data):
        if pos + 12 > len(data):
            raise ValueError(f"{name}: truncated chunk at byte {pos}")
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        end = pos + 12 + length
        if end > len(data):
            raise ValueError(f"{name}: truncated {kind!r} chunk")
        (crc,) = struct.unpack(">I", data[end - 4:end])
        if zlib.crc32(kind + body) & 0xffffffff != crc:
            raise ValueError(f"{name}: CRC mismatch in {kind!r} chunk")
        out.append((kind, body))
        pos = end
        if kind == b"IEND":
            break
    return out


def _samples(rows: np.ndarray, h: int, w: int, c: int,
             depth: int) -> np.ndarray:
    """Reconstructed bytes (h, stride) -> (h, w, c) integer samples."""
    if depth == 8:
        return rows[:, :w * c].reshape(h, w, c)
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, w, c)
    bits = np.unpackbits(rows, axis=1)[:, :w * depth].reshape(h, w, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1, dtype=np.uint8)[..., None]


def _convert(s: np.ndarray, ctype: int, depth: int,
             palette: np.ndarray) -> np.ndarray:
    """Samples -> the array Pillow hands imageio for this colour type."""
    if ctype == 3:
        if palette is None:
            raise ValueError("palette image without a PLTE chunk")
        lut = np.zeros((256, 3), np.uint8)
        lut[:min(len(palette), 256)] = palette[:256]
        return lut[s[..., 0]]
    if depth == 16 and ctype != 0:
        s = (s >> 8).astype(np.uint8)
        if ctype == 4:
            s = s[..., [0, 0, 0, 1]]
        return s
    if ctype == 0:
        g = s[..., 0]
        if depth == 1:
            return g != 0
        if depth in (2, 4):
            return g * np.uint8(255 // ((1 << depth) - 1))
        return g
    return s


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A PNG file's bytes -> the array :func:`imread` returns."""
    header, palette, idat = None, None, []
    for kind, body in _chunks(data, name):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None or not idat:
        raise ValueError(f"{name}: no IHDR or no IDAT chunk")
    w, h, depth, ctype, comp, filt, interlace = header
    if ctype not in CHANNELS or depth not in DEPTHS[ctype] or comp or filt \
            or interlace > 1 or not w or not h:
        raise ValueError(f"{name}: unsupported IHDR {header}")
    c = CHANNELS[ctype]
    bpp = max(1, c * depth // 8)
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{name}: corrupt image data ({e})") from e

    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    s = np.empty((h, w, c), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for y0, x0, dy, dx in passes:
        ph, pw = (h - y0 + dy - 1) // dy, (w - x0 + dx - 1) // dx
        if ph <= 0 or pw <= 0:
            continue
        stride = (pw * c * depth + 7) // 8
        n = ph * (stride + 1)
        if pos + n > len(raw):
            raise ValueError(f"{name}: image data ends early")
        rows = codec.unfilter(np.frombuffer(raw, np.uint8, n, pos), ph,
                              stride, bpp)
        s[y0::dy, x0::dx] = _samples(rows, ph, pw, c, depth)
        pos += n
    return _convert(s, ctype, depth, palette)


def imread(path: str) -> np.ndarray:
    """Read a PNG file as ``imageio.v2.imread`` does (module docstring)."""
    with open(path, "rb") as f:
        return decode(f.read(), str(path))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xffffffff))


_COLOUR_TYPES: Dict[int, int] = {1: 0, 2: 4, 3: 2, 4: 6}


# |residual| of a byte read as signed: the PNG specification's heuristic
_SIGNED_ABS = np.minimum(np.arange(256), 256 - np.arange(256)).astype(np.uint8)


def _filter_rows(x: np.ndarray, bpp: int) -> np.ndarray:
    """(h, stride) bytes -> (h, 1 + stride) rows, each under the filter
    (None, Sub, Up, Average, Paeth) with the least sum of absolute residues
    read as signed bytes."""
    x16 = x.astype(np.int16)
    a = np.zeros_like(x16)
    a[:, bpp:] = x16[:, :-bpp]
    b = np.zeros_like(x16)
    b[1:] = x16[:-1]
    c = np.zeros_like(x16)
    c[1:, bpp:] = x16[:-1, :-bpp]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    cand = np.stack([x, (x16 - a).astype(np.uint8), (x16 - b).astype(np.uint8),
                     (x16 - ((a + b) >> 1)).astype(np.uint8),
                     (x16 - paeth).astype(np.uint8)])
    best = _SIGNED_ABS[cand].sum(-1, dtype=np.int64).argmin(0)
    rows = cand[best, np.arange(x.shape[0])]
    return np.concatenate([best.astype(np.uint8)[:, None], rows], 1)


def encode(array: np.ndarray) -> bytes:
    """uint8 (H, W) / (H, W, 2|3|4) or uint16 (H, W) -> PNG bytes."""
    a = np.asarray(array)
    if a.dtype == np.uint8 and (a.ndim == 2 or (a.ndim == 3
                                                and a.shape[2] in (2, 3, 4))):
        depth = 8
    elif a.dtype == np.uint16 and a.ndim == 2:
        depth = 16
    else:
        raise ValueError(f"cannot write a {a.dtype} {a.shape} array as PNG: "
                         f"want uint8 (H, W) / (H, W, 2|3|4) or uint16 (H, W)")
    h, w = a.shape[:2]
    c = a.shape[2] if a.ndim == 3 else 1
    if not h or not w:
        raise ValueError(f"cannot write an empty {a.shape} image as PNG")
    x = (a.astype(">u2").view(np.uint8) if depth == 16 else a)
    x = np.ascontiguousarray(x).reshape(h, -1)
    raw = _filter_rows(x, c * depth // 8).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, depth, _COLOUR_TYPES[c], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))


def imwrite(path: str, array: np.ndarray) -> None:
    """Write ``array`` as a PNG file that :func:`imread` and imageio read
    back to the same array."""
    data = encode(array)
    with open(path, "wb") as f:
        f.write(data)
