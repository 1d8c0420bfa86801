"""Writes the JPEG fixtures of ``tests/goldens/jpeg/`` and the arrays
``imageio.v2.imread`` decodes them to (``decoded.npz``, one array a file).

The cases span what ``sin_inn_tpu_torch/io/jpeg.py`` decodes: baseline
JPEG at sampling 4:4:4, 4:2:2 and 4:2:0 (Pillow), 4:4:0 (written by the
small baseline encoder below, as Pillow cannot), progressive, restart
intervals, optimised Huffman tables, greyscale, EXIF (orientation 6) and
ICC markers, odd sizes; and the 8 frames of a 480 x 640 scene (4:2:0,
quality 90) that ``chip_smoke.py`` reads as a COLMAP scene's images. The
machine with the card has neither Pillow nor imageio: there the smoke holds
the port's decoder to ``decoded.npz``.

Run from the repository root on a machine with Pillow and imageio:

    python3 tools/make_jpeg_fixtures.py [--out tests/goldens/jpeg]
"""

from __future__ import annotations

import argparse
import io
import os
import struct
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE_FRAMES, SCENE_H, SCENE_W = 8, 480, 640


def test_image(h: int, w: int, seed: int) -> np.ndarray:
    """Smooth gradients, an edge and noise: every coefficient band busy."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    base = np.stack([128 + 100 * np.sin(x / 9 + y / 17),
                     128 + 90 * np.cos(y / 7 - x / 23),
                     (x * 3 + y * 2) % 256], -1)
    base[(x > w / 2) & (y < h / 3)] = (240, 30, 60)
    return np.clip(base + rng.randint(-20, 21, (h, w, 3)), 0, 255
                   ).astype(np.uint8)


def scene_frames() -> np.ndarray:
    """Flat 32 x 32 cells under a shading that drifts frame to frame: the
    decoded arrays compress well enough to be committed."""
    y, x = np.mgrid[0:SCENE_H, 0:SCENE_W].astype(np.float64)
    out = []
    for i in range(SCENE_FRAMES):
        cells = np.random.RandomState(i).randint(
            0, 256, (SCENE_H // 32, SCENE_W // 32, 3))
        a = np.kron(cells, np.ones((32, 32, 1)))
        out.append(a + 20 * np.sin((x + 7 * i) / 40)[..., None])
    return np.clip(np.stack(out), 0, 255).astype(np.uint8)


# -- a minimal baseline encoder, for the sampling Pillow does not write --------

_QL = np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
                14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
                18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113,
                92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112,
                100, 103, 99]).reshape(8, 8)
_QC = np.full((8, 8), 99)
_QC[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99],
               [47, 66, 99, 99]]
_ZZ = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
       40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50,
       43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46,
       53, 60, 61, 54, 47, 55, 62, 63]


def _quant(base: np.ndarray, quality: int) -> np.ndarray:
    s = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * s + 50) // 100, 1, 255).astype(np.int64)


def _category(v: int) -> int:
    return int(abs(v)).bit_length()


def encode_baseline(rgb: np.ndarray, sampling, quality: int = 75) -> bytes:
    """Baseline JFIF of uint8 (H, W, 3) with the luma's (h, v) sampling
    ``sampling`` and 1 x 1 chroma; each table's codes all of one length."""
    h, w, _ = rgb.shape
    hs, vs = sampling
    f = rgb.astype(np.float64)
    ycc = np.stack([0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2],
                    -0.168736 * f[..., 0] - 0.331264 * f[..., 1]
                    + 0.5 * f[..., 2] + 128,
                    0.5 * f[..., 0] - 0.418688 * f[..., 1]
                    - 0.081312 * f[..., 2] + 128], -1)
    mh, mw = 8 * vs, 8 * hs
    ph, pw = -(-h // mh) * mh, -(-w // mw) * mw
    ycc = np.pad(ycc, ((0, ph - h), (0, pw - w), (0, 0)), mode="edge")
    planes = [ycc[..., 0]]
    for c in (1, 2):
        planes.append(ycc[..., c].reshape(ph // vs, vs, pw // hs, hs)
                      .mean((1, 3)))
    k = np.arange(8)
    dct = np.sqrt(2 / 8) * np.cos((2 * k[None] + 1) * k[:, None] * np.pi / 16)
    dct[0] /= np.sqrt(2)
    qs = [_quant(_QL, quality), _quant(_QC, quality)]
    blocks = []
    for ci, p in enumerate(planes):
        bh, bw = p.shape[0] // 8, p.shape[1] // 8
        b = (p - 128).reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        c = dct @ b @ dct.T
        blocks.append(np.rint(c / qs[min(ci, 1)]).astype(np.int64))
    # MCU order: the luma's hs x vs blocks, then one Cb and one Cr block
    units = []
    for my in range(ph // mh):
        for mx in range(pw // mw):
            for v in range(vs):
                for u in range(hs):
                    units.append((0, blocks[0][my * vs + v, mx * hs + u]))
            units += [(1, blocks[1][my, mx]), (2, blocks[2][my, mx])]
    # symbols: per component class (0 luma, 1 chroma), DC then AC
    syms = []
    pred = [0, 0, 0]
    for ci, blk in units:
        z = blk.reshape(-1)[_ZZ]
        diff = int(z[0]) - pred[ci]
        pred[ci] = int(z[0])
        t = min(ci, 1)
        syms.append((t, 0, _category(diff), diff))
        run = 0
        last = max([i for i in range(1, 64) if z[i]] or [0])
        for i in range(1, last + 1):
            if z[i] == 0:
                run += 1
                continue
            while run > 15:
                syms.append((t, 1, 0xF0, None))
                run -= 16
            syms.append((t, 1, (run << 4) | _category(z[i]), int(z[i])))
            run = 0
        if last < 63:
            syms.append((t, 1, 0x00, None))
    tables = {}
    for key in ((0, 0), (0, 1), (1, 0), (1, 1)):
        used = sorted({s for t, a, s, _ in syms if (t, a) == key})
        length = max(1, len(used).bit_length())   # never the all-ones code
        tables[key] = (length, {s: i for i, s in enumerate(used)})
    bits = []
    for t, a, s, v in syms:
        length, codes = tables[(t, a)]
        bits.append((codes[s], length))
        cat = s & 15
        if cat:
            bits.append((v if v >= 0 else v + (1 << cat) - 1, cat))
    acc, n, out = 0, 0, bytearray()
    for val, ln in bits:
        acc = (acc << ln) | val
        n += ln
        while n >= 8:
            byte = (acc >> (n - 8)) & 0xFF
            out += b"\xff\x00" if byte == 0xFF else bytes([byte])
            n -= 8
    if n:
        byte = ((acc << (8 - n)) | ((1 << (8 - n)) - 1)) & 0xFF
        out += b"\xff\x00" if byte == 0xFF else bytes([byte])

    def seg(marker, body):
        return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body

    parts = [b"\xff\xd8", seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01"
                                     b"\x00\x00")]
    for i, q in enumerate(qs):
        parts.append(seg(0xDB, bytes([i]) + bytes(q.reshape(-1)[_ZZ]
                                                  .astype(np.uint8))))
    parts.append(seg(0xC0, struct.pack(">BHHB", 8, h, w, 3)
                     + bytes([1, (hs << 4) | vs, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for (t, a), (length, codes) in tables.items():
        counts = [0] * 16
        counts[length - 1] = len(codes)
        parts.append(seg(0xC4, bytes([(a << 4) | t]) + bytes(counts)
                         + bytes(sorted(codes))))
    parts.append(seg(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])))
    parts += [bytes(out), b"\xff\xd9"]
    return b"".join(parts)


def exif_orientation6() -> bytes:
    """A little-endian TIFF header with one IFD entry: Orientation = 6."""
    return (b"Exif\x00\x00II*\x00\x08\x00\x00\x00\x01\x00"
            + struct.pack("<HHIHH", 0x0112, 3, 1, 6, 0) + b"\x00\x00\x00\x00")


def cases():
    """{name: JPEG bytes} of the matrix."""
    from PIL import Image

    def pil(a, **kw):
        b = io.BytesIO()
        Image.fromarray(a).save(b, "JPEG", **kw)
        return b.getvalue()

    img = test_image(61, 83, 0)
    exif = Image.Exif()
    exif[0x0131] = "make_jpeg_fixtures"
    out = {
        "q75_444": pil(img, quality=75, subsampling=0),
        "q50_422": pil(img, quality=50, subsampling=1),
        "q95_420": pil(img, quality=95, subsampling=2),
        "q75_440": encode_baseline(img, (1, 2), 75),
        "q10_420_progressive": pil(img, quality=10, subsampling=2,
                                   progressive=True),
        "q95_444_progressive": pil(img, quality=95, subsampling=0,
                                   progressive=True),
        "q75_422_restart": pil(img, quality=75, subsampling=1,
                               restart_marker_blocks=3),
        "q75_420_progressive_restart": pil(img, quality=75, subsampling=2,
                                           progressive=True,
                                           restart_marker_blocks=2),
        "q75_420_optimized": pil(img, quality=75, optimize=True),
        "q90_grey": pil(img[..., 1], quality=90),
        "q75_grey_progressive": pil(img[..., 0], quality=75,
                                    progressive=True),
        "q75_exif_icc": pil(img, quality=75, exif=exif.tobytes(),
                            icc_profile=bytes(range(256)) * 2),
        "q90_1x1": pil(img[:1, :1], quality=90),
        "q90_17x23_420": pil(test_image(17, 23, 1), quality=90),
    }
    # the orientation-6 file: EXIF written by hand, as an APP1 after SOI
    plain = out["q75_444"]
    app1 = exif_orientation6()
    out["q75_exif_orientation6"] = (plain[:2] + b"\xff\xe1"
                                    + struct.pack(">H", len(app1) + 2) + app1
                                    + plain[2:])
    for i, f in enumerate(scene_frames()):
        out[f"scene_{i:02d}"] = pil(f, quality=90, subsampling=2)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "tests", "goldens",
                                                  "jpeg"))
    a = ap.parse_args(argv)
    import imageio.v2 as iio

    os.makedirs(a.out, exist_ok=True)
    arrays = {}
    total = 0
    for name, data in cases().items():
        p = os.path.join(a.out, f"{name}.jpg")
        with open(p, "wb") as fh:
            fh.write(data)
        arrays[name] = iio.imread(p)
        total += len(data)
    np.savez_compressed(os.path.join(a.out, "decoded.npz"), **arrays)
    total += os.path.getsize(os.path.join(a.out, "decoded.npz"))
    print(f"wrote {len(arrays)} JPEGs and decoded.npz to {a.out}: "
          f"{total} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
