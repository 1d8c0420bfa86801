"""The port's JPEG and GIF readers (``sin_inn_tpu_torch/io/jpeg.py``,
``io/gif.py``) against ``imageio.v2`` on the CPU.

JPEG: files Pillow writes here (libjpeg-turbo) across sampling 4:4:4,
4:2:2 and 4:2:0, 4:4:0 (``tools/make_jpeg_fixtures.py``'s baseline
encoder, as Pillow cannot), progressive, restart intervals, optimised
Huffman tables and greyscale, at qualities 10, 50, 75 and 95 and sizes 1x1,
17x23 and 437x1021, decode equal to ``imageio.v2.imread``; the committed
fixtures under ``tests/goldens/jpeg/`` equal their ``decoded.npz``; the
numpy route equals the C++ one; arithmetic coding, 12-bit samples,
lossless frames, CMYK and a truncated file raise, naming the file, on both
routes; so do crafted malformed headers that Pillow rejects too (Huffman
tables whose codes overflow their lengths or whose DC values pass 15, scans
with no component, five components, a component twice or a table above 3,
and progressive scans against libjpeg's progression rules), and the C++
scan refuses such tables and scan values on its own; a sequential frame's
scan values Ss, Se, Ah and Al are ignored, as imageio ignores them.

GIF: the port's own GIFs, Pillow's (each disposal method, optimised delta
frames, transparency, interlace) and GIFs encoded here block by block
(global and local palettes, interlace, transparency on the first and on
later frames, disposal 0-3, frames smaller than the logical screen, the
background index, indices past a palette's end, a grey-ramp palette) give
``imageio.v2.mimread``'s frames, and ``iter_frames`` ``get_reader``'s; the
numpy LZW route equals the C++ one.
"""

import ctypes
import importlib.util
import io
import itertools
import os
import struct

import numpy as np
import pytest

PIL = pytest.importorskip("PIL")
iio = pytest.importorskip("imageio.v2")

from PIL import Image  # noqa: E402

from sin_inn_tpu_torch.io import codec, gif, jpeg  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "goldens", "jpeg")


def _tool():
    spec = importlib.util.spec_from_file_location(
        "make_jpeg_fixtures", os.path.join(REPO, "tools",
                                           "make_jpeg_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _tool()

# (name, size, Pillow's keyword arguments or "440" for the tool's encoder)
JPEG_CASES = [
    ("444", (17, 23), dict(subsampling=0)),
    ("422", (17, 23), dict(subsampling=1)),
    ("420", (17, 23), dict(subsampling=2)),
    ("440", (17, 23), "440"),
    ("420_1x1", (1, 1), dict(subsampling=2)),
    ("422_1x1", (1, 1), dict(subsampling=1)),
    ("420_3x5", (3, 5), dict(subsampling=2)),
    ("420_large", (437, 1021), dict(subsampling=2)),
    ("444_large_progressive", (437, 1021), dict(subsampling=0,
                                                progressive=True)),
    ("440_odd", (37, 101), "440"),
    ("420_progressive", (17, 23), dict(subsampling=2, progressive=True)),
    ("422_progressive", (61, 83), dict(subsampling=1, progressive=True)),
    ("444_restart", (61, 83), dict(subsampling=0, restart_marker_blocks=1)),
    ("420_restart", (61, 83), dict(subsampling=2, restart_marker_blocks=3)),
    ("420_progressive_restart", (61, 83), dict(subsampling=2,
                                               progressive=True,
                                               restart_marker_blocks=2)),
    ("420_optimized", (61, 83), dict(subsampling=2, optimize=True)),
    ("grey", (17, 23), dict(grey=True)),
    ("grey_progressive_restart", (61, 83), dict(grey=True, progressive=True,
                                                restart_marker_blocks=2)),
]


def _jpeg_bytes(size, kw, quality, seed):
    img = TOOL.test_image(*size, seed)
    if kw == "440":
        return TOOL.encode_baseline(img, (1, 2), quality)
    kw = dict(kw)
    if kw.pop("grey", False):
        img = img[..., 1]
    b = io.BytesIO()
    Image.fromarray(img).save(b, "JPEG", quality=quality, **kw)
    return b.getvalue()


@pytest.mark.parametrize("name,size,kw", JPEG_CASES,
                         ids=[c[0] for c in JPEG_CASES])
def test_jpeg_equals_imageio(name, size, kw, tmp_path):
    for q in (10, 50, 75, 95):
        p = str(tmp_path / f"{name}_{q}.jpg")
        with open(p, "wb") as fh:
            fh.write(_jpeg_bytes(size, kw, q, seed=q))
        want, got = iio.imread(p), jpeg.imread(p)
        assert got.dtype == want.dtype and got.shape == want.shape, q
        np.testing.assert_array_equal(got, want, err_msg=f"quality {q}")


@pytest.mark.parametrize("name,size,kw",
                         [c for c in JPEG_CASES if max(c[1]) < 100],
                         ids=[c[0] for c in JPEG_CASES if max(c[1]) < 100])
def test_jpeg_numpy_route_equals_native(name, size, kw, monkeypatch):
    data = _jpeg_bytes(size, kw, 75, seed=1)
    native = jpeg.decode(data) if codec.available() else None
    monkeypatch.setattr(codec, "_load", lambda: None)
    codec.reset_route_counts()
    got = jpeg.decode(data)
    assert codec.route_counts() == {"native": 0, "numpy": 1}
    np.testing.assert_array_equal(got, np.asarray(Image.open(io.BytesIO(data))))
    if native is not None:
        np.testing.assert_array_equal(got, native)


def test_committed_jpeg_fixtures_decode_to_their_npz():
    want = np.load(os.path.join(FIXTURES, "decoded.npz"))
    names = sorted(want.files)
    assert len(names) >= 20 and sum(n.startswith("scene_") for n in names) == 8
    for n in names:
        p = os.path.join(FIXTURES, f"{n}.jpg")
        got = jpeg.imread(p)
        np.testing.assert_array_equal(got, want[n], err_msg=n)
        np.testing.assert_array_equal(got, iio.imread(p), err_msg=n)
    assert want["scene_00"].shape == (480, 640, 3)


def _patched(data: bytes, marker: int = None, precision: int = None):
    """``data`` with its SOF0 marker code or sample precision replaced."""
    i = data.index(b"\xff\xc0")
    out = bytearray(data)
    if marker is not None:
        out[i + 1] = marker
    if precision is not None:
        out[i + 4] = precision
    return bytes(out)


def _segments(data: bytes):
    """(marker, offset of its length field, body) of each marker segment,
    the entropy-coded data between them skipped."""
    out, pos = [], 2
    while True:
        while data[pos] != 0xFF:
            pos += 1
        while data[pos] == 0xFF:
            pos += 1
        m = data[pos]
        pos += 1
        if m == 0xD9:
            return out
        if m == 0 or 0xD0 <= m <= 0xD7:
            continue
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        out.append((m, pos, data[pos + 2:pos + length]))
        pos += length


def _replaced(data: bytes, seg, body: bytes) -> bytes:
    _, pos, old = seg
    return (data[:pos] + struct.pack(">H", len(body) + 2) + body
            + data[pos + 2 + len(old):])


def _malformed(kind: str) -> bytes:
    """A 4:2:0 file (baseline, or progressive for the progression kinds)
    with one header field broken as ``kind`` says."""
    base = _jpeg_bytes((17, 23), dict(subsampling=2), 75, seed=3)
    prog = _jpeg_bytes((17, 23), dict(subsampling=2, progressive=True), 75,
                       seed=3)
    dht = [g for g in _segments(base) if g[0] == 0xC4]
    sos = [g for g in _segments(base) if g[0] == 0xDA][0]
    b = bytearray(sos[2])
    ns = b[0]
    if kind == "overfull Huffman table":    # every AC code of length 1
        g = [g for g in dht if g[2][0] >> 4 == 1][0]
        n = sum(g[2][1:17])
        assert n > 100
        return _replaced(base, g, g[2][:1] + bytes([n]) + bytes(15)
                         + g[2][17:])
    if kind == "DC value above 15":
        g = [g for g in dht if g[2][0] >> 4 == 0][0]
        body = bytearray(g[2])
        body[17] = 200
        return _replaced(base, g, bytes(body))
    if kind == "5 components":              # the ids repeat
        comps = bytes(b[1:1 + 2 * ns])
        return _replaced(base, sos, bytes([5]) + comps + comps[:4]
                         + bytes(b[1 + 2 * ns:]))
    if kind == "component twice":
        b[3] = b[1]
        return _replaced(base, sos, bytes(b))
    if kind == "no component":
        return _replaced(base, sos, bytes([0]) + bytes(b[-3:]))
    if kind == "Huffman table 5":
        b[2] = 0x50
        return _replaced(base, sos, bytes(b))
    scans = [g for g in _segments(prog) if g[0] == 0xDA]
    dc = [g for g in scans if g[2][-3] == 0][0]
    ac = [g for g in scans if g[2][-3] > 0 and g[2][-1] >> 4 == 0][0]
    b = bytearray(ac[2])
    if kind == "Se past 63":
        b[-2] = 70
    elif kind == "Ss above Se":
        b[-3], b[-2] = b[-2] + 1, b[-2]
    elif kind == "Al not Ah - 1":
        b[-1] = 0x31
    else:
        assert kind == "Al above 13"
        b, ac = bytearray(dc[2]), dc
        b[-1] = 14
    return _replaced(prog, ac, bytes(b))


_MALFORMED = {
    "overfull Huffman table": "codes than fit their lengths",
    "DC value above 15": "DC value above 15",
    "5 components": "scan header \\(5 components",
    "component twice": "component 1 twice",
    "no component": "scan header \\(0 components",
    "Huffman table 5": "Huffman tables 5 / 0",
    "Se past 63": "progression \\(Ss=1, Se=70",
    "Ss above Se": "progression",
    "Al not Ah - 1": "progression .*Ah=3, Al=1",
    "Al above 13": "progression .*Al=14",
}


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("kind", ["arithmetic", "12-bit", "lossless", "CMYK",
                                  "truncated", "not a JPEG"]
                         + list(_MALFORMED))
def test_unsupported_jpeg_raises(kind, route, tmp_path, monkeypatch):
    base = _jpeg_bytes((17, 23), dict(subsampling=2), 75, seed=3)
    if kind == "arithmetic":
        data, match = _patched(base, marker=0xC9), "arithmetic"
    elif kind == "12-bit":
        data, match = _patched(base, precision=12), "12-bit"
    elif kind == "lossless":
        data, match = _patched(base, marker=0xC3), "lossless"
    elif kind == "CMYK":
        b = io.BytesIO()
        Image.new("CMYK", (8, 8), (1, 2, 3, 4)).save(b, "JPEG")
        data, match = b.getvalue(), "CMYK"
    elif kind == "truncated":
        data, match = base[:len(base) * 2 // 3], "truncated"
    elif kind == "not a JPEG":
        data, match = b"\x89PNG" + base[4:], "not a JPEG"
    else:
        data, match = _malformed(kind), _MALFORMED[kind]
        with pytest.raises(OSError):        # Pillow refuses it too
            np.asarray(Image.open(io.BytesIO(data)))
    if route == "numpy":
        monkeypatch.setattr(codec, "_load", lambda: None)
    elif not codec.available():
        pytest.skip("no g++: the C++ route cannot be built")
    p = tmp_path / "bad.jpg"
    p.write_bytes(data)
    with pytest.raises(ValueError, match=match) as e:
        jpeg.imread(str(p))
    assert str(p) in str(e.value)


@pytest.mark.parametrize("case", ["overfull", "DC value", "ns", "Se", "Ah",
                                  "table index"])
def test_jpeg_scan_refuses_bad_tables_and_scan_values(case):
    """codec.cpp's own guard, reached with io/jpeg.py's checks bypassed:
    -2 and nothing decoded, where it once wrote past its tables."""
    lib = codec.loaded()
    if lib is None:
        pytest.skip("no g++: the C++ route cannot be built")
    tables = np.zeros((8, 272), np.uint8)
    tables[:, 0] = 1                        # one code of length 1 each
    ns, ss, se, ah, al = 1, 0, 63, 0, 0
    info = np.array([[0, 1, 1, 1, 1, 1, 1, 0, 0]], np.int32)
    if case == "overfull":
        tables[4, 0] = 200
    elif case == "DC value":
        tables[0, 16] = 16
    elif case == "ns":
        ns = 5
        info = np.repeat(info, 5, 0)
    elif case == "Se":
        ss, se = 1, 70
    elif case == "Ah":
        ah, al = 3, 14
    else:
        info[0, 8] = 9
    coef = np.full((1, 1, 64), 7, np.int16)
    ptrs = (ctypes.c_void_p * len(info))(*[coef.ctypes.data] * len(info))
    data = np.frombuffer(b"\x00" * 64 + b"\xff\xd9", np.uint8)
    end = lib.jpeg_scan(data.ctypes.data, len(data), 0, ns, info.ctypes.data,
                        ptrs, tables.ctypes.data, ss, se, ah, al, 0, 1, 1)
    assert end == -2
    assert (coef == 7).all()


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_sequential_scan_values_are_ignored(route, monkeypatch):
    """libjpeg only warns of a baseline scan's stray Ss, Se, Ah and Al and
    decodes it as sequential; imageio returns that image."""
    base = _jpeg_bytes((17, 23), dict(subsampling=2), 75, seed=3)
    sos = [g for g in _segments(base) if g[0] == 0xDA][0]
    b = bytearray(sos[2])
    b[-3:] = bytes([5, 70, 0xEF])
    data = _replaced(base, sos, bytes(b))
    if route == "numpy":
        monkeypatch.setattr(codec, "_load", lambda: None)
    want = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(jpeg.decode(data), want)
    np.testing.assert_array_equal(want, np.asarray(Image.open(
        io.BytesIO(base))))


# -- GIF ----------------------------------------------------------------------

def _sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\x00"


def _table(pal):
    bits = max(1, (len(pal) - 1).bit_length())
    t = np.zeros((1 << bits, 3), np.uint8)
    t[:len(pal)] = pal
    return bits, t.tobytes()


def encode_gif(sw, sh, frames, global_pal=None, background=0):
    """A GIF89a block by block. ``frames``: dicts of ``idx`` (h, w) uint8,
    ``x0``, ``y0``, ``local`` (n, 3) palette or None, ``trns``, ``disposal``,
    ``interlace``."""
    out = [b"GIF89a"]
    flags, table = 0, b""
    if global_pal is not None:
        bits, table = _table(global_pal)
        flags = 0x80 | (bits - 1)
    out += [struct.pack("<HHBBB", sw, sh, flags, background, 0), table]
    for f in frames:
        trns = f.get("trns")
        gflags = (f.get("disposal", 0) << 2) | (trns is not None)
        out.append(b"\x21\xf9\x04" + bytes([gflags]) + struct.pack("<H", 5)
                   + bytes([trns or 0]) + b"\x00")
        idx = f["idx"]
        h, w = idx.shape
        lflags, ltable = 0, b""
        if f.get("local") is not None:
            bits, ltable = _table(f["local"])
            lflags = 0x80 | (bits - 1)
        if f.get("interlace"):
            lflags |= 0x40
            order = np.concatenate([np.arange(a, h, b) for a, b in
                                    ((0, 8), (4, 8), (2, 4), (1, 2))])
            idx = idx[order]
        out.append(b"\x2c" + struct.pack("<HHHHB", f.get("x0", 0),
                                         f.get("y0", 0), w, h, lflags)
                   + ltable)
        mc = max(2, int(idx.max()).bit_length())
        out.append(bytes([mc]) + _sub_blocks(codec.lzw(idx, mc)))
    out.append(b"\x3b")
    return b"".join(out)


def _same_frames(path):
    want = iio.mimread(path)
    got = gif.mimread(path)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, (i, g.shape,
                                                           w.shape)
        np.testing.assert_array_equal(g, w, err_msg=f"frame {i}")
    reader = iio.get_reader(path)
    for i, (g, w) in enumerate(zip(gif.iter_frames(path), reader)):
        np.testing.assert_array_equal(g, np.asarray(w),
                                      err_msg=f"get_reader frame {i}")
    reader.close()
    return got


def test_gif_reads_the_port_own_gifs(tmp_path):
    rng = np.random.RandomState(0)
    rgb = [rng.randint(0, 256, (21, 30, 3)).astype(np.uint8)
           for _ in range(3)] + [np.full((21, 30, 3), 7, np.uint8)]
    masks = [(rng.rand(21, 30) > 0.5).astype(np.uint8) * 255
             for _ in range(3)]
    for name, frames in (("rgb", rgb), ("masks", masks)):
        p = str(tmp_path / f"{name}.gif")
        gif.mimsave(p, frames, fps=10)
        got = _same_frames(p)
        for g, f in zip(got, frames):      # exact palettes: the frames back
            if len(np.unique(f.reshape(-1, f.shape[-1] if f.ndim == 3
                                       else 1), axis=0)) <= 256:
                want = f if f.ndim == 3 else np.repeat(f[..., None], 3, -1)
                np.testing.assert_array_equal(g, want)


@pytest.mark.parametrize("disposal,optimize,transparency",
                         list(itertools.product([0, 1, 2, 3], [False, True],
                                                [None, 0])))
def test_gif_reads_pillow_gifs(disposal, optimize, transparency, tmp_path):
    y, x = np.mgrid[0:40, 0:50]
    seq = []
    for t in range(5):
        f = np.zeros((40, 50, 3), np.uint8)
        f[..., 0] = (x * 5 + t * 9) % 256
        f[..., 1] = 80
        f[10 + t:20 + t, 5:15] = (255, 255, 0)
        seq.append(Image.fromarray(f).quantize(16))
    kw = dict(save_all=True, append_images=seq[1:], disposal=disposal,
              optimize=optimize, duration=100, loop=0,
              interlace=bool(disposal % 2))
    if transparency is not None:
        kw["transparency"] = transparency
    p = str(tmp_path / "pillow.gif")
    seq[0].save(p, **kw)
    _same_frames(p)


GIF_MATRIX = list(itertools.product([None, 3], [0, 1, 2, 3], [False, True],
                                    [False, True], [None, 1], [0, 2]))


@pytest.mark.parametrize("first_trns,disposal,local,interlace,trns,background",
                         GIF_MATRIX)
def test_gif_reads_encoded_gifs(first_trns, disposal, local, interlace, trns,
                                background, tmp_path):
    rng = np.random.RandomState(GIF_MATRIX.index(
        (first_trns, disposal, local, interlace, trns, background)))
    pal = lambda n: rng.randint(0, 256, (n, 3)).astype(np.uint8)
    frames = [dict(idx=rng.randint(0, 8, (12, 16)).astype(np.uint8), x0=2,
                   y0=1, trns=first_trns, disposal=disposal,
                   interlace=interlace, local=pal(8) if local else None)]
    for k in range(3):
        # local palettes of 4 entries: indices 4-7 lie past their end
        frames.append(dict(
            idx=rng.randint(0, 8, (5 + k, 7)).astype(np.uint8), x0=3 + k,
            y0=2 * k, trns=trns, disposal=(1, 2, 3)[k] if disposal else 0,
            interlace=interlace and k == 1,
            local=pal(4 + 4 * (k % 2)) if local and k != 1 else None))
    p = tmp_path / "encoded.gif"
    p.write_bytes(encode_gif(20, 14, frames, global_pal=pal(8),
                             background=background))
    _same_frames(str(p))


def test_gif_grey_ramp_palette_reads_as_grey(tmp_path):
    ramp = np.repeat(np.arange(4, dtype=np.uint8)[:, None], 3, 1)
    idx = [np.random.RandomState(i).randint(0, 4, (6, 9)).astype(np.uint8)
           for i in range(2)]
    p = tmp_path / "grey.gif"
    p.write_bytes(encode_gif(9, 6, [dict(idx=i) for i in idx],
                             global_pal=ramp))
    got = _same_frames(str(p))
    assert got[0].shape == (6, 9)


def test_gif_numpy_lzw_route_equals_native(tmp_path, monkeypatch):
    rng = np.random.RandomState(4)
    frames = [rng.randint(0, 256, (33, 47, 3)).astype(np.uint8)
              for _ in range(2)]
    p = str(tmp_path / "clip.gif")
    gif.mimsave(p, frames, fps=5)
    native = gif.mimread(p)
    monkeypatch.setattr(codec, "_load", lambda: None)
    codec.reset_route_counts()
    got = gif.mimread(p)
    assert codec.route_counts()["native"] == 0
    for a, b in zip(got, native):
        np.testing.assert_array_equal(a, b)
    for n, mc in ((1, 2), (5000, 4), (70000, 8)):
        idx = rng.randint(0, 1 << mc, n).astype(np.uint8)
        data = codec._lzw_python(idx.tolist(), mc)
        np.testing.assert_array_equal(codec.unlzw(data, mc, n), idx)


def test_gif_raises_on_a_bad_file(tmp_path):
    p = tmp_path / "bad.gif"
    gif.mimsave(str(p), [np.zeros((4, 4, 3), np.uint8)], fps=5)
    data = p.read_bytes()
    p.write_bytes(data[:-1])            # no trailer
    with pytest.raises(ValueError, match="trailer|ends"):
        gif.mimread(str(p))
    p.write_bytes(b"GIF00a" + data[6:])
    with pytest.raises(ValueError, match="not a GIF"):
        gif.mimread(str(p))
