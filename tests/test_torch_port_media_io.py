"""The port's PNG and GIF codecs (``io/png.py``, ``io/gif.py``,
``io/codec.py``) held against imageio (through Pillow) on the CPU.

``imread`` must return what ``imageio.v2.imread`` returns, in dtype, shape
and every value, on every file of a seeded matrix: each bit depth and
colour type Pillow writes, and files this test encodes itself, every
colour type at every bit depth the format allows with each of the five row
filters forced on every row or mixed row by row, Adam7 interlace, split
IDAT chunks and short palettes. ``imwrite``'s files read back to the array
through both readers; the C++ and the numpy unfilter, and the C++ and the
Python LZW, give equal bytes; the GIF reads back through imageio with its
frame count, imageio's frame delay and exact masks, and on flow images its
mean absolute error is at most twice that of imageio's own GIF.
"""

import struct
import warnings
import zlib
from pathlib import Path

import numpy as np
import pytest

from sin_inn_tpu_torch.data import native
from sin_inn_tpu_torch.data.flow_viz import flow_to_image
from sin_inn_tpu_torch.io import codec, gif, png

io = pytest.importorskip("imageio.v2")
Image = pytest.importorskip("PIL.Image")


def _imageio_read(p):
    with warnings.catch_warnings():
        # Pillow warns on palette files with a tRNS chunk; imageio still
        # drops the transparency
        warnings.simplefilter("ignore")
        return io.imread(p)


def _same(got, want, what):
    assert got.dtype == want.dtype and got.shape == want.shape, \
        (what, got.dtype, got.shape, want.dtype, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=what)


# ---------------------------------------------------------------------------
# an independent PNG encoder: the test chooses each row's filter
# ---------------------------------------------------------------------------

def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xffffffff))


def _pack_rows(s, depth):
    """(h, w, c) samples -> each row's bytes."""
    if depth == 16:
        return [r.astype(">u2").tobytes() for r in s]
    if depth == 8:
        return [r.astype(np.uint8).tobytes() for r in s]
    rows = []
    for r in s:
        bits = np.unpackbits(r.reshape(-1).astype(np.uint8)[:, None],
                             axis=1)[:, 8 - depth:]
        rows.append(np.packbits(bits.reshape(-1)).tobytes())
    return rows


def _filter(rows, bpp, kinds):
    """Filter each row with the loop of the PNG specification."""
    out, prev = b"", bytes(len(rows[0]))
    for r, k in zip(rows, kinds):
        f = bytearray(len(r))
        for i in range(len(r)):
            a = r[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            if k == 0:
                pred = 0
            elif k == 1:
                pred = a
            elif k == 2:
                pred = b
            elif k == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            f[i] = (r[i] - pred) & 0xff
        out += bytes([k]) + bytes(f)
        prev = r
    return out


def _encode(s, ctype, depth, filters, interlace=0, plte=None, trns=None,
            idat_parts=1, rng=None):
    """``filters``: a filter type for every row, or None for a random one
    a row."""
    h, w, _ = s.shape
    bpp = max(1, s.shape[2] * depth // 8)
    passes = png.ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = b""
    for y0, x0, dy, dx in passes:
        sub = s[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = _pack_rows(sub, depth)
        kinds = ([filters] * len(rows) if filters is not None
                 else list(rng.randint(0, 5, len(rows))))
        raw += _filter(rows, bpp, kinds)
    z = zlib.compress(raw)
    out = png.SIGNATURE + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if plte is not None:
        out += _chunk(b"PLTE", np.asarray(plte, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    step = len(z) // idat_parts + 1
    for i in range(0, len(z), step):
        out += _chunk(b"IDAT", z[i:i + step])
    return out + _chunk(b"IEND", b"")


_KINDS = [(ct, d) for ct in (0, 2, 3, 4, 6) for d in png.DEPTHS[ct]]


@pytest.mark.parametrize("ctype,depth", _KINDS,
                         ids=[f"type{c}-{d}bit" for c, d in _KINDS])
def test_imread_matches_imageio_on_encoded_files(tmp_path, ctype, depth):
    rng = np.random.RandomState(10 * ctype + depth)
    c = png.CHANNELS[ctype]
    n = 0
    for h, w in ((1, 1), (5, 9), (13, 17)):
        for interlace in (0, 1):
            for filters in (0, 1, 2, 3, 4, None):
                s = rng.randint(0, 1 << depth, (h, w, c))
                plte = trns = None
                if ctype == 3:
                    # a palette shorter than the index range: the indices
                    # past its end read as black
                    plte = rng.randint(0, 256, 3 * rng.randint(
                        1, (1 << depth) + 1))
                    trns = bytes([0, 128]) if rng.rand() < 0.5 else None
                elif rng.rand() < 0.3:
                    trns = bytes(2 * c if ctype in (0, 2) else 0) or None
                p = tmp_path / f"f{n}.png"
                p.write_bytes(_encode(s, ctype, depth, filters, interlace,
                                      plte, trns, rng.randint(1, 4), rng))
                _same(png.imread(str(p)), _imageio_read(str(p)),
                      f"{h}x{w} interlace {interlace} filter {filters}")
                n += 1


def _pil_files(d, rng):
    h, w = 23, 31
    files = {}

    def save(name, img, **kw):
        files[name] = str(d / f"{name}.png")
        img.save(files[name], **kw)

    save("mode1", Image.fromarray(rng.rand(h, w) > 0.5))
    save("L", Image.fromarray(rng.randint(0, 256, (h, w), np.uint8)))
    save("L_trns", Image.fromarray(rng.randint(0, 256, (h, w), np.uint8)),
         transparency=7)
    save("LA", Image.fromarray(rng.randint(0, 256, (h, w, 2), np.uint8),
                               "LA"))
    save("RGB", Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8)))
    save("RGB_trns", Image.fromarray(rng.randint(0, 256, (h, w, 3),
                                                 np.uint8)),
         transparency=(1, 2, 3))
    save("RGBA", Image.fromarray(rng.randint(0, 256, (h, w, 4), np.uint8)))
    save("RGB_optimized", Image.fromarray(
        rng.randint(0, 256, (h, w, 3), np.uint8)), optimize=True)
    for bits in (1, 2, 4, 8):
        p = Image.fromarray(rng.randint(0, 1 << bits, (h, w)).astype(
            np.uint8), "P")
        p.putpalette(list(rng.randint(0, 256, 3 << bits)))
        save(f"P{bits}", p, bits=bits)
        save(f"P{bits}_trns", p, bits=bits,
             transparency=bytes([0, 128] + [255] * ((1 << bits) - 2)))
    files["I16"] = str(d / "I16.png")
    io.imwrite(files["I16"], rng.randint(0, 65536, (h, w)).astype(np.uint16))
    return files


def test_imread_matches_imageio_on_pillow_files(tmp_path):
    files = _pil_files(tmp_path, np.random.RandomState(0))
    for name, p in files.items():
        _same(png.imread(p), _imageio_read(p), name)


@pytest.mark.parametrize("shape,dtype", [
    ((37, 53), np.uint8), ((37, 53, 2), np.uint8), ((37, 53, 3), np.uint8),
    ((37, 53, 4), np.uint8), ((37, 53), np.uint16), ((1, 1, 3), np.uint8)])
def test_imwrite_round_trips_through_imageio_and_imread(tmp_path, shape,
                                                        dtype):
    rng = np.random.RandomState(len(shape))
    # smooth and noisy halves, so rows take different filters
    a = rng.randint(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    a[: shape[0] // 2] = np.sort(a[: shape[0] // 2], axis=1)
    p = str(tmp_path / "w.png")
    png.imwrite(p, a)
    _same(png.imread(p), a, "imread")
    _same(_imageio_read(p), a, "imageio")


def test_imwrite_refuses_what_png_cannot_hold(tmp_path):
    for bad in (np.zeros((4, 4), np.float32), np.zeros((4, 4, 5), np.uint8),
                np.zeros((4, 4, 3), np.uint16), np.zeros((0, 4), np.uint8)):
        with pytest.raises(ValueError):
            png.imwrite(str(tmp_path / "x.png"), bad)


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_native_and_numpy_unfilter_agree(bpp):
    if not codec.available():
        pytest.skip("no g++: only the numpy unfilter is built")
    rng = np.random.RandomState(bpp)
    rows, stride = 37, 12 * bpp
    src = rng.randint(0, 256, (rows, stride + 1)).astype(np.uint8)
    src[:, 0] = rng.randint(0, 5, rows)
    src[:5, 0] = np.arange(5)
    _same(codec.unfilter(src, rows, stride, bpp),
          codec._unfilter_numpy(src, stride, bpp), f"bpp {bpp}")
    src[7, 0] = 5
    for route in (lambda: codec.unfilter(src, rows, stride, bpp),
                  lambda: codec._unfilter_numpy(src, stride, bpp)):
        with pytest.raises(ValueError, match="row 7"):
            route()


def test_native_codec_builds_in_the_ignored_build_dir():
    """The C++ loops' library lands in ``sin_inn_tpu_torch/build/``, which
    ``.gitignore`` lists, under a name keyed by the source's hash."""
    if not codec.available():
        pytest.skip("no g++: the numpy routes run")
    lib = Path(codec._load()._name)
    assert lib.parent == native.BUILD_DIR
    assert lib.name.startswith("libsininn_codec-") and lib.suffix == ".so"
    # keyed by the source and its flags (no fused multiply-add), and
    # nothing of it lands in native/ or beside the source
    assert lib == native.library_path(codec.SOURCE, "libsininn_codec",
                                      codec.FLAGS, codec.LIBS)
    assert "-ffp-contract=off" in codec.FLAGS
    assert not [p for p in native.SOURCE.parent.iterdir()
                if "codec" in p.name]
    assert [p.name for p in codec.SOURCE.parent.iterdir()
            if p.suffix in (".so", ".o", ".tmp")] == []
    ignored = (native.BUILD_DIR.parents[1] / ".gitignore").read_text()
    assert "sin_inn_tpu_torch/build/" in ignored.splitlines()


def test_numpy_unfilter_route_is_counted(monkeypatch):
    """Without g++ the numpy routes run and are counted, and decode the
    same file to the same array."""
    a = np.random.RandomState(2).randint(0, 256, (9, 11, 3)).astype(np.uint8)
    data = png.encode(a)
    monkeypatch.setattr(codec, "_load", lambda: None)
    codec.reset_route_counts()
    _same(png.decode(data), a, "numpy route")
    idx = np.random.RandomState(3).randint(0, 4, 500).astype(np.uint8)
    assert codec.lzw(idx, 2) == codec._lzw_python(idx.tolist(), 2)
    assert codec.route_counts() == {"native": 0, "numpy": 2}


@pytest.mark.parametrize("min_code,n", [(2, 1), (2, 60000), (8, 70000),
                                        (5, 0)])
def test_native_and_python_lzw_agree(min_code, n):
    if not codec.available():
        pytest.skip("no g++: only the Python LZW is built")
    rng = np.random.RandomState(n)
    # runs and noise, past several dictionary resets
    idx = np.repeat(rng.randint(0, 1 << min_code, max(n // 3, 1)),
                    3)[:n].astype(np.uint8)
    idx[::7] = rng.randint(0, 1 << min_code, idx[::7].shape)
    assert codec.lzw(idx, min_code) == codec._lzw_python(idx.tolist(),
                                                         min_code)


def test_corrupt_crc_raises(tmp_path):
    data = bytearray(png.encode(np.zeros((4, 4), np.uint8)))
    data[-20] ^= 0xff                  # a byte of the IDAT chunk's body
    p = tmp_path / "bad.png"
    p.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        png.imread(str(p))
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode(b"GIF89a" + bytes(20))


def _gif_frames(p):
    """(frame count, each frame's duration in ms, trailer, loop)."""
    im = Image.open(p)
    durations = []
    for k in range(im.n_frames):
        im.seek(k)
        durations.append(im.info.get("duration"))
    data = open(p, "rb").read()
    return im.n_frames, durations, data.endswith(b"\x3b"), \
        b"NETSCAPE2.0" in data


@pytest.mark.parametrize("fps", [4, 8, 30])
def test_gif_reads_back_with_imageio_delay_and_exact_masks(tmp_path, fps):
    rng = np.random.RandomState(fps)
    masks = [np.repeat((rng.rand(20, 28, 1) > 0.5).astype(np.uint8) * 255, 3,
                       -1) for _ in range(4)]
    ours, theirs = str(tmp_path / "o.gif"), str(tmp_path / "i.gif")
    gif.mimsave(ours, masks, fps=fps)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # imageio: fps is deprecated
        io.mimsave(theirs, masks, format="GIF", fps=fps)
    back = io.mimread(ours)
    assert len(back) == len(masks)
    for got, want in zip(back, masks):
        np.testing.assert_array_equal(got[..., :3], want)
    n, durations, trailer, loops = _gif_frames(ours)
    assert n == len(masks) and trailer and loops
    assert durations == [gif.frame_delay(fps) * 10] * n
    assert durations == _gif_frames(theirs)[1]
    with open(ours, "rb") as fh:
        data = fh.read()
    assert gif.describe(data) == {"size": (28, 20), "frames": n,
                                  "delays": [gif.frame_delay(fps)] * n,
                                  "loops": True}
    with open(theirs, "rb") as fh:
        assert gif.describe(fh.read())["frames"] == n
    with pytest.raises(ValueError, match="trailer|ends"):
        gif.describe(data[:-1])
    # grey frames and at most 256 colours: exact too
    grey = rng.randint(0, 200, (15, 19)).astype(np.uint8)
    gif.mimsave(ours, [grey], fps=fps)
    np.testing.assert_array_equal(io.mimread(ours)[0][..., 0], grey)


def test_gif_of_flow_images_within_twice_imageio_error(tmp_path):
    """Flow images have thousands of colours: the median-cut palette's mean
    absolute error a channel is at most twice that of imageio's GIF."""
    h, w = 64, 96
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    frames = []
    for k in range(3):
        ang = 0.3 * (k + 1)
        flow = np.stack([np.cos(ang) * (xx - w / 2) - np.sin(ang) * (yy - h / 2),
                         np.sin(ang) * (xx - w / 2) + np.cos(ang) * (yy - h / 2)],
                        -1) / (8.0 + 4 * k)
        frames.append(flow_to_image(flow))
    assert len(np.unique(frames[0].reshape(-1, 3), axis=0)) > 256
    ours, theirs = str(tmp_path / "o.gif"), str(tmp_path / "i.gif")
    gif.mimsave(ours, frames, fps=4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        io.mimsave(theirs, frames, format="GIF", fps=4)
    got, ref = io.mimread(ours), io.mimread(theirs)
    assert len(got) == len(ref) == len(frames)
    err = lambda back: np.mean([np.abs(b[..., :3].astype(np.float64) - f)
                                .mean((0, 1)) for b, f in zip(back, frames)],
                               0)
    e_ours, e_ref = err(got), err(ref)
    print(f"GIF mean absolute error a channel: port {e_ours}, "
          f"imageio {e_ref}")
    assert np.all(e_ours <= 2 * e_ref), (e_ours, e_ref)
