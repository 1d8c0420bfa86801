"""The port's resize (``sin_inn_tpu_torch/io/resize.py``) against
``cv2.resize`` on the CPU.

A seeded matrix of calls for each mode (``nearest``, ``linear``, ``cubic``,
``area``, ``lanczos4``) and dtype (uint8, float32, float64): 1, 2 and 3
channels, shrinking and enlarging, whole and general ratios, ``dsize`` and
``fx`` / ``fy``, strided views and sides of 1-3 pixels.

  * The port follows OpenCV's own route (``cv2.ipp.setUseIPP(False)``)
    except for float ``linear`` at a whole shrinking ratio (not 2
    channels), where it computes as cv2's IPP route does. Against that
    route every call is equal, on both of the port's routes (C++, numpy).
  * Against cv2 as the JAX package calls it (IPP on), every uint8 call but
    ``cubic`` and every float call of ``nearest``, ``area``, ``lanczos4``
    and float64 ``cubic`` is equal. Where IPP computes with its own
    arithmetic and the port with OpenCV's (uint8 ``cubic`` on sources of at
    least 4 x 4; float32 ``linear`` and ``cubic``, float64 ``linear`` at
    other ratios) the test asserts the bound measured on this matrix: uint8
    at most 1 apart on at most ``U8_CUBIC_SHARE`` of the elements; floats
    within ``FLOAT_ULPS`` units in the last place of the source's largest
    magnitude.
  * The port's ``_resize_frames`` / ``load_images(dir, size)`` and
    ``cv_resize`` / ``extract_bayer`` give the JAX package's arrays (cv2
    with IPP, as it runs) on frames, GT flows and float64 bayer planes.
"""

import itertools

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from sin_inn_tpu.data import flow_media as JM  # noqa: E402
from sin_inn_tpu.data import prepare as JP  # noqa: E402
from sin_inn_tpu_torch.data import flow_media as TM  # noqa: E402
from sin_inn_tpu_torch.data import prepare as TP  # noqa: E402
from sin_inn_tpu_torch.data.synthetic import write_flow_scene  # noqa: E402
from sin_inn_tpu_torch.io import codec  # noqa: E402
from sin_inn_tpu_torch.io import resize as R  # noqa: E402

FLAGS = {"nearest": cv2.INTER_NEAREST, "linear": cv2.INTER_LINEAR,
         "cubic": cv2.INTER_CUBIC, "area": cv2.INTER_AREA,
         "lanczos4": cv2.INTER_LANCZOS4}
DTYPES = ("uint8", "float32", "float64")
FACTORS = (0.5, 1 / 3, 0.25, 0.7, 1.3, 2.0, 3.0, 0.45)
# measured on this matrix against cv2 with IPP (module docstring): float32
# 16.75 ulps; float64 7.43e9 ulps (1.6e-6 of the largest magnitude: IPP's
# float64 linear at a general ratio maps coordinates with less precision);
# uint8 cubic 1.79% of the elements
FLOAT_ULPS = {"float32": 17, "float64": 7.5e9}
U8_CUBIC_SHARE = 0.018


def _matrix(mode, dtype, n=36):
    """[(src, kwargs)] of the module docstring's matrix, seeded by the
    mode and dtype."""
    rng = np.random.RandomState(sorted(FLAGS).index(mode) * 7
                                + DTYPES.index(dtype))
    out = []
    for t in range(n):
        cn = (1, 2, 3)[t % 3]
        h, w = (rng.randint(1, 4, 2) if t % 9 == 4
                else rng.randint(1, 33, 2))
        shape = (h, w) if cn == 1 else (h, w, cn)
        if dtype == "uint8":
            src = rng.randint(0, 256, shape).astype(np.uint8)
        else:
            src = (rng.rand(*shape) * 2 - 0.5).astype(dtype)
        if t % 6 == 5:      # a strided view, as cv_resize's bayer planes
            src = np.repeat(np.repeat(src, 2, 0), 2, 1)[::2, ::2]
        if t % 2:
            fx, fy = (float(rng.choice(FACTORS)) for _ in range(2))
            if round(w * fx) < 1 or round(h * fy) < 1:
                continue
            out.append((src, dict(fx=fx, fy=fy)))
        else:
            if t % 4 == 0:  # a whole shrinking ratio
                dw, dh = max(1, w // 2), max(1, h // 3)
                src = src[:dh * 3, :dw * 2] if h >= 3 and w >= 2 else src
                dw, dh = max(1, src.shape[1] // 2), max(1, src.shape[0] // 3)
            else:
                dw, dh = (int(v) for v in rng.randint(1, 41, 2))
            out.append((src, dict(dsize=(dw, dh))))
    return out


def _cv2(src, kw, mode, ipp):
    before = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(ipp)
    try:
        return cv2.resize(src, kw.get("dsize", (0, 0)), fx=kw.get("fx", 0),
                          fy=kw.get("fy", 0), interpolation=FLAGS[mode])
    finally:
        cv2.ipp.setUseIPP(before)


def _port_route(src, kw, mode) -> str:
    """"ipp" where the port computes as cv2's IPP route: float ``linear``
    (not 2 channels) at a whole ratio that divides the size."""
    h, w = src.shape[:2]
    cn = 1 if src.ndim == 2 else src.shape[2]
    dw, dh, isx, isy = R.output_size(src.shape, kw.get("dsize"),
                                     kw.get("fx"), kw.get("fy"))
    ix, iy = round(1 / isx), round(1 / isy)
    whole = abs(1 / isx - ix) < 2.3e-16 and abs(1 / isy - iy) < 2.3e-16
    if (mode == "linear" and src.dtype != np.uint8 and cn != 2 and whole
            and w == dw * ix and h == dh * iy and (dw, dh) != (w, h)):
        return "ipp"
    return "opencv"


def _ipp_differs(src, kw, mode) -> bool:
    """Where cv2's IPP route computes with arithmetic the port does not
    copy (measured; module docstring)."""
    h, w = src.shape[:2]
    cn = 1 if src.ndim == 2 else src.shape[2]
    if src.dtype == np.uint8:
        return mode == "cubic"
    if cn == 2:
        return False
    return (mode == "linear" and _port_route(src, kw, mode) == "opencv") or (
        mode == "cubic" and src.dtype == np.float32)


@pytest.mark.parametrize("mode,dtype", itertools.product(FLAGS, DTYPES))
def test_resize_equals_opencv_route(mode, dtype, monkeypatch):
    """Every call equals cv2 on the route the port follows, on both of the
    port's routes, which agree array for array."""
    calls = _matrix(mode, dtype)
    native = []
    for src, kw in calls:
        ipp = _port_route(src, kw, mode) == "ipp"
        want = _cv2(src, kw, mode, ipp=ipp)
        got = R.resize(src, mode=mode, **kw)
        native.append(got)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=f"{src.shape} {kw}")
    monkeypatch.setattr(codec, "_load", lambda: None)
    codec.reset_route_counts()
    for (src, kw), got in zip(calls, native):
        np.testing.assert_array_equal(R.resize(src, mode=mode, **kw), got,
                                      err_msg=f"numpy route {src.shape} {kw}")
    routes = codec.route_counts()
    assert routes["native"] == 0 and routes["numpy"] > 0


@pytest.mark.parametrize("mode,dtype", itertools.product(FLAGS, DTYPES))
def test_resize_against_cv2_as_called(mode, dtype):
    """cv2 with IPP, as the JAX package runs it: equal, or within the
    measured bound where IPP's arithmetic is its own."""
    differing = 0
    total = 0
    for src, kw in _matrix(mode, dtype):
        want = _cv2(src, kw, mode, ipp=True)
        got = R.resize(src, mode=mode, **kw)
        assert got.dtype == want.dtype and got.shape == want.shape
        if not _ipp_differs(src, kw, mode):
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{src.shape} {kw}")
            continue
        if dtype == "uint8":
            assert np.abs(got.astype(int) - want).max() <= 1, (src.shape, kw)
            differing += int((got != want).sum())
            total += got.size
        else:
            ulp = np.spacing(np.abs(src).max().astype(dtype))
            err = np.abs(got.astype(np.float64) - want) / ulp
            assert err.max() <= FLOAT_ULPS[dtype], (src.shape, kw, err.max())
    if total:
        assert differing <= U8_CUBIC_SHARE * total, (differing, total)


def test_resize_rejects_bad_calls():
    a = np.zeros((4, 5), np.uint8)
    for kw in (dict(mode="bicubic", fx=2), dict()):
        with pytest.raises(ValueError):
            R.resize(a, **kw)
    with pytest.raises(ValueError):
        R.resize(a.astype(np.int16), fx=2)
    with pytest.raises(ValueError):
        R.resize(a, dsize=(0, 3))
    assert R.resize(a, dsize=(5, 4)) is not a   # a copy at the same size


def test_resize_frames_and_load_images_match_jax(tmp_path):
    """``_resize_frames`` on uint8 frames (area to shrink at a general and a
    2x ratio, linear to enlarge) and float32 GT flows, and ``load_images``
    of a Sintel-layout scene at three sizes, against the JAX package."""
    rng = np.random.RandomState(0)
    frames = rng.randint(0, 256, (3, 24, 40, 3)).astype(np.uint8)
    flows = (rng.randn(2, 24, 40, 2) * 3).astype(np.float32)
    for size in (12, 10, 17, 36):
        for a in (frames, flows):
            got, want = TM._resize_frames(a, size), JM._resize_frames(a, size)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want, err_msg=f"size {size}")
    scene = write_flow_scene(str(tmp_path / "sintel"), "alley_1",
                             frames.astype(np.float32) / 255, flows)
    for size in (24, 10, 30):
        got, want = TM.load_images(scene, size=size), JM.load_images(
            scene, size=size)
        np.testing.assert_array_equal(got.video, want.video)
        np.testing.assert_array_equal(got.flow, want.flow)


@pytest.mark.parametrize("operator", ["linear", "cubic", "lanczos4",
                                      "nearest", "area"])
def test_cv_resize_and_extract_bayer_match_jax(operator):
    """``cv_resize`` on strided float64 bayer planes at scales 2-4 and
    ``extract_bayer``'s Lanczos downsampling, against the JAX package."""
    rng = np.random.RandomState(1)
    flag = getattr(cv2, f"INTER_{operator.upper()}")
    for scale in (2, 3, 4):
        bayer = rng.randint(0, 256, (24 * scale, 12 * scale)) / 255.0
        np.testing.assert_array_equal(TP.cv_resize(bayer, operator, scale),
                                      JP.cv_resize(bayer, flag, scale),
                                      err_msg=f"scale {scale}")
    frame = rng.randint(0, 256, (36, 52, 3)) / 255.0
    for d in (2.0, 3.0):
        for a, b in zip(TP.extract_bayer(frame, d), JP.extract_bayer(frame, d)):
            np.testing.assert_array_equal(a, b, err_msg=f"downsampling {d}")
