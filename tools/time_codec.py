#!/usr/bin/env python3
"""Time the port's image codecs and resize on the host, beside imageio's
and cv2's.

    python3 tools/time_codec.py [--reps 20]

Frames of ``moving_texture_video`` at 436x1024 (Sintel) and 352x640 (the
SRF flagship's HR): the median ms of ``io/png.py`` ``imread`` on a file
Pillow wrote (through imageio, where it is installed) and on one the port
wrote, of ``imwrite``, and of ``io/gif.py``'s encoding and decoding a
frame; imageio's read and write beside them where it is installed. Then
``io/jpeg.py`` ``imread`` of a 480x640 JPEG (quality 90, 4:2:0, written by
Pillow) beside ``imageio.v2.imread``, and ``io/resize.py`` beside
``cv2.resize`` (its default threads and IPP) on the calls of the port's
paths: ``area`` of a 436x1024x3 uint8 frame to 218x512 and to 200x470,
``linear`` to 512x1202, ``lanczos4`` of a 1080x1920x3 float64 frame at
0.5. Prints one JSON line. Host work only: nothing runs on a card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
import warnings

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from sin_inn_tpu_torch.data.synthetic import moving_texture_video  # noqa: E402
from sin_inn_tpu_torch.io import codec, gif, jpeg, png  # noqa: E402
from sin_inn_tpu_torch.io.resize import resize  # noqa: E402


def median_ms(fn, reps: int) -> float:
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(ts)


def _time_jpeg(d: str, iio, reps: int) -> dict:
    """The port's JPEG read of a 480x640 frame, imageio's beside it; the
    file is Pillow's where Pillow is installed, else a committed fixture."""
    try:
        from PIL import Image
    except ImportError:
        Image = None
    if Image is not None:
        frame = (moving_texture_video(2, 480, 640)[0] * 255).astype(np.uint8)
        p = os.path.join(d, "frame.jpg")
        Image.fromarray(frame).save(p, "JPEG", quality=90)
    else:
        p = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
            __file__))), "tests", "goldens", "jpeg", "scene_00.jpg")
    row = {"bytes": os.path.getsize(p),
           "imread": median_ms(lambda: jpeg.imread(p), reps)}
    if iio is not None:
        row["imageio_imread"] = median_ms(lambda: iio.imread(p), reps)
    return {k: round(v, 3) for k, v in row.items()}


def _time_resize(reps: int) -> dict:
    """The port's resize of each call beside cv2.resize (where cv2 is
    installed), ms."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    rng = np.random.RandomState(0)
    u8 = (moving_texture_video(2, 436, 1024)[0] * 255).astype(np.uint8)
    f64 = rng.rand(1080, 1920, 3)
    calls = {"area 436x1024x3 uint8 -> 218x512": (u8, (512, 218), "area"),
             "area 436x1024x3 uint8 -> 200x470": (u8, (470, 200), "area"),
             "linear 436x1024x3 uint8 -> 512x1202": (u8, (1202, 512),
                                                     "linear"),
             "lanczos4 1080x1920x3 float64 x0.5": (f64, None, "lanczos4")}
    out = {}
    for name, (src, dsize, mode) in calls.items():
        kw = dict(dsize=dsize) if dsize else dict(fx=0.5, fy=0.5)
        row = {"port": median_ms(lambda: resize(src, mode=mode, **kw), reps)}
        if cv2 is not None:
            flag = getattr(cv2, f"INTER_{mode.upper()}")
            row["cv2"] = median_ms(lambda: cv2.resize(
                src, dsize or (0, 0), fx=kw.get("fx", 0), fy=kw.get("fy", 0),
                interpolation=flag), reps)
            row["ratio"] = row["port"] / row["cv2"]
        out[name] = {k: round(v, 3) for k, v in row.items()}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    try:
        import imageio.v2 as iio
    except ImportError:
        iio = None
    out = {"native_codec": codec.available(), "imageio": iio is not None}
    with tempfile.TemporaryDirectory() as d:
        for h, w in ((436, 1024), (352, 640)):
            frame = (moving_texture_video(2, h, w)[0] * 255).astype(np.uint8)
            ours = os.path.join(d, f"port_{h}.png")
            png.imwrite(ours, frame)
            row = {"imread_port_file": median_ms(lambda: png.imread(ours),
                                                 args.reps),
                   "imwrite": median_ms(lambda: png.imwrite(ours, frame),
                                        args.reps),
                   "gif_frame": median_ms(lambda: gif.encode([frame], 30),
                                          args.reps)}
            gp = os.path.join(d, f"port_{h}.gif")
            gif.mimsave(gp, [frame], fps=30)
            row["gif_read_frame"] = median_ms(lambda: gif.mimread(gp),
                                              args.reps)
            if iio is not None:
                theirs = os.path.join(d, f"pillow_{h}.png")
                iio.imwrite(theirs, frame)
                row["imread_pillow_file"] = median_ms(
                    lambda: png.imread(theirs), args.reps)
                row["imageio_imread"] = median_ms(lambda: iio.imread(theirs),
                                                  args.reps)
                row["imageio_gif_read_frame"] = median_ms(
                    lambda: iio.mimread(gp), args.reps)
                row["imageio_imwrite"] = median_ms(
                    lambda: iio.imwrite(theirs, frame), args.reps)
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")   # imageio: fps
                    row["imageio_gif_frame"] = median_ms(
                        lambda: iio.mimsave(os.path.join(d, "x.gif"),
                                            [frame], format="GIF", fps=30),
                        args.reps)
            out[f"{h}x{w}"] = {k: round(v, 3) for k, v in row.items()}
        out["jpeg_480x640"] = _time_jpeg(d, iio, args.reps)
    out["resize"] = _time_resize(args.reps)
    out["routes"] = codec.route_counts()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
