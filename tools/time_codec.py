#!/usr/bin/env python3
"""Time the port's PNG and GIF codecs on the host, beside imageio's.

    python3 tools/time_codec.py [--reps 20]

Frames of ``moving_texture_video`` at 436x1024 (Sintel) and 352x640 (the
SRF flagship's HR): the median ms of ``io/png.py`` ``imread`` on a file
Pillow wrote (through imageio, where it is installed) and on one the port
wrote, of ``imwrite``, and of ``io/gif.py``'s encoding a frame; imageio's
read and write beside them where it is installed. Prints one JSON line.
Host work only: nothing runs on a card.
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
from sin_inn_tpu_torch.io import codec, gif, png  # noqa: E402


def median_ms(fn, reps: int) -> float:
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(ts)


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
            if iio is not None:
                theirs = os.path.join(d, f"pillow_{h}.png")
                iio.imwrite(theirs, frame)
                row["imread_pillow_file"] = median_ms(
                    lambda: png.imread(theirs), args.reps)
                row["imageio_imread"] = median_ms(lambda: iio.imread(theirs),
                                                  args.reps)
                row["imageio_imwrite"] = median_ms(
                    lambda: iio.imwrite(theirs, frame), args.reps)
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")   # imageio: fps
                    row["imageio_gif_frame"] = median_ms(
                        lambda: iio.mimsave(os.path.join(d, "x.gif"),
                                            [frame], format="GIF", fps=30),
                        args.reps)
            out[f"{h}x{w}"] = {k: round(v, 3) for k, v in row.items()}
    out["routes"] = codec.route_counts()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
