"""Middlebury .flo optical-flow file IO (numpy).

A copy of ``sin_inn_tpu/data/flo.py``: little-endian, magic tag 202021.25,
(H, W, 2) float32 with interleaved u/v bands.
"""

from __future__ import annotations

import numpy as np

TAG = np.float32(202021.25)


def read_flo(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or magic[0] != TAG:
            raise ValueError(f"invalid .flo magic in {path}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


def write_flo(path: str, flow: np.ndarray):
    flow = np.asarray(flow)
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f"flow must be (H, W, 2), got {flow.shape}")
    h, w, _ = flow.shape
    with open(path, "wb") as f:
        np.asarray([TAG], np.float32).tofile(f)
        np.asarray(w, np.int32).tofile(f)
        np.asarray(h, np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)
