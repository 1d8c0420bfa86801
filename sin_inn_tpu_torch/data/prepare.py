"""Bayer extraction and binning (host-side numpy).

Copies of ``extract_bayer`` and ``binning`` from
``sin_inn_tpu/data/prepare.py``; the rest of the offline preparation comes
with a later slice.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def extract_bayer(frame: np.ndarray, scale: float = 1.0
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """RGB frame -> (RGGB bayer mosaic, resized RGB)."""
    if scale != 1.0:
        import cv2
        frame = cv2.resize(frame, (0, 0), fx=1.0 / scale, fy=1.0 / scale,
                           interpolation=cv2.INTER_LANCZOS4)
    bayer = np.empty(frame.shape[:2], frame.dtype)
    bayer[::2, ::2] = frame[::2, ::2, 0]      # R
    bayer[::2, 1::2] = frame[::2, 1::2, 1]    # G1
    bayer[1::2, ::2] = frame[1::2, ::2, 1]    # G2
    bayer[1::2, 1::2] = frame[1::2, 1::2, 2]  # B
    return bayer, frame


def binning(img: np.ndarray, reduction: str, scale: int) -> np.ndarray:
    """Bayer binning -> 4-channel RGGB LR at HR/(2*scale)."""
    if img.ndim == 2:
        h, w = img.shape
        out = np.empty((h // scale // 2, w // scale // 2, 4), img.dtype)
        out[..., 0] = binning(img[::2, ::2, None], reduction, scale).squeeze(-1)
        out[..., 1] = binning(img[::2, 1::2, None], reduction, scale).squeeze(-1)
        out[..., 2] = binning(img[1::2, ::2, None], reduction, scale).squeeze(-1)
        out[..., 3] = binning(img[1::2, 1::2, None], reduction, scale).squeeze(-1)
        return out
    h, w, c = img.shape
    red = {"mean": np.mean, "sum": np.sum}[reduction]
    blk = img.reshape(h // scale, scale, w // scale, scale, c)
    return red(red(blk, 1), -2)
