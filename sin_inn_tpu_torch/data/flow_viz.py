"""Optical-flow visualization: Middlebury color wheel (numpy).

A copy of ``sin_inn_tpu/data/flow_viz.py``. Input flow is (H, W, 2) in
pixels (dx, dy); output is (H, W, 3) uint8.
"""

from __future__ import annotations

import numpy as np

_RY, _YG, _GC, _CB, _BM, _MR = 15, 6, 4, 11, 13, 6
_NCOLS = _RY + _YG + _GC + _CB + _BM + _MR


def _make_color_wheel() -> np.ndarray:
    wheel = np.zeros((_NCOLS, 3))
    col = 0
    wheel[:_RY, 0] = 255
    wheel[:_RY, 1] = np.floor(255 * np.arange(_RY) / _RY)
    col += _RY
    wheel[col:col + _YG, 0] = 255 - np.floor(255 * np.arange(_YG) / _YG)
    wheel[col:col + _YG, 1] = 255
    col += _YG
    wheel[col:col + _GC, 1] = 255
    wheel[col:col + _GC, 2] = np.floor(255 * np.arange(_GC) / _GC)
    col += _GC
    wheel[col:col + _CB, 1] = 255 - np.floor(255 * np.arange(_CB) / _CB)
    wheel[col:col + _CB, 2] = 255
    col += _CB
    wheel[col:col + _BM, 2] = 255
    wheel[col:col + _BM, 0] = np.floor(255 * np.arange(_BM) / _BM)
    col += _BM
    wheel[col:col + _MR, 2] = 255 - np.floor(255 * np.arange(_MR) / _MR)
    wheel[col:col + _MR, 0] = 255
    return wheel


_WHEEL = _make_color_wheel()


def flow_to_image(flow: np.ndarray, clip: float = None) -> np.ndarray:
    """Middlebury color coding of a flow field."""
    u = np.array(flow[..., 0], dtype=np.float64)
    v = np.array(flow[..., 1], dtype=np.float64)
    nan = ~(np.isfinite(u) & np.isfinite(v))
    u[nan] = 0.0
    v[nan] = 0.0
    if clip is not None:
        u = np.clip(u, -clip, clip)
        v = np.clip(v, -clip, clip)

    rad = np.sqrt(u ** 2 + v ** 2)
    maxrad = max(rad.max(), 1e-9)
    u = u / maxrad
    v = v / maxrad
    rad = np.sqrt(u ** 2 + v ** 2)

    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1.0) / 2.0 * (_NCOLS - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % _NCOLS
    f = fk - k0

    img = np.zeros(u.shape + (3,), np.uint8)
    for c in range(3):
        col0 = _WHEEL[k0, c] / 255.0
        col1 = _WHEEL[k1, c] / 255.0
        col = (1 - f) * col0 + f * col1
        inside = rad <= 1
        col[inside] = 1 - rad[inside] * (1 - col[inside])
        col[~inside] = col[~inside] * 0.75
        col[nan] = 0
        img[..., c] = np.floor(255.0 * col)
    return img
