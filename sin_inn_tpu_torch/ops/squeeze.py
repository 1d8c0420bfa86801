"""i-RevNet style space-to-depth squeeze with exact inverse, NHWC layout.

Same component-major channel order as the reference
(``sin_inn_tpu/ops/squeeze.py``): all channels of block position (0,0), then
(0,1), (1,0), (1,1).
"""

from __future__ import annotations

import torch


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/2, W/2, 4C), volume-preserving bijection."""
    n, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"spatial dims must be even, got {(h, w)}")
    x = x.reshape(n, h // 2, 2, w // 2, 2, c)
    # component-major: out channel = (2*dy + dx) * C + c
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // 2, w // 2, 4 * c)


def depth_to_space(y: torch.Tensor) -> torch.Tensor:
    """Exact inverse of :func:`space_to_depth`."""
    n, h, w, c4 = y.shape
    if c4 % 4:
        raise ValueError(f"channel dim must be divisible by 4, got {c4}")
    c = c4 // 4
    y = y.reshape(n, h, w, 2, 2, c)
    y = y.permute(0, 1, 3, 2, 4, 5)
    return y.reshape(n, 2 * h, 2 * w, c)
