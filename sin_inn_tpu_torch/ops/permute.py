"""Seeded random channel permutation with exact inverse.

The permutations are drawn on the host with numpy, exactly as the reference
package draws them (``sin_inn_tpu/ops/permute.py``), so both packages build
the same model from the same config.
"""

from __future__ import annotations

import numpy as np
import torch


def make_permutation(channels: int, seed: int) -> np.ndarray:
    """Deterministic permutation of ``channels`` indices from ``seed``."""
    return np.random.RandomState(seed).permutation(channels)


def invert_permutation(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return inv


def permute_channels(x: torch.Tensor, perm) -> torch.Tensor:
    """Apply a static channel permutation on the last (channel) axis."""
    index = torch.as_tensor(np.asarray(perm), dtype=torch.long,
                            device=x.device)
    return x.index_select(-1, index)
