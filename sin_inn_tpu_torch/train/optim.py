"""Optimizer of the SR pipeline: Adam with coupled L2 weight decay.

Counterpart of ``sin_inn_tpu/train/optim.py`` ``adam_l2``. The JAX package
builds it as optax ``add_decayed_weights -> scale_by_adam -> scale(-lr)``:
the decay term ``weight_decay * param`` is added to the gradient before the
moment updates. ``torch.optim.Adam(weight_decay=...)`` does exactly that
(coupled L2, not AdamW's decoupled decay), with the same bias corrections,
so the two take the same steps. ``lamb`` waits for the flow slice.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch


def adam_l2(params: Iterable[torch.Tensor], learning_rate: float,
            betas: Tuple[float, float] = (0.9, 0.99), eps: float = 1e-8,
            weight_decay: float = 0.0) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=learning_rate, betas=tuple(betas),
                            eps=eps, weight_decay=weight_decay)
