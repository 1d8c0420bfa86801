"""Optimizers: Adam with coupled L2 weight decay (SR) and LAMB (flow).

Counterpart of ``sin_inn_tpu/train/optim.py``. The JAX package builds
``adam_l2`` as optax ``add_decayed_weights -> scale_by_adam -> scale(-lr)``:
the decay term ``weight_decay * param`` is added to the gradient before the
moment updates. ``torch.optim.Adam(weight_decay=...)`` does exactly that
(coupled L2, not AdamW's decoupled decay), with the same bias corrections,
so the two take the same steps.

:class:`Lamb` is ``optax.lamb(lr, b1, b2, eps, weight_decay)``: Adam's
bias-corrected moments with ``eps`` outside the root (``eps_root = 0``), the
decayed weights added to that update, then per leaf the trust ratio
``|p| / |u|`` (1 where either norm is 0), then ``-lr``. The update stays on
the parameters' device: no norm is read by the host.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch


def adam_l2(params: Iterable[torch.Tensor], learning_rate: float,
            betas: Tuple[float, float] = (0.9, 0.99), eps: float = 1e-8,
            weight_decay: float = 0.0) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=learning_rate, betas=tuple(betas),
                            eps=eps, weight_decay=weight_decay)


class Lamb(torch.optim.Optimizer):
    """LAMB as ``optax.lamb`` computes it (see the module docstring)."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-6,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                state["step"] += 1
                t = state["step"]
                mu, nu = state["exp_avg"], state["exp_avg_sq"]
                mu.mul_(b1).add_(p.grad, alpha=1.0 - b1)
                nu.mul_(b2).addcmul_(p.grad, p.grad, value=1.0 - b2)
                u = (mu / (1.0 - b1 ** t)) / (
                    (nu / (1.0 - b2 ** t)).sqrt_().add_(group["eps"]))
                if group["weight_decay"]:
                    u.add_(p, alpha=group["weight_decay"])
                pn, un = torch.linalg.norm(p), torch.linalg.norm(u)
                ratio = torch.where((pn == 0) | (un == 0),
                                    torch.ones_like(pn), pn / un)
                p.addcmul_(u, ratio, value=-group["lr"])
        return loss


def lamb(params: Iterable[torch.Tensor], learning_rate: float,
         betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-6,
         weight_decay: float = 0.0) -> Lamb:
    return Lamb(params, learning_rate, betas, eps, weight_decay)
