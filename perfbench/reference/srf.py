"""Plain reference of the SRF (``UncondSRFlow``) and its training step.

The published network (paramhanji/sin-inn ``archs.py`` over FrEIA): an
i-RevNet squeeze, then per octave a squeeze and ``num_coupling`` GLOW
couplings, 3x3 subnets at even and 1x1 subnets at odd positions, each
followed by FrEIA's ``PermuteRandom`` (numpy ``RandomState(k)`` of the
channels). A coupling splits the channels at c / 2; subnet s2 maps x2 to a
scale and a shift for x1, s1 maps y1 to those of x2; the scale is
``exp(clamp 2 / pi atan(s / clamp))``. The loss of ``main.py`` with its
defaults: the MSE of the forward's LR channels against the LR window, plus
the MSE of the inverse from (LR || z) against the HR frame; Adam with
coupled L2 weight decay.

Written from that description in NHWC, channels last; nothing of the
program is imported. Weights come flat by name (``harness/weights.py``).
It runs in float32 (TF32 off, ``precision.strict_fp32``): the cells'
control is the program's own bfloat16 mode (``harness/controls.py``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from cost import srf_couplings
import torch.nn.functional as F

_TWO_OVER_PI = 2.0 / math.pi


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/2, W/2, 4C), channel (2 dy + dx) C + c."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // 2, w // 2, 4 * c)


def depth_to_space(y: torch.Tensor) -> torch.Tensor:
    n, h, w, c4 = y.shape
    c = c4 // 4
    y = y.reshape(n, h, w, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(n, 2 * h, 2 * w, c)


def _conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME convolution of NHWC ``x`` with an OIHW kernel."""
    out = F.conv2d(x.permute(0, 3, 1, 2), w, padding=w.shape[-1] // 2)
    return out.permute(0, 2, 3, 1)


def _subnet(p: Dict, pre: str, x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(_conv(x, p[pre + "conv1.w"]) + p[pre + "conv1.b"])
    return _conv(h, p[pre + "conv2.w"]) + p[pre + "conv2.b"]


def _log_e(s: torch.Tensor, clamp: float) -> torch.Tensor:
    return clamp * _TWO_OVER_PI * torch.atan(s / clamp)


def glow(p: Dict, i: int, x: torch.Tensor, len1: int, clamp: float,
         rev: bool) -> torch.Tensor:
    len2 = x.shape[-1] - len1
    a, b = x[..., :len1], x[..., len1:]
    s1 = lambda v: _subnet(p, f"c{i}.s1.", v)
    s2 = lambda v: _subnet(p, f"c{i}.s2.", v)
    if not rev:
        r2 = s2(b)
        y1 = torch.exp(_log_e(r2[..., :len1], clamp)) * a + r2[..., len1:]
        r1 = s1(y1)
        y2 = torch.exp(_log_e(r1[..., :len2], clamp)) * b + r1[..., len2:]
        return torch.cat([y1, y2], dim=-1)
    r1 = s1(a)
    x2 = (b - r1[..., len2:]) * torch.exp(-_log_e(r1[..., :len2], clamp))
    r2 = s2(x2)
    x1 = (a - r2[..., len1:]) * torch.exp(-_log_e(r2[..., :len1], clamp))
    return torch.cat([x1, x2], dim=-1)


def permutations(cfg: Dict) -> List[np.ndarray]:
    return [np.random.RandomState(k % cfg["num_coupling"]).permutation(c["c"])
            for k, c in enumerate(srf_couplings(cfg))]


def srf(p: Dict, cfg: Dict, x: torch.Tensor, rev: bool = False
        ) -> torch.Tensor:
    """HR (N, H, W, 3) -> (LR || z) (N, H/8, W/8, 192), or back with
    ``rev``."""
    couplings = srf_couplings(cfg)
    perms = permutations(cfg)
    per = cfg["num_coupling"]
    clamp = cfg["clamp_srf"]
    dev = x.device
    if not rev:
        x = space_to_depth(x)
        for i, c in enumerate(couplings):
            if i % per == 0:
                x = space_to_depth(x)
            x = glow(p, i, x, c["len1"], clamp, False)
            x = x[..., torch.as_tensor(perms[i], device=dev)]
        return x
    for i in reversed(range(len(couplings))):
        inv = np.argsort(perms[i])
        x = x[..., torch.as_tensor(inv, device=dev)]
        x = glow(p, i, x, couplings[i]["len1"], clamp, True)
        if i % per == 0:
            x = depth_to_space(x)
    return depth_to_space(x)


def sr_loss(p: Dict, cfg: Dict, hr_u8: torch.Tensor, lr_u8: torch.Tensor,
            z: torch.Tensor) -> torch.Tensor:
    hr = hr_u8.float() / 255.0
    lr = lr_u8.float() / 255.0
    lr_dims = lr.shape[-1]
    fwd = torch.mean((srf(p, cfg, hr)[..., :lr_dims] - lr) ** 2)
    hr_hat = srf(p, cfg, torch.cat([lr, z.float()], dim=-1), rev=True)
    bwd = torch.mean((hr_hat - hr) ** 2)
    return cfg["lambda_fwd_rec"] * fwd + cfg["lambda_bwd_rec"] * bwd


def window_batch(hr: torch.Tensor, lr: torch.Tensor, centres: Sequence[int],
                 half: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hr, lr) of the windows centred on frames ``centres`` of the video
    (hr (N, H, W, 3), lr (N, h, w, 4)): each HR frame, and the LR frames
    centre - half ... centre + half stacked along the channels, frame by
    frame."""
    idx = torch.as_tensor(list(centres), device=hr.device)
    win = torch.cat([lr[idx + d] for d in range(-half, half + 1)], dim=-1)
    return hr[idx], win


def train_steps(p0: Dict[str, torch.Tensor], cfg: Dict,
                batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                zs: Sequence[torch.Tensor]):
    """Adam steps (coupled L2 decay, ``torch.optim.Adam``'s arithmetic
    written out) from weights ``p0`` over ``batches`` of (hr, lr) uint8
    (:func:`window_batch`) with latents ``zs``. Returns (losses, grad of
    step 1 as Adam takes it, i.e. with the decay term, weights after step
    1, weights after the last step), each by name."""
    lr_, (b1, b2) = cfg["learning_rate"], cfg["adam_betas"]
    wd, eps = cfg["weight_decay"], 1e-8
    p = {k: v.detach().clone().requires_grad_(True) for k, v in p0.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, g1, p1 = [], None, None
    for t, ((hr, lr), z) in enumerate(zip(batches, zs), start=1):
        loss = sr_loss(p, cfg, hr, lr, z)
        grads = torch.autograd.grad(loss, list(p.values()))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            g = {k: gk + wd * p[k] for k, gk in zip(p, grads)}
            if t == 1:
                g1 = {k: v.clone() for k, v in g.items()}
            for k in p:
                m[k].mul_(b1).add_(g[k], alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g[k], g[k], value=1 - b2)
                den = (v2[k] / (1 - b2 ** t)).sqrt_().add_(eps)
                p[k].sub_(lr_ * (m[k] / (1 - b1 ** t)) / den)
            if t == 1:
                p1 = {k: v.detach().clone() for k, v in p.items()}
    return losses, g1, p1, {k: v.detach() for k, v in p.items()}
