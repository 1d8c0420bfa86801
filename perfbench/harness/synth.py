"""The benchmark's own synthetic videos, made on the device from the seed.

A seed draws only the texture (the frequencies, phases and colours of a sum
of plane waves); the motion comes from the traffic file and is the same for
every seed, so every seed gives the same sizes and the same amount of work.

* :func:`sr_video`: HR frames of a texture translating at a fixed velocity,
  and their LR stream by Bayer binning (RGGB planes, each averaged over
  ``scale`` x ``scale`` blocks), both uint8, as ``prepare`` makes them.
* :func:`flow_clip`: a clip whose frame k+1 is frame k moved by an affine
  flow, alternately zooming in and out about the centre while translating,
  with its exact (analytic) forward flow of every pair.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch


class Texture:
    """RGB in [0, 1] at continuous pixel coordinates: 0.5 plus a sum of
    ``waves`` plane waves with wavelengths log-uniform in [lo, hi] pixels,
    random directions, phases and colours."""

    def __init__(self, seed: int, device, waves: int = 32, lo: float = 6.0,
                 hi: float = 160.0):
        gen = torch.Generator(device=device).manual_seed(seed)
        u = torch.rand((waves, 6), generator=gen, device=device,
                       dtype=torch.float64)
        lam = lo * (hi / lo) ** u[:, 0]
        ang = 2 * math.pi * u[:, 1]
        self.fx = (torch.cos(ang) / lam).float()
        self.fy = (torch.sin(ang) / lam).float()
        self.phase = (2 * math.pi * u[:, 2]).float()
        self.colour = (0.5 + 0.5 * u[:, 3:6]).float()        # (waves, 3)
        self.amp = 0.9 / math.sqrt(waves)

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """x, y: (...) pixel coordinates -> (..., 3)."""
        arg = (x[..., None] * self.fx + y[..., None] * self.fy) * (
            2 * math.pi) + self.phase
        return torch.clamp(0.5 + self.amp * (torch.sin(arg) @ self.colour),
                           0.0, 1.0)


def _grid(h: int, w: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    ys = torch.arange(h, device=device, dtype=torch.float32)
    xs = torch.arange(w, device=device, dtype=torch.float32)
    return torch.meshgrid(ys, xs, indexing="ij")


def sr_video(frames: int, height: int, width: int, scale: int, seed: int,
             device, velocity=(1.5, 0.5), chunk: int = 16
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hr (N, H, W, 3), lr (N, H / 2s, W / 2s, 4)), uint8 on ``device``."""
    tex = Texture(seed, device)
    yy, xx = _grid(height, width, device)
    hr = torch.empty((frames, height, width, 3), dtype=torch.uint8,
                     device=device)
    lr = torch.empty((frames, height // (2 * scale), width // (2 * scale), 4),
                     dtype=torch.uint8, device=device)
    to_u8 = lambda t: (torch.clamp(t, 0, 1) * 255).to(torch.uint8)
    for s in range(0, frames, chunk):
        k = torch.arange(s, min(s + chunk, frames), device=device,
                         dtype=torch.float32)[:, None, None]
        img = tex(xx - velocity[0] * k, yy - velocity[1] * k)
        hr[s:s + len(k)] = to_u8(img)
        planes = torch.stack([img[:, 0::2, 0::2, 0], img[:, 0::2, 1::2, 1],
                              img[:, 1::2, 0::2, 1], img[:, 1::2, 1::2, 2]],
                             dim=-1)
        n, ph, pw, _ = planes.shape
        binned = planes.reshape(n, ph // scale, scale, pw // scale, scale,
                                4).mean(dim=(2, 4))
        lr[s:s + len(k)] = to_u8(binned)
    return hr, lr


def affine_steps(frames: int, height: int, width: int, motion: Dict
                 ) -> np.ndarray:
    """(N - 1, 3, 3) float64: the map M_k of pair k, p -> p + t_k + s_k K
    (p - c), s_k = (-1)^k, K = diag(kx, ky), t_k a circle of radii (tx, ty)
    over ``period`` pairs, c the frame's centre, in (x, y, 1)."""
    cx, cy = (width - 1) / 2.0, (height - 1) / 2.0
    out = []
    for k in range(frames - 1):
        s = 1.0 if k % 2 == 0 else -1.0
        kx, ky = s * motion["kx"], s * motion["ky"]
        a = 2 * math.pi * k / motion["period"]
        tx, ty = motion["tx"] * math.cos(a), motion["ty"] * math.sin(a)
        out.append(np.array([[1 + kx, 0, tx - kx * cx],
                             [0, 1 + ky, ty - ky * cy],
                             [0, 0, 1]], dtype=np.float64))
    return np.stack(out)


def flow_clip(frames: int, height: int, width: int, seed: int, device,
              motion: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """(video (N, H, W, 3) float32 in [0, 1], flow (N - 1, H, W, 2) float32
    of (dx, dy) in pixels) on ``device``: frame k is the texture at A_k^-1
    p with A_0 = I, A_{k+1} = M_k A_k, so frame k+1 at p + f_k(p) shows
    what frame k shows at p, with f_k(p) = M_k p - p."""
    tex = Texture(seed, device)
    yy, xx = _grid(height, width, device)
    steps = affine_steps(frames, height, width, motion)
    video = torch.empty((frames, height, width, 3), dtype=torch.float32,
                        device=device)
    flow = torch.empty((frames - 1, height, width, 2), dtype=torch.float32,
                       device=device)
    acc = np.eye(3)
    for k in range(frames):
        inv = np.linalg.inv(acc).astype(np.float32)
        video[k] = tex(inv[0, 0] * xx + inv[0, 1] * yy + inv[0, 2],
                       inv[1, 0] * xx + inv[1, 1] * yy + inv[1, 2])
        if k < frames - 1:
            m = steps[k].astype(np.float32)
            flow[k, ..., 0] = (m[0, 0] - 1) * xx + m[0, 2]
            flow[k, ..., 1] = (m[1, 1] - 1) * yy + m[1, 2]
            acc = steps[k] @ acc
    return video, flow
