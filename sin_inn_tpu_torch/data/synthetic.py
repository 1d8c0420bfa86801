"""Synthetic fixtures for tests and the chip smoke run.

Copies of fixtures of ``sin_inn_tpu/data/synthetic.py``: a moving texture
HR video whose LR RGGB stream comes from the same bayer-binning math as the
offline preparation, so (HR, LR) pairs are physically consistent, and
``synth_scene``, the dense multi-view scene of the scene-space gather.
"""

from __future__ import annotations

import numpy as np

from sin_inn_tpu_torch.core.config import SRConfig
from sin_inn_tpu_torch.data.prepare import binning, extract_bayer
from sin_inn_tpu_torch.data.sr_video import SRVideo


def moving_texture_video(num_frames: int, h: int, w: int,
                         seed: int = 0) -> np.ndarray:
    """(N, H, W, 3) float32 in [0,1]: smooth texture drifting over time."""
    rng = np.random.RandomState(seed)
    pad = num_frames + 8
    base = rng.rand(h + pad, w + pad, 3).astype(np.float32)
    # blur for spatial coherence (box filter, twice)
    for _ in range(2):
        base = (base
                + np.roll(base, 1, 0) + np.roll(base, -1, 0)
                + np.roll(base, 1, 1) + np.roll(base, -1, 1)) / 5.0
    frames = np.stack([base[i:i + h, i:i + w] for i in range(num_frames)])
    return np.clip(frames, 0.0, 1.0)


def _smooth_texture(h: int, w: int, seed: int, blur: int = 2) -> np.ndarray:
    rng = np.random.RandomState(seed)
    base = rng.rand(h, w, 3).astype(np.float32)
    for _ in range(blur):
        base = (base
                + np.roll(base, 1, 0) + np.roll(base, -1, 0)
                + np.roll(base, 1, 1) + np.roll(base, -1, 1)) / 5.0
    return base


def synth_scene(n: int, h: int, w: int, seed: int = 0):
    """Dense multi-view scene for the scene-space gather: N noisy views of
    one textured constant-depth plane, a per-frame camera y-translation and
    an off-center principal point. Returns (imgs, depths, poses, bds) in
    ``gather_scene``'s input layout (numpy)."""
    # the noise stream must not replay the texture's MT19937 prefix
    rng = np.random.RandomState(seed + 1)
    base = _smooth_texture(h, w, seed)
    imgs = np.clip(base[None] + 0.08 * rng.randn(n, h, w, 3), 0, 1
                   ).astype(np.float32)
    depths = np.full((n, h, w), 10.0, np.float32)
    poses = np.zeros((n, 3, 6), np.float32)
    for i in range(n):
        poses[i, :, :3] = np.eye(3)
        poses[i, 0, 3] = 0.02 * (i - n / 2)      # slight y translation
        poses[i, 0, 4], poses[i, 1, 4] = h, w
        poses[i, 2, 4] = 2.0 * max(h, w)          # focal
        poses[i, 0, 5], poses[i, 1, 5] = w / 2 + 3.5, h / 2 - 2.25  # cx, cy
    bds = np.tile(np.array([[8.0, 12.0]], np.float32), (n, 1))
    return imgs, depths, poses, bds


def natural_texture_video(num_frames: int, h: int, w: int, seed: int = 0,
                          alpha: float = 1.8, shift: float = 1.0
                          ) -> np.ndarray:
    """(N, H, W, 3) video with a 1/f^alpha power spectrum, drifting
    ``shift`` px/frame."""
    rng = np.random.RandomState(seed)
    pad = int(num_frames * shift) + 8
    hh, ww = h + pad, w + pad
    fy = np.fft.fftfreq(hh)[:, None]
    fx = np.fft.fftfreq(ww)[None, :]
    amp = 1.0 / np.maximum(np.sqrt(fy ** 2 + fx ** 2), 1.0 / max(hh, ww)) \
        ** alpha
    chans = []
    for _ in range(3):
        phase = np.exp(2j * np.pi * rng.rand(hh, ww))
        img = np.real(np.fft.ifft2(amp * phase))
        img = (img - img.min()) / max(img.max() - img.min(), 1e-9)
        chans.append(img)
    base = np.stack(chans, -1).astype(np.float32)
    frames = [base[i:i + h, i:i + w] for i in
              (int(round(t * shift)) for t in range(num_frames))]
    return np.clip(np.stack(frames), 0.0, 1.0)


def synthetic_sr_video(cfg: SRConfig, num_frames: int = None, h: int = 16,
                       w: int = 16, seed: int = 0,
                       texture: str = "smooth") -> SRVideo:
    """SRVideo with LR derived by bayer binning of the HR frames.

    ``texture='natural'`` uses the 1/f-spectrum video instead of blurred
    white noise."""
    if num_frames is None:
        # enough frames for at least two supervised samples
        num_frames = 2 * (120 // cfg.fps) + 2 * cfg.fps + 4
    hr = (natural_texture_video(num_frames, h, w, seed)
          if texture == "natural" else
          moving_texture_video(num_frames, h, w, seed))
    lr = []
    for f in hr:
        bayer, _ = extract_bayer(f)
        lr.append(binning(bayer, "mean", cfg.scale))
    lr = np.stack(lr)
    to_u8 = lambda x: (np.clip(x, 0, 1) * 255).astype(np.uint8)
    return SRVideo(lr=to_u8(lr), hr=to_u8(hr))
