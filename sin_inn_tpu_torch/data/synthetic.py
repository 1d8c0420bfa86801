"""Synthetic fixtures for tests and the chip smoke run.

Copies of fixtures of ``sin_inn_tpu/data/synthetic.py``: a moving texture
HR video whose LR RGGB stream comes from the same bayer-binning math as the
offline preparation, so (HR, LR) pairs are physically consistent; the
analytic-GT flow sequences (shift, rotation, zoom, a moving occluder) that
``tools/validate_torch.py`` trains on; and ``synth_scene``, the dense
multi-view scene of the scene-space gather. ``write_sr_dataset``,
``write_flow_scene``, ``write_scene_dir`` and ``write_sparse_model`` lay
such data out on disk as the commands read it, PNGs through the port's
codec.
"""

from __future__ import annotations

import os
import struct
from typing import Optional, Sequence

import numpy as np

from sin_inn_tpu_torch.core.config import SRConfig
from sin_inn_tpu_torch.data.prepare import binning, extract_bayer
from sin_inn_tpu_torch.data.flo import write_flo
from sin_inn_tpu_torch.data.sr_video import SRVideo
from sin_inn_tpu_torch.io import png


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


def _sample_bilinear(base: np.ndarray, yy: np.ndarray,
                     xx: np.ndarray) -> np.ndarray:
    """Bilinear sample (H, W, C) base at float (h, w) coordinate grids."""
    hb, wb = base.shape[:2]
    y0 = np.clip(np.floor(yy), 0, hb - 2).astype(np.int64)
    x0 = np.clip(np.floor(xx), 0, wb - 2).astype(np.int64)
    fy = np.clip(yy - y0, 0.0, 1.0)[..., None]
    fx = np.clip(xx - x0, 0.0, 1.0)[..., None]
    tl = base[y0, x0]
    tr = base[y0, x0 + 1]
    bl = base[y0 + 1, x0]
    br = base[y0 + 1, x0 + 1]
    return ((tl * (1 - fx) + tr * fx) * (1 - fy)
            + (bl * (1 - fx) + br * fx) * fy).astype(np.float32)


def synthetic_flow_sequence(kind: str, num_frames: int, h: int, w: int,
                            seed: int = 0, magnitude: float = 1.0):
    """Analytic-GT flow fixtures. Returns ``(frames (N, h, w, 3) float32,
    flows (N-1, h, w, 2) float32)`` with flow channels (dx, dy), the forward
    frame_t -> frame_{t+1} convention of the trainer's EPE
    (``train/flow.py`` ``epe``).

    kinds:
      * ``shift``: uniform translation by ``magnitude`` px/frame;
      * ``rotation``: rigid rotation by ``magnitude`` degrees/frame about
        the image centre, a smoothly varying, non-constant field;
      * ``zoom``: scaling by ``(1 + magnitude/100)``/frame about the
        centre, a divergent field with a radial profile;
      * ``occlusion``: a textured square moving ``magnitude`` px/frame over
        a static textured background: a motion discontinuity with real
        cover/uncover regions, the regime of the wang / brox occlusion
        estimators.

    Frames sample one continuous base texture at analytically transformed
    coordinates, so the GT flow is exact to the transform (no resampling
    drift accumulates). The base is padded by the analytic maximum
    excursion of the sampled coordinates past the frame (at the corners:
    the transforms are affine) plus 8, so ``_sample_bilinear`` never clips
    at its border."""
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0

    def _raw(y, x, t: float):
        """Unpadded pixel coords -> base-texture coords at time t (affine).
        Never called for 'occlusion' (static background, own frame loop)."""
        if kind == "shift":
            return y, x + magnitude * t
        if kind == "rotation":
            a = np.deg2rad(magnitude) * t
            return ((y - cy) * np.cos(a) - (x - cx) * np.sin(a) + cy,
                    (y - cy) * np.sin(a) + (x - cx) * np.cos(a) + cx)
        if kind == "zoom":
            s = (1.0 + magnitude / 100.0) ** t
            return (y - cy) * s + cy, (x - cx) * s + cx
        raise ValueError(kind)

    if kind == "occlusion":
        pad = 8                          # static background, no base motion
    else:
        ky = np.array([0.0, 0.0, h - 1.0, h - 1.0])
        kx = np.array([0.0, w - 1.0, 0.0, w - 1.0])
        exc = 0.0
        for t in range(num_frames + 1):
            by, bx = _raw(ky, kx, float(t))
            exc = max(exc, -by.min(), by.max() - (h - 1.0),
                      -bx.min(), bx.max() - (w - 1.0))
        pad = int(np.ceil(exc)) + 8
    base = _smooth_texture(h + 2 * pad, w + 2 * pad, seed)
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float64),
                         np.arange(w, dtype=np.float64), indexing="ij")

    def transform(t: float):
        """Pixel coords -> base-texture coords at time t; returns (by, bx)."""
        by, bx = _raw(yy, xx, t)
        return by + pad, bx + pad

    def inverse(by, bx, t: float):
        """Base coords -> pixel coords at time t (exact transform inverse)."""
        if kind == "shift":
            return by - pad, bx - pad - magnitude * t
        if kind == "rotation":
            a = np.deg2rad(magnitude) * t
            qy, qx = by - pad - cy, bx - pad - cx
            return (qy * np.cos(a) + qx * np.sin(a) + cy,
                    -qy * np.sin(a) + qx * np.cos(a) + cx)
        s = (1.0 + magnitude / 100.0) ** t
        return (by - pad - cy) / s + cy, (bx - pad - cx) / s + cx

    if kind == "occlusion":
        fg = _smooth_texture(h, w, seed + 1)
        side = max(h, w) // 4
        y0, x0 = h // 4, w // 8
        frames, flows = [], []
        for t in range(num_frames):
            off = magnitude * t
            frame = base[pad:pad + h, pad:pad + w].copy()
            flow = np.zeros((h, w, 2), np.float32)
            sx0 = int(round(x0 + off))
            fr_y, fr_x = slice(y0, y0 + side), slice(sx0, min(sx0 + side, w))
            frame[fr_y, fr_x] = fg[y0:y0 + side, 0:fr_x.stop - fr_x.start]
            flow[fr_y, fr_x, 0] = magnitude      # square moves in x
            frames.append(frame)
            if t:
                flows.append(flows_prev)
            flows_prev = flow
        return (np.stack(frames).astype(np.float32),
                np.stack(flows).astype(np.float32))

    frames, flows = [], []
    for t in range(num_frames):
        by, bx = transform(float(t))
        frames.append(_sample_bilinear(base, by, bx))
        py, px = inverse(by, bx, float(t + 1))
        flows.append(np.stack([px - xx, py - yy], -1).astype(np.float32))
    return np.stack(frames), np.stack(flows[:-1])


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


def write_sr_dataset(root: str, scene: str, video: SRVideo) -> None:
    """``<root>/hr_frames/<scene>/`` and ``<root>/lr_frames/<scene>/``:
    one ``frame_%05d.png`` a frame (the LR ones RGGB, 4 channels), the
    layout ``prepare`` writes and ``sr --dataset root -s scene`` reads."""
    for kind, frames in (("hr_frames", video.hr), ("lr_frames", video.lr)):
        d = os.path.join(root, kind, scene)
        os.makedirs(d, exist_ok=True)
        for i, f in enumerate(frames):
            png.imwrite(os.path.join(d, f"frame_{i + 1:05d}.png"), f)


def write_flow_scene(root: str, scene: str, frames: np.ndarray,
                     flows: np.ndarray = None) -> str:
    """Sintel's layout: ``<root>/final/<scene>/frame_%04d.png`` from (N, H,
    W, 3) frames in [0, 1] and, with ``flows``, the GT
    ``<root>/flow/<scene>/frame_%04d.flo`` that ``flow --input-video``
    finds beside them. Returns the frame directory."""
    d = os.path.join(root, "final", scene)
    os.makedirs(d, exist_ok=True)
    for i, f in enumerate(frames):
        png.imwrite(os.path.join(d, f"frame_{i + 1:04d}.png"),
                    (np.clip(f, 0, 1) * 255).astype(np.uint8))
    if flows is not None:
        fd = os.path.join(root, "flow", scene)
        os.makedirs(fd, exist_ok=True)
        for i, f in enumerate(flows):
            write_flo(os.path.join(fd, f"frame_{i + 1:04d}.flo"), f)
    return d


def write_scene_dir(d: str, imgs: np.ndarray, depths: np.ndarray,
                    poses: np.ndarray, bds: np.ndarray,
                    jpegs: Optional[Sequence[bytes]] = None) -> None:
    """A dense COLMAP scene directory as ``scene-space`` reads it:
    ``poses_bounds.npy``, ``images/im_%04d.png`` and their geometric depth
    maps ``stereo/depth_maps/im_%04d.png.geometric.bin``; the arrays are
    :func:`synth_scene`'s. With ``jpegs`` (one file's bytes a frame) the
    images are those files, ``images/im_%04d.jpg``, in place of ``imgs``."""
    n, h, w = depths.shape
    os.makedirs(os.path.join(d, "images"), exist_ok=True)
    os.makedirs(os.path.join(d, "stereo", "depth_maps"), exist_ok=True)
    np.save(os.path.join(d, "poses_bounds.npy"),
            np.concatenate([poses.reshape(n, -1), bds], axis=1))
    for i in range(n):
        if jpegs is not None:
            name = f"im_{i:04d}.jpg"
            with open(os.path.join(d, "images", name), "wb") as f:
                f.write(jpegs[i])
        else:
            name = f"im_{i:04d}.png"
            png.imwrite(os.path.join(d, "images", name),
                        (np.clip(imgs[i], 0, 1) * 255).astype(np.uint8))
        with open(os.path.join(d, "stereo", "depth_maps",
                               name + ".geometric.bin"), "wb") as f:
            f.write(f"{w}&{h}&1&".encode())
            depths[i].astype(np.float32).tofile(f)


def write_sparse_model(d: str, names: Sequence[str], h: int, w: int,
                       seed: int = 3) -> None:
    """A COLMAP binary sparse model (``cameras.bin``, ``images.bin``,
    ``points3D.bin``) under ``d``, as ``scene-space read_matrices`` reads
    it: one SIMPLE_RADIAL camera of ``w`` x ``h``, an image a name of
    ``names`` (listed in reverse) with a seeded pose and two keypoints, and
    4 points."""
    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(seed)
    n = len(names)
    with open(os.path.join(d, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 2, w, h))
        f.write(struct.pack("<dddd", 20.0, w / 2 + 0.5, h / 2 - 0.25, 0.01))
    with open(os.path.join(d, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", n))
        for i in range(n):
            q = rng.randn(4)
            q = q / np.linalg.norm(q)
            f.write(struct.pack("<i", i + 1))
            f.write(struct.pack("<dddd", *q))
            f.write(struct.pack("<ddd", *rng.randn(3)))
            f.write(struct.pack("<i", 1))
            f.write(names[n - 1 - i].encode() + b"\x00")
            f.write(struct.pack("<Q", 2))
            f.write(struct.pack("<ddq", 1.5, 2.5, 1))
            f.write(struct.pack("<ddq", 3.0, 4.0, -1))
    with open(os.path.join(d, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", 4))
        for p in range(4):
            f.write(struct.pack("<Q", p + 1))
            f.write(struct.pack("<ddd", *(rng.randn(3) * 0.3 + [0, 0, 4])))
            f.write(struct.pack("<BBB", 10, 20, 30))
            f.write(struct.pack("<d", 0.5))
            f.write(struct.pack("<Q", 2))
            f.write(struct.pack("<iiii", 1, 0, 2, 1))
