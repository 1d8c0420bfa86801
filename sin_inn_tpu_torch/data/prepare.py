"""Offline dataset preparation: bayer extraction, binning, demosaic
(host-side numpy / scipy and the port's codecs).

Counterpart of ``sin_inn_tpu/data/prepare.py``, function for function:
a video -> per-frame HR RGB PNGs, 4-channel RGGB LR PNGs (bayer binning or
a resize of each bayer plane), their bilinear demosaiced previews and,
with ``noise``, noisy HR frames, under the same file names
(``frame_00001.png`` ...). No step runs on the card. A GIF is decoded by
``io/gif.py`` (another container by ``imageio``), the resizes are
``io/resize.py``'s (the JAX package's cv2 calls, array for array) and the
PNGs are written by ``io/png.py``. The preview videos are encoded with
ffmpeg only where it is installed.
"""

from __future__ import annotations

import os
import shutil
import subprocess as sp
from typing import Optional, Tuple

import numpy as np

from sin_inn_tpu_torch.core.config import PrepareConfig
from sin_inn_tpu_torch.io import gif, png
from sin_inn_tpu_torch.io.resize import resize


def extract_bayer(frame: np.ndarray, scale: float = 1.0
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """RGB frame -> (RGGB bayer mosaic, resized RGB)."""
    if scale != 1.0:
        frame = resize(frame, fx=1.0 / scale, fy=1.0 / scale,
                       mode="lanczos4")
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


def cv_resize(bayer: np.ndarray, operator: str, scale: int) -> np.ndarray:
    """Per-plane resize of the bayer mosaic with ``operator`` (one of
    ``io/resize.py``'s modes; the JAX package's cv2 ``INTER_<OPERATOR>``)."""
    h, w = bayer.shape[:2]
    out = np.empty((h // scale // 2, w // scale // 2, 4))
    planes = (bayer[::2, ::2], bayer[::2, 1::2],
              bayer[1::2, ::2], bayer[1::2, 1::2])
    for i, p in enumerate(planes):
        out[..., i] = resize(p, fx=1.0 / scale, fy=1.0 / scale,
                             mode=operator)
    return out


def pack_bayer(img: np.ndarray) -> np.ndarray:
    """4-channel RGGB -> mosaic."""
    h, w, _ = img.shape
    bayer = np.empty((h * 2, w * 2), img.dtype)
    bayer[::2, ::2] = img[..., 0]
    bayer[::2, 1::2] = img[..., 1]
    bayer[1::2, ::2] = img[..., 2]
    bayer[1::2, 1::2] = img[..., 3]
    return bayer


def demosaic_bilinear(bayer: np.ndarray) -> np.ndarray:
    """Bilinear RGGB demosaic via small convolutions (equivalent of
    colour_demosaicing.demosaicing_CFA_Bayer_bilinear for RGGB)."""
    from scipy.ndimage import convolve

    h, w = bayer.shape
    r_m = np.zeros((h, w)); r_m[::2, ::2] = 1
    b_m = np.zeros((h, w)); b_m[1::2, 1::2] = 1
    g_m = 1.0 - r_m - b_m

    k_g = np.array([[0, 1, 0], [1, 4, 1], [0, 1, 0]]) / 4.0
    k_rb = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]]) / 4.0

    r = convolve(bayer * r_m, k_rb, mode="mirror")
    g = convolve(bayer * g_m, k_g, mode="mirror")
    b = convolve(bayer * b_m, k_rb, mode="mirror")
    return np.stack([r, g, b], axis=-1)


def pack_demosaic(img: np.ndarray) -> np.ndarray:
    return demosaic_bilinear(pack_bayer(img))


def _normalize(frame: np.ndarray) -> np.ndarray:
    if frame.dtype == np.uint8:
        return frame / 255.0
    if frame.dtype == np.uint16:
        return frame / (2 ** 16 - 1)
    raise NotImplementedError(f"unsupported dtype {frame.dtype}")


def _to_u8(x: np.ndarray) -> np.ndarray:
    return (np.clip(x, 0.0, 1.0) * 255.0).astype(np.uint8)


def prepare_video(cfg: PrepareConfig, dataset: Optional[str] = None,
                  scene: Optional[str] = None, rng: Optional[np.random.RandomState] = None):
    """The whole preparation of ``cfg.video``; returns (dataset, scene).
    ``dataset`` defaults to the video's parent directory's parent and
    ``scene`` to ``<video name>_<operator>_<scale>x``; ``rng`` draws the
    HR noise."""
    if dataset is None:
        dataset = os.path.join(os.path.dirname(cfg.video), "..")
    if scene is None:
        base = os.path.splitext(os.path.basename(cfg.video))[0]
        scene = f"{base}_{cfg.operator}_{cfg.scale}x"
    for sub in ("hr_frames", "lr_frames", "lr_frames_demosaiced",
                "hr_frames_noisy"):
        os.makedirs(os.path.join(dataset, sub, scene), exist_ok=True)
    rng = rng or np.random.RandomState(0)

    if cfg.bayer:
        raise NotImplementedError("bayer input videos are not supported")

    if cfg.video.lower().endswith(".gif"):
        reader = gif.iter_frames(cfg.video)
    else:
        try:
            import imageio.v2 as io
        except ImportError as e:
            raise ImportError(
                f"{cfg.video}: reading a video that is not a GIF needs the "
                f"imageio package and its ffmpeg plugin, which are not "
                f"installed; a GIF needs neither") from e
        reader = io.get_reader(cfg.video)
    for i, frame in enumerate(reader):
        frame = _normalize(np.asarray(frame))
        bayer, hr = extract_bayer(frame, cfg.downsampling)

        hr8 = _to_u8(hr)
        png.imwrite(os.path.join(dataset, "hr_frames", scene,
                                 f"frame_{i+1:05d}.png"), hr8)
        if cfg.noise:
            noisy = np.clip(hr8 + rng.normal(0, cfg.noise, hr8.shape), 0, 255)
            png.imwrite(os.path.join(dataset, "hr_frames_noisy", scene,
                                     f"frame_{i+1:05d}.png"),
                        noisy.astype(np.uint8))

        h, w = bayer.shape
        if h % (cfg.scale * 2) or w % (cfg.scale * 2):
            raise ValueError("frame size not divisible by 2*scale; "
                             "pick a lower scale")
        if cfg.operator == "binning":
            lr = binning(bayer, cfg.reduction, cfg.scale)
        else:
            lr = cv_resize(bayer, cfg.operator, cfg.scale)
        lr_rgb = pack_demosaic(lr)

        png.imwrite(os.path.join(dataset, "lr_frames", scene,
                                 f"frame_{i+1:05d}.png"), _to_u8(lr))
        png.imwrite(os.path.join(dataset, "lr_frames_demosaiced", scene,
                                 f"frame_{i+1:05d}.png"), _to_u8(lr_rgb))

    _encode_previews(dataset, scene)
    return dataset, scene


def _encode_previews(dataset: str, scene: str, fps: int = 30, crf: int = 18):
    """Preview videos via ffmpeg where it is installed; skipped otherwise."""
    if shutil.which("ffmpeg") is None:
        return
    for sub in ("hr_frames", "lr_frames_demosaiced"):
        vdir = os.path.join(dataset, sub, "videos")
        os.makedirs(vdir, exist_ok=True)
        cmd = ["ffmpeg", "-framerate", str(fps), "-i",
               os.path.join(dataset, sub, scene, "frame_%5d.png"),
               "-c:v", "libx264", "-preset", "veryslow", "-crf", str(crf),
               "-y", os.path.join(vdir, f"{scene}.avi")]
        with open(os.devnull, "w") as dump:
            sp.check_call(cmd, stdin=sp.PIPE, stderr=dump, stdout=dump)
