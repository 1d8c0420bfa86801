"""Lazy per-index scene dataset.

A copy of ``sin_inn_tpu/scene_space/data.py``: ``ImagesData`` reads one
frame's image and depth map a ``__getitem__``, for scenes too large to load
at once (``pose_utils.load_data`` is the eager path the CLI takes). Poses and
bounds are read once; images and depth maps on demand, as numpy arrays on
the host. PNG and JPEG images go through the port's codecs (``io/png.py``,
``io/jpeg.py``; :func:`read_image`).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from sin_inn_tpu_torch.io import jpeg, png
from sin_inn_tpu_torch.scene_space.colmap import pair_depth_maps, read_depth_bin
from sin_inn_tpu_torch.scene_space.gather import unpack_matrices

_IMG_EXT = (".png", ".jpg", ".jpeg")


def read_image(p: str) -> np.ndarray:
    """A scene image as ``imageio.v2.imread`` returns it: PNG and JPEG
    through the port's codecs (``io/png.py``, ``io/jpeg.py``)."""
    if p.lower().endswith((".jpg", ".jpeg")):
        return jpeg.imread(p)
    return png.imread(p)


class ImagesData:
    """Lazy scene access: ``len(ds)`` frames, ``ds[i]`` -> (c2w, bds, img,
    depth), the image and depth read on demand (depth None for a frame
    without a map). ``K`` / ``K_inv`` are the (4, 4) intrinsics of
    :func:`unpack_matrices` (the true principal point when the 6-column pose
    layout holds it)."""

    def __init__(self, basedir: str, length: Optional[int] = None):
        self.dir = basedir
        arr = np.load(os.path.join(basedir, "poses_bounds.npy"))
        ncol = (arr.shape[1] - 2) // 3
        self.poses = arr[:, :-2].reshape(-1, 3, ncol).astype(np.float32)
        self.bds = arr[:, -2:].astype(np.float32)

        imgdir = os.path.join(basedir, "images")
        self._img_files = sorted(
            os.path.join(imgdir, f) for f in os.listdir(imgdir)
            if f.lower().endswith(_IMG_EXT))
        depthdir = os.path.join(basedir, "stereo", "depth_maps")
        self._depth_files = pair_depth_maps(depthdir, self._img_files)
        n = len(self._img_files)
        if self.poses.shape[0] != n:
            raise ValueError(f"{self.poses.shape[0]} poses != {n} images "
                             f"in {basedir}")
        self.len = n if length is None else min(length, n)

        K, K_inv, _, _ = unpack_matrices(self.poses)
        self.K, self.K_inv = K, K_inv

    def __len__(self) -> int:
        return self.len

    def __getitem__(self, index: int) -> Tuple[np.ndarray, np.ndarray,
                                               np.ndarray, Optional[np.ndarray]]:
        if index >= len(self) or index < 0:
            raise IndexError(index)
        img = (read_image(self._img_files[index])[..., :3] / 255.0
               ).astype(np.float32)
        dpath = self._depth_files[index]
        depth = (read_depth_bin(dpath).astype(np.float32)
                 if dpath is not None else None)
        c2w = np.zeros((4, 4), np.float32)
        c2w[:3, :] = self.poses[index, :, :4]
        c2w[3, 3] = 1.0
        return c2w, self.bds[index], img, depth
