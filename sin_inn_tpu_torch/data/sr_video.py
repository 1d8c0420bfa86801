"""Single-video SR datasets: host-cached frames, device feeding.

Counterpart of ``sin_inn_tpu/data/sr_video.py``. The whole video is decoded
once into host uint8 arrays. A batch is assembled by the native loader
(``data/native.py``, one pass over the frame cache) where it is built, else
by numpy fancy indexing; :func:`gather_route_counts` tells which route each
gather took. Frames go to the device as uint8 from pinned memory
(``non_blocking``) and are normalized there.

Index semantics are the reference's:
  * train (supervised): every ``120 // fps``-th frame in
    ``range(1 + fps, num_lr - 1 - fps)``;
  * all (unsupervised/inference): every frame in the same range;
  * val: a seeded random subset of the non-train frames.

Each LR sample is the channel-concat of the ``2*lr_window+1`` RGGB LR frames
around the index.
"""

from __future__ import annotations

import collections
import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from sin_inn_tpu_torch.core.config import SRConfig
from sin_inn_tpu_torch.data import native
from sin_inn_tpu_torch.io import png

# gathers taken by each route since the last reset
_GATHER_ROUTES = {"native": 0, "numpy": 0}


def gather_route_counts() -> Dict[str, int]:
    return dict(_GATHER_ROUTES)


def reset_gather_route_counts() -> None:
    for k in _GATHER_ROUTES:
        _GATHER_ROUTES[k] = 0


def _read_frames(directory: str, dtype=np.uint8) -> np.ndarray:
    files = sorted(f for f in os.listdir(directory) if f.endswith(".png"))
    if not files:
        raise FileNotFoundError(f"no .png frames in {directory}")
    frames = [png.imread(os.path.join(directory, f)) for f in files]
    arr = np.stack(frames).astype(dtype)
    if arr.ndim == 3:
        arr = arr[..., None]
    return arr


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Host batch -> tensors on ``device`` (pinned, non-blocking to CUDA)."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t
    return out


@dataclass
class SRVideo:
    """All frames of one scene, host-cached. lr: (N, h, w, 4) uint8 RGGB;
    hr: (N, H, W, 3) uint8 RGB. Frame i of ``hr`` corresponds to frame i of
    ``lr``."""

    lr: np.ndarray
    hr: np.ndarray

    @classmethod
    def from_dirs(cls, cfg: SRConfig) -> "SRVideo":
        lr_dir = os.path.join(cfg.dataset, "lr_frames", cfg.scene)
        hr_dir = os.path.join(cfg.dataset, "hr_frames", cfg.scene)
        return cls(lr=_read_frames(lr_dir), hr=_read_frames(hr_dir))

    @property
    def num_lr(self) -> int:
        return self.lr.shape[0]


def train_indices(cfg: SRConfig, num_lr: int) -> np.ndarray:
    """Supervised HR frame indices (0-based)."""
    return np.arange(1 + cfg.fps, num_lr - 1 - cfg.fps, 120 // cfg.fps)


def all_indices(cfg: SRConfig, num_lr: int) -> np.ndarray:
    """Every valid window center."""
    return np.arange(1 + cfg.fps, num_lr - 1 - cfg.fps)


def val_indices(cfg: SRConfig, num_lr: int, k: int,
                seed: Optional[int] = None) -> np.ndarray:
    """k random non-train indices."""
    rng = np.random.RandomState(cfg.random_seed if seed is None else seed)
    train = set(train_indices(cfg, num_lr).tolist())
    pool = [i for i in all_indices(cfg, num_lr) if i not in train]
    rng.shuffle(pool)
    return np.asarray(pool[:k], dtype=np.int64)


class SRDataset:
    """Batched (hr, lr-window) sampler over a cached video."""

    def __init__(self, video: SRVideo, cfg: SRConfig, indices: np.ndarray,
                 shuffle: bool = False, seed: int = 0):
        self.video = video
        self.cfg = cfg
        self.indices = np.asarray(indices)
        self.shuffle = shuffle
        self._rng = np.random.RandomState(seed)
        w = cfg.lr_window
        # window gather indices: (num_samples, 2w+1)
        self.window = self.indices[:, None] + np.arange(-w, w + 1)[None, :]
        if self.window.min() < 0 or self.window.max() >= video.num_lr:
            raise ValueError("LR window exceeds video bounds; check fps/lr_window")

    def __len__(self) -> int:
        return len(self.indices)

    def gather(self, sel: np.ndarray) -> Dict[str, np.ndarray]:
        """Assemble a batch for sample positions ``sel`` (uint8 arrays): the
        native loader where it is built, else numpy."""
        win = self.window[sel]                      # (B, 2w+1)
        if native.available():
            _GATHER_ROUTES["native"] += 1
            return {"hr": native.gather_frames(self.video.hr,
                                               self.indices[sel]),
                    "lr": native.gather_windows(self.video.lr, win)}
        _GATHER_ROUTES["numpy"] += 1
        lr = self.video.lr[win]                     # (B, 2w+1, h, w, 4)
        b, t, h, w, c = lr.shape
        lr = np.moveaxis(lr, 1, 3).reshape(b, h, w, t * c)
        hr = self.video.hr[self.indices[sel]]
        return {"hr": hr, "lr": lr}

    def native_prefetch(self, batch_size: int,
                        shuffle: Optional[bool] = None
                        ) -> Optional[native.Prefetcher]:
        """The batches of one pass in the dataset's order (shuffled by its
        own stream when ``shuffle``, default the dataset's), assembled
        ahead by the native loader's thread; None where it is not built."""
        if not native.available():
            return None
        order = np.arange(len(self))
        if self.shuffle if shuffle is None else shuffle:
            self._rng.shuffle(order)
        return native.Prefetcher(self.video.lr, self.video.hr, self.window,
                                 self.indices, order, batch_size)

    def device_cache(self, batch_size: int, device,
                     mesh=None) -> List[Dict[str, torch.Tensor]]:
        """Pre-gather every batch (in order) and keep it on ``device``. With
        ``mesh`` each rank keeps its shard of every batch over the ``data``
        axis (a ragged last batch whole: ``place_batch``'s
        ``allow_uneven``)."""
        put = lambda b: to_device(b, device)
        if mesh is not None:
            from sin_inn_tpu_torch.parallel.sharding import place_batch
            put = lambda b: place_batch(mesh, to_device(b, "cpu"),
                                        allow_uneven=True).to(device)
        return [put(self.gather(np.arange(s, min(s + batch_size, len(self)))))
                for s in range(0, len(self), batch_size)]

    def random_batch(self, batch_size: int) -> Dict[str, np.ndarray]:
        """``batch_size`` samples drawn with replacement from the dataset's
        own ``RandomState`` stream (the reference's unsupervised draw)."""
        sel = self._rng.randint(0, len(self), size=batch_size)
        return self.gather(sel)

    def batches(self, batch_size: int) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self))
        if self.shuffle:
            self._rng.shuffle(order)
        for s in range(0, len(order), batch_size):
            yield self.gather(order[s:s + batch_size])


def make_datasets(video: SRVideo, cfg: SRConfig):
    """(sup, unsup, val) datasets."""
    sup = SRDataset(video, cfg, train_indices(cfg, video.num_lr),
                    shuffle=True, seed=cfg.random_seed)
    unsup = SRDataset(video, cfg, all_indices(cfg, video.num_lr),
                      shuffle=True, seed=cfg.random_seed + 1)
    k = max(1, len(sup) * 2 * 4 // 6)   # 60-40 split on paired len
    val = SRDataset(video, cfg, val_indices(cfg, video.num_lr, k),
                    shuffle=False)
    return sup, unsup, val


def prefetch_to_device(it: Iterator[Dict[str, np.ndarray]], device,
                       size: int = 2) -> Iterator[Dict[str, torch.Tensor]]:
    """Keep ``size`` batches in flight: the host gather and copy of batch
    k+1 overlap device work on batch k."""
    queue = collections.deque()
    for item in it:
        queue.append(to_device(item, device))
        if len(queue) >= size:
            yield queue.popleft()
    while queue:
        yield queue.popleft()
