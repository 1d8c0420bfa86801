"""SR serving entry points: checkpoint restore, test frame loop, sr test.

Counterpart of the ``sr test`` half of ``sin_inn_tpu/train/loop.py``
(``sr_dirs``, ``_sr_create_and_restore``, ``run_sr_test``). The frame loop
is factored out as :func:`sr_test_frames`, which yields uint8 frames without
touching imageio or ffmpeg. The train and export entry points come with the
training slice.
"""

from __future__ import annotations

import os
import os.path as path
from typing import Iterator, Optional

import numpy as np

from sin_inn_tpu_torch.core import rng as R
from sin_inn_tpu_torch.core.checkpoint import CheckpointStore
from sin_inn_tpu_torch.core.config import SRConfig
from sin_inn_tpu_torch.core.device import resolve_device
from sin_inn_tpu_torch.data.sr_video import (SRVideo, make_datasets,
                                             prefetch_to_device)
from sin_inn_tpu_torch.io.video_io import VideoWriter
from sin_inn_tpu_torch.train import sr as SR


def sr_dirs(cfg: SRConfig, operation: str) -> str:
    exp_dir = path.join(cfg.working_dir, operation, cfg.exp_name)
    os.makedirs(exp_dir, exist_ok=True)
    return exp_dir


def _check_params(fresh, restored) -> None:
    """A checkpoint must match the config's architecture, tensor for tensor."""
    if len(fresh) != len(restored):
        raise ValueError(f"checkpoint holds {len(restored)} layers, the config "
                         f"builds {len(fresh)}")
    for i, (f, r) in enumerate(zip(fresh, restored)):
        if (f is None) != (r is None):
            raise ValueError(f"checkpoint layer {i} does not match the config")
        if f is None:
            continue
        for sub in f:
            for conv in f[sub]:
                for k, t in f[sub][conv].items():
                    got = r[sub][conv][k]
                    if tuple(got.shape) != tuple(t.shape):
                        raise ValueError(
                            f"checkpoint layer {i} {sub}.{conv}.{k}: shape "
                            f"{tuple(got.shape)}, config needs {tuple(t.shape)}")


def _sr_create_and_restore(cfg: SRConfig, init_gen, require: str = ""):
    """create_state + latest-scan restore. Restore source = ``resume_state``
    when given, else the experiment's own train checkpoint dir; ``require``
    (an error message) makes a missing checkpoint fatal. Returns
    (spec, state, store, start_epoch)."""
    store = CheckpointStore(
        cfg.resume_state or path.join(sr_dirs(cfg, "train"), "checkpoints"))
    spec, state = SR.create_state(init_gen, cfg)
    restored, step = store.restore(map_location=resolve_device(cfg.device))
    if restored is not None:
        _check_params(state.params, restored["params"])
        return (spec, SR.SRState(params=restored["params"],
                                 step=int(restored["step"])), store, int(step))
    if cfg.resume_state:
        # an explicit resume request never falls back to a fresh state
        raise FileNotFoundError(
            f"--resume_state {cfg.resume_state}: no checkpoint found there")
    if require:
        raise FileNotFoundError(require)
    return spec, state, store, 0


def sr_test_frames(cfg: SRConfig, video: SRVideo, state: SR.SRState,
                   spec) -> Iterator[np.ndarray]:
    """Render every test window of ``video`` to uint8 (H, W, 3) HR frames,
    ``cfg.val_batch_size`` windows per inference batch."""
    device = resolve_device(cfg.device)
    _, unsup, _ = make_datasets(video, cfg)
    unsup.shuffle = False
    infer = SR.make_infer_step(spec, cfg)
    infer_gen = R.named_fold(R.root_generator(cfg.random_seed, device),
                             "infer")
    lr_batches = ({"lr": b["lr"]} for b in unsup.batches(cfg.val_batch_size))
    for i, batch in enumerate(prefetch_to_device(lr_batches, device)):
        frames = infer(state.params, batch["lr"], R.step_fold(infer_gen, i))
        yield from frames.cpu().numpy()


def run_sr_test(cfg: SRConfig, video: Optional[SRVideo] = None,
                state=None, spec=None, save_video: Optional[str] = None,
                save_images: bool = False) -> str:
    """SR inference: writes a video (ffmpeg, else GIF), or PNG frames
    with ``save_images``. Returns the output path."""
    resolve_device(cfg.device)
    video = video or SRVideo.from_dirs(cfg)
    if state is None:
        init_gen = R.named_fold(R.root_generator(cfg.random_seed), "init")
        spec, state, _, _ = _sr_create_and_restore(
            cfg, init_gen, require="no checkpoint to test from")
    exp_dir = sr_dirs(cfg, "test")
    frames = sr_test_frames(cfg, video, state, spec)

    if save_images:
        from sin_inn_tpu_torch.io.video_io import write_frames
        img_dir = path.join(exp_dir,
                            f"{cfg.architecture}_{cfg.suffix}_t{cfg.temp}")
        write_frames(img_dir, frames,
                     prefix=f"{cfg.architecture}_{cfg.suffix}")
        return img_dir

    out = save_video or path.join(
        exp_dir, f"{cfg.architecture}_{cfg.suffix}_t{cfg.temp}.avi")
    with VideoWriter(out, fps=30) as vw:
        for f in frames:
            vw.add(f)
    return vw.path
