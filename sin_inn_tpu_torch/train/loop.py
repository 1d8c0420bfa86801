"""SR entry points: checkpoint restore, ``sr train``, the test frame loop and
``sr test``.

Counterpart of the SR half of ``sin_inn_tpu/train/loop.py``
(``sr_dirs``, ``_sr_create_and_restore``, ``run_sr_train``,
``run_sr_test``) on one device. The frame loop is factored out as
:func:`sr_test_frames`, which yields uint8 frames without touching imageio
or ffmpeg. The mesh, tuner, profiler and ``--import-torch`` branches and
``sr export`` wait for their slices.
"""

from __future__ import annotations

import os
import os.path as path
import time
from typing import Dict, Iterator, Optional

import numpy as np

from sin_inn_tpu_torch.core import rng as R
from sin_inn_tpu_torch.core.checkpoint import CheckpointStore
from sin_inn_tpu_torch.core.config import SRConfig
from sin_inn_tpu_torch.core.device import resolve_device
from sin_inn_tpu_torch.core.metrics import MetricsWriter
from sin_inn_tpu_torch.core.preempt import GracefulStop
from sin_inn_tpu_torch.data.sr_video import (SRVideo, make_datasets,
                                             prefetch_to_device, to_device)
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
    """create_train_state + latest-scan restore. Restore source =
    ``resume_state`` when given, else the experiment's own train checkpoint
    dir; ``require`` (an error message) makes a missing checkpoint fatal.
    A checkpoint's optimizer state is restored with its params; a
    params-only checkpoint starts a fresh optimizer. Returns
    (spec, SRTrainState, store, start_epoch)."""
    store = CheckpointStore(
        cfg.resume_state or path.join(sr_dirs(cfg, "train"), "checkpoints"))
    spec, state = SR.create_train_state(init_gen, cfg)
    restored, step = store.restore(map_location=resolve_device(cfg.device))
    if restored is not None:
        _check_params(state.params, restored["params"])
        state = SR.train_state(restored["params"], cfg, restored.get("opt"),
                               int(restored["step"]))
        return spec, state, store, int(step)
    if cfg.resume_state:
        # an explicit resume request never falls back to a fresh state
        raise FileNotFoundError(
            f"--resume_state {cfg.resume_state}: no checkpoint found there")
    if require:
        raise FileNotFoundError(require)
    return spec, state, store, 0


def run_sr_train(cfg: SRConfig, video: Optional[SRVideo] = None,
                 use_wandb: bool = False) -> Dict:
    """SR training on one device: every epoch replays the supervised batches
    (kept on the device), with a random unsupervised batch per step when TCR
    is on; at the print cadence the val split is evaluated on the device and
    logged with the step's losses and frames/s; a checkpoint every
    ``save_iter`` epochs, at the last epoch, and on SIGTERM/SIGINT."""
    device = resolve_device(cfg.device)
    video = video or SRVideo.from_dirs(cfg)
    sup, unsup, val = make_datasets(video, cfg)

    root = R.root_generator(cfg.random_seed)
    spec, state, store, start_epoch = _sr_create_and_restore(
        cfg, R.named_fold(root, "init"))
    step = SR.make_train_step(spec, cfg)
    eval_step = SR.make_eval_step(spec, cfg)

    exp_dir = sr_dirs(cfg, "train")
    if cfg.resume_state:
        # a run resumed from elsewhere still saves into its own directory
        store = CheckpointStore(path.join(exp_dir, "checkpoints"))
    writer = MetricsWriter(exp_dir, run_name=cfg.exp_name,
                           use_wandb=use_wandb, wandb_project="sin-inn",
                           hyperparams=cfg.__dict__)

    dev_root = R.root_generator(cfg.random_seed, device)
    step_gen = R.named_fold(dev_root, "train")
    val_gen = R.named_fold(dev_root, "val")
    use_tcr = cfg.lambda_bwd_tcr > 0
    last_metrics: Dict = {}
    aux: Dict = {}
    sample_infer = None
    t0 = time.time()
    frames_done = 0
    # the supervised set of one video fits on the card: pin every batch
    # once, and replay them each epoch with no host work
    cached = sup.device_cache(cfg.batch_size, device)
    val_cached = val.device_cache(cfg.val_batch_size, device)
    stop = GracefulStop().install()
    try:
        for epoch in range(start_epoch, cfg.epochs):
            for sup_batch in cached:
                unsup_batch = (to_device(
                    unsup.random_batch(sup_batch["hr"].shape[0]), device)
                    if use_tcr else None)
                aux = step(state, sup_batch, unsup_batch, step_gen)
                frames_done += int(sup_batch["hr"].shape[0])

            if (epoch + 1) % cfg.print_iter == 0 or epoch == cfg.epochs - 1:
                # the val split, sample-weighted, summed on the device; one
                # host read per metric at the end
                vm_acc: Dict = {}
                vn = 0
                for vi, vb in enumerate(val_cached):
                    vm = eval_step(state.params, vb,
                                   R.step_fold(val_gen, epoch * 10_000 + vi))
                    nb = int(vb["hr"].shape[0])
                    for k, v in vm.items():
                        vm_acc[k] = vm_acc.get(k, 0.0) + v * nb
                    vn += nb
                if writer.wants_media and val_cached:
                    if sample_infer is None:
                        sample_infer = SR.make_infer_step(spec, cfg)
                    fr = sample_infer(
                        state.params, val_cached[0]["lr"][:1],
                        R.step_fold(R.named_fold(dev_root, "media"), epoch))
                    writer.log_image(epoch, "media/sample_hr",
                                     fr[0].cpu().numpy())
                last_metrics = {k: float(v) for k, v in aux.items()}
                last_metrics.update(
                    {k: float(v) / max(vn, 1) for k, v in vm_acc.items()})
                last_metrics["frames_per_sec"] = frames_done / max(
                    time.time() - t0, 1e-9)
                writer.log(epoch, last_metrics)

            saved = (epoch + 1) % cfg.save_iter == 0 or epoch == cfg.epochs - 1
            if saved or stop:
                store.save(epoch + 1, state.state_dict())
            if stop:
                break
    finally:
        stop.restore()
        writer.close()
    return {"state": state, "spec": spec, "metrics": last_metrics,
            "exp_dir": exp_dir, "start_epoch": start_epoch}


def sr_test_frames(cfg: SRConfig, video: SRVideo, state,
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
