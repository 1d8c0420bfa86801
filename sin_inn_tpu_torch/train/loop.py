"""Entry points: SR (``sr train``, ``sr test``, ``sr export``) and flow
(``flow train``, ``flow test``, ``flow interpolate``, ``flow export``,
``flow summarize``, ``flow sintel``).

Counterpart of ``sin_inn_tpu/train/loop.py`` on one device: for SR,
``sr_dirs``, ``_warn_ckpt_overrides_import`` (the one precedence rule of
``--import-torch`` for both pipelines), ``_sr_create_and_restore`` (with the
``--import-torch`` branch), ``run_sr_train`` (with ``--auto_batch``,
``--auto_lr`` and ``--profile``), ``run_sr_test`` and ``run_sr_export``;
for flow, ``flow_ckpt_dir``, ``_flow_create_and_restore`` (with the
``--import-torch`` branch), ``_scene_flow_dir``, the window bounds
(``_q16``, ``_q8p``, the sidecar ``_save_window_bounds``,
``_load_window_bounds``, ``_load_window_hist``, ``_inference_bounds``, the
GT-flow probe ``_resolve_and_probe_splat_bounds`` and the mid-training
refit ``_refit_window_bounds``), ``run_flow_train`` (with ``--profile``),
``run_flow_test`` (with the wandb media), ``run_flow_interpolate``,
``run_flow_export``, ``run_flow_summarize`` and ``run_flow_sintel``. The
frame loops are factored out as in-memory cores (:func:`sr_test_frames`,
:func:`flow_test_outputs`, :func:`interpolate_frames`,
:func:`sintel_scene_flows`, :func:`normalized_aepe`) that return numpy
arrays and uint8 frames without touching imageio or ffmpeg.
``_maybe_pseudo_gt`` attaches the ``--flow-producer`` pseudo-GT flow (the
port's RAFT under ``raft:``) to media without GT, in ``flow train`` and
``flow test``. The mesh branches are not ported.
"""

from __future__ import annotations

import logging
import os
import os.path as path
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from sin_inn_tpu_torch.core import rng as R
from sin_inn_tpu_torch.core.checkpoint import CheckpointStore
from sin_inn_tpu_torch.core.config import FlowConfig, SRConfig
from sin_inn_tpu_torch.core.device import resolve_device
from sin_inn_tpu_torch.core.metrics import MetricsWriter
from sin_inn_tpu_torch.core.preempt import GracefulStop
from sin_inn_tpu_torch.core.profiler import TraceWindow
from sin_inn_tpu_torch.data import flow_media
from sin_inn_tpu_torch.data.flo import write_flo
from sin_inn_tpu_torch.data.flow_viz import flow_to_image
from sin_inn_tpu_torch.data.sr_video import (SRVideo, make_datasets,
                                             prefetch_to_device, to_device)
from sin_inn_tpu_torch.io.video_io import VideoWriter
from sin_inn_tpu_torch.models import controllers as C
from sin_inn_tpu_torch.models.inr import flat_leaves
from sin_inn_tpu_torch.ops.occlusion import OCCLUSIONS
from sin_inn_tpu_torch.ops.offsets import tile_deviation_fine, tile_flow_offsets
from sin_inn_tpu_torch.train import flow as FT
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


_log = logging.getLogger(__name__)


def _warn_ckpt_overrides_import(cfg, store: CheckpointStore):
    """One precedence rule for every entry point of both pipelines (an
    ``SRConfig`` or a ``FlowConfig``): a framework checkpoint on disk wins
    over ``--import-torch`` (the import seeds a run, resume continues one),
    loudly, and the reference file is then not read at all."""
    step = store.latest_step()
    if cfg.import_torch and step is not None:
        _log.warning(
            "--import-torch %s ignored: framework checkpoint at %s (step %d) "
            "takes precedence. Delete that checkpoint dir or point "
            "--resume_state / --name elsewhere to run from the imported "
            "weights.", cfg.import_torch, store.directory, step)
        return cfg.replace(import_torch=None)
    return cfg


def _sr_create_and_restore(cfg: SRConfig, init_gen, require: str = ""):
    """create_train_state + latest-scan restore. Restore source =
    ``resume_state`` when given, else the experiment's own train checkpoint
    dir; ``require`` (an error message) makes a missing checkpoint fatal
    unless ``--import-torch`` supplied the weights. A checkpoint's optimizer
    state is restored with its params; a params-only checkpoint starts a
    fresh optimizer. Returns (spec, SRTrainState, store, start_epoch)."""
    store = CheckpointStore(
        cfg.resume_state or path.join(sr_dirs(cfg, "train"), "checkpoints"))
    spec, state = SR.create_train_state(
        init_gen, _warn_ckpt_overrides_import(cfg, store))
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
    if require and not cfg.import_torch:
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
    dev_root = R.root_generator(cfg.random_seed, device)
    # auto-tuning before the fit (the reference's auto_scale_batch_size,
    # then auto_lr_find), on the first windows of the supervised set
    probe = lambda b: to_device(sup.gather(np.arange(b) % max(len(sup), 1)),
                                device)
    if cfg.auto_batch:
        from sin_inn_tpu_torch.train.tuner import find_batch_size
        cfg = cfg.replace(batch_size=find_batch_size(
            cfg, probe, R.named_fold(dev_root, "tune"),
            start=cfg.batch_size))
    if cfg.auto_lr:
        from sin_inn_tpu_torch.train.tuner import find_lr
        cfg = cfg.replace(learning_rate=find_lr(
            cfg, probe(cfg.batch_size), R.named_fold(dev_root, "tune")))
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
    # --profile N: one trace of N train steps after two warm-up steps
    tracer = TraceWindow(path.join(store.directory, "trace"),
                         cfg.profile_steps, device=device)
    stop = GracefulStop().install()
    try:
        for epoch in range(start_epoch, cfg.epochs):
            for sup_batch in cached:
                unsup_batch = (to_device(
                    unsup.random_batch(sup_batch["hr"].shape[0]), device)
                    if use_tcr else None)
                aux = step(state, sup_batch, unsup_batch, step_gen)
                tracer.tick()
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
        tracer.close()
        writer.close()
    return {"state": state, "spec": spec, "metrics": last_metrics,
            "exp_dir": exp_dir, "start_epoch": start_epoch,
            # the batch size and LR after any auto-tuning; the trace file
            "cfg": cfg, "trace": tracer.path}


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


def run_sr_export(cfg: SRConfig, out: Optional[str] = None) -> str:
    """Export the latest SR checkpoint (or the ``--import-torch`` weights
    when there is none) as a reference-loadable torch state_dict, the
    reverse of ``--import-torch``. Returns the file's path."""
    from sin_inn_tpu_torch.models import torch_import as TI

    init_gen = R.named_fold(R.root_generator(cfg.random_seed), "init")
    spec, state, _, _ = _sr_create_and_restore(
        cfg, init_gen, require="no checkpoint to export")
    out = out or path.join(sr_dirs(cfg, "train"),
                           f"{cfg.architecture}_{cfg.suffix}_export.ckpt")
    return TI.save_reference_checkpoint(
        out, TI.export_state_dict(spec, state.params))


# ===========================================================================
# Flow pipeline
# ===========================================================================

def flow_ckpt_dir(cfg: FlowConfig, scene: str) -> str:
    return path.join(cfg.checkpoints_dir, scene, cfg.name)


def flow_state_dict(params, consts, step: int, opt=None,
                    ctrl_state=None) -> Dict:
    """The flow checkpoint: ``{"params", "consts", "step"}``, ``"opt"`` (the
    optimizer's state dict) when training saves it, and for a progressive
    net ``"ctrl_state"`` (the controller's state as a dict of tensors and
    ints with its kind). The encoding consts ride with the params, so a
    restore never pairs trained weights with freshly drawn RBF centres."""
    out = {"params": params, "consts": consts, "step": int(step)}
    if opt is not None:
        out["opt"] = opt
    if ctrl_state is not None:
        out["ctrl_state"] = C.state_to_dict(ctrl_state)
    return out


def _check_tree(fresh, restored, what: str) -> None:
    """A checkpoint must match the config's net, leaf for leaf."""
    f, r = flat_leaves(fresh), flat_leaves(restored)
    if [k for k, _ in f] != [k for k, _ in r]:
        raise ValueError(f"checkpoint {what} leaves {[k for k, _ in r]} do "
                         f"not match the config's {[k for k, _ in f]}")
    for (k, a), (_, b) in zip(f, r):
        if tuple(a.shape) != tuple(b.shape):
            raise ValueError(f"checkpoint {what}.{k}: shape "
                             f"{tuple(b.shape)}, config needs "
                             f"{tuple(a.shape)}")


def _restored_ctrl_state(fresh, restored: Dict, device):
    """The controller state of a checkpoint, checked against the config's
    fresh one: the same kind, every tensor of the same shape. A progressive
    net's checkpoint without one, or one for a net that has no controller,
    does not match the config."""
    tree = restored.get("ctrl_state")
    if fresh is None and tree is None:
        return None
    if fresh is None or tree is None:
        raise ValueError(
            "checkpoint " + ("holds" if tree is not None else "lacks")
            + " a controller state and the config's net "
            + ("has no controller" if fresh is None else "needs one")
            + " (check --net and --spatially-adaptive)")
    want = C.state_to_dict(fresh)
    if tree.get("kind") != want["kind"]:
        raise ValueError(f"checkpoint controller is {tree.get('kind')!r}, "
                         f"the config's is {want['kind']!r} (check "
                         "--spatially-adaptive)")
    state = C.state_from_dict(tree, device)
    for name, a in want.items():
        b = getattr(state, name, None)
        if isinstance(a, torch.Tensor) and tuple(a.shape) != tuple(b.shape):
            raise ValueError(f"checkpoint ctrl_state.{name}: shape "
                             f"{tuple(b.shape)}, config needs "
                             f"{tuple(a.shape)} (check --spatial-res)")
    return state


def _flow_restore(cfg: FlowConfig, init_gen, scene: str):
    """The config's INR with its controller (imported from
    ``cfg.import_torch`` unless a checkpoint wins), and the latest
    checkpoint of ``flow_ckpt_dir`` shape-checked against them. Returns (spec, params,
    consts, ctrl_cfg, ctrl_state, store, restored or None, step); the
    controller state is the checkpoint's when there is a checkpoint."""
    device = resolve_device(cfg.device)
    store = CheckpointStore(flow_ckpt_dir(cfg, scene))
    # with --import-torch and no checkpoint, the fresh net carries the
    # reference checkpoint's weights, encoding buffers and controller mask
    spec, params, consts, ctrl_cfg, ctrl_state = FT.build_flow_model(
        init_gen, _warn_ckpt_overrides_import(cfg, store), device)
    restored, step = store.restore(map_location=device)
    if restored is not None:
        _check_tree(params, restored["params"], "params")
        _check_tree(consts, restored["consts"], "consts")
        ctrl_state = _restored_ctrl_state(ctrl_state, restored, device)
    return spec, params, consts, ctrl_cfg, ctrl_state, store, restored, step


def _flow_create_and_restore(cfg: FlowConfig, init_gen, scene: str,
                             require: str = ""):
    """The config's INR, then the latest checkpoint of ``flow_ckpt_dir``
    restored over it (its params, consts and controller state; a training
    checkpoint's optimizer state is left aside). ``require`` (an error
    message) makes a missing checkpoint fatal unless ``--import-torch``
    supplied the weights. Returns (spec, params, consts, store, step,
    ctrl_cfg, ctrl_state)."""
    (spec, params, consts, ctrl_cfg, ctrl_state, store, restored,
     step) = _flow_restore(cfg, init_gen, scene)
    if restored is not None:
        return (spec, restored["params"], restored["consts"], store,
                int(step), ctrl_cfg, ctrl_state)
    if require and not cfg.import_torch:
        raise FileNotFoundError(require)
    return spec, params, consts, store, 0, ctrl_cfg, ctrl_state


def _flow_train_create_and_restore(cfg: FlowConfig, init_gen, scene: str):
    """create_flow_state + latest-scan restore: the checkpoint's params,
    consts and controller state, with its optimizer state when it has one
    (a serving checkpoint starts a fresh optimizer). Returns (spec,
    FlowTrainState, consts, store, start_epoch)."""
    (spec, params, consts, ctrl_cfg, ctrl_state, store, restored,
     step) = _flow_restore(cfg, init_gen, scene)
    if restored is None:
        return (spec, FT.train_state(params, cfg, ctrl_cfg=ctrl_cfg,
                                     ctrl_state=ctrl_state), consts, store, 0)
    state = FT.train_state(restored["params"], cfg, restored.get("opt"),
                           int(restored["step"]), ctrl_cfg, ctrl_state)
    return spec, state, restored["consts"], store, int(step)


def _scene_flow_dir(flow_dir: Optional[str], scene: str) -> Optional[str]:
    """The multi-scene entry points read an explicit ``flow_dir`` as a root
    of per-scene subdirectories (Sintel's ``flow/<scene>``): one flat .flo
    directory is never attached to every scene."""
    if not flow_dir:
        return None
    sub = path.join(flow_dir, scene)
    return sub if path.isdir(sub) else None


def _q16(v) -> int:
    """A global window bound from a measured max |flow|: 1.5x, rounded up to
    16 px, at least 16. Shared by the GT probe and the refit."""
    return max(16, int(-(-(1.5 * float(v)) // 16) * 16))


def _q8p(v) -> int:
    """A local row bound from a measured per-tile deviation: 1.5x + 3 px
    (the resample coordinates' shift), rounded up to 8, at least 8. Shared
    by the GT probe and the refit."""
    return max(8, int(-(-(1.5 * float(v) + 3.0) // 8) * 8))


def _save_window_bounds(directory: str, cfg: FlowConfig, fh: int, fw: int,
                        hist: Optional[Dict] = None) -> None:
    """Write the run's effective window bounds, global and local, beside its
    checkpoints (``window_bounds.json``), with ``hist``, the refit monitor's
    running maxima, so that a resume and a later ``flow test`` or ``flow
    interpolate`` at the same frame size use the windows the net was
    trained on, and a resume keeps the history its refit decides by."""
    import json
    with open(path.join(directory, "window_bounds.json"), "w") as f:
        json.dump({"fh": fh, "fw": fw,
                   **{k: getattr(cfg, k) for k in FlowConfig.WINDOW_BOUND_KEYS},
                   "hist": hist or {}}, f)


def _read_window_sidecar(directory: str, fh: int, fw: int) -> Optional[Dict]:
    """The sidecar's contents, or None when it is absent, unreadable or of
    another frame size (bounds are pixels at the train frame size)."""
    import json
    try:
        with open(path.join(directory, "window_bounds.json")) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return None
    return data if (data.get("fh"), data.get("fw")) == (fh, fw) else None


def _load_window_hist(directory: str, fh: int, fw: int) -> Dict:
    """The sidecar's refit-monitor maxima ({} without a valid sidecar)."""
    data = _read_window_sidecar(directory, fh, fw) or {}
    return {k: float(v) for k, v in data.get("hist", {}).items()
            if v is not None}


def _load_window_bounds(cfg: FlowConfig, directory: str, fh: int,
                        fw: int) -> Tuple[FlowConfig, bool]:
    """Apply the training run's effective window bounds (the sidecar beside
    the checkpoints) to every bound still on 'auto'; an explicit value
    given now wins. Returns (cfg, sidecar_found_and_valid)."""
    data = _read_window_sidecar(directory, fh, fw)
    if data is None:
        return cfg, False
    upd = {k: data[k] for k in FlowConfig.WINDOW_BOUND_KEYS
           if k in data and getattr(cfg, k) == "auto"}
    return (cfg.replace(**upd) if upd else cfg), True


def _inference_bounds(cfg: FlowConfig) -> FlowConfig:
    """Serving has no monitor and no refit: a local bound still on 'auto'
    (no training evidence applied) resolves off, so that no local window
    engages without deviation evidence. Global 'auto' bounds keep their
    size-scaled defaults."""
    upd = {k: "off" for k in ("splat_local_dy", "splat_local_dx")
           if getattr(cfg, k) == "auto"}
    return cfg.replace(**upd) if upd else cfg


def _resolve_and_probe_splat_bounds(cfg: FlowConfig, media, fh: int,
                                    fw: int) -> FlowConfig:
    """Resolve the 'auto' window bounds for the frame size, then, when the
    media has GT flow, re-derive every bound left on 'auto' from it:

    - the global bounds to ``_q16`` of the largest |flow| (tighter for slow
      scenes, wider for fast ones); at half the frame or beyond, the exact
      warp and scatter, unless a global axis is pinned (a pin asks for the
      windowed path);
    - the local row bound to ``_q8p`` of the per-tile deviation against the
      quantized offsets (kept only if smaller than dy);
    - the local column bound, which only this probe engages: 64 px of
      offset quantization plus 1.5x the unquantized deviation + 3 px,
      rounded up to 64, kept only if it narrows the window at 128-column
      granularity."""
    was_auto_dy = cfg.splat_max_dy == "auto"
    was_auto_dx = cfg.splat_max_dx == "auto"
    was_auto_ldy = cfg.splat_local_dy == "auto"
    was_auto_ldx = cfg.splat_local_dx == "auto"
    # the local values as given: the probe may widen the globals to where a
    # pinned local bound engages, so they are resolved again from these
    raw_ldy, raw_ldx = cfg.splat_local_dy, cfg.splat_local_dx
    cfg = cfg.resolve_splat_bounds(fh, fw)
    have_gt = media is not None and media.gt_available
    log = logging.getLogger(__name__)
    if ((was_auto_dy or was_auto_dx) and have_gt
            and isinstance(cfg.splat_max_dy, int)):
        probe_dx = _q16(np.abs(media.flow[..., 0]).max())
        probe_dy = _q16(np.abs(media.flow[..., 1]).max())
        dy = probe_dy if was_auto_dy else cfg.splat_max_dy
        dx = (probe_dx if was_auto_dx and cfg.splat_max_dx is not None
              else cfg.splat_max_dx)
        if (was_auto_dy and dy >= fh // 2) or (was_auto_dx and dx is not None
                                               and dx >= fw // 2):
            if was_auto_dy and (was_auto_dx or dx is None):
                log.warning(
                    "GT flow probe (|dy| window %s, |dx| window %s) reaches "
                    "half the %dx%d frame: windowing buys nothing; taking "
                    "the exact scatter splat and warp.", dy, dx, fh, fw)
                dy = dx = None
                raw_ldy = raw_ldx = None
            else:
                log.warning(
                    "GT flow probe widened the auto window bound past half "
                    "the %dx%d frame (|dy| %s, |dx| %s) but the other axis "
                    "is pinned: keeping the windowed path.", fh, fw, dy, dx)
        cfg = cfg.replace(splat_max_dy=dy, splat_max_dx=dx,
                          splat_local_dy=raw_ldy, splat_local_dx=raw_ldx)
        cfg = cfg.resolve_splat_bounds(fh, fw)
    if was_auto_ldy and cfg.splat_local_dy is not None and have_gt:
        dy = cfg.splat_max_dy
        capy = -(-dy // 8) * 8
        offs = tile_flow_offsets(torch.from_numpy(media.flow), 128, 128,
                                 capy, 0)
        dev_y = float(torch.maximum(offs.dev_src[1], offs.dev_out[1]))
        ldy = _q8p(dev_y)
        cfg = cfg.replace(splat_local_dy=ldy if ldy < dy else None)
    if (was_auto_ldx and have_gt and isinstance(cfg.splat_local_dy, int)
            and isinstance(cfg.splat_max_dx, int)):
        dx = cfg.splat_max_dx
        dev_x = float(tile_deviation_fine(torch.from_numpy(media.flow),
                                          128, 128)[0])
        ldx = 64 + max(0, int(-(-(1.5 * dev_x + 3.0) // 64) * 64))
        if -(-(128 + 2 * ldx) // 128) < -(-(128 + 2 * dx) // 128):
            cfg = cfg.replace(splat_local_dx=ldx)
    return cfg


def _refit_window_bounds(cfg: FlowConfig, auto: Dict, fh: int, fw: int,
                         since: Dict, hist: Dict,
                         allow_tighten: bool) -> Optional[FlowConfig]:
    """The window bounds refitted from the monitor's measured flow, or None
    when nothing changes. ``auto`` marks the bounds left on 'auto' (only
    those move); ``since`` and ``hist`` are running maxima of the monitor
    {fy, fx: max |flow|; dvy, dvx: max deviation from the tile offsets, in
    local mode only} since the last refit and since the run began.

    - An axis widens as soon as its stat nears the bound (|flow| > bound - 1,
      deviation > bound - 3); a global bound widened to half the frame falls
      back to the exact warp and scatter unless a global axis is pinned.
    - With ``allow_tighten`` an axis tightens to the history's bound when
      that frees at least one quantum (16 px global, 8 local rows, 64 local
      columns), so a bound never tightens below flows already seen.
    - A local row bound no smaller than the global dy drops local mode; a
      dropped one re-engages from the deviation history (with one extra
      quantum) once dy has room for it. The local column bound moves but is
      never engaged here (that is the GT probe's)."""
    dy, dx = cfg.splat_max_dy, cfg.splat_max_dx
    if not dy:
        return None
    ldy, ldx = cfg.splat_local_dy, cfg.splat_local_dx
    to64p = lambda v: max(128, int(-(-(1.5 * v + 3.0) // 64) * 64))
    new: Dict = {}
    if auto["dy"]:
        if since["fy"] > dy - 1:
            new["splat_max_dy"] = max(_q16(since["fy"]), dy + 16)
        elif allow_tighten and _q16(hist["fy"]) <= dy - 16:
            new["splat_max_dy"] = _q16(hist["fy"])
    if auto["dx"] and dx is not None:
        if since["fx"] > dx - 1:
            new["splat_max_dx"] = max(_q16(since["fx"]), dx + 16)
        elif allow_tighten and _q16(hist["fx"]) <= dx - 16:
            new["splat_max_dx"] = _q16(hist["fx"])
    ndy = new.get("splat_max_dy", dy)
    ndx = new.get("splat_max_dx", dx)
    if (auto["dy"] and ndy >= fh // 2) or (
            auto["dx"] and ndx is not None and ndx >= fw // 2):
        if auto["dy"] and (auto["dx"] or ndx is None):
            return cfg.replace(splat_max_dy=None, splat_max_dx=None,
                               splat_local_dy=None, splat_local_dx=None)
    if ldy is not None:
        if auto["ldy"] and since.get("dvy") is not None:
            if since["dvy"] > ldy - 3:
                new["splat_local_dy"] = max(_q8p(since["dvy"]), ldy + 8)
            elif allow_tighten and _q8p(hist["dvy"]) <= ldy - 8:
                new["splat_local_dy"] = _q8p(hist["dvy"])
        nldy = new.get("splat_local_dy", ldy)
        if nldy is not None and nldy >= ndy:
            new["splat_local_dy"] = None
            new["splat_local_dx"] = None
        elif (ldx is not None and auto["ldx"] and ndx is not None
              and since.get("dvx") is not None):
            if since["dvx"] > ldx - 3:
                new["splat_local_dx"] = max(to64p(since["dvx"]), ldx + 64)
            elif allow_tighten and to64p(hist["dvx"]) <= ldx - 64:
                new["splat_local_dx"] = to64p(hist["dvx"])
            nldx = new.get("splat_local_dx", ldx)
            if (nldx is not None and -(-(128 + 2 * nldx) // 128)
                    >= -(-(128 + 2 * ndx) // 128)):
                new["splat_local_dx"] = None
    elif (auto["ldy"] and ndx is not None
          and hist.get("dvy") is not None):
        cand = _q8p(hist["dvy"]) + 8
        if cand <= ndy - 8:
            new["splat_local_dy"] = cand
    if not new or all(getattr(cfg, k) == v for k, v in new.items()):
        return None
    return cfg.replace(**new)


def _to_device_batch(batch: Dict[str, np.ndarray], device) -> Dict:
    """A media batch on ``device``; ``scale`` stays a Python float."""
    return {k: (float(v) if k == "scale" else torch.from_numpy(v).to(device))
            for k, v in batch.items()}


def _warn_if_outgrown(cfg: FlowConfig, m: Dict, epoch: int) -> bool:
    """Warn once the flow nears the windows whose far taps are dropped: in
    local mode the deviation from the tile offsets against the local bounds
    (with a 3 px margin for the resample coordinates' shift), else |flow|
    against the global ones. Returns whether it warned."""
    log = logging.getLogger(__name__)
    dy, dx = cfg.splat_max_dy, cfg.splat_max_dx
    if "flow_dev_y" in m and cfg.splat_local_dy:
        dvy, dvx = float(m["flow_dev_y"]), float(m["flow_dev_x"])
        ldy = cfg.splat_local_dy
        ldx = cfg.splat_local_dx or dx
        if dvy > ldy - 3 or dvx > ldx - 3:
            log.warning(
                "flow deviation from the tile means (dy %.1f px; dx %.1f px) "
                "approaches the local window bounds (local dy=%s, x=%s) at "
                "epoch %d: taps beyond the window are being dropped. Raise "
                "--splat-local-dy/--splat-local-dx (or pass 'off' for the "
                "global windows) / --splat-max-dx.", dvy, dvx, ldy, ldx,
                epoch)
            return True
        return False
    fy, fx = float(m["flow_max_y"]), float(m["flow_max_x"])
    if fy > dy - 1 or (dx is not None and fx > dx - 1):
        log.warning(
            "flow magnitude (|fy| %.1f, |fx| %.1f px) exceeds the splat "
            "window bounds (dy=%s, dx=%s) at epoch %d: taps beyond the "
            "window are being dropped. Raise --splat-max-dy/--splat-max-dx "
            "or pass 'off' for the exact scatter.", fy, fx, dy, dx, epoch)
        return True
    return False


def _maybe_pseudo_gt(cfg: FlowConfig, media, scene: str):
    """Attach producer-made pseudo-GT flow when the media has no GT flow,
    on ``cfg.device``. The cache directory,
    ``<checkpoints_dir>/pseudo_gt/<scene>_h<H>_<tag>``, is keyed by the
    scene, the frame height, the frame sampling (step, end) and the
    producer spec, exactly as the JAX package keys it: a rerun reuses the
    ``.flo`` files, and any change of the frame pairs or the producer makes
    new ones."""
    if (media is None or not cfg.flow_producer
            or getattr(media, "gt_available", False)):
        return media
    import hashlib

    producer = flow_media.resolve_producer(cfg.flow_producer,
                                           device=cfg.device)
    key = f"{cfg.flow_producer}|step={cfg.step}|end={cfg.end}"
    tag = hashlib.sha1(key.encode()).hexdigest()[:8]
    out = path.join(cfg.checkpoints_dir, "pseudo_gt",
                    f"{scene}_h{media.video.shape[1]}_{tag}")
    return flow_media.attach_pseudo_gt(media, producer, out)


def run_flow_train(cfg: FlowConfig, media=None, scene: str = "scene",
                   use_wandb: bool = False, val_media=None,
                   keep_writer: bool = False) -> Dict:
    """``flow train`` on one device: fit the config's INR to the video's
    flow with the photometric loss and LAMB.

    The window bounds are resolved for the frame size and, with GT flow,
    probed from it (``_resolve_and_probe_splat_bounds``); a resume keeps
    the bounds its run had reached (the sidecar). The frame-pair batches are
    placed on the device once and replayed every epoch in a seeded
    permutation. At the ``val_iter`` cadence (off by default) and at the
    last epoch the step's metrics and pairs/s are logged, with the
    validation EPE when the val media has GT flow (summed on the device, one
    scalar read). A checkpoint (``{"params", "consts", "opt", "step"}``,
    and ``"ctrl_state"`` for a progressive net, whose controller a resume
    continues) and the window-bound sidecar are written every ``epochs //
    100`` epochs, at the last epoch and on SIGTERM/SIGINT; a rerun resumes
    from the latest one. The window monitor of every step is kept on the
    device as a running maximum and read at each save, where the refit
    (``window_refit``) may move the 'auto' bounds and rebuild the step;
    when the flow outgrows the windows (whose far taps are dropped) the
    loop warns once."""
    device = resolve_device(cfg.device)
    if media is None:
        media, val_media, scene = flow_media.get_video(
            cfg.input_video, cfg.size, cfg.test_size, cfg.end, cfg.step,
            flow_dir=cfg.flow_dir)
    same = val_media is media
    media = _maybe_pseudo_gt(cfg, media, scene)
    val_media = media if same else _maybe_pseudo_gt(cfg, val_media, scene)
    fh, fw = media.video.shape[1:3]
    ckpt_dir = flow_ckpt_dir(cfg, scene)
    # the bounds left on 'auto': only these may move, in the probe and in
    # the refit
    auto_bounds = {"dy": cfg.splat_max_dy == "auto",
                   "dx": cfg.splat_max_dx == "auto",
                   "ldy": cfg.splat_local_dy == "auto",
                   "ldx": cfg.splat_local_dx == "auto"}
    # a resumed run keeps the bounds it trained on (bounds pinned now win);
    # a fresh run in a reused directory probes its own
    if CheckpointStore(ckpt_dir).latest_step() is not None:
        cfg, _ = _load_window_bounds(cfg, ckpt_dir, fh, fw)
    cfg = _resolve_and_probe_splat_bounds(cfg, media, fh, fw)
    refit_on = (cfg.window_refit != "off" and any(auto_bounds.values())
                and bool(cfg.splat_max_dy))
    root = R.root_generator(cfg.random_seed)
    spec, state, consts, store, start_epoch = _flow_train_create_and_restore(
        cfg, R.named_fold(root, "init"), scene)
    step = FT.make_flow_train_step(spec, cfg)

    writer = MetricsWriter(store.directory, run_name=f"{scene}_{cfg.name}",
                           use_wandb=use_wandb, wandb_project="optical_flow",
                           hyperparams=cfg.__dict__)
    if writer.wants_media:
        # the source video and its GT flow, once at the start
        writer.log_media(0, "media/source", (np.clip(media.video, 0.0, 1.0)
                                             * 255).astype(np.uint8), fps=4)
        if media.gt_available:
            writer.log_media(0, "media/gt_flow", np.stack(
                [flow_to_image(f) for f in media.flow]), fps=4)
    do_val = (val_media is not None and val_media.gt_available
              and cfg.effective_val_iter <= cfg.epochs)
    if do_val:
        vh, vw = val_media.video.shape[1:3]

    rng = np.random.RandomState(cfg.random_seed)
    save_every = max(cfg.epochs // 100, 1)
    last: Dict = {}
    m: Dict = {}
    t0 = time.time()
    pairs_done = 0
    cached = [_to_device_batch(b, device) for b in media.batches(cfg.batch)]
    # --profile N: one trace of N train steps after two warm-up steps
    tracer = TraceWindow(path.join(store.directory, "trace"),
                         cfg.profile_steps, device=device)
    stop = GracefulStop().install()
    window_warned = False
    # the refit monitor: the running maximum of [fy, fx(, dvy, dvx)] over
    # every step since the last save, on the device (read at a save); the
    # all-time maxima as host floats, restored on a resume
    mon_since = None
    mon_hist: Dict = (_load_window_hist(ckpt_dir, fh, fw)
                      if start_epoch > 0 else {})
    try:
        for epoch in range(start_epoch, cfg.epochs):
            mon_epoch = []
            for bi in rng.permutation(len(cached)):
                batch = cached[bi]
                m = step(state, consts, batch)
                tracer.tick()
                pairs_done += int(batch["frame1"].shape[0])
                if refit_on and "flow_max_y" in m:
                    mon_epoch.append(torch.stack(
                        [m["flow_max_y"], m["flow_max_x"]]
                        + ([m["flow_dev_y"], m["flow_dev_x"]]
                           if "flow_dev_y" in m else [])))
            if mon_epoch:
                vec = torch.stack(mon_epoch).amax(dim=0)
                mon_since = (vec if mon_since is None
                             else torch.maximum(mon_since, vec))
            if ((epoch + 1) % cfg.effective_val_iter == 0
                    or epoch == cfg.epochs - 1):
                last = {k: float(v) for k, v in m.items()}
                last["frames_per_sec"] = pairs_done / max(time.time() - t0,
                                                          1e-9)
                if do_val:
                    epe_sum, n = torch.zeros((), device=device), 0
                    for vb in val_media.batches(cfg.test_batch):
                        vb = _to_device_batch(vb, device)
                        f12, _ = FT.flow_infer(spec, state.params, consts,
                                               vb["times"], vb["scale"],
                                               vh, vw, state.ctrl_cfg,
                                               state.ctrl_state)
                        nb = int(vb["times"].shape[0])
                        epe_sum = epe_sum + FT.epe(f12, vb["gt_flow"]) * nb
                        n += nb
                    last["val_epe"] = float(epe_sum) / max(n, 1)
                writer.log(epoch, last)
            saved = (epoch + 1) % save_every == 0 or epoch == cfg.epochs - 1
            if saved or stop:
                store.save(epoch + 1, flow_state_dict(
                    state.params, consts, state.step,
                    state.optimizer.state_dict(), state.ctrl_state))
            if saved and refit_on and mon_since is not None:
                v = mon_since.tolist()
                mon_since = None
                since = {"fy": v[0], "fx": v[1],
                         "dvy": v[2] if len(v) > 2 else None,
                         "dvx": v[3] if len(v) > 3 else None}
                for k, x in since.items():
                    if x is not None:
                        mon_hist[k] = max(mon_hist.get(k, 0.0), x)
                new_cfg = _refit_window_bounds(
                    cfg, auto_bounds, fh, fw, since, mon_hist,
                    allow_tighten=(epoch + 1) >= max(cfg.epochs // 5, 2))
                if new_cfg is not None:
                    logging.getLogger(__name__).warning(
                        "window refit at epoch %d (measured max |fy| %.1f "
                        "|fx| %.1f dev_y %s dev_x %s): dy %s->%s dx %s->%s "
                        "local dy %s->%s dx %s->%s; rebuilding the train "
                        "step.", epoch + 1, since["fy"], since["fx"],
                        since["dvy"], since["dvx"], cfg.splat_max_dy,
                        new_cfg.splat_max_dy, cfg.splat_max_dx,
                        new_cfg.splat_max_dx, cfg.splat_local_dy,
                        new_cfg.splat_local_dy, cfg.splat_local_dx,
                        new_cfg.splat_local_dx)
                    cfg = new_cfg
                    step = FT.make_flow_train_step(spec, cfg)
                    window_warned = False
                    refit_on = (cfg.window_refit != "off"
                                and bool(cfg.splat_max_dy))
            if saved or stop:
                # the bounds after any refit, with the monitor's history
                _save_window_bounds(store.directory, cfg, fh, fw, mon_hist)
            if (saved and cfg.splat_max_dy and "flow_max_y" in m
                    and not window_warned):
                window_warned = _warn_if_outgrown(cfg, m, epoch + 1)
            if stop:
                break
    finally:
        stop.restore()
        tracer.close()
        if not keep_writer:
            writer.close()
    out = {"state": state, "spec": spec, "consts": consts, "metrics": last,
           "scene": scene, "start_epoch": start_epoch,
           # the effective config: the probed and refitted window bounds
           "cfg": cfg, "trace": tracer.path}
    if keep_writer:
        out["writer"] = writer
    return out


def flow_test_outputs(cfg: FlowConfig, media: flow_media.FlowMedia, spec,
                      params, consts, ctrl_cfg=None, ctrl_state=None) -> Dict:
    """Flows and occlusion masks of every frame pair of ``media``,
    ``cfg.test_batch`` pairs per INR query, under the controller's mask for
    a progressive net. Returns numpy arrays:
    ``flow12`` (P, H, W, 2), ``masks`` (P, H, W, 1) or None, and ``epe``
    (the mean end-point error against the GT, or None without GT)."""
    device = resolve_device(cfg.device)
    occl = OCCLUSIONS.get(cfg.occl)
    h, w = media.video.shape[1:3]
    flows: List[np.ndarray] = []
    masks: List[np.ndarray] = []
    epes: List[float] = []
    with torch.no_grad():
        for batch in media.batches(cfg.test_batch):
            times = torch.from_numpy(batch["times"]).to(device)
            f12, f21 = FT.flow_infer(spec, params, consts, times,
                                     float(batch["scale"]), h, w, ctrl_cfg,
                                     ctrl_state)
            if "gt_flow" in batch:
                gt = torch.from_numpy(batch["gt_flow"]).to(device)
                epes.append(float(FT.epe(f12, gt)))
            flows.append(f12.cpu().numpy())
            if occl is not None:
                masks.append(occl(f12, f21, cfg.occl_thresh).cpu().numpy())
    return {"flow12": np.concatenate(flows),
            "masks": np.concatenate(masks) if masks else None,
            "epe": float(np.mean(epes)) if epes else None}


def run_flow_test(cfg: FlowConfig, media=None, scene: str = "scene",
                  spec=None, params=None, consts=None, ctrl_cfg=None,
                  ctrl_state=None, use_wandb: bool = False,
                  writer: Optional[MetricsWriter] = None) -> Dict:
    """``flow test``: predicted flows (Middlebury colours) and occlusion
    masks of every pair written as GIFs with a JSON sidecar, and the EPE
    against the GT when there is one. Restores the scene's checkpoint
    (or, without one, the ``--import-torch`` weights) unless a model is
    given. With a ``writer`` (the training run's) or ``use_wandb`` the flow
    GIF gets a metadata sidecar and, where wandb is on, the flow and
    occlusion videos are logged as media."""
    resolve_device(cfg.device)
    if media is None:
        _, media, scene = flow_media.get_video(
            cfg.input_video, cfg.size, cfg.test_size, cfg.end, cfg.step,
            flow_dir=cfg.flow_dir)
    media = _maybe_pseudo_gt(cfg, media, scene)
    # the training run's bounds; without them no local window engages
    cfg, _ = _load_window_bounds(cfg, flow_ckpt_dir(cfg, scene),
                                 *media.video.shape[1:3])
    cfg = _inference_bounds(cfg)
    if params is None:
        init = R.named_fold(R.root_generator(cfg.random_seed), "init")
        spec, params, consts, _, _, ctrl_cfg, ctrl_state = \
            _flow_create_and_restore(
                cfg, init, scene, require=f"no checkpoint for scene {scene}")
    out = flow_test_outputs(cfg, media, spec, params, consts, ctrl_cfg,
                            ctrl_state)

    os.makedirs(cfg.results_dir, exist_ok=True)
    tag = f"{scene}_{cfg.name}"
    mean_epe = out["epe"] if out["epe"] is not None else 0.0
    flow_imgs = np.stack([flow_to_image(f) for f in out["flow12"]])
    with VideoWriter(path.join(cfg.results_dir,
                               f"flow_{tag}_epe_{mean_epe:.3f}.gif"),
                     fps=4) as vw:
        for f in flow_imgs:
            vw.add(f)
    import json
    with open(path.join(cfg.results_dir, f"flow_{tag}.json"), "w") as fh:
        json.dump({"epe": mean_epe, "frames": len(out["flow12"]),
                   "scene": scene, "name": cfg.name}, fh)
    occl_path, mask_imgs = None, None
    if out["masks"] is not None:
        mask_imgs = (out["masks"].repeat(3, -1) * 255).astype(np.uint8)
        with VideoWriter(path.join(cfg.results_dir, f"occl_{tag}.gif"),
                         fps=4) as ow:
            for m in mask_imgs:
                ow.add(m)
        occl_path = ow.path

    own_writer = writer is None and use_wandb
    if own_writer:
        writer = MetricsWriter(cfg.results_dir, run_name=f"test_{tag}",
                               use_wandb=True, wandb_project="optical_flow")
    if writer is not None:
        writer.log_artifact(vw.path, {"epe": mean_epe, "scene": scene})
        if writer.wants_media:
            # past the training epochs: wandb drops steps that go back
            writer.log_media(cfg.epochs, f"flow/{tag}", flow_imgs, fps=4)
            if mask_imgs is not None:
                writer.log_media(cfg.epochs, f"occl/{tag}", mask_imgs, fps=4)
        if own_writer:
            writer.close()
    return {"epe": mean_epe, "num_frames": len(out["flow12"]),
            "flow_path": vw.path, "occl_path": occl_path}


def interpolate_frames(cfg: FlowConfig, media: flow_media.FlowMedia, spec,
                       params, consts, factor: int = 2, ctrl_cfg=None,
                       ctrl_state=None) -> np.ndarray:
    """Temporal upsampling: ``factor - 1`` softsplat mid-frames
    (:func:`train.flow.frame_interp`) between every adjacent pair, the
    input frames kept. Returns (F, H, W, 3) uint8 frames, F = (N - 1)
    factor + 1."""
    if factor < 2:
        raise ValueError(f"factor must be >= 2, got {factor}")
    device = resolve_device(cfg.device)
    video, times = media.video, media.times
    scale = float(np.float32(media.flow_scale))
    to_u8 = lambda f: (np.clip(f, 0.0, 1.0) * 255).astype(np.uint8)
    frames_out = []
    for i in range(len(video) - 1):
        pair = torch.from_numpy(video[i:i + 2]).to(device)
        frames_out.append(to_u8(video[i]))
        for k in range(1, factor):
            mid = FT.frame_interp(spec, cfg, params, consts, float(times[i]),
                                  pair, k / factor, scale, ctrl_cfg,
                                  ctrl_state)
            frames_out.append(to_u8(torch.clamp(mid, 0.0, 1.0).cpu().numpy()))
    frames_out.append(to_u8(video[-1]))
    return np.stack(frames_out)


def run_flow_interpolate(cfg: FlowConfig, factor: int = 2, media=None,
                         scene: str = "scene") -> Dict:
    """``flow interpolate``: the interleaved (N - 1) factor + 1 frame video
    as a GIF, with a JSON sidecar."""
    resolve_device(cfg.device)
    if media is None:
        _, media, scene = flow_media.get_video(
            cfg.input_video, cfg.size, cfg.test_size, cfg.end, cfg.step,
            flow_dir=cfg.flow_dir)
    cfg, _ = _load_window_bounds(cfg, flow_ckpt_dir(cfg, scene),
                                 *media.video.shape[1:3])
    cfg = _inference_bounds(cfg)
    init = R.named_fold(R.root_generator(cfg.random_seed), "init")
    spec, params, consts, _, _, ctrl_cfg, ctrl_state = \
        _flow_create_and_restore(
            cfg, init, scene, require=f"no checkpoint for scene {scene}")
    frames = interpolate_frames(cfg, media, spec, params, consts, factor,
                                ctrl_cfg, ctrl_state)

    os.makedirs(cfg.results_dir, exist_ok=True)
    tag = f"{scene}_{cfg.name}"
    with VideoWriter(path.join(cfg.results_dir,
                               f"interp_{tag}_x{factor}.gif"),
                     fps=4 * factor) as vw:
        for f in frames:
            vw.add(f)
    import json
    with open(path.join(cfg.results_dir, f"interp_{tag}_x{factor}.json"),
              "w") as fh:
        json.dump({"scene": scene, "name": cfg.name, "factor": factor,
                   "frames_in": int(len(media.video)),
                   "frames_out": len(frames)}, fh)
    return {"path": vw.path, "num_frames": len(frames)}


def run_flow_export(cfg: FlowConfig, out: Optional[str] = None) -> str:
    """``flow export``: the scene's latest checkpoint (or, without one, the
    ``--import-torch`` weights) as a reference-loadable torch state_dict,
    the reverse of ``--import-torch``; the controller mask leaves as the
    reference's stashed counts. Returns the file's path."""
    from sin_inn_tpu_torch.models import torch_import as TI

    # the scene's name only: no frame is read
    scene = path.splitext(path.basename(cfg.input_video))[0]
    init = R.named_fold(R.root_generator(cfg.random_seed), "init")
    spec, params, consts, store, _, _, ctrl_state = _flow_create_and_restore(
        cfg, init, scene, require=f"no checkpoint for scene {scene}")
    out = out or path.join(store.directory, f"{cfg.name}_export.ckpt")
    return TI.save_reference_checkpoint(
        out, TI.export_flow_state_dict(spec, ctrl_state, params, consts))


def normalized_aepe(results) -> float:
    """The dataset's average end-point error: each scene's mean EPE
    (``run_flow_test``'s ``epe``) weighted by its ``num_frames``."""
    results = list(results)
    frames = sum(r["num_frames"] for r in results)
    return sum(r["epe"] * r["num_frames"] for r in results) / max(frames, 1)


def run_flow_summarize(cfg: FlowConfig) -> float:
    """``flow summarize``: ``flow test`` on every scene beside
    ``input_video`` (its parent directory's entries, in order), then the
    frame-weighted AEPE over them (:func:`normalized_aepe`), printed and
    returned. The per-scene results come from the metadata, never from
    file names."""
    root = path.dirname(cfg.input_video)
    results = []
    for scene in sorted(os.listdir(root)):
        results.append(run_flow_test(cfg.replace(
            input_video=path.join(root, scene),
            flow_dir=_scene_flow_dir(cfg.flow_dir, scene))))
    aepe = normalized_aepe(results)
    print(f"Normalized AEPE: {aepe}")
    return aepe


def sintel_scene_flows(cfg: FlowConfig, media: flow_media.FlowMedia, spec,
                       params, consts, ctrl_cfg=None, ctrl_state=None,
                       outdir: Optional[str] = None) -> np.ndarray:
    """The flow of every frame pair of ``media``, one pair per INR query,
    as (P, H, W, 2) float32; with ``outdir`` each is also written there as
    ``frame_%04d.flo`` (Sintel's submission layout)."""
    device = resolve_device(cfg.device)
    h, w = media.video.shape[1:3]
    if outdir is not None:
        os.makedirs(outdir, exist_ok=True)
    flows = []
    for i, batch in enumerate(media.batches(1)):
        f12, _ = FT.flow_infer(spec, params, consts,
                               torch.from_numpy(batch["times"]).to(device),
                               float(batch["scale"]), h, w, ctrl_cfg,
                               ctrl_state)
        flows.append(f12[0].cpu().numpy())
        if outdir is not None:
            write_flo(path.join(outdir, f"frame_{i + 1:04d}.flo"), flows[-1])
    return np.stack(flows)


def run_flow_sintel(cfg: FlowConfig,
                    outroot: str = "sintel_submission") -> str:
    """``flow sintel``: the Sintel submission. For every scene beside
    ``input_video``, its checkpoint (or, without one, the ``--import-torch``
    weights) renders each pair's flow into
    ``<outroot>/<clean|final>/<scene>/frame_%04d.flo`` (``clean`` when the
    run's ``--name`` ends in it). Returns the submission's directory."""
    resolve_device(cfg.device)
    root = path.dirname(cfg.input_video)
    sub = path.join(outroot, "clean" if cfg.name.endswith("clean")
                    else "final")
    for scene in sorted(os.listdir(root)):
        scene_cfg = cfg.replace(input_video=path.join(root, scene),
                                flow_dir=_scene_flow_dir(cfg.flow_dir, scene))
        _, media, name = flow_media.get_video(
            scene_cfg.input_video, cfg.size, cfg.test_size, cfg.end, cfg.step,
            flow_dir=scene_cfg.flow_dir)
        spec, params, consts, _, _, ctrl_cfg, ctrl_state = \
            _flow_create_and_restore(
                scene_cfg, R.named_fold(R.root_generator(cfg.random_seed),
                                        "init"),
                name, require=f"no checkpoint for {name}")
        sintel_scene_flows(scene_cfg, media, spec, params, consts, ctrl_cfg,
                           ctrl_state, outdir=path.join(sub, name))
    return sub
