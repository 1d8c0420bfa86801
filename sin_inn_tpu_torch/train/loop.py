"""Entry points: SR (``sr train``, ``sr test``) and flow (``flow train``,
``flow test``, ``flow interpolate``).

Counterpart of ``sin_inn_tpu/train/loop.py`` on one device: for SR,
``sr_dirs``, ``_sr_create_and_restore``, ``run_sr_train`` and
``run_sr_test``; for flow, ``flow_ckpt_dir``, ``_flow_create_and_restore``,
the window-bound sidecar (``_save_window_bounds``, and
``_load_window_bounds``, which also holds the reference's
``_inference_bounds`` rule), ``run_flow_train``, ``run_flow_test`` and
``run_flow_interpolate``. The frame loops are factored out as in-memory
cores (:func:`sr_test_frames`, :func:`flow_test_outputs`,
:func:`interpolate_frames`) that return numpy arrays and uint8 frames
without touching imageio or ffmpeg. ``run_flow_train`` trains on the static
global windows: the GT-flow probe of the window bounds, their mid-training
refit and the pseudo-GT producers are not ported, nor are the mesh, tuner,
profiler and ``--import-torch`` branches, ``sr export`` and ``flow
{export,summarize,sintel}``.
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
from sin_inn_tpu_torch.data import flow_media
from sin_inn_tpu_torch.data.flow_viz import flow_to_image
from sin_inn_tpu_torch.data.sr_video import (SRVideo, make_datasets,
                                             prefetch_to_device, to_device)
from sin_inn_tpu_torch.io.video_io import VideoWriter
from sin_inn_tpu_torch.models import controllers as C
from sin_inn_tpu_torch.models.inr import flat_leaves
from sin_inn_tpu_torch.ops.occlusion import OCCLUSIONS
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
    """The config's INR with its controller, and the latest checkpoint of
    ``flow_ckpt_dir`` shape-checked against them. Returns (spec, params,
    consts, ctrl_cfg, ctrl_state, store, restored or None, step); the
    controller state is the checkpoint's when there is a checkpoint."""
    device = resolve_device(cfg.device)
    store = CheckpointStore(flow_ckpt_dir(cfg, scene))
    spec, params, consts, ctrl_cfg, ctrl_state = FT.build_flow_model(
        init_gen, cfg, device)
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
    message) makes a missing checkpoint fatal. Returns (spec, params,
    consts, store, step, ctrl_cfg, ctrl_state)."""
    (spec, params, consts, ctrl_cfg, ctrl_state, store, restored,
     step) = _flow_restore(cfg, init_gen, scene)
    if restored is not None:
        return (spec, restored["params"], restored["consts"], store,
                int(step), ctrl_cfg, ctrl_state)
    if require:
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


_LOCAL_BOUND_KEYS = ("splat_local_dy", "splat_local_dx")


def _save_window_bounds(directory: str, cfg: FlowConfig, fh: int,
                        fw: int) -> None:
    """Write the run's effective window bounds beside its checkpoints
    (``window_bounds.json``), so that a resume and a later ``flow test`` or
    ``flow interpolate`` at the same frame size use the windows the net was
    trained on. The local bounds are written as null: this run trained on
    the global windows."""
    import json
    with open(path.join(directory, "window_bounds.json"), "w") as f:
        json.dump({"fh": fh, "fw": fw,
                   **{k: getattr(cfg, k) for k in FlowConfig.WINDOW_BOUND_KEYS},
                   **{k: None for k in _LOCAL_BOUND_KEYS}, "hist": {}}, f)


def _load_window_bounds(cfg: FlowConfig, directory: str, fh: int,
                        fw: int) -> Tuple[FlowConfig, bool]:
    """Apply the training run's effective window bounds
    (``window_bounds.json`` beside the checkpoints) to every bound still on
    'auto'; an explicit value given now wins. Bounds are pixels at the
    train frame size, so another size ignores them. A run that trained on
    local windows (a non-null local bound in the sidecar) is refused: the
    static windows would compute another function. Without a sidecar no
    local window engages, as in the reference's ``_inference_bounds``.
    Returns (cfg, sidecar_found_and_valid)."""
    import json
    p = path.join(directory, "window_bounds.json")
    if not path.exists(p):
        return cfg, False
    try:
        with open(p) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return cfg, False
    if (data.get("fh"), data.get("fw")) != (fh, fw):
        return cfg, False
    local = {k: data[k] for k in _LOCAL_BOUND_KEYS if data.get(k)}
    if local:
        raise NotImplementedError(
            f"{p} names local windows {local}: slice B2 (the local-window "
            "kernels are not ported yet)")
    upd = {k: data[k] for k in FlowConfig.WINDOW_BOUND_KEYS
           if k in data and getattr(cfg, k) == "auto"}
    return (cfg.replace(**upd) if upd else cfg), True


def _to_device_batch(batch: Dict[str, np.ndarray], device) -> Dict:
    """A media batch on ``device``; ``scale`` stays a Python float."""
    return {k: (float(v) if k == "scale" else torch.from_numpy(v).to(device))
            for k, v in batch.items()}


def run_flow_train(cfg: FlowConfig, media=None, scene: str = "scene",
                   use_wandb: bool = False, val_media=None,
                   keep_writer: bool = False) -> Dict:
    """``flow train`` on one device: fit the config's INR to the video's
    flow with the photometric loss and LAMB.

    The frame-pair batches are placed on the device once and replayed every
    epoch in a seeded permutation. At the ``val_iter`` cadence (off by
    default) and at the last epoch the step's metrics and pairs/s are
    logged, with the validation EPE when the val media has GT flow (summed
    on the device, one scalar read). A checkpoint (``{"params", "consts",
    "opt", "step"}``, and ``"ctrl_state"`` for a progressive net, whose
    controller a resume continues) and the window-bound sidecar are written
    every ``epochs // 100`` epochs, at the last epoch and on SIGTERM/SIGINT; a
    rerun resumes from the latest one. When the flow outgrows the windows
    (whose far taps are dropped) the loop warns once."""
    device = resolve_device(cfg.device)
    if media is None:
        media, val_media, scene = flow_media.get_video(
            cfg.input_video, cfg.size, cfg.test_size, cfg.end, cfg.step,
            flow_dir=cfg.flow_dir)
    fh, fw = media.video.shape[1:3]
    ckpt_dir = flow_ckpt_dir(cfg, scene)
    # a resumed run keeps the bounds it trained on (bounds pinned now win);
    # a fresh run in a reused directory resolves its own
    if CheckpointStore(ckpt_dir).latest_step() is not None:
        cfg, _ = _load_window_bounds(cfg, ckpt_dir, fh, fw)
    cfg = cfg.resolve_splat_bounds(fh, fw)
    root = R.root_generator(cfg.random_seed)
    spec, state, consts, store, start_epoch = _flow_train_create_and_restore(
        cfg, R.named_fold(root, "init"), scene)
    step = FT.make_flow_train_step(spec, cfg)

    writer = MetricsWriter(store.directory, run_name=f"{scene}_{cfg.name}",
                           use_wandb=use_wandb, wandb_project="optical_flow",
                           hyperparams=cfg.__dict__)
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
    stop = GracefulStop().install()
    window_warned = False
    try:
        for epoch in range(start_epoch, cfg.epochs):
            for bi in rng.permutation(len(cached)):
                batch = cached[bi]
                m = step(state, consts, batch)
                pairs_done += int(batch["frame1"].shape[0])
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
                _save_window_bounds(store.directory, cfg, fh, fw)
            if (saved and cfg.splat_max_dy and "flow_max_y" in m
                    and not window_warned):
                fy, fx = float(m["flow_max_y"]), float(m["flow_max_x"])
                dy, dx = cfg.splat_max_dy, cfg.splat_max_dx
                if fy > dy - 1 or (dx is not None and fx > dx - 1):
                    window_warned = True
                    logging.getLogger(__name__).warning(
                        "flow magnitude (|fy| %.1f, |fx| %.1f px) exceeds "
                        "the splat window bounds (dy=%s, dx=%s) at epoch %d: "
                        "taps beyond the window are being dropped. Raise "
                        "--splat-max-dy/--splat-max-dx or pass 'off' for "
                        "the exact scatter.", fy, fx, dy, dx, epoch + 1)
            if stop:
                break
    finally:
        stop.restore()
        if not keep_writer:
            writer.close()
    out = {"state": state, "spec": spec, "consts": consts, "metrics": last,
           "scene": scene, "start_epoch": start_epoch,
           # the effective config: the resolved window bounds
           "cfg": cfg}
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
                  ctrl_state=None) -> Dict:
    """``flow test``: predicted flows (Middlebury colours) and occlusion
    masks of every pair written as GIFs with a JSON sidecar, and the EPE
    against the GT when there is one. Restores the scene's checkpoint
    unless a model is given."""
    resolve_device(cfg.device)
    if media is None:
        _, media, scene = flow_media.get_video(
            cfg.input_video, cfg.size, cfg.test_size, cfg.end, cfg.step,
            flow_dir=cfg.flow_dir)
    cfg, _ = _load_window_bounds(cfg, flow_ckpt_dir(cfg, scene),
                                 *media.video.shape[1:3])
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
    with VideoWriter(path.join(cfg.results_dir,
                               f"flow_{tag}_epe_{mean_epe:.3f}.gif"),
                     fps=4) as vw:
        for f in out["flow12"]:
            vw.add(flow_to_image(f))
    import json
    with open(path.join(cfg.results_dir, f"flow_{tag}.json"), "w") as fh:
        json.dump({"epe": mean_epe, "frames": len(out["flow12"]),
                   "scene": scene, "name": cfg.name}, fh)
    occl_path = None
    if out["masks"] is not None:
        with VideoWriter(path.join(cfg.results_dir, f"occl_{tag}.gif"),
                         fps=4) as ow:
            for m in out["masks"]:
                ow.add((m.repeat(3, -1) * 255).astype(np.uint8))
        occl_path = ow.path
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
