#!/usr/bin/env python3
"""Convergence checks of the PyTorch port (``sin_inn_tpu_torch``), on the
card by default. The port's counterpart of ``tools/validate.py`` and
``tools/loop_check.py``; it imports nothing of JAX or of the JAX package.

    python3 tools/validate_torch.py sr   [--epochs 60] [--arch SRF]
    python3 tools/validate_torch.py flow [--iters 1500] [--net RBF]
        [--fixture shift|rotation|zoom|occlusion] [--magnitude 2]
        [--splat-max-dy 64] [--splat-max-dx 128] [--splat-local-dy off]
        [--spatial] [--scale 1] [--use-kernel auto|off]
    python3 tools/validate_torch.py loop [--epochs 30] [--no-gt] [--dir D]
        [--size 436]

Every subcommand takes ``--seed`` (0) and ``--device`` (``cuda``; without
a card it raises unless ``--device cpu`` is given; nothing falls back). On
the card the kernels are built first, one nvcc per source in parallel.

- ``sr``: SRF 4x (4 couplings, LR window 10, batch 8) on a 360x640
  synthetic moving-texture video, ``train/sr.py``'s train and eval steps;
  a milestone every ``epochs // 6`` epochs (train loss, val HR-PSNR).
- ``flow``: the INR at Sintel size (436x1024) on 4 frames of an
  analytic-GT fixture (the shift: a 2 px/frame crop of a moving texture;
  the others from ``data/synthetic.py`` ``synthetic_flow_sequence``), all 3
  pairs a step, flow scale 1, LAMB lr 3e-3; ``train/flow.py``'s train step;
  10 milestones (EPE against the GT, warp PSNR).
- ``loop``: ``train/loop.py`` ``run_flow_train`` on a 4-frame 2 px shift
  (RBF, bfloat16, the batch all pairs): the GT window probe, the monitor,
  the refit, the sidecar and the checkpoints; frames/s, final loss, EPE,
  the refitted bounds, whether the sidecar was written.

Each prints one JSON line per milestone, then a summary line with the keys
of the JAX tools and ``device``, ``card`` (nvidia-smi's name and power
limit), ``launches`` (the port's kernel launches in one train step),
``band`` and ``within_band`` (the acceptance band of the run's
configuration, None off the table below, which holds each band for the
full-size run of that configuration):

- flow shift, RBF, static windows: the median of the milestones from
  iteration 300 on <= 0.05 px, and the last <= 0.05;
- flow shift, RBF, local windows: last <= 0.05; flow shift, PFF spatial:
  last <= 0.06;
- rotation 3 deg/frame: last <= 0.66; zoom 4 %/frame: last <= 0.44;
  occluder 3 px/frame: last <= 0.036 (RBF, static windows);
- sr, SRF float32 on the smooth texture: the milestone losses monotone,
  the last <= 0.028, the last val HR-PSNR >= 17.8 dB;
- loop: finite loss (and EPE with GT), the sidecar written.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sin_inn_tpu_torch.core import rng as R  # noqa: E402
from sin_inn_tpu_torch.core.device import resolve_device  # noqa: E402

SINTEL = (436, 1024)
SR_HR = (360, 640)
# (fixture, magnitude or None for any, net, spatial, local windows) ->
# the last EPE's limit
FLOW_BANDS = {
    ("shift", None, "RBF", False, False): 0.05,
    ("shift", None, "RBF", False, True): 0.05,
    ("shift", None, "PFF", True, False): 0.06,
    ("rotation", 3.0, "RBF", False, False): 0.66,
    ("zoom", 4.0, "RBF", False, False): 0.44,
    ("occlusion", 3.0, "RBF", False, False): 0.036,
}
SHIFT_MEDIAN_FROM = 300      # the static shift band's median starts here


def _kernel_modules():
    from sin_inn_tpu_torch.ops.cuda import coupling as K
    from sin_inn_tpu_torch.ops.cuda import coupling3x3 as K8
    from sin_inn_tpu_torch.ops.cuda import gather as K6
    from sin_inn_tpu_torch.ops.cuda import inr as K7
    from sin_inn_tpu_torch.ops.cuda import splat as K5

    return K, K5, K6, K7, K8


def launch_counts() -> dict:
    """Every kernel's launch counter."""
    counts = {}
    for mod in _kernel_modules():
        counts.update(mod.launch_counts())
    return counts


def counted(fn):
    """(fn(), the kernels it launched, 0s omitted). The counters are read,
    not reset, so a caller's count of a whole run stays whole."""
    before = launch_counts()
    out = fn()
    return out, {k: v - before[k] for k, v in launch_counts().items()
                 if v != before[k]}


def prepare_device(device: str) -> dict:
    """Resolve ``device`` (raises for CUDA without a card), build the
    kernels there, and return the run's ``device`` / ``card`` keys."""
    dev = resolve_device(device)
    out = {"device": str(dev), "card": None}
    if dev.type == "cuda":
        from sin_inn_tpu_torch.ops.cuda import _build

        t0 = time.perf_counter()
        _build.build_all()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        out["card"] = smi.stdout.strip().splitlines()[dev.index or 0]
        out["kind"] = torch.cuda.get_device_name(dev)
        out["build_s"] = round(time.perf_counter() - t0, 1)
    return out


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _emit(row: dict, out=None) -> None:
    print(json.dumps(row), file=out or sys.stdout, flush=True)


# ---------------------------------------------------------------------------
# sr
# ---------------------------------------------------------------------------

def sr_band(r: dict):
    """(text, ok) of an sr run's band, (None, None) off the table."""
    if ((r["arch"], r["dtype"], r["texture"], tuple(r["size"]))
            != ("SRF", "float32", "smooth", SR_HR)):
        return None, None
    ok = (r["monotone"] and r["loss_traj"][-1] <= 0.028
          and r["psnr_traj"][-1] >= 17.8)
    return ("loss monotone over the milestones, last <= 0.028; "
            "val HR-PSNR last >= 17.8 dB"), ok


def validate_sr(epochs: int, arch: str = "SRF",
                compute_dtype: str = "float32", texture: str = "smooth",
                use_kernel: str = "auto", seed: int = 0,
                device: str = "cuda", h: int = SR_HR[0], w: int = SR_HR[1],
                out=None) -> dict:
    """Train the SR flagship config for ``epochs`` epochs; a milestone (the
    last step's loss, the val HR-PSNR of the first val batch under one
    fixed z) every ``epochs // 6`` epochs and at the last."""
    from sin_inn_tpu_torch.core.config import SRConfig
    from sin_inn_tpu_torch.data.sr_video import make_datasets, to_device
    from sin_inn_tpu_torch.data.synthetic import synthetic_sr_video
    from sin_inn_tpu_torch.train import sr as SR

    info = prepare_device(device)
    dev = torch.device(info["device"])
    cfg = SRConfig(architecture=arch, scale=4, num_coupling=4, lr_window=10,
                   batch_size=8, epochs=epochs, compute_dtype=compute_dtype,
                   use_kernel=use_kernel, device=device, random_seed=seed)
    video = synthetic_sr_video(cfg, h=h, w=w, texture=texture)
    root = R.root_generator(seed)
    spec, state = SR.create_train_state(R.named_fold(root, "init"), cfg)
    step = SR.make_train_step(spec, cfg)
    eval_step = SR.make_eval_step(spec, cfg)
    sup, _, val = make_datasets(video, cfg)
    cached = sup.device_cache(cfg.batch_size, dev)
    val_batch = to_device(next(iter(val.batches(cfg.val_batch_size))), dev)
    dev_root = R.root_generator(seed, dev)
    train_gen = R.named_fold(dev_root, "train")
    stride = max(epochs // 6, 1)
    losses, psnrs, walls = [], [], []
    launches = None
    frames = 0
    _sync(dev)
    t0 = time.time()
    for epoch in range(epochs):
        for batch in cached:
            frames += int(batch["hr"].shape[0])
            if launches is None:
                aux, launches = counted(
                    lambda: step(state, batch, None, train_gen))
            else:
                aux = step(state, batch, None, train_gen)
        if (epoch + 1) % stride == 0 or epoch == epochs - 1:
            # the same z at every milestone: a fresh fold of one name
            em = eval_step(state.params, val_batch,
                           R.named_fold(dev_root, "val"))
            losses.append(float(aux["loss"]))
            psnrs.append(float(em["hr_psnr"]))
            walls.append(time.time() - t0)
            _emit({"check": "sr_convergence", "epoch": epoch + 1,
                   "loss": losses[-1], "hr_psnr": psnrs[-1],
                   "wall_s": round(walls[-1], 1)}, out)
    wall = time.time() - t0
    r = {"check": "sr_convergence", "arch": arch, "dtype": compute_dtype,
         "texture": texture, "epochs": epochs, "seed": seed,
         "use_kernel": use_kernel, "size": [h, w],
         "loss_traj": losses, "hr_psnr": psnrs[-1], "psnr_traj": psnrs,
         "monotone": all(a >= b for a, b in zip(losses, losses[1:])),
         "milestone_stride": stride, "steps": state.step,
         "frames_per_sec": frames / wall,
         "wall_s": round(wall, 1), **info, "launches": launches}
    r["band"], r["within_band"] = sr_band(r)
    return r


# ---------------------------------------------------------------------------
# flow
# ---------------------------------------------------------------------------

def flow_band(r: dict):
    """(text, ok) of a flow run's band, (None, None) off the table."""
    if tuple(r["size"]) != SINTEL or r["scale"] != 1.0:
        return None, None
    local = r["splat_local_dy"] not in ("off", None)
    limit = None
    for (fix, mag, net, spatial, loc), lim in FLOW_BANDS.items():
        if ((fix, net, spatial, loc)
                == (r["fixture"], r["net"], r["spatial"], local)
                and mag in (None, r["magnitude"])):
            limit = lim
    if limit is None:
        return None, None
    text = f"last <= {limit}"
    ok = r["epe"] <= limit
    if (r["fixture"], r["net"], r["spatial"], local) == (
            "shift", "RBF", False, False):
        late = [e for i, e in zip(r["milestone_iters"], r["epe_traj"])
                if i >= SHIFT_MEDIAN_FROM]
        text = (f"median of the milestones from iteration "
                f"{SHIFT_MEDIAN_FROM} on <= {limit}, and last <= {limit}")
        ok = ok and bool(late) and statistics.median(late) <= limit
    return text, ok


def flow_fixture(fixture: str, h: int, w: int, nf: int = 4,
                 magnitude: float = 2.0):
    """(frames (nf, h, w, 3), gt (nf - 1, h, w, 2)) of ``tools/validate.py``
    ``validate_flow``: the shift is a 2 px/frame crop of one moving-texture
    frame (``magnitude`` unused), the others ``synthetic_flow_sequence``."""
    from sin_inn_tpu_torch.data.synthetic import (moving_texture_video,
                                                  synthetic_flow_sequence)
    if fixture == "shift":
        base = moving_texture_video(1, h, w + 2 * nf + 2, seed=3)[0]
        frames = np.stack([base[:, 2 * i:2 * i + w] for i in range(nf)])
        gt = np.zeros((nf - 1, h, w, 2), np.float32)
        gt[..., 0] = -2.0
        return frames, gt
    return synthetic_flow_sequence(fixture, nf, h, w, seed=3,
                                   magnitude=magnitude)


def validate_flow(iters: int, net: str = "RBF", splat_max_dy: int = 64,
                  splat_max_dx: int = 128, use_kernel: str = "auto",
                  scale: float = 1.0, spatial: bool = False,
                  splat_local_dy="off", fixture: str = "shift",
                  magnitude: float = 2.0, seed: int = 0,
                  device: str = "cuda", h: int = SINTEL[0],
                  w: int = SINTEL[1], out=None, **cfg_kw) -> dict:
    """Train the flow INR on the fixture for ``iters`` steps after one
    step that measures the initial EPE; 10 milestones. ``cfg_kw``: further
    ``FlowConfig`` fields (the tests' narrow nets)."""
    from sin_inn_tpu_torch.core.config import FlowConfig
    from sin_inn_tpu_torch.train import flow as FT

    info = prepare_device(device)
    dev = torch.device(info["device"])
    frames, gt = flow_fixture(fixture, h, w, magnitude=magnitude)
    b = frames.shape[0] - 1
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    batch = {"frame1": t(frames[:-1]), "frame2": t(frames[1:]),
             "times": torch.linspace(-1, 1, b, device=dev),
             "scale": float(scale), "gt_flow": t(gt)}
    cfg = FlowConfig(net=net, epochs=iters, lr=3e-3,
                     splat_max_dy=splat_max_dy, splat_chunk=2,
                     splat_max_dx=splat_max_dx or None,
                     splat_local_dy=splat_local_dy, use_kernel=use_kernel,
                     spatially_adaptive=spatial, device=device,
                     random_seed=seed, **cfg_kw).resolve_splat_bounds(h, w)
    spec, state, consts = FT.create_flow_state(
        R.named_fold(R.root_generator(seed), "init"), cfg)
    step = FT.make_flow_train_step(spec, cfg)
    m, launches = counted(lambda: step(state, consts, batch))
    epe0 = float(m["epe"])
    stride = max(iters // 10, 1)
    its, epe_traj, psnr_traj = [], [], []
    _sync(dev)
    t0 = time.time()
    for i in range(iters):
        m = step(state, consts, batch)
        if (i + 1) % stride == 0 or i == iters - 1:
            its.append(i + 1)
            epe_traj.append(float(m["epe"]))
            psnr_traj.append(float(m["psnr"]))
            _emit({"check": "flow_convergence", "iter": i + 1,
                   "epe": epe_traj[-1], "psnr": psnr_traj[-1],
                   "wall_s": round(time.time() - t0, 1)}, out)
    _sync(dev)
    wall = time.time() - t0
    r = {"check": "flow_convergence", "net": net, "iters": iters,
         "fixture": fixture, "magnitude": magnitude,
         "use_kernel": use_kernel, "scale": scale, "spatial": spatial,
         "splat_local_dy": splat_local_dy, "seed": seed, "size": [h, w],
         "bounds": {k: getattr(cfg, k) for k in FlowConfig.WINDOW_BOUND_KEYS},
         "epe0": epe0, "epe": epe_traj[-1], "psnr": psnr_traj[-1],
         "epe_traj": epe_traj, "psnr_traj": psnr_traj,
         "milestone_stride": stride, "milestone_iters": its,
         "frames_per_sec": b * iters / wall, "wall_s": round(wall, 1),
         **info, "launches": launches}
    r["band"], r["within_band"] = flow_band(r)
    return r


# ---------------------------------------------------------------------------
# loop
# ---------------------------------------------------------------------------

def synthetic_media(n=4, h=436, w=1024, dx=-2.0, blur=9):
    """Shift sequence with uniform GT flow (``tools/loop_check.py``'s)."""
    rng = np.random.RandomState(0)
    big = rng.rand(h, w + 64, 3).astype(np.float32)
    k = np.ones(blur, np.float32) / blur
    for ax in (0, 1):
        big = np.apply_along_axis(
            lambda v: np.convolve(v, k, mode="same"), ax, big)
    frames = np.stack([big[:, 32 + int(i * -dx): 32 + int(i * -dx) + w]
                       for i in range(n)])
    flow = np.zeros((n - 1, h, w, 2), np.float32)
    flow[..., 0] = dx
    return frames, flow


def loop_size(size: int):
    """(h, w): Sintel's 436x1024, else the width at its aspect, a multiple
    of 128 (``tools/loop_check.py``'s rule)."""
    if size == SINTEL[0]:
        return SINTEL
    return size, max(128, int(size * 1024 / 436) // 128 * 128)


def loop_check(epochs: int = 30, size: int = SINTEL[0], gt: bool = True,
               directory=None, seed: int = 0, device: str = "cuda",
               out=None, **cfg_kw) -> dict:
    """``run_flow_train`` end to end on the shift media; then one more step
    at the effective (refitted) bounds, whose launches are reported."""
    from sin_inn_tpu_torch.core.config import FlowConfig
    from sin_inn_tpu_torch.data.flow_media import FlowMedia
    from sin_inn_tpu_torch.train import flow as FT
    from sin_inn_tpu_torch.train.loop import _to_device_batch, run_flow_train

    info = prepare_device(device)
    h, w = loop_size(size)
    frames, flow = synthetic_media(h=h, w=w)
    media = FlowMedia(frames, flow if gt else None)
    tmp = directory or tempfile.mkdtemp(prefix="validate_torch_loop_")
    cfg = FlowConfig(net="RBF", epochs=epochs, lr=3e-3, batch=len(media),
                     compute_dtype="bfloat16", device=device,
                     random_seed=seed,
                     checkpoints_dir=os.path.join(tmp, "ck"),
                     results_dir=os.path.join(tmp, "res"),
                     val_iter=10 ** 9, **cfg_kw)
    t0 = time.time()
    res = run_flow_train(cfg, media=media, scene="loopcheck")
    wall = time.time() - t0
    eff = res["cfg"]
    ckpt = os.path.join(cfg.checkpoints_dir, "loopcheck", cfg.name)
    with open(os.path.join(ckpt, f"loopcheck_{cfg.name}.metrics.jsonl")) as f:
        for line in f:
            _emit({"check": "flow_loop_e2e", **json.loads(line)}, out)
    batch = _to_device_batch(next(iter(media.batches(cfg.batch))),
                             torch.device(info["device"]))
    _, launches = counted(lambda: FT.make_flow_train_step(res["spec"], eff)(
        res["state"], res["consts"], batch))
    m = res["metrics"]
    r = {"check": "flow_loop_e2e", "epochs": epochs, "size": [h, w],
         "gt": gt, "seed": seed, "wall_s": round(wall, 1),
         "frames_per_sec": m.get("frames_per_sec", 0.0),
         "final_loss": m.get("loss", float("nan")),
         "epe": m.get("epe", -1.0),
         "bounds": {k: getattr(eff, k) for k in FlowConfig.WINDOW_BOUND_KEYS},
         "sidecar": os.path.exists(os.path.join(ckpt, "window_bounds.json")),
         **info, "launches": launches}
    r["band"] = "finite loss (and EPE with GT), sidecar written"
    r["within_band"] = (math.isfinite(r["final_loss"]) and r["sidecar"]
                        and (not gt or math.isfinite(r["epe"])))
    return r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="pipeline", required=True)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--seed", type=int, default=0)
    common.add_argument("--device", default="cuda",
                        help="'cuda' (default; raises without a card) or "
                             "'cpu'")
    common.add_argument("--use-kernel", default="auto",
                        choices=["auto", "off"],
                        help="the fused and windowed kernels, or the plain "
                             "PyTorch route")
    p = sub.add_parser("sr", parents=[common])
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--arch", choices=["SRF", "IRN"], default="SRF")
    p.add_argument("--compute-dtype", default="float32",
                   choices=["float32", "bfloat16", "float32_highest"])
    p.add_argument("--texture", default="smooth",
                   choices=["smooth", "natural"],
                   help="HR texture statistics (natural = 1/f)")
    p = sub.add_parser("flow", parents=[common])
    p.add_argument("--iters", type=int, default=1500)
    p.add_argument("--net", default="RBF")
    p.add_argument("--splat-max-dy", type=int, default=64)
    p.add_argument("--splat-max-dx", type=int, default=128)
    p.add_argument("--splat-local-dy", default="off",
                   help="local-window row bound: 'auto', 'off' or an int")
    p.add_argument("--scale", type=float, default=1.0,
                   help="output scale (the trainer uses W/5)")
    p.add_argument("--spatial", action="store_true")
    p.add_argument("--fixture", default="shift",
                   choices=["shift", "rotation", "zoom", "occlusion"])
    p.add_argument("--magnitude", type=float, default=2.0,
                   help="fixture magnitude (px, deg, or %% per frame)")
    p = sub.add_parser("loop", parents=[common])
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--size", type=int, default=SINTEL[0])
    p.add_argument("--no-gt", action="store_true",
                   help="no GT flow: the refit-only path")
    p.add_argument("--dir", default=None,
                   help="work directory; a second run resumes from the "
                        "first's checkpoint and window-bounds sidecar")
    args = ap.parse_args(argv)
    common_kw = dict(seed=args.seed, device=args.device)
    if args.pipeline == "sr":
        r = validate_sr(args.epochs, args.arch, args.compute_dtype,
                        texture=args.texture, use_kernel=args.use_kernel,
                        **common_kw)
    elif args.pipeline == "flow":
        ldy = args.splat_local_dy
        if ldy not in ("auto", "off"):
            ldy = int(ldy)
        r = validate_flow(args.iters, args.net, args.splat_max_dy,
                          args.splat_max_dx, use_kernel=args.use_kernel,
                          scale=args.scale, spatial=args.spatial,
                          splat_local_dy=ldy, fixture=args.fixture,
                          magnitude=args.magnitude, **common_kw)
    else:
        r = loop_check(args.epochs, args.size, gt=not args.no_gt,
                       directory=args.dir, use_kernel=args.use_kernel,
                       **common_kw)
    _emit(r)
    return 0


if __name__ == "__main__":
    sys.exit(main())
