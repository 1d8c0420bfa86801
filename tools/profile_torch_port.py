#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's SRF paths, on one card.

    python3 tools/profile_torch_port.py [--train | --flow | --flow-train]
                                        [--net NET] [--spatially-adaptive]
                                        [--splat-local-dy B]
                                        [--match REGEX]
                                        [--batches N] [--out DIR]

Builds the kernels, makes a seeded flagship SRF state (SRConfig defaults:
scale 4, lr_window 10, 4 couplings, hidden 256) and random uint8 batches at
HR 352x640, then on ``cuda`` in the ``float32`` mode:

* serving (default): batches of 40 windows; times the infer step
  (``sr test``) and the eval step with CUDA events (median of N after a
  warm-up);
* ``--train``: batches of 8 windows; times the train step (loss, backward,
  Adam) the same way;
* ``--flow``: instead of the SRF paths, the flow serving path at Sintel
  size (436x1024) with a seeded full-width ``RBF`` INR (FlowConfig
  defaults): one ``flow test`` pair (the INR query and the Wang occlusion
  map) and one interpolated mid-frame (``frame_interp`` at alpha 0.5);
* ``--flow-train``: one ``flow train`` step at Sintel size (batch 1, the
  ``RBF`` net, Wang occlusion, bounds dy 64, dx 128, local dy 32; loss,
  backward, LAMB) on the kernel route and with ``use_kernel="off"`` (the
  windowed forms), each with its peak memory and the memory held between
  the forward and the backward, and the window offsets of one flow
  (``tile_flow_offsets``) on their own; ``--splat-local-dy`` passes
  through to the config (``off``: the static windows), so that two runs in
  one command set the local and the static routes side by side;
* ``--net`` and ``--spatially-adaptive`` choose the INR and its controller
  for ``--flow`` and ``--flow-train`` (default ``RBF``; ``--net PFF
  --spatially-adaptive`` is the progressive path, whose train step carries
  the controller's transition and whose serving starts from a seeded
  controller state that is not the initial one);
* traces one step of each with ``torch.profiler`` and prints the device
  time by kernel and by kernel family (the instantiations of one template
  summed), the number of kernel launches and the device's busy share of the
  step's wall time; with ``--match``, every kernel whose name the regular
  expression finds, with its device time a launch (``--train --match
  'row_phase|weight_stage|pack_kernel|reduce_partials'``: the stages of K3
  and K4, ``csrc/coupling_1x1_bwd.cu``, by direction, phase and octave;
  ``--train --match coupling_1x1``: K1 and K2, ``csrc/coupling_1x1.cu``,
  ``coupling_1x1_kernel<T, inverse, tiles>`` by direction (the 24-tile
  instance runs the second octave, the 8-tile one the first); their
  packing kernel is ``pack_kernel``, one row for K1-K4).

Writes the profiler tables to DIR (default ``torch_port_profile``).
"""

from __future__ import annotations

import argparse
import os
import re
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sin_inn_tpu_torch.core import rng as R  # noqa: E402
from sin_inn_tpu_torch.core.config import SRConfig  # noqa: E402
from sin_inn_tpu_torch.core.profiler import settle  # noqa: E402
from sin_inn_tpu_torch.ops.cuda import _build  # noqa: E402
from sin_inn_tpu_torch.ops.cuda import coupling as K  # noqa: E402
from sin_inn_tpu_torch.train import sr as SR  # noqa: E402


def _events_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times), min(times), max(times)


def _profile(name, fn, out_dir, match=None):
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        settle("cuda")
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: the aten:: rows carry their kernels' device time again
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    launches = sum(e.count for e in events)
    table = prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=25)
    with open(os.path.join(out_dir, f"{name}_kernels.txt"), "w") as f:
        f.write(table)
    print(f"[profile] {name}: wall {wall_ms:.3f} ms, device busy "
          f"{device_ms:.3f} ms ({100 * device_ms / wall_ms:.1f}% of wall) "
          f"in {launches} kernel launches")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<4d} {e.key[:90]}")
    # by kernel family: every instantiation of a template summed
    families = {}
    for e in events:
        key = e.key.replace("(anonymous namespace)::", "")
        key = re.split(r"[<(]", re.sub(r"^void ", "", key), maxsplit=1)[0]
        ms, n = families.get(key, (0.0, 0))
        families[key] = (ms + e.self_device_time_total / 1e3, n + e.count)
    for key, (ms, n) in sorted(families.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"[profile]   family {ms:9.3f} ms x{n:<4d} {key[:70]}")
    if match:
        for e in sorted(events, key=lambda e: e.key):
            if re.search(match, e.key):
                ms = e.self_device_time_total / 1e3
                print(f"[profile]   matched {ms:9.3f} ms x{e.count:<4d} "
                      f"({ms / e.count:.4f} ms a launch) {e.key[:90]}")


def _flow(a, dev) -> int:
    import numpy as np

    from sin_inn_tpu_torch.core.config import FlowConfig
    from sin_inn_tpu_torch.data.synthetic import moving_texture_video
    from sin_inn_tpu_torch.ops.cuda import gather as K6
    from sin_inn_tpu_torch.ops.cuda import inr as K7
    from sin_inn_tpu_torch.ops.cuda import splat as K5
    from sin_inn_tpu_torch.ops.occlusion import occlusion_wang
    from sin_inn_tpu_torch.train import flow as FT

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = FlowConfig(device="cuda", net=a.net,
                     spatially_adaptive=a.spatially_adaptive)
    h, w = cfg.size, 1024
    spec, params, consts, ccfg, cstate = FT.build_flow_model(
        R.root_generator(0), cfg, dev)
    if cstate is not None:
        # a mask as training leaves it, not the initial one: seeded values
        cstate = cstate._replace(mask=torch.rand(
            cstate.mask.shape, device=dev,
            generator=torch.Generator(device=dev).manual_seed(1)))
    pair = torch.from_numpy(np.ascontiguousarray(
        moving_texture_video(2, h, w))).to(dev)
    times = torch.tensor([-1.0], device=dev)
    scale = w / 5.0

    def test_pair():
        f12, f21 = FT.flow_infer(spec, params, consts, times, scale, h, w,
                                 ccfg, cstate)
        return occlusion_wang(f12, f21, cfg.occl_thresh)

    steps = (("flow_test_pair", test_pair),
             ("interp_mid_frame", lambda: FT.frame_interp(
                 spec, cfg, params, consts, -1.0, pair, 0.5, scale, ccfg,
                 cstate)))
    for mod in (K5, K6, K7):
        mod.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    print(f"[time] net {cfg.net}, controller "
          f"{type(cstate).__name__ if cstate is not None else 'none'}")
    for name, fn in steps:
        med, lo, hi = _events_ms(fn, a.batches)
        print(f"[time] {name}, 1 x {h}x{w}: median {med:.3f} ms (min "
              f"{lo:.3f}, max {hi:.3f}, {a.batches} runs) = "
              f"{1e3 / med:.1f} per second")
    print(f"[time] launches over the timed runs: {K5.launch_counts()} "
          f"{K6.launch_counts()} {K7.launch_counts()}; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    for name, fn in steps:
        _profile(name, fn, a.out, a.match)
    return 0


def _flow_train(a, dev) -> int:
    import dataclasses

    import numpy as np

    from sin_inn_tpu_torch.core.config import FlowConfig
    from sin_inn_tpu_torch.data.synthetic import moving_texture_video
    from sin_inn_tpu_torch.ops.cuda import gather as K6
    from sin_inn_tpu_torch.ops.cuda import inr as K7
    from sin_inn_tpu_torch.ops.cuda import splat as K5
    from sin_inn_tpu_torch.train import flow as FT

    torch.backends.cuda.matmul.allow_tf32 = False
    h, w = 436, 1024
    cfg = FlowConfig(device="cuda", net=a.net,
                     spatially_adaptive=a.spatially_adaptive,
                     splat_local_dy=a.splat_local_dy
                     ).resolve_splat_bounds(h, w)
    print(f"[bounds] dy {cfg.splat_max_dy}, dx {cfg.splat_max_dx}, local dy "
          f"{cfg.splat_local_dy}, local dx {cfg.splat_local_dx}")
    pair = torch.from_numpy(np.ascontiguousarray(
        moving_texture_video(2, h, w))).to(dev)
    batch = {"frame1": pair[0:1], "frame2": pair[1:2],
             "times": torch.tensor([-1.0], device=dev), "scale": w / 5.0}
    spec, _, _ = FT.create_flow_state(R.root_generator(0), cfg)
    _, _, local = FT._splat_ops(cfg)
    if local is not None:
        flow = 8.0 * torch.randn((1, h, w, 2), device=dev)
        _profile("tile_flow_offsets",
                 lambda: FT._flow_offsets(flow, local), a.out)
    for tag, sp, c in (("flow_train_step", spec, cfg),
                       ("flow_train_step_off",
                        dataclasses.replace(spec, use_kernel="off"),
                        cfg.replace(use_kernel="off"))):
        _, state, consts = FT.create_flow_state(R.root_generator(0), cfg)
        step = FT.make_flow_train_step(sp, c)
        fn = lambda: step(state, consts, batch)
        for mod in (K5, K6, K7):
            mod.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        med, lo, hi = _events_ms(fn, a.batches)
        counts = {**K5.launch_counts(), **K6.launch_counts(),
                  **K7.launch_counts()}
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        # what the graph holds for the backward: allocated after the loss
        # is built, less what is allocated with no graph alive
        state.optimizer.zero_grad(set_to_none=True)
        base = torch.cuda.memory_allocated(dev)
        loss, _ = FT.flow_loss(sp, c, state.params, consts, batch,
                               state.ctrl_cfg, state.ctrl_state)
        held = (torch.cuda.memory_allocated(dev) - base) / 2 ** 30
        del loss
        print(f"[time] {tag} (net {cfg.net}, controller "
              f"{type(state.ctrl_state).__name__}, use_kernel="
              f"{sp.use_kernel}), 1 x {h}x{w}: "
              f"median {med:.3f} ms (min {lo:.3f}, max {hi:.3f}, "
              f"{a.batches} runs) = {1e3 / med:.2f} pairs/s; peak device "
              f"memory {peak:.2f} GiB, held for the backward {held:.2f} "
              f"GiB; launches over {a.batches + 1} steps: {counts}")
        _profile(tag, fn, a.out, a.match)
        del state, step, fn
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=10)
    ap.add_argument("--out", default="torch_port_profile")
    ap.add_argument("--match", default=None,
                    help="print every kernel whose name this regular "
                         "expression finds, with its device time a launch")
    ap.add_argument("--train", action="store_true",
                    help="profile the train step at batch 8")
    ap.add_argument("--flow", action="store_true",
                    help="profile flow test and interpolation at 436x1024")
    ap.add_argument("--flow-train", action="store_true",
                    help="profile a flow train step at 436x1024, both routes")
    ap.add_argument("--net", default="RBF",
                    help="--flow, --flow-train: the INR (RBF, PFF, PRBF, ...)")
    ap.add_argument("--spatially-adaptive", action="store_true",
                    help="--flow, --flow-train: a progressive net's spatial "
                         "controller instead of the linear one")
    ap.add_argument("--splat-local-dy", default="auto",
                    type=lambda v: v if v in ("auto", "off") else int(v),
                    help="--flow-train: the local-window row bound ('auto' "
                         "= 32 at 436x1024, 'off' = the static windows)")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_port: needs a CUDA device", file=sys.stderr)
        return 1
    os.makedirs(a.out, exist_ok=True)
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"[card] {smi}; torch {torch.__version__}")
    _build.build_all()

    if a.flow:
        return _flow(a, dev)
    if a.flow_train:
        return _flow_train(a, dev)
    cfg = SRConfig(device="cuda", compute_dtype="float32")
    if a.train:
        spec, state = SR.create_train_state(R.root_generator(0), cfg)
        b = cfg.batch_size
    else:
        spec, state = SR.create_state(R.root_generator(0), cfg)
        b = cfg.val_batch_size
    gen = torch.Generator(device=dev).manual_seed(1)
    s = 2 * cfg.scale
    hr = torch.randint(0, 256, (b, 352, 640, 3), generator=gen, device=dev,
                       dtype=torch.uint8)
    lr = torch.randint(0, 256, (b, 352 // s, 640 // s, cfg.lr_dims),
                       generator=gen, device=dev, dtype=torch.uint8)
    z_gen = torch.Generator(device=dev).manual_seed(2)
    if a.train:
        train = SR.make_train_step(spec, cfg)
        steps = (("train", lambda: train(state, {"hr": hr, "lr": lr}, None,
                                         z_gen)),)
    else:
        infer = SR.make_infer_step(spec, cfg)
        evals = SR.make_eval_step(spec, cfg)
        steps = (("infer", lambda: infer(state.params, lr, z_gen)),
                 ("eval", lambda: evals(state.params, {"hr": hr, "lr": lr},
                                        z_gen)))

    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    for name, fn in steps:
        med, lo, hi = _events_ms(fn, a.batches)
        print(f"[time] {name} step, batch {b}: median {med:.3f} ms "
              f"(min {lo:.3f}, max {hi:.3f}, {a.batches} runs) = "
              f"{1e3 * b / med:.1f} frames/s")
    print(f"[time] launches over the timed runs: {K.launch_counts()}; peak "
          f"device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f}"
          " GiB")
    for name, fn in steps:
        _profile(name, fn, a.out, a.match)
    return 0


if __name__ == "__main__":
    sys.exit(main())
