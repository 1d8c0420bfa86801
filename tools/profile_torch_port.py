#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's SRF paths, on one card.

    python3 tools/profile_torch_port.py [--train | --flow] [--batches N]
                                        [--out DIR]

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
* traces one step of each with ``torch.profiler`` and prints the device
  time by kernel and the device's busy share of the step's wall time.

Writes the profiler tables to DIR (default ``torch_port_profile``).
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sin_inn_tpu_torch.core import rng as R  # noqa: E402
from sin_inn_tpu_torch.core.config import SRConfig  # noqa: E402
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


def _profile(name, fn, out_dir):
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: the aten:: rows carry their kernels' device time again
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    table = prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=25)
    with open(os.path.join(out_dir, f"{name}_kernels.txt"), "w") as f:
        f.write(table)
    print(f"[profile] {name}: wall {wall_ms:.3f} ms, device busy "
          f"{device_ms:.3f} ms ({100 * device_ms / wall_ms:.1f}% of wall)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<4d} {e.key[:90]}")


def _flow(a, dev) -> int:
    import numpy as np

    from sin_inn_tpu_torch.core.config import FlowConfig
    from sin_inn_tpu_torch.data.synthetic import moving_texture_video
    from sin_inn_tpu_torch.models.inr import build_inr
    from sin_inn_tpu_torch.ops.cuda import gather as K6
    from sin_inn_tpu_torch.ops.cuda import splat as K5
    from sin_inn_tpu_torch.ops.occlusion import occlusion_wang
    from sin_inn_tpu_torch.train import flow as FT

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = FlowConfig(device="cuda")
    h, w = cfg.size, 1024
    spec, params, consts = build_inr(R.root_generator(0), cfg.net, cfg, dev)
    pair = torch.from_numpy(np.ascontiguousarray(
        moving_texture_video(2, h, w))).to(dev)
    times = torch.tensor([-1.0], device=dev)
    scale = w / 5.0

    def test_pair():
        f12, f21 = FT.flow_infer(spec, params, consts, times, scale, h, w)
        return occlusion_wang(f12, f21, cfg.occl_thresh)

    steps = (("flow_test_pair", test_pair),
             ("interp_mid_frame", lambda: FT.frame_interp(
                 spec, cfg, params, consts, -1.0, pair, 0.5, scale)))
    K5.reset_launch_counts()
    K6.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    for name, fn in steps:
        med, lo, hi = _events_ms(fn, a.batches)
        print(f"[time] {name}, 1 x {h}x{w}: median {med:.3f} ms (min "
              f"{lo:.3f}, max {hi:.3f}, {a.batches} runs) = "
              f"{1e3 / med:.1f} per second")
    print(f"[time] launches over the timed runs: {K5.launch_counts()} "
          f"{K6.launch_counts()}; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    for name, fn in steps:
        _profile(name, fn, a.out)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=10)
    ap.add_argument("--out", default="torch_port_profile")
    ap.add_argument("--train", action="store_true",
                    help="profile the train step at batch 8")
    ap.add_argument("--flow", action="store_true",
                    help="profile flow test and interpolation at 436x1024")
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
        _profile(name, fn, a.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
