#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``sin_inn_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Needs one CUDA card and nvcc (``CUDA_HOME`` or ``/usr/local/cuda``); imports
nothing of JAX or of the JAX package. Phases:

1. the card: its name, and nvidia-smi's name and power limit;
2. the build: every CUDA source of the port, one nvcc each, in parallel;
3. the kernels against their plain PyTorch versions, at the shapes the SRF
   flagship path gives them (batch 40, HR 352x640: C=48 and C=192), fp32
   (max abs error <= 1e-4 + 1e-4 |plain|: fp32 sums over K=256 in another
   order, atanf against torch.atan) and one bf16-storage case (one bf16
   rounding step), the forward-inverse round trip, and median times;
   Then at the training shapes (batch 8, HR 352x640): K1 and K2 timed, and
   K3 and K4 (the backward kernels, each with its gradient reduction)
   against their plain versions with fp32 matmuls (dx within
   1e-4 + 1e-4 |plain|; each weight and bias gradient within 1e-3 of the
   largest |plain| of it, since the sums over 10^5 rows run in another
   order), one bf16-storage case, and median times;
4. the path: a 102-frame synthetic 352x640 video, a seeded state saved and
   restored through the checkpoint store, ``sr test`` frames over both
   40-window batches and the eval step over the val split, on ``cuda`` in
   the ``float32`` compute mode. Launch counts are reset before and read
   after each, and must show that every 1x1 coupling ran in a kernel.
5. train: a 204-frame synthetic 352x640 video (16 training windows),
   ``run_sr_train`` at the flagship config (batch 8, 2 epochs = 4 steps,
   val metrics and checkpoints every epoch), then a resume to 3 epochs;
   launch counts of one train step (4 K1, 4 K2, 4 K3, 4 K4 and a reduction
   per K3/K4) and of one step with TCR (5 iterations) and both MMD terms
   (4, 44, 4, 44); the gradients of the kernel route against the cuDNN
   route (``use_kernel="off"``) on one batch with the same noise (each leaf
   within a normwise relative error of 2e-2, the TF32 rounding of the
   convolutions; the loss within 1e-3); train frames/s over 10 steps.
6. the windowed splat (K5) and gather (K6) against their plain versions at
   the flow path's shapes (1 x 436 x 1024; K6 C=3, K5 C=5; dy=64, dx=128),
   on a seeded smooth flow that leaves the window in part of the frame, so
   the drop rule runs: K6 within 1e-5 + 1e-5 |plain| (it repeats the plain
   arithmetic), K5 and its coverage channel within 1e-5 + 1e-5 |plain| (its
   atomic sums run in another order); device time per call (torch.profiler:
   every kernel and memset of the call) of each kernel, of its plain
   version and, for K6, of ``grid_sample``, and each kernel's median time
   between CUDA events (which includes the host's launch path);
7. the flow path: a 6-frame synthetic 436x1024 video and a seeded
   full-width ``RBF`` INR (E = 512, MLP 512-256-256-256-4) saved and
   restored through the checkpoint store; ``flow_test_outputs`` over the 5
   pairs (finite flows, Wang masks in {0, 1}, no K5/K6 launch: the
   occlusion map is the exact scatter) and ``interpolate_frames`` at factor
   2 (exactly 2 K5 + 2 K6 launches per mid-frame), each timed as frames/s;
   alpha = 0 and 1 reproduce the endpoint frames within 1e-5; one mid-frame
   and K5 on its splat input timed at the path's flow scale and at 16x it
   (flows of Sintel magnitude, some beyond the window); the card against
   the CPU on a small crop (flows within 1e-3 px, frames within 1e-3). The
   phase never sets ``allow_tf32`` and checks that it stays off, and the
   RBF encoding of the full pose grid is bitwise the same with it on.

Any failed check exits non-zero. The line before the last is a JSON object
with each kernel's numbers; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

BATCH, HR_H, HR_W = 40, 352, 640
TRAIN_BATCH = 8
NUM_FRAMES = 102
TRAIN_FRAMES = 204
HIDDEN = 256
CLAMP = 1.2
# published H100 SXM peaks (NVIDIA data sheet, dense)
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
REPLACES = {
    "fused_glow_forward_1x1": "sin_inn_tpu/ops/pallas/coupling.py:82",
    "fused_glow_inverse_1x1": "sin_inn_tpu/ops/pallas/coupling.py:111",
    "fused_glow_backward_1x1": "sin_inn_tpu/ops/pallas/coupling.py:256",
    "fused_glow_inverse_backward_1x1": "sin_inn_tpu/ops/pallas/coupling.py:412",
    "splat_region": "sin_inn_tpu/ops/pallas/splat.py:57",
    "gather_region": "sin_inn_tpu/ops/pallas/gather.py:79",
}
SOURCES = {
    "fused_glow_forward_1x1": "sin_inn_tpu_torch/csrc/coupling_1x1.cu",
    "fused_glow_inverse_1x1": "sin_inn_tpu_torch/csrc/coupling_1x1.cu",
    "fused_glow_backward_1x1": "sin_inn_tpu_torch/csrc/coupling_1x1_bwd.cu",
    "fused_glow_inverse_backward_1x1":
        "sin_inn_tpu_torch/csrc/coupling_1x1_bwd.cu",
    "splat_region": "sin_inn_tpu_torch/csrc/splat_region.cu",
    "gather_region": "sin_inn_tpu_torch/csrc/gather_region.cu",
}
COUPLING = ("fused_glow_forward_1x1", "fused_glow_inverse_1x1",
            "fused_glow_backward_1x1", "fused_glow_inverse_backward_1x1")
BACKWARD = ("fused_glow_backward_1x1", "fused_glow_inverse_backward_1x1")
FLOW_H, FLOW_W = 436, 1024     # Sintel
FLOW_FRAMES = 6
DY, DX = 64, 128               # resolve_splat_bounds at 436x1024


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def check_counts(counts, what: str, **want) -> None:
    """Every kernel's count is ``want``'s, or 0 where ``want`` names none."""
    full = {k: want.get(k, 0) for k in counts}
    check(counts == full and set(want) <= set(counts),
          f"{what}: launches {counts}, want {full}")


def add_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def median_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def device_ms(fn, reps: int) -> float:
    """Device time per call of ``fn``: every kernel and memset it launches,
    traced by torch.profiler over ``reps`` calls. A small kernel's event
    time is mostly the host's launch path; this is the card's share."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    check(total_us > 0, "the profiler saw no device time")
    return total_us / reps / 1e3


def coupling_cost(m: int, c: int, hidden: int, elem_bytes: int):
    """FLOP and bytes one coupling launch needs: four matmuls per pixel;
    x read once, y written once, each weight and bias read once."""
    len1 = c // 2
    len2 = c - len1
    flops = 2 * m * hidden * (len2 + 2 * len1 + len1 + 2 * len2)
    weights = (len2 * hidden + hidden + hidden * 2 * len1 + 2 * len1
               + len1 * hidden + hidden + hidden * 2 * len2 + 2 * len2)
    return flops, 2 * m * c * elem_bytes + 4 * weights


def backward_cost(m: int, c: int, hidden: int, elem_bytes: int):
    """FLOP and bytes of one K3 or K4 launch with its reduction: 18 H C
    FLOP per pixel (recompute, dx chain and weight gradients, 6 H C each);
    x and g read once, dx written once, each weight read once and each
    weight gradient written once."""
    flops, _ = coupling_cost(m, c, hidden, elem_bytes)
    weights = (coupling_cost(1, c, hidden, 4)[1] - 2 * c * 4) // 4
    return 3 * flops, 3 * m * c * elem_bytes + 2 * 4 * weights


def phase_card():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    print(f"[card] torch: {name}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; nvidia-smi name, power.limit:")
    print(smi_line)
    return name, smi_line


def phase_build():
    from sin_inn_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    wall = time.perf_counter() - t0
    for name, b in built.items():
        print(f"[build] {name}: {b.seconds:.1f} s -> {b.path.name}")
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")
    print(f"[build] all sources: {wall:.1f} s wall")


def _coupling_params(gen, c: int, dev):
    from sin_inn_tpu_torch.ops import subnet as S

    len1 = c // 2
    len2 = c - len1
    p = {"s1": S.conv_subnet_init(gen, len1, 2 * len2, 1, HIDDEN),
         "s2": S.conv_subnet_init(gen, len2, 2 * len1, 1, HIDDEN)}
    return {s: {k: {n: t.to(dev) for n, t in conv.items()}
                for k, conv in sub.items()} for s, sub in p.items()}


def phase_kernels(dev):
    """K1/K2 against the plain versions at both flagship octave shapes."""
    from sin_inn_tpu_torch.ops.cuda import coupling as K

    torch.backends.cuda.matmul.allow_tf32 = False
    gen_w = torch.Generator().manual_seed(1234)
    gen_x = torch.Generator(device=dev).manual_seed(4321)
    shapes = [(BATCH, HR_H // 4, HR_W // 4, 48),     # octave 1
              (BATCH, HR_H // 8, HR_W // 8, 192)]    # octave 2
    rows = {n: [] for n in COUPLING[:2]}
    with torch.inference_mode():
        for shape in shapes:
            c = shape[-1]
            len1 = c // 2
            p = _coupling_params(gen_w, c, dev)
            x = torch.randn(shape, generator=gen_x, device=dev)
            y = K.fused_glow_forward_1x1(p, x, CLAMP, len1)
            y_plain = K.fused_glow_forward_1x1_plain(p, x, CLAMP, len1)
            x_back = K.fused_glow_inverse_1x1(p, y_plain, CLAMP, len1)
            x_plain = K.fused_glow_inverse_1x1_plain(p, y_plain, CLAMP, len1)
            trip = K.fused_glow_inverse_1x1(p, y, CLAMP, len1)
            torch.cuda.synchronize()
            errs = {
                "fused_glow_forward_1x1": (y - y_plain).abs(),
                "fused_glow_inverse_1x1": (x_back - x_plain).abs(),
            }
            refs = {"fused_glow_forward_1x1": y_plain,
                    "fused_glow_inverse_1x1": x_plain}
            for n, e in errs.items():
                check(bool(torch.isfinite(e).all()), f"{n} C={c}: non-finite")
                ok = bool((e <= 1e-4 + 1e-4 * refs[n].abs()).all())
                check(ok, f"{n} C={c}: max abs err {e.max().item():.3e} "
                          f"exceeds 1e-4 + 1e-4|plain|")
            trip_err = (trip - x).abs().max().item()
            check(trip_err <= 1e-4, f"round trip C={c}: {trip_err:.3e} > 1e-4")
            m = x.numel() // c
            flops, nbytes = coupling_cost(m, c, HIDDEN, 4)
            for n, fn, plain, inp in (
                    ("fused_glow_forward_1x1", K.fused_glow_forward_1x1,
                     K.fused_glow_forward_1x1_plain, x),
                    ("fused_glow_inverse_1x1", K.fused_glow_inverse_1x1,
                     K.fused_glow_inverse_1x1_plain, y_plain)):
                ms = median_ms(lambda: fn(p, inp, CLAMP, len1), 20)
                plain_ms = median_ms(lambda: plain(p, inp, CLAMP, len1), 10)
                rows[n].append({
                    "shape": list(shape), "M": m, "C": c,
                    "max_abs_err": errs[n].max().item(),
                    "ms": ms, "plain_ms": plain_ms,
                    "flop": flops, "bytes": nbytes,
                    "fp32_bound_ms": flops / PEAK_FP32 * 1e3,
                    "tf32_bound_ms": flops / PEAK_TF32 * 1e3,
                    "bytes_bound_ms": nbytes / PEAK_BYTES * 1e3,
                    "round_trip_err": trip_err,
                })
            del y, y_plain, x_back, x_plain, trip, errs, refs
        # one bf16-storage case: the octave-1 forward
        c = 48
        p = _coupling_params(gen_w, c, dev)
        xb = torch.randn(shapes[0], generator=gen_x,
                         device=dev).to(torch.bfloat16)
        yb = K.fused_glow_forward_1x1(p, xb, CLAMP, c // 2).float()
        yb_plain = K.fused_glow_forward_1x1_plain(p, xb, CLAMP, c // 2).float()
        e = (yb - yb_plain).abs()
        # both round fp32 results to bf16: at most one rounding step apart
        check(bool((e <= 1e-4 + 2.0 ** -7 * yb_plain.abs()).all()),
              f"bf16 forward C=48: max abs err {e.max().item():.3e}")
        bf16_err = e.max().item()
    print(f"[kernels] bf16-storage forward C=48: max abs err {bf16_err:.3e}")
    for n, rs in rows.items():
        for r in rs:
            print(f"[kernels] {n} C={r['C']} M={r['M']}: {r['ms']:.3f} ms "
                  f"(plain {r['plain_ms']:.3f} ms; bounds fp32 "
                  f"{r['fp32_bound_ms']:.3f} / tf32 {r['tf32_bound_ms']:.3f} "
                  f"/ bytes {r['bytes_bound_ms']:.3f} ms) max abs err "
                  f"{r['max_abs_err']:.3e}, round trip {r['round_trip_err']:.3e}")
    return rows, bf16_err


def _time_reduction(K, dev, m: int, c: int, len1: int, inverse: bool):
    """Median ms of the gradient reduction alone at one K3/K4 launch's
    size (its grid and slot size as the wrapper would take them)."""
    import ctypes

    lib = K._bwd_lib()
    blocks = ctypes.c_int(0)
    err = lib.sininn_coupling_1x1_bwd_blocks(int(inverse), 0, m, c, len1,
                                             HIDDEN, ctypes.byref(blocks))
    check(err == 0, f"backward grid query failed ({err})")
    slot = lib.sininn_coupling_1x1_bwd_slot_floats(c, len1, HIDDEN)
    part = torch.zeros((blocks.value, slot), device=dev)
    run = lambda: K.reduce_weight_grads(part)
    return median_ms(run, 20), blocks.value, slot


def _grads_close(dp, rp, dx, rx, step: float, what: str) -> float:
    """Checks the backward tolerances; returns dx's max abs error."""
    from sin_inn_tpu_torch.ops.cuda import coupling as K

    for (s, c, k), a, b in zip(K.LEAVES, K.param_leaves(dp),
                               K.param_leaves(rp)):
        err = (a - b).abs().max().item()
        lim = 1e-3 * b.abs().max().item()
        check(a.shape == b.shape and err <= lim,
              f"{what} grad {s}.{c}.{k}: max abs err {err:.3e} > {lim:.3e}")
    dx, rx = dx.float(), rx.float()
    e = (dx - rx).abs()
    check(bool(torch.isfinite(e).all()), f"{what}: non-finite dx")
    check(bool((e <= 1e-4 + step * rx.abs()).all()),
          f"{what}: dx max abs err {e.max().item():.3e} exceeds "
          f"1e-4 + {step:g}|plain|")
    return e.max().item()


def phase_train_kernels(dev):
    """K1/K2 timed and K3/K4 checked and timed at the training shapes."""
    from sin_inn_tpu_torch.ops.cuda import coupling as K

    torch.backends.cuda.matmul.allow_tf32 = False
    gen_w = torch.Generator().manual_seed(5678)
    gen_x = torch.Generator(device=dev).manual_seed(8765)
    shapes = [(TRAIN_BATCH, HR_H // 4, HR_W // 4, 48),     # octave 1
              (TRAIN_BATCH, HR_H // 8, HR_W // 8, 192)]    # octave 2
    rows = {n: [] for n in COUPLING}
    for shape in shapes:
        c = shape[-1]
        len1 = c // 2
        m = math.prod(shape[:-1])
        p = _coupling_params(gen_w, c, dev)
        x = torch.randn(shape, generator=gen_x, device=dev)
        g = torch.randn(shape, generator=gen_x, device=dev)
        flops, nbytes = coupling_cost(m, c, HIDDEN, 4)
        with torch.inference_mode():
            for n, fn, plain in (
                    ("fused_glow_forward_1x1", K.fused_glow_forward_1x1,
                     K.fused_glow_forward_1x1_plain),
                    ("fused_glow_inverse_1x1", K.fused_glow_inverse_1x1,
                     K.fused_glow_inverse_1x1_plain)):
                ref = plain(p, x, CLAMP, len1)
                e = (fn(p, x, CLAMP, len1) - ref).abs()
                check(bool((e <= 1e-4 + 1e-4 * ref.abs()).all()),
                      f"{n} C={c} batch {TRAIN_BATCH}: max abs err "
                      f"{e.max().item():.3e}")
                rows[n].append({
                    "shape": list(shape), "M": m, "C": c,
                    "max_abs_err": e.max().item(),
                    "ms": median_ms(lambda: fn(p, x, CLAMP, len1), 20),
                    "plain_ms": median_ms(lambda: plain(p, x, CLAMP, len1),
                                          10),
                    "flop": flops, "bytes": nbytes,
                    "fp32_bound_ms": flops / PEAK_FP32 * 1e3,
                    "tf32_bound_ms": flops / PEAK_TF32 * 1e3,
                    "bytes_bound_ms": nbytes / PEAK_BYTES * 1e3,
                })
                del ref, e
        bflops, bbytes = backward_cost(m, c, HIDDEN, 4)
        for n, fn, plain in (
                ("fused_glow_backward_1x1", K.fused_glow_backward_1x1,
                 K.fused_glow_backward_1x1_plain),
                ("fused_glow_inverse_backward_1x1",
                 K.fused_glow_inverse_backward_1x1,
                 K.fused_glow_inverse_backward_1x1_plain)):
            dp, dx = fn(p, x, g, CLAMP, len1)
            rp, rx = plain(p, x, g, CLAMP, len1)
            torch.cuda.synchronize()
            err = _grads_close(dp, rp, dx, rx, 1e-4, f"{n} C={c}")
            grad_err = max((a - b).abs().max().item() for a, b in
                           zip(K.param_leaves(dp), K.param_leaves(rp)))
            del dp, dx, rp, rx
            red_ms, blocks, slot = _time_reduction(
                K, dev, m, c, len1, n == BACKWARD[1])
            rows[n].append({
                "shape": list(shape), "M": m, "C": c,
                "max_abs_err": err, "grad_max_abs_err": grad_err,
                "ms": median_ms(lambda: fn(p, x, g, CLAMP, len1), 10),
                "reduce_ms": red_ms, "blocks": blocks,
                "partials_mb": blocks * slot * 4 / 1e6,
                "plain_ms": median_ms(lambda: plain(p, x, g, CLAMP, len1),
                                      5),
                "flop": bflops, "bytes": bbytes,
                "fp32_bound_ms": bflops / PEAK_FP32 * 1e3,
                "tf32_bound_ms": bflops / PEAK_TF32 * 1e3,
                "bytes_bound_ms": bbytes / PEAK_BYTES * 1e3,
            })
        del x, g
    # one bf16-storage case: K3 at octave 1
    c = 48
    p = _coupling_params(gen_w, c, dev)
    xb = torch.randn(shapes[0], generator=gen_x, device=dev).bfloat16()
    gb = torch.randn(shapes[0], generator=gen_x, device=dev).bfloat16()
    dp, dx = K.fused_glow_backward_1x1(p, xb, gb, CLAMP, c // 2)
    rp, rx = K.fused_glow_backward_1x1_plain(p, xb, gb, CLAMP, c // 2)
    check(dx.dtype == torch.bfloat16, f"bf16 K3 returned dx in {dx.dtype}")
    # both round fp32 results to bf16: at most one rounding step apart
    bf16_err = _grads_close(dp, rp, dx, rx, 2.0 ** -7, "bf16 K3 C=48")
    print(f"[kernels] bf16-storage K3 C=48: dx max abs err {bf16_err:.3e}")
    for n, rs in rows.items():
        for r in rs:
            extra = (f", reduction {r['reduce_ms']:.3f} ms over "
                     f"{r['blocks']} slots ({r['partials_mb']:.1f} MB), "
                     f"grads max abs err {r['grad_max_abs_err']:.3e}"
                     if "reduce_ms" in r else "")
            print(f"[kernels] batch {TRAIN_BATCH}: {n} C={r['C']} "
                  f"M={r['M']}: {r['ms']:.3f} ms (plain {r['plain_ms']:.3f} "
                  f"ms; bounds fp32 {r['fp32_bound_ms']:.3f} / tf32 "
                  f"{r['tf32_bound_ms']:.3f} / bytes "
                  f"{r['bytes_bound_ms']:.3f} ms) max abs err "
                  f"{r['max_abs_err']:.3e}{extra}")
    return rows, bf16_err


def phase_path(dev, card: str):
    """SRF flagship `sr test` frames and eval on cuda, with launch counts."""
    import os.path as path

    from sin_inn_tpu_torch.core import rng as R
    from sin_inn_tpu_torch.core.checkpoint import CheckpointStore
    from sin_inn_tpu_torch.core.config import SRConfig
    from sin_inn_tpu_torch.data.sr_video import make_datasets
    from sin_inn_tpu_torch.data.synthetic import synthetic_sr_video
    from sin_inn_tpu_torch.models.inn import (build_inn_spec, inn_apply,
                                              params_to)
    from sin_inn_tpu_torch.ops.cuda import coupling as K
    from sin_inn_tpu_torch.train import loop as LP
    from sin_inn_tpu_torch.train import sr as SR

    counts = {}
    with tempfile.TemporaryDirectory() as work:
        cfg = SRConfig(scene="chip_smoke", device="cuda",
                       compute_dtype="float32", working_dir=work)
        check(cfg.val_batch_size == BATCH and cfg.lr_dims == 84
              and cfg.total_dims == 192 and cfg.octaves == 2,
              "SRConfig defaults are not the flagship SRF widths")
        t0 = time.perf_counter()
        video = synthetic_sr_video(cfg, num_frames=NUM_FRAMES, h=HR_H, w=HR_W)
        print(f"[path] synthetic video: hr {video.hr.shape}, lr "
              f"{video.lr.shape} in {time.perf_counter() - t0:.1f} s")

        init = R.named_fold(R.root_generator(cfg.random_seed), "init")
        spec, state = SR.create_state(init, cfg)
        store = CheckpointStore(path.join(LP.sr_dirs(cfg, "train"),
                                          "checkpoints"))
        store.save(1, state.state_dict())
        other = R.named_fold(R.root_generator(cfg.random_seed + 1), "init")
        spec, restored, _, step = LP._sr_create_and_restore(
            cfg, other, require="checkpoint missing")
        check(step == 1, f"restored step {step}, saved 1")
        same = all(torch.equal(a, b)
                   for pa, pb in zip(state.params, restored.params)
                   if pa is not None
                   for s in pa for c in pa[s] for a, b in
                   zip(pa[s][c].values(), pb[s][c].values()))
        check(same, "restored params differ from the saved ones")
        state = restored
        n_1x1 = sum(1 for l in spec if l.kind == "glow" and l.kernel == 1)
        check(n_1x1 == 4 and all(l.use_kernel for l in spec
                                 if l.kind == "glow"),
              "spec does not route the 1x1 couplings to the kernels")

        # sr test: one warm-up pass, then the counted and timed pass
        frames = np.stack(list(LP.sr_test_frames(cfg, video, state, spec)))
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames = np.stack(list(LP.sr_test_frames(cfg, video, state, spec)))
        torch.cuda.synchronize()
        test_s = time.perf_counter() - t0
        test_counts = K.launch_counts()
        n_test = math.ceil(len(frames) / cfg.val_batch_size)
        check(frames.dtype == np.uint8 and frames.shape == (80, HR_H, HR_W, 3),
              f"test frames {frames.dtype} {frames.shape}, want uint8 "
              f"(80, {HR_H}, {HR_W}, 3)")
        check_counts(test_counts, f"sr test over {n_test} batches "
                                  "(4 inverse per batch)",
                     fused_glow_inverse_1x1=4 * n_test)
        fps = len(frames) / test_s
        print(f"[path] sr test: {len(frames)} frames in {n_test} batches, "
              f"{test_s:.3f} s, {fps:.2f} frames/s on {card}; launches "
              f"{test_counts}")

        # eval over the val split
        _, _, val = make_datasets(video, cfg)
        val_batches = val.device_cache(cfg.val_batch_size, dev)
        eval_step = SR.make_eval_step(spec, cfg)
        val_gen = R.named_fold(R.root_generator(cfg.random_seed, dev), "val")
        K.reset_launch_counts()
        metrics = [eval_step(state.params, vb, R.step_fold(val_gen, i))
                   for i, vb in enumerate(val_batches)]
        torch.cuda.synchronize()
        eval_counts = K.launch_counts()
        nb = len(val_batches)
        check_counts(eval_counts, f"eval over {nb} batches (4 each per "
                                  "batch)",
                     fused_glow_forward_1x1=4 * nb,
                     fused_glow_inverse_1x1=4 * nb)
        for i, m in enumerate(metrics):
            vals = {k: v.item() for k, v in m.items()}
            check(all(math.isfinite(v) for v in vals.values()),
                  f"eval batch {i}: non-finite metric {vals}")
            print(f"[path] eval batch {i} ({val_batches[i]['hr'].shape[0]} "
                  f"windows): {vals}")
        add_counts(counts, test_counts)
        add_counts(counts, eval_counts)

        # invertibility at depth, float32 with TF32 convolutions
        with torch.inference_mode():
            hr = val_batches[0]["hr"].float() / 255.0
            rec = inn_apply(spec, state.params,
                            inn_apply(spec, state.params, hr), rev=True)
            inv_err = (rec - hr).abs().max().item()
        check(inv_err <= 1e-3, f"inverse(forward(hr)) error {inv_err:.3e} "
                               "> 1e-3")
        print(f"[path] invertibility at depth: max abs err {inv_err:.3e}")

        # agreement with the CPU reference on a small input: full fp32 on
        # both sides (kernels off), so only the summation order differs
        small = SRConfig(scene="chip_smoke", device="cpu",
                         compute_dtype="float32_highest", working_dir=work)
        spec_hi = build_inn_spec(small)[0]
        lr_small = val_batches[0]["lr"][:2, :8, :8].float() / 255.0
        z = torch.randn((2, 8, 8, small.z_dims),
                        generator=torch.Generator().manual_seed(7))
        lr_z = torch.cat([lr_small.cpu(), z], dim=-1)
        with torch.inference_mode():
            ref = inn_apply(spec_hi, params_to(state.params, "cpu"), lr_z,
                            rev=True)
            got = inn_apply(spec_hi, state.params, lr_z.to(dev), rev=True)
            ref_err = (got.cpu() - ref).abs().max().item()
        check(ref_err <= 1e-3, f"cuda vs cpu inverse (float32_highest): "
                               f"{ref_err:.3e} > 1e-3")
        print(f"[path] cuda vs cpu reference (2x64x64, float32_highest): "
              f"max abs err {ref_err:.3e}")
        print(f"[path] peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    return counts, fps


def _leaf_grads(params):
    from sin_inn_tpu_torch.models.inn import flat_params

    return [t.grad.detach().clone() for t in flat_params(params)]


def phase_train(dev, card: str, smi_line: str):
    """SRF flagship training on cuda: run_sr_train, resume, launch counts,
    gradient agreement with the cuDNN route, and train frames/s."""
    import os.path as path

    from sin_inn_tpu_torch.core.checkpoint import CheckpointStore
    from sin_inn_tpu_torch.core.config import SRConfig
    from sin_inn_tpu_torch.data.sr_video import make_datasets, to_device
    from sin_inn_tpu_torch.data.synthetic import synthetic_sr_video
    from sin_inn_tpu_torch.models.inn import build_inn_spec, params_to
    from sin_inn_tpu_torch.ops.cuda import coupling as K
    from sin_inn_tpu_torch.train import loop as LP
    from sin_inn_tpu_torch.train import sr as SR

    torch.backends.cuda.matmul.allow_tf32 = False
    counts = {}
    stats = {}
    with tempfile.TemporaryDirectory() as work:
        cfg = SRConfig(scene="chip_smoke_train", device="cuda",
                       compute_dtype="float32", working_dir=work,
                       batch_size=TRAIN_BATCH, epochs=2, print_iter=1,
                       save_iter=1)
        check(cfg.batch_size == TRAIN_BATCH and cfg.learning_rate == 1e-4
              and cfg.adam_betas == (0.9, 0.99) and cfg.weight_decay == 1e-5
              and cfg.total_dims == 192 and cfg.num_coupling == 4
              and cfg.hidden_channels == HIDDEN,
              "SRConfig defaults are not the flagship training config")
        t0 = time.perf_counter()
        video = synthetic_sr_video(cfg, num_frames=TRAIN_FRAMES, h=HR_H,
                                   w=HR_W)
        sup, unsup, _ = make_datasets(video, cfg)
        check(len(sup) >= 2 * TRAIN_BATCH,
              f"{len(sup)} training windows, want >= {2 * TRAIN_BATCH}")
        print(f"[train] synthetic video: hr {video.hr.shape}, "
              f"{len(sup)} training windows, in "
              f"{time.perf_counter() - t0:.1f} s")

        # run_sr_train: 2 epochs of 2 full batches, then resume to 3
        K.reset_launch_counts()
        t0 = time.perf_counter()
        out = LP.run_sr_train(cfg, video=video)
        torch.cuda.synchronize()
        run_counts = K.launch_counts()
        steps = out["state"].step
        m = out["metrics"]
        check(out["start_epoch"] == 0 and steps == 4,
              f"run_sr_train took {steps} steps from epoch "
              f"{out['start_epoch']}, want 4 from 0")
        check(all(math.isfinite(v) for v in m.values()),
              f"run_sr_train: non-finite metric {m}")
        ckpts = CheckpointStore(path.join(out["exp_dir"],
                                          "checkpoints")).latest_step()
        check(ckpts == 2, f"latest checkpoint {ckpts}, want 2")
        # 4 K1 + 4 K2 + 4 K3 + 4 K4 per step; 4 K1 + 4 K2 per eval batch
        evals = 2
        check_counts(run_counts, "run_sr_train (4 steps, 2 evals)",
                     fused_glow_forward_1x1=4 * steps + 4 * evals,
                     fused_glow_inverse_1x1=4 * steps + 4 * evals,
                     fused_glow_backward_1x1=4 * steps,
                     fused_glow_inverse_backward_1x1=4 * steps,
                     reduce_weight_grads=8 * steps)
        add_counts(counts, run_counts)
        print(f"[train] run_sr_train: {steps} steps in "
              f"{time.perf_counter() - t0:.1f} s; metrics {m}")

        K.reset_launch_counts()
        again = LP.run_sr_train(cfg.replace(epochs=3), video=video)
        torch.cuda.synchronize()
        add_counts(counts, K.launch_counts())
        st = again["state"]
        opt_steps = {int(v["step"]) for v in
                     st.optimizer.state_dict()["state"].values()}
        check(again["start_epoch"] == 2,
              f"resume started at epoch {again['start_epoch']}, want 2")
        check(st.step == 6 and opt_steps == {6},
              f"after resume: step {st.step}, optimizer steps {opt_steps}, "
              "want 6")
        check(math.isfinite(again["metrics"]["loss"]),
              f"resumed loss {again['metrics']['loss']}")
        print(f"[train] resumed at epoch 2: step {st.step}, optimizer step "
              f"{opt_steps}, loss {again['metrics']['loss']:.6g}")

        spec = again["spec"]
        batch = sup.device_cache(TRAIN_BATCH, dev)[0]
        b, h, w, _ = batch["lr"].shape
        step = SR.make_train_step(spec, cfg)
        gen = torch.Generator(device=dev).manual_seed(11)

        # one default step: launch counts
        K.reset_launch_counts()
        aux = step(st, batch, None, gen)
        torch.cuda.synchronize()
        one = K.launch_counts()
        check_counts(one, "one train step", fused_glow_forward_1x1=4,
                     fused_glow_inverse_1x1=4, fused_glow_backward_1x1=4,
                     fused_glow_inverse_backward_1x1=4,
                     reduce_weight_grads=8)
        add_counts(counts, one)

        # one step with TCR (5 iterations) and both MMD terms
        tcr_cfg = cfg.replace(lambda_bwd_tcr=1.0, tcr_iters=5,
                              lambda_fwd_mmd=1.0, lambda_bwd_mmd=1.0)
        tcr_step = SR.make_train_step(spec, tcr_cfg)
        unsup_batch = to_device(unsup.random_batch(TRAIN_BATCH), dev)
        K.reset_launch_counts()
        aux = tcr_step(st, batch, unsup_batch, gen)
        torch.cuda.synchronize()
        tcr = K.launch_counts()
        check_counts(tcr, "one TCR + MMD train step",
                     fused_glow_forward_1x1=4, fused_glow_inverse_1x1=44,
                     fused_glow_backward_1x1=4,
                     fused_glow_inverse_backward_1x1=44,
                     reduce_weight_grads=48)
        add_counts(counts, tcr)
        check(counts["reduce_weight_grads"] ==
              counts[BACKWARD[0]] + counts[BACKWARD[1]],
              f"launches {counts}: one reduction per K3/K4 launch")
        vals = {k: v.item() for k, v in aux.items()}
        check(all(math.isfinite(v) for v in vals.values()) and
              vals["tcr"] > 0, f"TCR + MMD step: loss terms {vals}")
        print(f"[train] one TCR (5 iters) + MMD step: {vals}; launches {tcr}")

        # gradients of the kernel route against the cuDNN route
        draws = SR.draw_sr_noise(torch.Generator(device=dev).manual_seed(3),
                                 cfg, b, h, w)
        routes = {}
        for route in ("auto", "off"):
            rcfg = cfg.replace(use_kernel=route)
            rspec, _ = build_inn_spec(rcfg)
            check(any(l.use_kernel for l in rspec) == (route == "auto"),
                  f"use_kernel={route} routes the wrong way")
            params = [None if p is None else
                      {s: {c: {k: t.detach().clone() for k, t in conv.items()}
                           for c, conv in sub.items()}
                       for s, sub in p.items()}
                      for p in params_to(st.params, dev)]
            rstate = SR.train_state(params, rcfg)
            loss, _ = SR.sr_loss(rstate.params, rspec, rcfg, batch, None,
                                 draws)
            loss.backward()
            routes[route] = (loss.item(), _leaf_grads(rstate.params))
        (la, ga), (lo, go) = routes["auto"], routes["off"]
        worst = max((a - o).norm().item() / max(o.norm().item(), 1e-30)
                    for a, o in zip(ga, go))
        loss_rel = abs(la - lo) / abs(lo)
        print(f"[train] kernel route vs cuDNN route: worst leaf normwise "
              f"relative error {worst:.3e} (limit 2e-2), loss {la:.7g} vs "
              f"{lo:.7g} (relative {loss_rel:.3e}, limit 1e-3)")
        check(worst <= 2e-2, f"gradient agreement: {worst:.3e} > 2e-2")
        check(loss_rel <= 1e-3, f"loss agreement: {loss_rel:.3e} > 1e-3")
        stats.update(grad_worst=worst, loss_rel=loss_rel)
        del routes, ga, go

        # throughput: 2 warm-up steps, then 10 timed
        torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(2):
            step(st, batch, None, gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            aux = step(st, batch, None, gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check(math.isfinite(aux["loss"].item()), "non-finite loss")
        stats.update(frames_per_sec=10 * TRAIN_BATCH / dt,
                     ms_per_step=dt * 100,
                     peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
        print(f"[train] {stats['frames_per_sec']:.2f} train frames/s, "
              f"{stats['ms_per_step']:.2f} ms/step (batch {TRAIN_BATCH}, "
              f"HR {HR_H}x{HR_W}, float32), peak device memory "
              f"{stats['peak_gib']:.2f} GiB, on {card} ({smi_line})")
    return counts, stats


def _window_flow(gen, dev):
    """A seeded smooth flow (1, 436, 1024, 2) that leaves the dy=64 /
    dx=128 window in part of the frame, plus a little noise."""
    ys = torch.linspace(0.0, math.pi, FLOW_H, device=dev)[None, :, None]
    xs = torch.linspace(0.0, 2 * math.pi, FLOW_W, device=dev)[None, None, :]
    noise = torch.randn((1, FLOW_H, FLOW_W, 2), generator=gen, device=dev)
    fx = 170.0 * torch.sin(xs + 0.5 * ys) + noise[..., 0]
    fy = 85.0 * torch.cos(xs - ys) + noise[..., 1]
    return torch.stack([fx, fy], -1).contiguous()


def _close(got, ref, what: str) -> float:
    e = (got - ref).abs()
    check(bool(torch.isfinite(e).all()), f"{what}: non-finite")
    check(bool((e <= 1e-5 + 1e-5 * ref.abs()).all()),
          f"{what}: max abs err {e.max().item():.3e} exceeds "
          f"1e-5 + 1e-5|plain|")
    return e.max().item()


def phase_flow_kernels(dev):
    """K5/K6 against their plain versions at the flow path's shapes, with
    flows beyond the window; times, bounds and the library yardstick."""
    import torch.nn.functional as F

    from sin_inn_tpu_torch.ops.cuda import gather as K6
    from sin_inn_tpu_torch.ops.cuda import splat as K5

    gen = torch.Generator(device=dev).manual_seed(6)
    fl = _window_flow(gen, dev)
    out_y = (fl[..., 1].abs() > DY - 1).float().mean().item()
    out_x = (fl[..., 0].abs() > DX - 1).float().mean().item()
    check(out_y > 0.05 and out_x > 0.05,
          f"flow leaves the window at too few pixels ({out_y:.3f}, "
          f"{out_x:.3f})")
    img = torch.rand((1, FLOW_H, FLOW_W, 3), generator=gen, device=dev)
    metric = -20.0 * torch.rand((1, FLOW_H, FLOW_W, 1), generator=gen,
                                device=dev)
    e = metric.exp()
    cat = torch.cat([img * e, e, torch.ones_like(e)], -1).contiguous()
    coord = K6.resample_coord(FLOW_H, FLOW_W)
    px = FLOW_H * FLOW_W
    rows = {}
    with torch.inference_mode():
        got = K6.gather_region(img, fl, DY, DX, coord)
        ref = K6.gather_region_plain(img, fl, DY, DX, coord)
        torch.cuda.synchronize()
        err6 = _close(got, ref, "gather_region (K6)")
        # the library yardstick: grid_sample on resample2d's normalised
        # grid (NCHW input); the same function for flows in the window
        ys, xs = torch.meshgrid(
            torch.arange(FLOW_H, device=dev, dtype=torch.float32),
            torch.arange(FLOW_W, device=dev, dtype=torch.float32),
            indexing="ij")
        grid = torch.stack([(xs + fl[0, ..., 0]) / (FLOW_W - 1) * 2 - 1,
                            (ys + fl[0, ..., 1]) / (FLOW_H - 1) * 2 - 1],
                           -1)[None]
        nchw = img.permute(0, 3, 1, 2).contiguous()
        lib = lambda: F.grid_sample(nchw, grid, mode="bilinear",
                                    padding_mode="zeros",
                                    align_corners=False)
        nbytes = px * (3 + 2 + 3) * 4
        flops = px * (16 + 9 * 3)
        kern = lambda: K6.gather_region(img, fl, DY, DX, coord)
        rows["gather_region"] = {
            "shape": [1, FLOW_H, FLOW_W, 3], "max_abs_err": err6,
            "ms": device_ms(kern, 50),
            "plain_ms": device_ms(lambda: K6.gather_region_plain(
                img, fl, DY, DX, coord), 10),
            "library_ms": device_ms(lib, 50),
            "event_ms": median_ms(kern, 50),
            "bytes": nbytes, "flop": flops,
            "bytes_bound_ms": nbytes / PEAK_BYTES * 1e3,
            "ops_bound_ms": flops / PEAK_FP32 * 1e3}

        got = K5.splat_region(cat, fl, DY, DX)
        ref = K5.splat_region_plain(cat, fl, DY, DX)
        torch.cuda.synchronize()
        err5 = _close(got, ref, "splat_region (K5)")
        cov_err = _close(got[..., 4:], ref[..., 4:], "K5 coverage channel")
        exact = (ref[..., 4:] - K5.splat_region_plain(
            cat[..., 4:].contiguous(), fl, 4 * DY, 4 * DX)).abs().max()
        check(exact.item() > 0.1, "the window dropped no tap")
        nbytes = px * (5 + 2 + 5) * 4
        flops = px * (16 + 12 * 5)
        kern = lambda: K5.splat_region(cat, fl, DY, DX)
        rows["splat_region"] = {
            "shape": [1, FLOW_H, FLOW_W, 5], "max_abs_err": err5,
            "coverage_max_abs_err": cov_err,
            "ms": device_ms(kern, 50),
            "plain_ms": device_ms(lambda: K5.splat_region_plain(
                cat, fl, DY, DX), 10),
            "library_ms": None,
            "event_ms": median_ms(kern, 50),
            "bytes": nbytes, "flop": flops,
            "bytes_bound_ms": nbytes / PEAK_BYTES * 1e3,
            "ops_bound_ms": flops / PEAK_FP32 * 1e3}
    for n, r in rows.items():
        lib_s = ("" if r["library_ms"] is None
                 else f", grid_sample {r['library_ms']:.4f} ms")
        print(f"[flow kernels] {n} {r['shape']}: {r['ms']:.4f} ms on the "
              f"device, {r['event_ms']:.4f} ms between events (plain "
              f"{r['plain_ms']:.3f} ms{lib_s}; bound bytes "
              f"{r['bytes_bound_ms']:.4f} / fp32 {r['ops_bound_ms']:.4f} ms)"
              f" max abs err {r['max_abs_err']:.3e}")
    print(f"[flow kernels] flow beyond the window at {out_y:.1%} (y) and "
          f"{out_x:.1%} (x) of the pixels")
    return rows


def _all_counts():
    from sin_inn_tpu_torch.ops.cuda import coupling as K
    from sin_inn_tpu_torch.ops.cuda import gather as K6
    from sin_inn_tpu_torch.ops.cuda import splat as K5

    counts = {}
    for mod in (K, K5, K6):
        counts.update(mod.launch_counts())
    return counts


def _reset_all_counts():
    from sin_inn_tpu_torch.ops.cuda import coupling as K
    from sin_inn_tpu_torch.ops.cuda import gather as K6
    from sin_inn_tpu_torch.ops.cuda import splat as K5

    for mod in (K, K5, K6):
        mod.reset_launch_counts()


def phase_flow(dev, card: str, smi_line: str):
    """Flow serving at Sintel size: checkpoint round trip, the RBF encoding
    against the TF32 flag, flow test and interpolation with launch counts
    and frames/s, endpoint exactness, a mid-frame on flows of Sintel
    magnitude, and the card against the CPU on a small crop."""
    from sin_inn_tpu_torch.core import rng as R
    from sin_inn_tpu_torch.core.checkpoint import CheckpointStore
    from sin_inn_tpu_torch.core.config import FlowConfig
    from sin_inn_tpu_torch.data.flow_media import FlowMedia
    from sin_inn_tpu_torch.data.synthetic import moving_texture_video
    from sin_inn_tpu_torch.models.inr import (build_inr, flat_leaves,
                                              get_encoding, tree_to)
    from sin_inn_tpu_torch.train import flow as FT
    from sin_inn_tpu_torch.train import loop as LP

    from sin_inn_tpu_torch.ops.cuda import gather as K6
    from sin_inn_tpu_torch.ops.cuda import splat as K5

    # the flow path itself never touches the TF32 flag: it is off here as
    # PyTorch leaves it (and as phases 3-5 set it), and the RBF encoding is
    # shown below not to depend on it
    tf32 = torch.backends.cuda.matmul
    check(not tf32.allow_tf32, "TF32 matmuls on at the start of the flow "
                                "phase")
    stats = {}
    with tempfile.TemporaryDirectory() as work:
        cfg = FlowConfig(device="cuda", checkpoints_dir=work + "/ck",
                         results_dir=work + "/results")
        check(cfg.net == "RBF" and cfg.num_frequencies == 256
              and cfg.hidden_dim == 256 and cfg.num_layers == 3
              and cfg.size == 436 and cfg.test_batch == 1
              and cfg.occl == "wang",
              "FlowConfig defaults are not the Sintel RBF config")
        t0 = time.perf_counter()
        media = FlowMedia(moving_texture_video(FLOW_FRAMES, FLOW_H, FLOW_W,
                                               seed=1))
        check(media.flow_scale == FLOW_W / 5.0, "flow_scale is not W/5")
        scene = "chip_smoke"
        spec, params, consts = build_inr(
            R.named_fold(R.root_generator(cfg.random_seed), "init"),
            cfg.net, cfg, dev)
        check(spec.encoding_dim == 512 and [tuple(l["w"].shape) for l in
                                            params["mlp"]] ==
              [(512, 256), (256, 256), (256, 256), (256, 4)],
              "the RBF net is not E=512, MLP 512-256-256-256-4")
        CheckpointStore(LP.flow_ckpt_dir(cfg, scene)).save(
            7, LP.flow_state_dict(params, consts, 7))
        other = R.named_fold(R.root_generator(cfg.random_seed + 1), "init")
        spec, rp, rc, _, step = LP._flow_create_and_restore(
            cfg, other, scene, require="checkpoint missing")
        same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
            flat_leaves({"p": params, "c": consts}),
            flat_leaves({"p": rp, "c": rc})))
        check(step == 7 and same, f"restore: step {step}, same {same}")
        params, consts = rp, rc
        print(f"[flow] synthetic video {media.video.shape}, RBF INR saved "
              f"and restored, in {time.perf_counter() - t0:.1f} s")

        # the RBF distance stays full fp32 whatever a user's process sets
        # the TF32 flag to: the encoding of the whole Sintel pose grid is
        # bitwise the same with TF32 matmuls allowed
        pts = FT.pose_grid(torch.tensor([0.2], device=dev), FLOW_H,
                           FLOW_W).reshape(-1, 3)
        with torch.inference_mode():
            enc_off = get_encoding(spec, params, consts, pts)
            try:
                tf32.allow_tf32 = True
                enc_on = get_encoding(spec, params, consts, pts)
            finally:
                tf32.allow_tf32 = False
        check(torch.equal(enc_off, enc_on),
              "the RBF encoding changes with allow_tf32: max abs diff "
              f"{(enc_off - enc_on).abs().max().item():.3e}")
        del pts, enc_off, enc_on
        print("[flow] RBF encoding of the 436x1024 grid: bitwise the same "
              "with allow_tf32 on and off")

        # flow test: one warm-up pass, then the counted and timed pass
        check(not tf32.allow_tf32, "TF32 matmuls on")
        LP.flow_test_outputs(cfg, media, spec, params, consts)
        _reset_all_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = LP.flow_test_outputs(cfg, media, spec, params, consts)
        torch.cuda.synchronize()
        test_s = time.perf_counter() - t0
        test_counts = _all_counts()
        pairs = FLOW_FRAMES - 1
        check_counts(test_counts, "flow test (the exact occlusion scatter)")
        f12, masks = out["flow12"], out["masks"]
        check(f12.shape == (pairs, FLOW_H, FLOW_W, 2)
              and bool(np.isfinite(f12).all()),
              f"flow test flows {f12.shape}, finite "
              f"{bool(np.isfinite(f12).all())}")
        check(masks.shape == (pairs, FLOW_H, FLOW_W, 1)
              and set(np.unique(masks)) <= {0.0, 1.0},
              f"occlusion masks {masks.shape} {np.unique(masks)[:5]}")
        stats["test_fps"] = pairs / test_s
        mag = np.sqrt((f12 ** 2).sum(-1))
        print(f"[flow] flow test: {pairs} pairs in {test_s:.3f} s, "
              f"|flow| mean {mag.mean():.2f} px, max {mag.max():.2f} px, "
              f"visible {masks.mean():.3f}; launches {test_counts}")

        # interpolation at factor 2: warm-up, then counted and timed
        check(not tf32.allow_tf32, "TF32 matmuls on")
        LP.interpolate_frames(cfg, media, spec, params, consts, 2)
        _reset_all_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames = LP.interpolate_frames(cfg, media, spec, params, consts, 2)
        torch.cuda.synchronize()
        interp_s = time.perf_counter() - t0
        interp_counts = _all_counts()
        check_counts(interp_counts, f"interpolation ({pairs} mid-frames, 2 "
                                    "K5 + 2 K6 each)",
                     splat_region=2 * pairs, gather_region=2 * pairs)
        u8 = (np.clip(media.video, 0, 1) * 255).astype(np.uint8)
        check(frames.shape == (2 * pairs + 1, FLOW_H, FLOW_W, 3)
              and frames.dtype == np.uint8
              and np.array_equal(frames[::2], u8),
              f"interpolated frames {frames.shape} {frames.dtype}")
        stats["interp_fps"] = pairs / interp_s
        stats["counts"] = interp_counts
        print(f"[flow] interpolation x2: {pairs} mid-frames ({len(frames)} "
              f"frames out) in {interp_s:.3f} s; launches {interp_counts}")

        # alpha = 0 and 1 reproduce the endpoints at full size on the card
        pair = torch.from_numpy(media.video[2:4]).to(dev)
        ends = []
        for alpha, want in ((0.0, pair[0]), (1.0, pair[1])):
            got = FT.frame_interp(spec, cfg, params, consts,
                                  float(media.times[2]), pair, alpha,
                                  media.flow_scale)
            ends.append((got - want).abs().max().item())
        check(max(ends) <= 1e-5, f"endpoint frames: max abs err {ends}")
        print(f"[flow] alpha 0 / 1 reproduce the endpoints: max abs err "
              f"{ends[0]:.3e} / {ends[1]:.3e}")

        # the seeded net's flows are a few px; the same net at 16x the
        # flow scale gives flows of Sintel magnitude (tens of px, some
        # beyond the window): one mid-frame timed, and K5 on its splat
        # input, beside the same at the path's scale
        t2 = float(media.times[2])
        for tag, sc in (("path", media.flow_scale),
                        ("x16", 16.0 * media.flow_scale)):
            with torch.inference_mode():
                f01, _ = FT.flow_infer(spec, params, consts,
                                       torch.tensor([t2], device=dev), sc,
                                       FLOW_H, FLOW_W)
                mid = FT.frame_interp(spec, cfg, params, consts, t2, pair,
                                      0.5, sc)
                check(bool(torch.isfinite(mid).all()),
                      f"mid-frame at flow scale {tag}: non-finite")
                frame0 = pair[0:1]
                m0 = (frame0 - K6.resample2d_region(pair[1:2], f01, DY, DX)
                      ).abs().mean(-1, keepdim=True)
                e = torch.exp(-20.0 * m0)
                cat = torch.cat([frame0 * e, e, torch.ones_like(e)],
                                -1).contiguous()
                half = (0.5 * f01).contiguous()
                mag = f01.norm(dim=-1)
                beyond = ((f01[..., 1].abs() > DY - 1)
                          | (f01[..., 0].abs() > DX - 1)).float().mean()
                stats[f"scale_{tag}"] = {
                    "flow_mean_px": mag.mean().item(),
                    "flow_max_px": mag.max().item(),
                    "beyond_window": beyond.item(),
                    "mid_frame_ms": median_ms(lambda: FT.frame_interp(
                        spec, cfg, params, consts, t2, pair, 0.5, sc), 10),
                    "k5_device_ms": device_ms(lambda: K5.splat_region(
                        cat, half, DY, DX), 20)}
            r = stats[f"scale_{tag}"]
            print(f"[flow] flow scale {tag} ({sc:.1f}): |flow| mean "
                  f"{r['flow_mean_px']:.2f} px, max {r['flow_max_px']:.2f} "
                  f"px, beyond the window at {r['beyond_window']:.2%}; "
                  f"mid-frame {r['mid_frame_ms']:.3f} ms between events, "
                  f"K5 {r['k5_device_ms']:.4f} ms on the device")

        # the card against the CPU on a small crop (kernel route pinned)
        small = cfg.replace(splat_max_dy=16, splat_max_dx=16)
        crop = np.ascontiguousarray(media.video[2:4, :40, :64])
        t2 = torch.tensor([float(media.times[2])])
        res = []
        for d in (dev, torch.device("cpu")):
            p_, c_ = tree_to(params, d), tree_to(consts, d)
            fl, _ = FT.flow_infer(spec, p_, c_, t2.to(d), 12.8, 40, 64)
            mid = FT.frame_interp(spec, small, p_, c_, float(t2),
                                  torch.from_numpy(crop).to(d), 0.5, 12.8)
            res.append((fl.cpu(), mid.cpu()))
        (fg, mg), (fc, mc) = res
        ferr = (fg - fc).abs().max().item()
        merr = (mg - mc).abs().max().item()
        check(ferr <= 1e-3 and merr <= 1e-3,
              f"card vs CPU on a 40x64 crop: flows {ferr:.3e} px, frame "
              f"{merr:.3e} (limits 1e-3)")
        print(f"[flow] card vs CPU (40x64 crop): flows max abs err "
              f"{ferr:.3e} px, mid-frame {merr:.3e}")
        check(not tf32.allow_tf32, "TF32 matmuls on")
        stats["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"[flow] peak device memory {stats['peak_gib']:.2f} GiB, on {card} "
          f"({smi_line})")
    return stats


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    try:
        card, smi_line = phase_card()
        phase_build()
        rows, bf16_err = phase_kernels(dev)
        train_rows, bwd_bf16_err = phase_train_kernels(dev)
        counts, fps = phase_path(dev, card)
        train_counts, train = phase_train(dev, card, smi_line)
        flow_rows = phase_flow_kernels(dev)
        flow = phase_flow(dev, card, smi_line)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    add_counts(counts, train_counts)
    kernels = []
    for n in COUPLING:
        # K1/K2: the eval/infer shapes (batch 40), as before, with the
        # training shapes beside them; K3/K4: the training shapes
        rs = rows.get(n) or train_rows[n]
        bytes_ms = sum(r["bytes_bound_ms"] for r in rs)
        ops_ms = sum(r["fp32_bound_ms"] for r in rs)
        entry = {
            "name": n, "route": "cuda", "source": SOURCES[n],
            "replaces": REPLACES[n], "launches": counts[n],
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": sum(r["ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None,
            "shapes": rs,
        }
        if rows.get(n):
            entry["train_shapes"] = train_rows[n]
        else:
            entry["reduce_launches"] = counts["reduce_weight_grads"]
            entry["reduce_ms"] = sum(r["reduce_ms"] for r in rs)
        kernels.append(entry)
    for n, r in flow_rows.items():
        kernels.append({
            "name": n, "route": "cuda", "source": SOURCES[n],
            "replaces": REPLACES[n], "launches": flow["counts"][n],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": max(r["bytes_bound_ms"], r["ops_bound_ms"]),
            "bound_by": ("bytes" if r["bytes_bound_ms"] >= r["ops_bound_ms"]
                         else "operations"),
            "library_ms": r["library_ms"], "shapes": [r]})
    print(f"[flow] flow test {flow['test_fps']:.2f} frames/s (pairs), "
          f"on {card} ({smi_line})")
    print(f"[flow] interpolation {flow['interp_fps']:.2f} mid-frames/s, "
          f"on {card} ({smi_line})")
    print(f"[done] sr test {fps:.2f} frames/s; train "
          f"{train['frames_per_sec']:.2f} frames/s; bf16 err {bf16_err:.3e}"
          f" (K3 {bwd_bf16_err:.3e}); total "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
