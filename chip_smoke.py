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
4. the path: a 102-frame synthetic 352x640 video, a seeded state saved and
   restored through the checkpoint store, ``sr test`` frames over both
   40-window batches and the eval step over the val split, on ``cuda`` in
   the ``float32`` compute mode. Launch counts are reset before and read
   after each, and must show that every 1x1 coupling ran in a kernel.

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
NUM_FRAMES = 102
HIDDEN = 256
CLAMP = 1.2
# published H100 SXM peaks (NVIDIA data sheet, dense)
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
REPLACES = {
    "fused_glow_forward_1x1": "sin_inn_tpu/ops/pallas/coupling.py:82",
    "fused_glow_inverse_1x1": "sin_inn_tpu/ops/pallas/coupling.py:111",
}
SOURCE = "sin_inn_tpu_torch/csrc/coupling_1x1.cu"


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


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


def coupling_cost(m: int, c: int, hidden: int, elem_bytes: int):
    """FLOP and bytes one coupling launch needs: four matmuls per pixel;
    x read once, y written once, each weight and bias read once."""
    len1 = c // 2
    len2 = c - len1
    flops = 2 * m * hidden * (len2 + 2 * len1 + len1 + 2 * len2)
    weights = (len2 * hidden + hidden + hidden * 2 * len1 + 2 * len1
               + len1 * hidden + hidden + hidden * 2 * len2 + 2 * len2)
    return flops, 2 * m * c * elem_bytes + 4 * weights


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
    rows = {n: [] for n in REPLACES}
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
        check(test_counts == {"fused_glow_forward_1x1": 0,
                              "fused_glow_inverse_1x1": 4 * n_test},
              f"sr test launches {test_counts}, want 4 inverse per batch "
              f"over {n_test} batches")
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
        check(eval_counts == {"fused_glow_forward_1x1": 4 * nb,
                              "fused_glow_inverse_1x1": 4 * nb},
              f"eval launches {eval_counts}, want 4 each per batch over "
              f"{nb} batches")
        for i, m in enumerate(metrics):
            vals = {k: v.item() for k, v in m.items()}
            check(all(math.isfinite(v) for v in vals.values()),
                  f"eval batch {i}: non-finite metric {vals}")
            print(f"[path] eval batch {i} ({val_batches[i]['hr'].shape[0]} "
                  f"windows): {vals}")
        counts = {k: test_counts[k] + eval_counts[k] for k in test_counts}

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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    try:
        card, _ = phase_card()
        phase_build()
        rows, bf16_err = phase_kernels(dev)
        counts, fps = phase_path(dev, card)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    kernels = []
    for n, rs in rows.items():
        bytes_ms = sum(r["bytes_bound_ms"] for r in rs)
        ops_ms = sum(r["fp32_bound_ms"] for r in rs)
        kernels.append({
            "name": n, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[n], "launches": counts[n],
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": sum(r["ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None,
            "shapes": rs,
        })
    print(f"[done] sr test {fps:.2f} frames/s; bf16 err {bf16_err:.3e}; "
          f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
