#!/usr/bin/env python3
"""Times the fused INR forward kernel (K7 forward) and the windowed splat
(K5, K5 local) of one checkout of the port on one card, or with ``--k8``
the 3x3 GLOW coupling's kernels (K8 forward and backward), so that two
checkouts can be compared inside one call.

    PYTHONPATH=CHECKOUT python3 tools/time_flow_kernels.py [LABEL] [--k8 | --k5]

Builds ``csrc/inr_fwd.cu`` and ``csrc/splat_region.cu`` of the
``sin_inn_tpu_torch`` package found on ``PYTHONPATH``, prints the registers
and spills ptxas gave each kernel, then at the flow path's shapes:

* K7 forward at N = 446,464 points (the 436x1024 pose grid) for ``PFF``
  (mask length 515, MLP 515-256-256-256-4) in the ``slab``, ``point`` and
  ``const`` modes, ``PRBF`` in ``slab`` mode, and ``RBF`` (no coordinate
  rows, constant mask), under a seeded spatial-controller state (cell
  values in [0, 1], ``spatial_res`` 50), fp32 and bf16 operands: the
  median, least and largest of 10 launches (CUDA events, after a warm-up);
* K5 at 1 x 436 x 1024 x 5 (dy 64, dx 128) on a smooth flow that leaves the
  window in part, and K5 local (local dy 32, dx 128, cap 64) on a flow of
  10-40 px drift a tile: the same over 20 batches of 10 launches (a batch's
  time over 10, which includes the host's launch path), and the device time
  of a launch (torch.profiler: every kernel and memset it queues) over 50.
  With ``--k5``: builds ``csrc/splat_region.cu`` alone, times these two,
  then K5 on a quarter of that flow and on 0.3 px of noise, with the device
  time of each of its kernels (``tools/probe_k5_parts.sh`` runs it on
  copies with a part of K5 switched off).

With ``--k8``: builds ``csrc/coupling_3x3.cu`` and ``csrc/coupling_3x3_bwd.cu``
(and the reduction's ``csrc/coupling_1x1_bwd.cu``), prints their registers
and spills, then at the SRF flagship's two octaves (one half coupling: 88 x
160, Cin 24 -> 256 -> 48, and 44 x 80, Cin 96 -> 256 -> 192, seeded
weights and inputs, fp32): K8 forward at batch 8 and 40 and K8 backward
(with its reduction) at batch 8, the median, least and largest of 10 (5 for
batch 40 and the backward) calls between CUDA events after a warm-up, and
the device time of each kernel of a backward call (torch.profiler, the mean
over 5 calls).

Run a parent checkout (``git archive`` into a git-ignored directory) and the
working tree in turns: parent, change, change, parent.
"""

from __future__ import annotations

import math
import re
import statistics
import sys

import torch

from sin_inn_tpu_torch.core import rng as R
from sin_inn_tpu_torch.core.config import FlowConfig
from sin_inn_tpu_torch.core.profiler import settle
from sin_inn_tpu_torch.models import controllers as C
from sin_inn_tpu_torch.models.inr import build_inr
from sin_inn_tpu_torch.ops.cuda import _build
from sin_inn_tpu_torch.ops.cuda import inr as K7
from sin_inn_tpu_torch.ops.cuda import splat as K5
from sin_inn_tpu_torch.ops.offsets import tile_flow_offsets
from sin_inn_tpu_torch.train import flow as FT

H, W = 436, 1024


def timed(fn, reps: int, per: int = 1):
    """(median, least, largest) ms a call over ``reps`` batches of ``per``
    calls between CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / per)
    return statistics.median(times), min(times), max(times)


def device_ms(fn, reps: int = 50):
    """(median, least, largest) device ms a call over ``reps`` calls:
    torch.profiler's device time of every kernel and memset a call queues,
    summed a call (a short kernel's event time is mostly the host's launch
    path). Traced up to three times if the trace lost device events."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            settle("cuda")
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        if len(evs) >= reps and len(evs) % reps == 0:
            break
    per = len(evs) // reps
    calls = [sum(e.device_time_total for e in evs[i * per:(i + 1) * per])
             / 1e3 for i in range(reps)]
    return statistics.median(calls), min(calls), max(calls)


def line(tag: str, label: str, t) -> None:
    print(f"[{label}] {tag}: median {t[0]:.4f} ms (min {t[1]:.4f}, max "
          f"{t[2]:.4f})")


def masks(spec, dev):
    ccfg = C.SpatialConfig.create(spec, 50, block_iterations=8)
    gen = torch.Generator(device=dev).manual_seed(11)
    state = C.spatial_init(ccfg, dev)._replace(
        mask=torch.rand((ccfg.cells, ccfg.encoding_dim), generator=gen,
                        device=dev))
    times = torch.tensor([0.2], device=dev)
    return {"const": state.mask[777].clone(),
            "slab": C.spatial_grid_mask_slabs(ccfg, state, times, H, W),
            "point": C.spatial_grid_mask_split(ccfg, state, times, H, W)}


def build(names, label: str) -> None:
    """Build the named sources; print each kernel's registers and spills."""
    for name, b in _build.build_all(names).items():
        for block in b.log.split("Compiling entry function '")[1:]:
            kernel = block.split("'", 1)[0]
            regs = block.split("Used ", 1)[1].split(" registers", 1)[0] \
                if "Used " in block else "?"
            spill = block.split("bytes stack frame, ", 1)[1].split(
                "\n", 1)[0] if "bytes stack frame, " in block else "?"
            print(f"[{label}] build {name}: {regs} registers, {spill}: "
                  f"{kernel[:80]}")


def kernel_ms(fn, reps: int = 5):
    """Mean device ms a call of each kernel ``fn`` queues (torch.profiler),
    by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        settle("cuda")
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per[e.name] = per.get(e.name, 0.0) + e.device_time_total / 1e3
    return {k: v / reps for k, v in per.items()}


def short(kernel: str) -> str:
    """A kernel's name without its namespace and arguments."""
    m = re.search(r"::(\w+)", kernel)
    return m.group(1) if m else kernel


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0) + " (power limit not read)"


def k8_times(label: str, dev) -> None:
    from sin_inn_tpu_torch.ops import subnet as S
    from sin_inn_tpu_torch.ops.cuda import coupling3x3 as K8

    build(["coupling_3x3", "coupling_3x3_bwd", "coupling_1x1_bwd"], label)
    torch.backends.cuda.matmul.allow_tf32 = False
    clamp = 1.2
    for h, w, cin in ((88, 160, 24), (44, 80, 96)):
        gen = R.root_generator(cin)
        sub = {k: {n: t.to(dev) for n, t in conv.items()}
               for k, conv in S.conv_subnet_init(gen, cin, 2 * cin, 3,
                                                 256).items()}
        g_dev = torch.Generator(device=dev).manual_seed(cin)
        for b in (8, 40):
            x_in = torch.randn((b, h, w, cin), generator=g_dev, device=dev)
            x_aff = torch.randn((b, h, w, cin), generator=g_dev, device=dev)
            with torch.no_grad():
                t = timed(lambda: K8.half_coupling_3x3(sub, x_in, x_aff,
                                                       clamp),
                          10 if b == 8 else 5)
            line(f"K8 forward {b}x{h}x{w} Cin {cin}", label, t)
            if b != 8:
                continue
            g = torch.randn(x_aff.shape, generator=g_dev, device=dev)
            bwd = lambda: K8.half_coupling_3x3_backward(sub, x_in, x_aff, g,
                                                        clamp)
            line(f"K8 backward {b}x{h}x{w} Cin {cin}", label, timed(bwd, 5))
            for name, ms in sorted(kernel_ms(bwd).items(),
                                   key=lambda kv: -kv[1]):
                print(f"[{label}]   K8 backward {b}x{h}x{w} Cin {cin}: "
                      f"{ms:.4f} ms {name[:90]}")
    print(f"[{label}] on {card()}")


def main() -> int:
    if not torch.cuda.is_available():
        print("time_flow_kernels: needs a CUDA device", file=sys.stderr)
        return 1
    args = [a for a in sys.argv[1:] if a not in ("--k8", "--k5")]
    label = args[0] if args else "tree"
    dev = torch.device("cuda", 0)
    if "--k8" in sys.argv[1:]:
        k8_times(label, dev)
        return 0
    k5_only = "--k5" in sys.argv[1:]
    build(["splat_region"] if k5_only else ["inr_fwd", "splat_region"], label)
    pts = FT.pose_grid(torch.tensor([0.2], device=dev), H,
                       W).reshape(-1, 3).contiguous()
    runs = () if k5_only else (
        ("PFF", "ff", ("slab", "point", "const")),
        ("PRBF", "rbf", ("slab",)), ("RBF", "rbf", ("const",)))
    with torch.inference_mode():
        for net, kind, modes in runs:
            cfg = FlowConfig(net=net, device="cuda")
            spec, params, consts = build_inr(
                R.named_fold(R.root_generator(10), "init"), net, cfg, dev)
            layers = [(l["w"], l["b"]) for l in params["mlp"]]
            ms = (masks(spec, dev) if spec.is_progressive
                  else {"const": torch.ones(512, device=dev)})
            for mode in modes:
                for bf16 in (False, True):
                    t = timed(lambda: K7.fused_inr_forward(
                        kind, consts["enc"], layers, pts, ms[mode], bf16), 10)
                    line(f"K7 forward {net} {mode} "
                         f"{'bf16' if bf16 else 'fp32'} N={pts.shape[0]}",
                         label, t)
            del ms

        gen = torch.Generator(device=dev).manual_seed(6)
        ys = torch.linspace(0.0, math.pi, H, device=dev)[None, :, None]
        xs = torch.linspace(0.0, 2 * math.pi, W, device=dev)[None, None, :]
        noise = torch.randn((1, H, W, 2), generator=gen, device=dev)
        fl = torch.stack([170.0 * torch.sin(xs + 0.5 * ys) + noise[..., 0],
                          85.0 * torch.cos(xs - ys) + noise[..., 1]],
                         -1).contiguous()
        img = torch.rand((1, H, W, 3), generator=gen, device=dev)
        e = (-20.0 * torch.rand((1, H, W, 1), generator=gen,
                                device=dev)).exp()
        cat = torch.cat([img * e, e, torch.ones_like(e)], -1).contiguous()
        k5 = lambda: K5.splat_region(cat, fl, 64, 128)
        line("K5 1x436x1024x5 dy 64 dx 128, events", label, timed(k5, 20, 10))
        line("K5 1x436x1024x5 dy 64 dx 128, device", label, device_ms(k5))
        hb, wb = -(-H // 128), -(-W // 128)
        drift = 10.0 + 30.0 * torch.rand((1, hb, wb, 2), generator=gen,
                                         device=dev)
        lfl = (drift.repeat_interleave(128, 1).repeat_interleave(128, 2)
               [:, :H, :W].contiguous())
        offs = tile_flow_offsets(lfl, 128, 128, 64, 0)
        k5l = lambda: K5.splat_region_local(cat, lfl, offs.off_out,
                                            offs.off_src, 32, 128)
        line("K5 local 1x436x1024x5 local dy 32 dx 128, events", label,
             timed(k5l, 20, 10))
        line("K5 local 1x436x1024x5 local dy 32 dx 128, device", label,
             device_ms(k5l))
        if k5_only:
            # the same static launch on a quarter of the flow and on 0.3 px
            # of noise (no source converges), with each kernel's device time
            for tag, f in (("flow", fl), ("flow / 4", fl / 4),
                           ("0.3 px noise", 0.3 * noise)):
                f = f.contiguous()
                k = lambda: K5.splat_region(cat, f, 64, 128)
                parts = ", ".join(f"{short(n)} {ms:.4f}"
                                  for n, ms in kernel_ms(k, 20).items())
                line(f"K5 on the {tag} ({parts}), device", label,
                     device_ms(k))
    print(f"[{label}] on {card()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
