#!/usr/bin/env python3
"""Times the fused INR forward kernel (K7 forward) and the windowed splat
(K5, K5 local) of one checkout of the port on one card, so that two
checkouts can be compared inside one call.

    PYTHONPATH=CHECKOUT python3 tools/time_flow_kernels.py [LABEL]

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

Run a parent checkout (``git archive`` into a git-ignored directory) and the
working tree in turns: parent, change, change, parent.
"""

from __future__ import annotations

import math
import statistics
import sys

import torch

from sin_inn_tpu_torch.core import rng as R
from sin_inn_tpu_torch.core.config import FlowConfig
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


def main() -> int:
    if not torch.cuda.is_available():
        print("time_flow_kernels: needs a CUDA device", file=sys.stderr)
        return 1
    label = sys.argv[1] if len(sys.argv) > 1 else "tree"
    dev = torch.device("cuda", 0)
    built = _build.build_all(["inr_fwd", "splat_region"])
    for name, b in built.items():
        for block in b.log.split("Compiling entry function '")[1:]:
            kernel = block.split("'", 1)[0]
            regs = block.split("Used ", 1)[1].split(" registers", 1)[0] \
                if "Used " in block else "?"
            spill = block.split("bytes stack frame, ", 1)[1].split(
                "\n", 1)[0] if "bytes stack frame, " in block else "?"
            print(f"[{label}] build {name}: {regs} registers, {spill}: "
                  f"{kernel[:80]}")
    pts = FT.pose_grid(torch.tensor([0.2], device=dev), H,
                       W).reshape(-1, 3).contiguous()
    runs = (("PFF", "ff", ("slab", "point", "const")),
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
    print(f"[{label}] on {torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
