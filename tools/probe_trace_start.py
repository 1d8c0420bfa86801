#!/usr/bin/env python3
"""Counts the kernel events a torch.profiler session misses at its start,
with and without ``core/profiler.py``'s ``settle`` wait, on one card.

    python3 tools/probe_trace_start.py [--sessions 250]

Builds ``csrc/gather_region.cu``, then at the flow train step's shape (K6
grads, 1 x 436 x 1024 x 3, resample coordinates, a seeded window flow)
traces 200 launches each of K6 grads and ``grid_sampler_2d_backward`` in
turns, one kernel a call, ``--sessions`` times for each of four kinds of
session taken in turns: CUDA activity alone or CPU + CUDA, each with the
launches queued right after the profiler starts or after ``settle``. A
session that holds fewer than 400 of the two kernels lost some: the tool
prints, per kind, how many sessions lost events, how many were lost in all
and the most in one session, and whether the events kept alternate (a loss
at the start keeps them alternating), then one JSON line of the same.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sin_inn_tpu_torch.core.profiler import CUPTI_SETTLE_S, settle  # noqa: E402
from sin_inn_tpu_torch.ops.cuda import gather as K6  # noqa: E402

H, W, C = 436, 1024, 3
DY, DX = 64, 128
CALLS = 200


def window_flow(gen, dev):
    """A seeded smooth flow that leaves the dy 64 / dx 128 window in part
    of the frame, plus a little noise."""
    ys = torch.linspace(0.0, math.pi, H, device=dev)[None, :, None]
    xs = torch.linspace(0.0, 2 * math.pi, W, device=dev)[None, None, :]
    noise = torch.randn((1, H, W, 2), generator=gen, device=dev)
    return torch.stack([170.0 * torch.sin(xs + 0.5 * ys) + noise[..., 0],
                        85.0 * torch.cos(xs - ys) + noise[..., 1]],
                       -1).contiguous()


def calls(dev):
    """K6 grads and the grid-gradient-only backward of grid_sample on the
    same payload and flow: one kernel each."""
    gen = torch.Generator(device=dev).manual_seed(8)
    fl = window_flow(torch.Generator(device=dev).manual_seed(6), dev)
    a = torch.rand((1, H, W, C), generator=gen, device=dev)
    q = torch.randn((1, H, W, C), generator=gen, device=dev)
    coord = K6.resample_coord(H, W)
    ys, xs = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32),
                            torch.arange(W, device=dev, dtype=torch.float32),
                            indexing="ij")
    grid = torch.stack([(xs + fl[0, ..., 0]) / (W - 1) * 2 - 1,
                        (ys + fl[0, ..., 1]) / (H - 1) * 2 - 1],
                       -1)[None].contiguous()
    inp = a.permute(0, 3, 1, 2).contiguous()
    gout = q.permute(0, 3, 1, 2).contiguous()
    return [lambda: K6.gather_region_grads(a, fl, q, DY, DX, coord),
            lambda: torch.ops.aten.grid_sampler_2d_backward(
                gout, inp, grid, 0, 0, False, [False, True])]


def session(fns, cpu: bool, wait: bool):
    """The two kernels' events of one traced session, in time order."""
    from torch.profiler import ProfilerActivity, profile

    acts = ([ProfilerActivity.CPU] if cpu else []) + [ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        if wait:
            settle("cuda")
        for _ in range(CALLS):
            for fn in fns:
                fn()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and ("gather" in e.name or "grid_sampler" in e.name)),
                 key=lambda e: e.time_range.start)
    return [e.name for e in evs]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sessions", type=int, default=250)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_trace_start: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    fns = calls(dev)
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    kinds = {f"{'cpu+cuda' if cpu else 'cuda'}, "
             f"{'settle' if wait else 'no wait'}": (cpu, wait)
             for wait in (False, True) for cpu in (False, True)}
    out = {k: {"sessions": 0, "short": 0, "lost": 0, "most": 0,
               "alternating": True} for k in kinds}
    t0 = time.perf_counter()
    for _ in range(a.sessions):
        for k, (cpu, wait) in kinds.items():
            names = session(fns, cpu, wait)
            r = out[k]
            r["sessions"] += 1
            lost = 2 * CALLS - len(names)
            if lost:
                r["short"] += 1
                r["lost"] += lost
                r["most"] = max(r["most"], lost)
            r["alternating"] &= all(x != y for x, y in zip(names, names[1:]))
    for k, r in out.items():
        print(f"[trace start] {k}: {r['short']} of {r['sessions']} sessions "
              f"lost events, {r['lost']} in all, at most {r['most']} in one;"
              f" events kept alternate: {r['alternating']}")
    print(f"[trace start] settle waits {CUPTI_SETTLE_S * 1e3:g} ms; "
          f"{time.perf_counter() - t0:.1f} s")
    print(json.dumps({"settle_s": CUPTI_SETTLE_S, "kinds": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
