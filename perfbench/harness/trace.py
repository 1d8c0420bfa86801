"""The traced slices: ``torch.profiler`` sessions over a few timed units
each, read back from their Chrome traces.

* :func:`device_slice` records CUDA activity alone, so that recording the
  host's operations does not widen the gaps between launches: the slice is
  the host clock's span of the units and a closing synchronise, the busy
  time the union of every kernel, copy and memset in it. ``busy_s``,
  ``window_s``, the idle share and the kernels' times come from it.
* :func:`host_slice` records CPU and CUDA activity, for the breakdown of
  the idle gaps by host operation alone: the slice is the span of a
  ``record_function`` annotation around the units and a synchronise.

Each session waits 10 ms after it starts before the units run, the rule
the program's own profiler follows (the first kernels queued right after
start can be missing from a trace without it).
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

SETTLE_S = 0.01
SLICE = "perfbench.slice"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")


@dataclass
class Trace:
    start_us: float
    end_us: float
    device: List[Tuple[float, float, str]]       # (start, end, name)
    host: List[Tuple[float, float, str]]
    units: int = 0
    busy: List[Tuple[float, float]] = field(default_factory=list)
    host_window_s: Optional[float] = None        # the host clock's span

    @property
    def window_s(self) -> float:
        if self.host_window_s is not None:
            return self.host_window_s
        return (self.end_us - self.start_us) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) * 1e-6

    def kernels(self, pattern: str) -> List[Tuple[float, float, str]]:
        rx = re.compile(pattern)
        return [e for e in self.device if rx.search(e[2])]


def _merge(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def parse(events: List[Dict]) -> Trace:
    ann = [e for e in events if e.get("name") == SLICE and "dur" in e
           and e.get("cat") in ("user_annotation", "cpu_op")]
    if not ann:
        raise RuntimeError("the trace holds no slice annotation")
    a = min(ann, key=lambda e: e["ts"])
    t0, t1 = float(a["ts"]), float(a["ts"]) + float(a["dur"])
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        if s + d <= t0 or s >= t1:
            continue
        item = (max(s, t0), min(s + d, t1), e.get("name", "?"))
        if e.get("cat") in DEVICE_CATS:
            dev.append(item)
        elif e.get("cat") in HOST_CATS and e.get("name") != SLICE:
            host.append(item)
    tr = Trace(t0, t1, dev, host)
    tr.busy = _merge([(s, e) for s, e, _ in dev])
    return tr


def _events(prof) -> List[Dict]:
    fd, path = tempfile.mkstemp(prefix="perfbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def device_slice(unit: Callable[[], int], n: int) -> Trace:
    """Run ``unit`` n times under a CUDA-only session; the device's
    activity over the host clock's span of the units."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(SETTLE_S)
        t0 = time.perf_counter()
        units = sum(unit() for _ in range(n))
        torch.cuda.synchronize()
        span = time.perf_counter() - t0
    dev = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
            e.get("name", "?")) for e in _events(prof)
           if e.get("ph") == "X" and "dur" in e
           and e.get("cat") in DEVICE_CATS]
    if not dev:
        raise RuntimeError("the device trace holds no kernel")
    tr = Trace(min(a for a, _, _ in dev), max(b for _, b, _ in dev), dev,
               [], units, _merge([(a, b) for a, b, _ in dev]), span)
    return tr


def host_slice(unit: Callable[[], int], n: int) -> Trace:
    """Run ``unit`` n times under a CPU and CUDA session; the annotated
    slice with its host operations (for :func:`breakdown`)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(SETTLE_S)
        with record_function(SLICE):
            units = sum(unit() for _ in range(n))
            torch.cuda.synchronize()
    tr = parse(_events(prof))
    tr.units = units
    return tr


def idle_percent(tr: Trace) -> Optional[float]:
    if tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def breakdown(tr: Trace, device: Optional[Trace] = None,
              top: int = 10) -> Dict[str, List]:
    """The device operations that took most time (in ``device`` where
    given), and the idle gaps of ``tr`` by the innermost host operation
    running at each gap's midpoint (``host_python`` where none is)."""
    ops: Dict[str, float] = defaultdict(float)
    for s, e, name in (device or tr).device:
        ops[name[:64]] += (e - s) * 1e-6
    gaps: Dict[str, float] = defaultdict(float)
    edges = [tr.start_us] + [x for ab in tr.busy for x in ab] + [tr.end_us]
    host = sorted(tr.host)
    starts = [h[0] for h in host]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        name = "host_python"
        # the latest-starting host operation that still runs at mid (among
        # the 4096 that started last before it: the nesting is shallow)
        hi = bisect.bisect_right(starts, mid) - 1
        for i in range(hi, max(hi - 4096, -1), -1):
            if host[i][1] >= mid:
                name = host[i][2][:64]
                break
        gaps[name] += (b - a) * 1e-6
    rank = lambda d: [[k, v] for k, v in sorted(d.items(),
                                                key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(ops), "idle_gaps": rank(gaps)}


def symbol(name: str) -> str:
    """A pattern matching a CUDA kernel by its function name in a
    demangled symbol (preceded by a space, a colon or nothing, followed by
    its template or argument list)."""
    return r"(?:^|[\s:])" + re.escape(name) + r"[<(]"


def group_time_s(tr: Trace, names: Sequence[str]) -> float:
    rx = re.compile("|".join(symbol(n) for n in names))
    return sum(e - s for s, e, n in tr.device if rx.search(n)) * 1e-6


def count(tr: Trace, pattern: str) -> int:
    return len(tr.kernels(pattern))
