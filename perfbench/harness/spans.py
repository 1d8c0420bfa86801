"""The span session of a traced run: the program's spans and counters
(``sin_inn_tpu_torch/core/profiler.py``) over ``trace_units`` units under a
``torch.profiler`` session of CUDA activity alone, and the session's idle
time put down to the layer the host was in.

One session a run, cached on the ``Run`` (:func:`session`), so that every
``metrics/idle.*`` and ``metrics/host_syncs.*`` reader reads the same one.
It waits ``SETTLE_S`` after its start, as :func:`trace.device_slice` does,
stamps the host clock around the program's anchor calls at both ends and
puts the spans on the trace's clock with them. The window is the host
clock's span of the units and a closing synchronise; the card is busy where
any kernel, copy or memset runs. Each idle stretch is split, piecewise, by
the innermost span open on the main thread across it, ``outside`` where
none is (:func:`attribute`): a name's share is its idle time over the
window, in %, and the shares add up to the session's idle share. The
counters give their increments per unit.

A program without spans (one older than them) gives no session, and its
metrics read nothing.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from harness.trace import DEVICE_CATS, SETTLE_S, _events, _merge

OUTSIDE = "outside"
NEEDS = ("enable_spans", "collect_spans", "anchor", "clock_offsets",
         "to_trace_us", "counters")
Interval = Tuple[float, float]
Named = Tuple[float, float, str]


@dataclass
class SpanSession:
    idle: Dict[str, float]          # % of the window, by innermost span
    per_unit: Dict[str, float]      # each counter's increment per unit


def idle_gaps(busy: Sequence[Interval], t0: float, t1: float
              ) -> List[Interval]:
    """The stretches of [t0, t1] outside the sorted, disjoint ``busy``."""
    out, cur = [], t0
    for a, b in busy:
        if a >= t1:
            break
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if cur < t1:
        out.append((cur, t1))
    return out


def segments(spans: Sequence[Named], t0: float, t1: float) -> List[Named]:
    """[t0, t1] cut where the innermost open span changes, as (start, end,
    name), ``outside`` where none is open; ``spans`` nest (one thread's)."""
    out: List[Named] = []
    cur = t0

    def emit(b: float, name: str) -> None:
        nonlocal cur
        lo, hi = max(cur, t0), min(b, t1)
        if hi > lo:
            out.append((lo, hi, name))
        cur = max(cur, b)

    stack: List[Named] = []
    for s in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][1] <= s[0]:
            emit(stack[-1][1], stack.pop()[2])
        emit(s[0], stack[-1][2] if stack else OUTSIDE)
        stack.append(s)
    while stack:
        emit(stack[-1][1], stack.pop()[2])
    emit(t1, OUTSIDE)
    return out


def attribute(busy: Sequence[Interval], spans: Sequence[Named], t0: float,
              t1: float) -> Dict[str, float]:
    """The idle time of [t0, t1] (outside the merged ``busy``) by the
    innermost span open across it, in %, of the window."""
    segs = segments(spans, t0, t1)
    out: Dict[str, float] = defaultdict(float)
    i = 0
    for a, b in idle_gaps(busy, t0, t1):
        while segs[i][1] <= a:
            i += 1
        j = i
        while j < len(segs) and segs[j][0] < b:
            lo, hi = max(a, segs[j][0]), min(b, segs[j][1])
            if hi > lo:
                out[segs[j][2]] += hi - lo
            j += 1
    return {k: 100.0 * v / (t1 - t0) for k, v in out.items()}


def _program():
    from sin_inn_tpu_torch.core import profiler as P
    return P if all(hasattr(P, f) for f in NEEDS) else None


def _measure(run) -> Optional[SpanSession]:
    P = _program()
    if P is None:
        return None
    from torch.profiler import ProfilerActivity, profile
    unit, n = run.entry.unit, int(run.cell.traffic["trace_units"])
    device = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.synchronize()
    before = P.counters()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(SETTLE_S)
        first = P.anchor(device)
        P.enable_spans()
        t0 = time.perf_counter_ns()
        units = sum(unit() for _ in range(n))
        torch.cuda.synchronize()
        t1 = time.perf_counter_ns()
        spans = P.collect_spans()
        last = P.anchor(device)
    after = P.counters()
    events = _events(prof)
    offsets = P.clock_offsets(events, first, last)
    edges = (first[0][0], last[-1][1])
    on_trace = lambda t: P.to_trace_us(t, offsets, edges)
    main = threading.get_native_id()
    own = [(on_trace(s.start_ns), on_trace(s.end_ns), s.name) for s in spans
           if s.thread == main]
    busy = _merge([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events if e.get("ph") == "X" and "dur" in e
                   and e.get("cat") in DEVICE_CATS])
    idle = attribute(busy, own, on_trace(t0), on_trace(t1))
    per_unit = {k: (v - before.get(k, 0)) / max(units, 1)
                for k, v in after.items() if v != before.get(k, 0)}
    print("spans " + json.dumps({
        "idle_percent": sum(idle.values()), "idle": idle,
        "per_unit": per_unit, "units": units, "window_s": (t1 - t0) * 1e-9,
        "anchor_drift_us": offsets[1] - offsets[0]}), file=sys.stderr)
    return SpanSession(idle, per_unit)


def session(run) -> Optional[SpanSession]:
    """The run's span session, measured on the first call."""
    if not hasattr(run, "span_session"):
        run.span_session = None if run.trace is None else _measure(run)
    return run.span_session


def idle_share(run, *names: str) -> Optional[float]:
    """The session's idle share, in %, under the spans ``names``."""
    s = session(run)
    return None if s is None else sum(s.idle.get(n, 0.0) for n in names)


def per_unit(run, counter: str) -> Optional[float]:
    """A counter's increment per unit over the session."""
    s = session(run)
    return None if s is None else s.per_unit.get(counter, 0.0)
