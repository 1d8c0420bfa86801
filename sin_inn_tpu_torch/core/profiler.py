"""Profiling hooks over ``torch.profiler``, the program's spans and its
counters.

Counterpart of ``sin_inn_tpu/core/profiler.py``: :func:`trace`, a context
manager around one profiler session, and :class:`TraceWindow`, one trace of
N train steps after a warm-up (``--profile N``). A session records the
host's operators and, on a CUDA device, the card's kernels and copies
(CUPTI). It is written as one Chrome trace,
``<host>_<pid>.<ns>.pt.trace.json`` under ``logdir``, the layout
TensorBoard's profiler plugin reads; ``chrome://tracing`` and Perfetto read
it too. The edges of a window wait for the card with
``torch.cuda.synchronize()``: kernels are queued asynchronously, so the
clock or the profiler would otherwise cut a step in two. After
``start()`` a session on a CUDA device waits ``CUPTI_SETTLE_S`` before it
returns (:func:`settle`): the first kernels queued at once may otherwise be
missing from the trace.

**Spans.** ``with span("step.backward"):`` marks a layer boundary of the
program. Spans are off unless a session turns them on
(:func:`enable_spans` / :func:`collect_spans`; :func:`trace` and
:class:`TraceWindow` do so for their window): off, :func:`span` returns
one shared no-op context manager. On, each span keeps its name, its start
and end on the host's ``perf_counter_ns`` clock, its parent span and its
unit (the outermost span open on its thread when it opened), on a stack
of its own thread. No span is opened inside an autograd backward
function: the engine runs those on threads of its own.

**One clock.** A session stamps the host clock around :data:`ANCHORS`
anchor calls at its start and at its end (:func:`anchor`: on a CUDA device
``torch.cuda.synchronize()``, else a ``record_function`` annotation; the
first call 1 ms before the rest). The trace holds each of them on its own
clock (the ``cudaDeviceSynchronize`` runtime events, told from the
profiler's own by the gap, or the annotations), so :func:`clock_offsets`
gives the offset of the trace's clock from the host's at both ends.
:func:`trace` and :class:`TraceWindow` write the window's spans into their
trace on its clock, on the rows of their threads, where they nest above
the operators and kernels.

**Counters.** :func:`count` adds to a named integer, always (the kernels'
``launches.<kernel>``, the loops' ``host_syncs``, ``h2d_bytes`` and
``d2h_bytes``); :func:`counters` reads them all and
:func:`reset_counters` sets those of a prefix back to nothing.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import socket
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

# The first kernels queued right after start() (up to 19 of them) were
# missing from 2-3 of 250 traces of 200 x 2 launches each, and from none of
# 250 with this wait (NVIDIA H100 80GB HBM3, 700.00 W;
# tools/probe_trace_start.py).
CUPTI_SETTLE_S = 0.01
ANCHOR = "profiler.anchor"
# A group of anchor calls: one, a wait of ANCHOR_GAP_S, then the rest back
# to back. The wait tells the group's synchronise events from any other
# (the profiler adds its own at its stop); calls back to back are quick,
# and so bound the clocks' offset tightly (a call after a sleep can take
# 200-400 us, one back to back 30 us; NVIDIA H100 80GB HBM3).
ANCHORS = 8
ANCHOR_GAP_S = 0.001
# how many anchor-like events before the first group, or after the last,
# the match looks past
ANCHOR_SEARCH = 4
SPAN_CAT = "program_span"


def _on_cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def _sync(device) -> None:
    if _on_cuda(device):
        torch.cuda.synchronize(device)


def _profiler(device) -> torch.profiler.profile:
    """A profiler of the host's operators, and of the card's kernels when
    ``device`` is a CUDA device."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if _on_cuda(device):
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def settle(device) -> None:
    """Call right after a profiler's ``start()`` (or on entering its
    ``with``) with the card idle: on a CUDA device, wait until CUPTI records
    the card's kernels, so that the traced work is whole."""
    if _on_cuda(device):
        time.sleep(CUPTI_SETTLE_S)


# -- counters ----------------------------------------------------------------

_COUNTS: Dict[str, int] = {}
# the autograd engine's threads count the backward's launches
_COUNTS_LOCK = threading.Lock()


def count(name: str, n: int = 1) -> None:
    with _COUNTS_LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + n


def counters() -> Dict[str, int]:
    with _COUNTS_LOCK:
        return dict(_COUNTS)


def reset_counters(prefix="") -> None:
    """Drop the counters whose name starts with ``prefix`` (a string or a
    tuple of them; all by default)."""
    with _COUNTS_LOCK:
        for k in [k for k in _COUNTS if k.startswith(prefix)]:
            del _COUNTS[k]


# -- spans -------------------------------------------------------------------

class Span(NamedTuple):
    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: int         # 0: none
    unit: int           # the id of the outermost span open when it opened
    thread: int         # the thread's native id


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()
_SPANS_ON = False
_CLOSED: List[Span] = []
_IDS = itertools.count(1)
_LOCAL = threading.local()


def _stack() -> list:
    st = getattr(_LOCAL, "stack", None)
    if st is None:
        st = _LOCAL.stack = []
    return st


class _OpenSpan:
    __slots__ = ("name", "id", "parent", "unit", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        st = _stack()
        self.id = next(_IDS)
        self.parent, self.unit = ((st[-1].id, st[-1].unit) if st
                                  else (0, self.id))
        st.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _stack().pop()
        _CLOSED.append(Span(self.id, self.name, self.start, end, self.parent,
                            self.unit, threading.get_native_id()))
        return False


def span(name: str):
    """A context manager marking one layer boundary (see the module's
    docstring); the shared no-op while spans are off."""
    return _OpenSpan(name) if _SPANS_ON else _NO_SPAN


def enable_spans() -> None:
    """Start recording spans, with none kept so far."""
    global _SPANS_ON
    _CLOSED.clear()
    _SPANS_ON = True


def collect_spans() -> List[Span]:
    """Stop recording spans; the spans closed since :func:`enable_spans`,
    in the order they closed."""
    global _SPANS_ON
    _SPANS_ON = False
    out = list(_CLOSED)
    _CLOSED.clear()
    return out


# -- one clock ---------------------------------------------------------------

def anchor(device) -> List[Tuple[int, int]]:
    """A group of ``ANCHORS`` anchor calls: on a CUDA device each a
    synchronise, else a ``record_function(ANCHOR)`` annotation; the host's
    ``perf_counter_ns`` just before and just after each."""
    out = []
    for i in range(ANCHORS):
        if i == 1:
            # a busy wait: the calls after it stay quick
            end = time.perf_counter_ns() + int(ANCHOR_GAP_S * 1e9)
            while time.perf_counter_ns() < end:
                pass
        a = time.perf_counter_ns()
        if _on_cuda(device):
            torch.cuda.synchronize(device)
        else:
            with torch.profiler.record_function(ANCHOR):
                pass
        out.append((a, time.perf_counter_ns()))
    return out


def _anchor_events(events: Sequence[Dict]) -> List[Tuple[float, float]]:
    """The anchor-like calls in a Chrome trace's events, (ts, dur) in
    order: the ``cudaDeviceSynchronize`` runtime events where the trace
    holds enough, else the annotations."""
    for cat, name in (("cuda_runtime", "cudaDeviceSynchronize"),
                      ("user_annotation", ANCHOR)):
        found = sorted((float(e["ts"]), float(e["dur"])) for e in events
                       if e.get("ph") == "X" and e.get("cat") == cat
                       and e.get("name") == name and "dur" in e)
        if len(found) >= 2 * ANCHORS:
            return found
    raise RuntimeError("the trace holds no anchor calls")


def _group(stamps: Sequence[Tuple[int, int]],
           found: Sequence[Tuple[float, float]], starts) -> int:
    """Where in ``found`` the run of ``len(stamps)`` events starts, of
    ``starts`` the first whose gaps fit the stamps' best: each call's start
    lies inside its stamps, so its start less the first's lies in [a_k -
    b_0, b_k - a_0]."""
    (a0, b0), k = stamps[0], len(stamps)

    def misfit(j: int) -> float:
        out = 0.0
        for (a, b), (ts, _) in zip(stamps[1:], found[j + 1:j + k]):
            d = ts - found[j][0]
            out += max(0.0, (a - b0) / 1e3 - d, d - (b - a0) / 1e3)
        return out

    return min(starts, key=misfit)


def _offset_us(stamps: Sequence[Tuple[int, int]],
               found: Sequence[Tuple[float, float]]) -> float:
    """The offset (trace us minus host us) that puts each anchor call
    inside its host stamps: the middle of the range all of them allow, or
    of their own ranges' middles where they allow none together."""
    lo, hi = [], []
    for (a, b), (ts, dur) in zip(stamps, found):
        lo.append(ts + dur - b / 1e3)
        hi.append(ts - a / 1e3)
    if max(lo) <= min(hi):
        return (max(lo) + min(hi)) / 2
    return sum(x + y for x, y in zip(lo, hi)) / (2 * len(lo))


def clock_offsets(events: Sequence[Dict], first: Sequence[Tuple[int, int]],
                  last: Sequence[Tuple[int, int]]) -> Tuple[float, float]:
    """The trace's clock minus the host's, in us, at a session's start and
    at its end: ``first`` and ``last`` are :func:`anchor`'s stamps taken
    there, matched to the trace's first and last groups of anchor
    calls."""
    found = _anchor_events(events)
    n, k = len(found), len(first)
    i = _group(first, found, range(min(ANCHOR_SEARCH, n - 2 * k) + 1))
    j = _group(last, found, range(n - k, max(n - k - ANCHOR_SEARCH,
                                             i + k) - 1, -1))
    return (_offset_us(first, found[i:i + k]),
            _offset_us(last, found[j:j + k]))


def to_trace_us(t_ns: int, offsets: Tuple[float, float],
                edges_ns: Tuple[int, int]) -> float:
    """A host stamp on the trace's clock, the offset interpolated between
    the session's two ends (``edges_ns``: the host's stamps there)."""
    (o0, o1), (t0, t1) = offsets, edges_ns
    f = (t_ns - t0) / (t1 - t0) if t1 > t0 else 0.0
    return t_ns / 1e3 + o0 + (o1 - o0) * f


def span_events(spans: Sequence[Span], offsets: Tuple[float, float],
                edges_ns: Tuple[int, int]) -> List[Dict]:
    """Chrome trace events of ``spans`` on the trace's clock, on their
    threads' rows of this process."""
    out = []
    for s in spans:
        ts = to_trace_us(s.start_ns, offsets, edges_ns)
        out.append({"ph": "X", "cat": SPAN_CAT, "name": s.name,
                    "pid": os.getpid(), "tid": s.thread, "ts": ts,
                    "dur": to_trace_us(s.end_ns, offsets, edges_ns) - ts,
                    "args": {"id": s.id, "parent": s.parent,
                             "unit": s.unit}})
    return out


# -- sessions ----------------------------------------------------------------

def _export(prof: torch.profiler.profile, logdir: str,
            spans: Sequence[Span], first: list, last: list) -> str:
    """Write the session's Chrome trace under ``logdir``, with ``spans``
    on its clock (``first``, ``last``: the anchors' stamps at its start
    and end)."""
    os.makedirs(logdir, exist_ok=True)
    out = os.path.join(logdir, f"{socket.gethostname()}_{os.getpid()}."
                               f"{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(out)
    with open(out) as f:
        doc = json.load(f)
    offsets = clock_offsets(doc["traceEvents"], first, last)
    doc["traceEvents"] += span_events(spans, offsets,
                                      (first[0][0], last[-1][1]))
    doc["spanClockOffsetsUs"] = list(offsets)
    with open(out, "w") as f:
        json.dump(doc, f)
    return out


def _start(device):
    """Start a session with spans on; returns (profiler, anchor stamps)."""
    _sync(device)
    prof = _profiler(device)
    prof.start()
    settle(device)
    first = anchor(device)
    enable_spans()
    return prof, first


def _stop(prof, device, first, logdir: str) -> str:
    spans = collect_spans()
    last = anchor(device)
    prof.stop()
    return _export(prof, logdir, spans, first, last)


@contextlib.contextmanager
def trace(logdir: str, device="cuda"):
    """Profile the block, with the program's spans; its Chrome trace lands
    under ``logdir``. Yields the profiler (``key_averages()`` and
    friends)."""
    prof, first = _start(device)
    try:
        yield prof
    finally:
        _stop(prof, device, first, logdir)


class TraceWindow:
    """One profiler trace of ``steps`` train steps, with the program's
    spans.

    Call :meth:`tick` once after each dispatched step. The first ``warmup``
    steps are skipped (first calls build kernels and fill the allocator's
    cache); the trace starts after the next one and stops once ``steps``
    more have run, each edge after a ``torch.cuda.synchronize()``. Spans
    are on in between and land in the trace, nested in its steps. With
    ``steps <= 0`` it does nothing and never starts the profiler. ``path``
    is the written trace file, once there is one."""

    def __init__(self, logdir: str, steps: int, warmup: int = 2,
                 device="cuda"):
        self.logdir = logdir
        self.steps = steps
        self.warmup = warmup
        self.device = device
        self.done = steps <= 0
        self.path: Optional[str] = None
        self._i = 0
        self._start = 0
        self._prof: Optional[torch.profiler.profile] = None
        self._first: list = []

    def tick(self) -> None:
        if self.done:
            return
        self._i += 1
        if self._prof is None:
            if self._i > self.warmup:
                self._prof, self._first = _start(self.device)
                self._start = self._i
        elif self._i - self._start >= self.steps:
            self._finish()

    def _finish(self) -> None:
        self.path = _stop(self._prof, self.device, self._first, self.logdir)
        self._prof = None
        self.done = True

    def close(self) -> None:
        """Stop and write a trace still open (the run ended inside the
        window)."""
        if self._prof is not None:
            self._finish()
