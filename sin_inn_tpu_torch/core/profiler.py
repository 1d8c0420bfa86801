"""Profiling and step-timing hooks over ``torch.profiler``.

Counterpart of ``sin_inn_tpu/core/profiler.py``: :func:`trace`, a context
manager around one profiler session, :class:`StepTimer`, a rolling step
timer, and :class:`TraceWindow`, one trace of N train steps after a warm-up
(``--profile N``). A session records the host's operators and, on a CUDA
device, the card's kernels and copies (CUPTI). It is written as one Chrome
trace, ``<host>_<pid>.<ns>.pt.trace.json`` under ``logdir``, the layout
TensorBoard's profiler plugin reads; ``chrome://tracing`` and Perfetto read
it too. The edges of a window wait for the card with
``torch.cuda.synchronize()``: kernels are queued asynchronously, so the
clock or the profiler would otherwise cut a step in two. After
``start()`` a session on a CUDA device waits ``CUPTI_SETTLE_S`` before it
returns (:func:`settle`): the first kernels queued at once may otherwise be
missing from the trace.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import List, Optional

import torch

# The first kernels queued right after start() (up to 19 of them) were
# missing from 2-3 of 250 traces of 200 x 2 launches each, and from none of
# 250 with this wait (NVIDIA H100 80GB HBM3, 700.00 W;
# tools/probe_trace_start.py).
CUPTI_SETTLE_S = 0.01


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


def _export(prof: torch.profiler.profile, logdir: str) -> str:
    os.makedirs(logdir, exist_ok=True)
    out = os.path.join(logdir, f"{socket.gethostname()}_{os.getpid()}."
                               f"{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(out)
    return out


@contextlib.contextmanager
def trace(logdir: str, device="cuda"):
    """Profile the block; its Chrome trace lands under ``logdir``. Yields the
    profiler (``key_averages()`` and friends)."""
    prof = _profiler(device)
    _sync(device)
    prof.start()
    settle(device)
    try:
        yield prof
    finally:
        _sync(device)
        prof.stop()
        _export(prof, logdir)


class StepTimer:
    """Rolling step timer over the last ``window`` steps. On a CUDA
    ``device``, :meth:`stop` waits for the card before it reads the
    clock."""

    def __init__(self, window: int = 50, device=None):
        self.window = window
        self.device = device
        self._times: List[float] = []
        self._last: Optional[float] = None

    def start(self) -> None:
        self._last = time.perf_counter()

    def stop(self) -> float:
        if self.device is not None:
            _sync(self.device)
        now = time.perf_counter()
        dt = now - (self._last or now)
        self._times.append(dt)
        if len(self._times) > self.window:
            self._times.pop(0)
        self._last = now
        return dt

    @property
    def mean(self) -> float:
        return sum(self._times) / max(len(self._times), 1)

    def throughput(self, items_per_step: int) -> float:
        return items_per_step / self.mean if self._times else 0.0


class TraceWindow:
    """One profiler trace of ``steps`` train steps.

    Call :meth:`tick` once after each dispatched step. The first ``warmup``
    steps are skipped (first calls build kernels and fill the allocator's
    cache); the trace starts after the next one and stops once ``steps``
    more have run, each edge after a ``torch.cuda.synchronize()``. With
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

    def tick(self) -> None:
        if self.done:
            return
        self._i += 1
        if self._prof is None:
            if self._i > self.warmup:
                _sync(self.device)
                self._prof = _profiler(self.device)
                self._prof.start()
                settle(self.device)
                self._start = self._i
        elif self._i - self._start >= self.steps:
            self._finish()

    def _finish(self) -> None:
        _sync(self.device)
        self._prof.stop()
        self.path = _export(self._prof, self.logdir)
        self._prof = None
        self.done = True

    def close(self) -> None:
        """Stop and write a trace still open (the run ended inside the
        window)."""
        if self._prof is not None:
            self._finish()
