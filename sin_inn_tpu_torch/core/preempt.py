"""Graceful preemption for the train loop.

A copy of ``sin_inn_tpu/core/preempt.py``: SIGTERM/SIGINT (what SLURM, k8s
and the like send before killing a job) flip a flag that the epoch loop
checks; the loop finishes the epoch in flight, writes a checkpoint and
returns, so a preempted run resumes where it stopped.
"""

from __future__ import annotations

import signal
import threading


class GracefulStop:
    """Flag that flips on SIGTERM/SIGINT; restores prior handlers on exit.

    Usage::

        with GracefulStop() as stop:
            for epoch in range(epochs):
                ...
                if stop:
                    store.save(epoch + 1, state)
                    break

    Safe off the main thread (signal handlers can only be installed from
    the main thread): it degrades to a never-set flag there.
    """

    def __init__(self):
        self.requested = False
        self._prev = {}

    def _handler(self, signum, frame):
        self.requested = True

    def __enter__(self) -> "GracefulStop":
        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    self._prev[sig] = signal.signal(sig, self._handler)
                except (ValueError, OSError):
                    pass
        return self

    def __exit__(self, *exc):
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._prev.clear()
        return False

    def __bool__(self) -> bool:
        return self.requested

    # non-context-manager form for loops with their own cleanup tails
    def install(self) -> "GracefulStop":
        return self.__enter__()

    def restore(self) -> None:
        self.__exit__(None, None, None)
