"""Cooperative preemption handling for training loops (plain Python, a
copy of `bevgen_tpu/training/preemption.py`).

Schedulers deliver SIGTERM ahead of maintenance or preemption; a trainer
turns that into "finish the current step, write a final checkpoint, exit
0" rather than dying mid-serialization.

Usage:
    with PreemptionGuard() as guard:
        for step in range(steps):
            ...
            if guard.should_stop:
                break
    # final checkpoint save runs after the loop either way
"""
from __future__ import annotations

import signal
import threading


class PreemptionGuard:
    """Installs SIGTERM/SIGINT handlers that set a flag instead of
    killing the process. Handlers are installed on __enter__ and the
    previous ones restored on __exit__ (nestable; only the outermost
    guard owns the handlers). Must enter from the main thread (a
    CPython signal rule); `should_stop` may be read from any thread.
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = tuple(signals)
        self._event = threading.Event()
        self._prev = {}

    def _handler(self, signum, frame):
        # Second delivery falls through to the previous handler (so a
        # second Ctrl-C still interrupts a stuck step).
        if self._event.is_set():
            prev = self._prev.get(signum)
            if callable(prev):
                prev(signum, frame)
            elif prev == signal.SIG_DFL:
                signal.signal(signum, signal.SIG_DFL)
                signal.raise_signal(signum)
            return
        self._event.set()
        print(f"[preemption] caught signal {signum}; finishing the "
              "current step and checkpointing")

    def __enter__(self):
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()
        return False

    @property
    def should_stop(self) -> bool:
        return self._event.is_set()
