"""Straggler / hang detection — counterpart of :mod:`repro.ft.watchdog`,
copied whole so that the port never imports the JAX package (importing
``repro.ft`` runs ``repro/__init__.py``, which loads jax).
``tests/test_torch_ft.py`` drives both through the same fake-clock call
sequences and compares their flags.

``StepWatchdog`` tracks per-step wall times and flags stragglers against a
rolling median (real fleets: a slow HBM or thermal-throttled chip shows up
exactly like this).  ``HangDetector`` arms a timer around each step; if a
step exceeds the deadline the registered callback fires (checkpoint and
abort, typically) — on a real cluster that converts a hung collective into
a clean restart instead of a silent stall.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, List, Optional

__all__ = ["StepWatchdog", "HangDetector"]


@dataclass
class StepWatchdog:
    window: int = 50
    threshold: float = 2.0     # x median => straggler
    _times: Deque[float] = field(default_factory=deque)
    stragglers: List[int] = field(default_factory=list)
    _step: int = 0
    _t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> bool:
        """Record one step; returns True if it was a straggler."""
        assert self._t0 is not None, "start() not called"
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self._step += 1
        is_straggler = False
        if len(self._times) >= 5:
            med = sorted(self._times)[len(self._times) // 2]
            if dt > self.threshold * med:
                self.stragglers.append(self._step)
                is_straggler = True
        self._times.append(dt)
        if len(self._times) > self.window:
            self._times.popleft()
        return is_straggler

    @property
    def median(self) -> float:
        if not self._times:
            return 0.0
        return sorted(self._times)[len(self._times) // 2]


class HangDetector:
    """Arms a deadline around a step; fires ``on_hang`` if exceeded.

    Re-armable: one detector guards many steps (the serving engine arms
    it around every tick), and back-to-back arms must each observe their
    own overrun.  Two races make the naive Timer-only version drop
    hangs:

    * a step that overruns the deadline but whose Timer thread has not
      been scheduled by the time ``__exit__`` cancels it — the hang is
      real (the deadline elapsed) but ``fired`` never flips, so a second
      hang in the same recovery window is silently missed;
    * a stale Timer from a PREVIOUS arm that slips past ``cancel()`` and
      fires after the next arm reset ``fired`` — reporting a phantom
      hang against a healthy step.

    Each arm therefore carries a generation number (a stale fire against
    a newer generation is ignored, under a lock) and ``__exit__`` checks
    the elapsed ``time.perf_counter()`` clock against the deadline
    directly — deterministic, thread-free, and what makes the overrun
    path testable with a fake clock.  ``on_hang`` runs at most once per
    arm: whichever of the Timer thread and ``__exit__`` flips ``fired``
    first makes the call, the other sees the flag and stands down.
    """

    def __init__(self, timeout: float, on_hang: Callable[[], None]):
        self.timeout = timeout
        self.on_hang = on_hang
        self._timer: Optional[threading.Timer] = None
        self.fired = False
        self._gen = 0
        self._armed_at: Optional[float] = None
        self._lock = threading.Lock()

    def __enter__(self):
        with self._lock:
            self._gen += 1
            gen = self._gen
            self.fired = False
        self._armed_at = time.perf_counter()

        def fire(gen: int = gen) -> None:
            with self._lock:
                if gen != self._gen or self.fired:
                    return          # stale arm, or __exit__ beat us to it
                self.fired = True
            self.on_hang()

        self._timer = threading.Timer(self.timeout, fire)
        self._timer.daemon = True
        self._timer.start()
        return self

    def __exit__(self, *exc):
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        overran = (self._armed_at is not None
                   and time.perf_counter() - self._armed_at >= self.timeout)
        missed = False
        with self._lock:
            # invalidate the cancelled Timer even if its thread is past
            # the cancel window — it must not touch the next arm's flag
            self._gen += 1
            if overran and not self.fired:
                self.fired = True
                missed = True
        if missed:
            self.on_hang()
        return False
