"""Host-sharded loader with background prefetch (double buffering) — a
copy of :mod:`repro.data.loader`.

Wraps any step->batch source (e.g. SyntheticLM.batch_at) and keeps
``prefetch`` batches materialised ahead on a worker thread, so host input
prep overlaps device compute — the standard input-pipeline overlap trick,
testable on CPU.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, Optional

__all__ = ["PrefetchLoader"]


class PrefetchLoader:
    def __init__(self, batch_fn: Callable[[int], Any], *, start_step: int = 0,
                 prefetch: int = 2):
        self._fn = batch_fn
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            batch = self._fn(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        step, batch = self._q.get()
        return step, batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
