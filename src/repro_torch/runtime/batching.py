"""Slot scheduling for fixed-batch serving — counterpart of
:class:`repro.runtime.batching.SlotScheduler` (the JAX package's
``ContinuousBatcher`` over layer-stack models is not ported).

Priority FIFO admission, bounded-queue admission control and conservation
accounting: every submitted request reaches exactly one terminal state —
finished, rejected, or dropped — and is handed out exactly once.
"""

from __future__ import annotations

import heapq
from typing import Any, Callable, List, Optional, Tuple

__all__ = ["SlotScheduler"]


class SlotScheduler:
    """Queue + slot bookkeeping for fixed-batch serving.

    Requests are admitted to free slots in (priority desc, submit order)
    — FIFO among equal priorities (``priority`` is read via ``getattr``,
    default 0).  With ``max_queue`` set, :meth:`submit` applies admission
    control: a full queue rejects instead of growing without bound.
    (``preempt`` and ``shed_lowest``, which recovery and tier-aware
    overload control use in ``repro``, come with those features.)

    Invariants:

    * conservation — ``n_submitted == n_rejected + n_finished + n_dropped
      + len(queue) + busy_slots`` at every step;
    * each request is admitted at most once and finalised at most once;
    * ``len(active slots) <= n_slots`` always.
    """

    def __init__(self, n_slots: int, max_queue: Optional[int] = None):
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        self.n_slots = n_slots
        self.max_queue = max_queue
        self.active: List[Optional[Any]] = [None] * n_slots
        self._heap: List[Tuple[int, int, Any]] = []   # (-priority, seq, req)
        self._seq = 0
        self.n_submitted = 0
        self.n_rejected = 0
        self.n_finished = 0
        self.n_dropped = 0

    # ------------------------------------------------------------------ #
    def submit(self, req: Any) -> bool:
        """Queue ``req``; False when admission control rejects it."""
        self.n_submitted += 1
        if self.max_queue is not None and len(self._heap) >= self.max_queue:
            self.n_rejected += 1
            return False
        heapq.heappush(self._heap, (-getattr(req, "priority", 0), self._seq, req))
        self._seq += 1
        return True

    def reject(self, req: Any) -> None:
        """Count a request the caller refused before queueing (invalid
        prompt, cannot fit the cache, ...) so conservation still holds —
        the accounting stays in one place instead of callers poking
        counters."""
        self.n_submitted += 1
        self.n_rejected += 1

    def peek(self) -> Optional[Any]:
        """The request :meth:`admit` would consider first, or None."""
        return self._heap[0][2] if self._heap else None

    @property
    def busy_slots(self) -> int:
        return sum(1 for s in self.active if s is not None)

    def has_work(self) -> bool:
        return bool(self._heap) or any(s is not None for s in self.active)

    def admit(self, can_admit: Optional[Callable[[Any], bool]] = None
              ) -> List[Tuple[int, Any]]:
        """Fill free slots from the queue; returns newly (slot, request)
        pairs in admission order.

        ``can_admit`` gates each candidate on a resource check beyond slot
        count (the paged engine passes a block-availability predicate).
        Admission stops at the first refused request rather than skipping
        past it: FIFO-among-equal-priority order is part of the scheduler
        contract, so a briefly-unadmittable request causes head-of-line
        blocking instead of being silently overtaken."""
        out: List[Tuple[int, Any]] = []
        for slot in range(self.n_slots):
            if self.active[slot] is None and self._heap:
                if can_admit is not None and not can_admit(self._heap[0][2]):
                    break
                _, _, req = heapq.heappop(self._heap)
                self.active[slot] = req
                out.append((slot, req))
        return out

    def finish(self, slot: int) -> Any:
        """Release ``slot``, counting its request as finished."""
        req = self._release(slot)
        self.n_finished += 1
        return req

    def drop(self, slot: int) -> Any:
        """Release ``slot``, counting its request as dropped (deadline,
        cancellation, ...)."""
        req = self._release(slot)
        self.n_dropped += 1
        return req

    def _release(self, slot: int) -> Any:
        req = self.active[slot]
        if req is None:
            raise ValueError(f"slot {slot} is not active")
        self.active[slot] = None
        return req

    def drop_queued(self, pred: Callable[[Any], bool]) -> List[Any]:
        """Remove queued requests matching ``pred`` (e.g. expired
        deadlines) before they reach a slot."""
        keep, dropped = [], []
        for entry in self._heap:
            (dropped if pred(entry[2]) else keep).append(entry)
        if dropped:
            self._heap = keep
            heapq.heapify(self._heap)
            self.n_dropped += len(dropped)
        return [e[2] for e in dropped]

    def check_conservation(self) -> None:
        """Raise AssertionError if any request was lost or duplicated."""
        accounted = (self.n_rejected + self.n_finished + self.n_dropped
                     + len(self._heap) + self.busy_slots)
        assert accounted == self.n_submitted, (
            f"conservation violated: submitted={self.n_submitted} "
            f"accounted={accounted}")
