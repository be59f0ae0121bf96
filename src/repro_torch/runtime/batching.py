"""Continuous batching for serving — counterpart of
:mod:`repro.runtime.batching`: :class:`SlotScheduler` (priority FIFO
admission, bounded-queue admission control and conservation accounting:
every submitted request reaches exactly one terminal state — finished,
rejected, or dropped — and is handed out exactly once) and
:class:`ContinuousBatcher`, which runs a layer-stack LM
(:class:`repro_torch.models.lm.LM`) over a fixed decode batch, refilling
finished slots from the queue via a single-sequence prefill whose cache is
spliced into the slot.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["Request", "ContinuousBatcher", "SlotScheduler"]


@dataclass
class Request:
    uid: int
    prompt: np.ndarray               # (prompt_len,) int32
    max_new_tokens: int
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False


class SlotScheduler:
    """Queue + slot bookkeeping for fixed-batch serving.

    Requests are admitted to free slots in (priority desc, submit order)
    — FIFO among equal priorities (``priority`` is read via ``getattr``,
    default 0).  With ``max_queue`` set, :meth:`submit` applies admission
    control: a full queue rejects instead of growing without bound.  A
    tier-aware caller can instead make room with :meth:`shed_lowest` —
    evict the lowest-priority, most recently queued request below a
    priority floor — so overload sheds low-tier work before high-tier work
    is turned away; :meth:`preempt` moves a running request back into the
    queue (self-healing recovery and tier-aware preemption).  The policies
    live in the engine; this is only the mechanism.

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
        self._active_seq: Dict[int, int] = {}         # slot -> submit seq
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
    def queue_len(self) -> int:
        return len(self._heap)

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
                _, seq, req = heapq.heappop(self._heap)
                self.active[slot] = req
                self._active_seq[slot] = seq
                out.append((slot, req))
        return out

    def finish(self, slot: int) -> Any:
        """Release ``slot``, counting its request as finished."""
        req = self._release(slot)
        self.n_finished += 1
        return req

    def preempt(self, slot: int) -> Any:
        """Evict ``slot``'s request back into the queue at its ORIGINAL
        submit position (the self-healing engine requeues every in-flight
        request after a failed tick).  Not a terminal state: no counter
        moves (busy -> queued keeps conservation), and ``max_queue`` is not
        applied — already-admitted work is never shed by its own
        recovery."""
        seq = self._active_seq[slot]
        req = self._release(slot)
        heapq.heappush(self._heap, (-getattr(req, "priority", 0), seq, req))
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
        self._active_seq.pop(slot, None)
        return req

    def shed_lowest(self, min_priority: int) -> Optional[Any]:
        """Evict and return the queued request with the LOWEST priority
        strictly below ``min_priority`` (ties broken toward the most
        recently submitted — the entry with the least waiting time and the
        least claim on FIFO fairness).  ``None`` when every queued request
        is at or above the floor.  The victim is counted as rejected:
        shed-at-admission is a terminal state, and conservation (queued ->
        rejected) still balances."""
        victim_i = None
        for i, (neg_pri, seq, _req) in enumerate(self._heap):
            if -neg_pri >= min_priority:
                continue
            if victim_i is None or (neg_pri, seq) > self._heap[victim_i][:2]:
                victim_i = i
        if victim_i is None:
            return None
        req = self._heap.pop(victim_i)[2]
        heapq.heapify(self._heap)
        self.n_rejected += 1
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


class ContinuousBatcher:
    """Drives an LM's (prefill, decode_step) over a slot-based batch.

    ``model.prefill(params, {"tokens": (1, L)}, cache_cap)`` admits one
    request into a free slot; ``model.decode_step`` then runs all
    ``n_slots`` sequences every step (idle slots compute but are ignored —
    the fixed-batch tradeoff), on the device the params live on.  Greedy:
    the next token is the argmax of the logits (first index on ties)."""

    def __init__(self, model, params, *, n_slots: int, cache_cap: int, eos_id: int = 1):
        self.model = model
        self.params = params
        self.n_slots = n_slots
        self.cache_cap = cache_cap
        self.eos_id = eos_id
        self.device = params["embed"].device
        self.sched = SlotScheduler(n_slots)
        self.submitted: List[Request] = []
        self.caches = model.init_caches(n_slots, cache_cap, device=self.device)
        self.lengths = torch.zeros((n_slots,), dtype=torch.int32, device=self.device)
        self.next_token = torch.zeros((n_slots,), dtype=torch.int32, device=self.device)
        self.steps = 0
        self.busy_slot_steps = 0

    @property
    def active(self) -> List[Optional[Request]]:
        return self.sched.active

    # ------------------------------------------------------------------ #
    def submit(self, req: Request) -> None:
        self.sched.submit(req)
        self.submitted.append(req)

    def _splice_cache(self, slot: int, cache1: Any) -> None:
        """Write a single-sequence prefill cache into batch slot ``slot``
        (in place: the batcher owns its caches)."""
        def walk(full, one):
            if isinstance(full, dict):
                for k in full:
                    walk(full[k], one[k])
            elif isinstance(full, list):
                for f, o in zip(full, one):
                    walk(f, o)
            elif full is not None:
                _set_slot(full, one, slot)
        walk(self.caches, cache1)

    def _admit(self) -> None:
        for slot, req in self.sched.admit():
            toks = torch.as_tensor(np.asarray(req.prompt, np.int32),
                                   device=self.device)[None, :]
            logits, cache1, lengths1 = self.model.prefill(self.params, {"tokens": toks},
                                                          cache_cap=self.cache_cap)
            self._splice_cache(slot, cache1)
            self.lengths[slot] = lengths1[0]
            first = int(torch.argmax(logits[0]))
            req.out_tokens.append(first)
            self.next_token[slot] = first

    # ------------------------------------------------------------------ #
    def step(self) -> None:
        """One decode step over all slots."""
        self._admit()
        logits, self.caches = self.model.decode_step(self.params, self.next_token,
                                                     self.caches, self.lengths)
        active = torch.tensor([r is not None for r in self.active], dtype=torch.int32,
                              device=self.device)
        self.lengths = self.lengths + active
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        self.next_token = nxt
        self.steps += 1
        toks = nxt.tolist()
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            self.busy_slot_steps += 1
            tok = toks[slot]
            req.out_tokens.append(tok)
            if tok == self.eos_id or len(req.out_tokens) >= req.max_new_tokens:
                req.done = True
                self.sched.finish(slot)

    def run(self, max_steps: int = 10_000) -> List[Request]:
        """Drive until queue and slots drain (or ``max_steps``); returns
        every submitted request that finished, each exactly once."""
        while self.sched.has_work() and self.steps < max_steps:
            self.step()
        finished = [r for r in self.submitted if r.done]
        self.submitted = [r for r in self.submitted if not r.done]
        return finished

    @property
    def utilisation(self) -> float:
        return self.busy_slot_steps / max(self.steps * self.n_slots, 1)


def _set_slot(full: torch.Tensor, one: torch.Tensor, slot: int) -> None:
    """Set batch index ``slot`` of ``full`` from single-batch ``one``, in
    place.  Works for both stacked (n_periods, B, ...) and plain (B, ...)
    leaves: the batch dim is the first whose size differs (one has size 1).
    With one slot the shapes are equal and the slot is the whole leaf."""
    if full.shape == one.shape and slot == 0:
        full.copy_(one)
        return
    for axis in range(full.dim()):
        if one.shape[axis] == 1 and full.shape[axis] != 1:
            full.narrow(axis, slot, 1).copy_(one)
            return
    raise ValueError(f"no batch axis found: {tuple(full.shape)} vs {tuple(one.shape)}")
