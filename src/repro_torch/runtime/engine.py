"""Program-backed serving engine, dense or paged KV cache — counterpart of
:mod:`repro.runtime.engine`.

Both engine steps are compiled :class:`~repro_torch.core.program.Program`\\ s
over the GraphIR LM (:mod:`repro_torch.models.graph_lm`):

* decode Program — tokens (B, 1) + caches -> next-token logits, one call
  per decode tick over the whole fixed slot batch;
* prefill Program — tokens (B, chunk) + caches -> per-position logits;
  long prompts are split into fixed-size chunks interleaved with decode
  ticks.

With ``paged=True`` the per-slot dense caches become one shared page pool
per layer (fp32 or int8 pages) reached through block tables;
:class:`PagedProgramStepper` owns the pool tensors and a
:class:`~repro_torch.runtime.kv_cache.BlockPool` owns the bookkeeping
(prefix reuse, copy-on-write), and admission waits on blocks as well as
slots.

Scheduling is deterministic and tick-based (wall-clock only feeds
metrics): :class:`~repro_torch.runtime.batching.SlotScheduler` supplies
priority FIFO admission with bounded-queue admission control; per-request
deadlines (in ticks) drop expired work from the queue and from slots.

Exactness contract: under greedy decoding the engine's outputs are
token-exact against :class:`UnbatchedReference` — a no-batching loop over
B=1 Programs compiled from the same graphs.  On the card this holds
because every kernel computes a sequence's rows with arithmetic that does
not depend on the batch (see ``csrc/``).

Not ported yet (see ROADMAP.md): int8 weights (``quantize``), speculative
decoding, self-healing and tier-aware overload control, tensor parallel
serving, ``AsyncEngine``, dense resume (``relocate_slots``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.device import DeviceLike, resolve_device, to_tensor
from repro_torch.core.program import compile
from repro_torch.core.selector import BackendPolicy
from repro_torch.models.graph_lm import (GraphLMConfig, build_decode_graph,
                                         build_paged_decode_graph,
                                         build_paged_prefill_graph,
                                         build_prefill_graph, init_cache_inputs,
                                         init_lm_params, init_paged_cache_inputs,
                                         params_from_numpy)
from repro_torch.runtime.batching import SlotScheduler
from repro_torch.runtime.kv_cache import BlockPool, kv_page_bytes

__all__ = [
    "EngineRequest", "EngineMetrics", "Engine", "ProgramStepper",
    "PagedProgramStepper", "UnbatchedReference", "build_lm_serving", "padded_len",
]


def padded_len(n: int, chunk: int) -> int:
    """Prompt length rounded up to a whole number of prefill chunks."""
    return -(-max(n, 1) // chunk) * chunk


# --------------------------------------------------------------------------- #
# Requests and metrics
# --------------------------------------------------------------------------- #

@dataclass
class EngineRequest:
    """One generation request.  Terminal states are mutually exclusive:
    ``done`` (finished normally) or ``dropped`` (reason string — admission
    rejection or deadline expiry); partial output survives a drop."""

    uid: int
    prompt: np.ndarray                      # (prompt_len,) int32
    max_new_tokens: int
    priority: int = 0
    deadline_tick: Optional[int] = None     # absolute engine tick to finish by
    on_token: Optional[Callable[["EngineRequest", int], None]] = None
    on_finish: Optional[Callable[["EngineRequest"], None]] = None

    out_tokens: List[int] = field(default_factory=list)
    done: bool = False
    dropped: Optional[str] = None
    submit_tick: int = -1
    first_token_tick: Optional[int] = None
    finish_tick: Optional[int] = None
    t_submit: float = 0.0
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    max_gap_s: float = 0.0                  # max wall gap between our tokens
    max_gap_ticks: int = 0                  # same, in deterministic ticks
    _t_last_token: Optional[float] = None
    _last_token_tick: Optional[int] = None

    @property
    def latency_s(self) -> Optional[float]:
        return None if self.t_done is None else self.t_done - self.t_submit

    @property
    def ttft_s(self) -> Optional[float]:
        return None if self.t_first is None else self.t_first - self.t_submit

    @property
    def ttft_ticks(self) -> Optional[int]:
        """Deterministic TTFT: engine ticks from submit to first token."""
        return (None if self.first_token_tick is None
                else self.first_token_tick - self.submit_tick)


def _pct(xs: Sequence[float], q: float) -> Optional[float]:
    """Percentile of a sample list; ``None`` for an empty window (no data
    is not a perfect p99)."""
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else None


def _pct_dict(xs: Sequence[float]) -> Dict[str, Any]:
    return {"p50": _pct(xs, 50), "p95": _pct(xs, 95), "p99": _pct(xs, 99),
            "n_samples": len(xs)}


@dataclass
class EngineMetrics:
    """Aggregated serving metrics (wall times are host clocks around ticks
    that end with the logits on the host, so device work is included)."""

    n_finished: int = 0
    n_dropped: int = 0
    n_rejected: int = 0
    ticks: int = 0
    decode_ticks: int = 0
    prefill_ticks: int = 0
    busy_slot_ticks: int = 0    # slots doing real work, summed over ticks
    n_slots: int = 0
    tokens_out: int = 0
    wall_s: float = 0.0
    latencies_s: List[float] = field(default_factory=list)
    ttfts_s: List[float] = field(default_factory=list)
    max_intertoken_gap_s: float = 0.0
    decode_tokens: int = 0
    decode_wall_s: float = 0.0
    prefill_wall_s: float = 0.0

    @property
    def busy_slot_fraction(self) -> float:
        return self.busy_slot_ticks / max(self.ticks * self.n_slots, 1)

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_out / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def decode_tokens_per_s(self) -> float:
        return (self.decode_tokens / self.decode_wall_s
                if self.decode_wall_s > 0 else 0.0)

    def summary(self) -> Dict[str, Any]:
        return {
            "n_finished": self.n_finished,
            "n_dropped": self.n_dropped,
            "n_rejected": self.n_rejected,
            "ticks": self.ticks,
            "decode_ticks": self.decode_ticks,
            "prefill_ticks": self.prefill_ticks,
            "tokens_out": self.tokens_out,
            "wall_s": self.wall_s,
            "tokens_per_s": self.tokens_per_s,
            "busy_slot_fraction": self.busy_slot_fraction,
            "latency_s": _pct_dict(self.latencies_s),
            "ttft_s": _pct_dict(self.ttfts_s),
            "max_intertoken_gap_s": self.max_intertoken_gap_s,
            "decode_tokens": self.decode_tokens,
            "decode_wall_s": self.decode_wall_s,
            "decode_tokens_per_s": self.decode_tokens_per_s,
            "prefill_wall_s": self.prefill_wall_s,
        }


# --------------------------------------------------------------------------- #
# Program-backed step functions
# --------------------------------------------------------------------------- #

def _cache_names(cfg: GraphLMConfig) -> List[str]:
    return sorted(init_cache_inputs(cfg, 1, 1))


class ProgramStepper:
    """Owns the two compiled Programs plus the cache tensors they thread.
    Step dispatch goes through :meth:`Program.bind`, the positional
    fast-call path."""

    paged = False

    def __init__(self, cfg: GraphLMConfig, params: Mapping[str, Any], *,
                 n_slots: int, chunk: int, cache_cap: int,
                 policy: Optional[BackendPolicy] = None,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.n_slots = n_slots
        self.chunk = chunk
        self.cache_cap = cache_cap
        self.device = resolve_device(device)
        dec_g = build_decode_graph(cfg, params, batch=n_slots, cache_cap=cache_cap)
        pre_g = build_prefill_graph(cfg, params, batch=n_slots, chunk=chunk,
                                    cache_cap=cache_cap)
        self.decode_program = compile(dec_g, policy=policy, device=self.device)
        self.prefill_program = compile(pre_g, policy=policy, device=self.device)
        self.cache_names = list(dec_g.outputs[1:])  # new_cache_*
        cache_inputs = _cache_names(cfg)
        self._input_names = ("tokens", "start", "n_new", *cache_inputs)
        self._dec = self.decode_program.bind(*self._input_names, donate=cache_inputs)
        self._pre = self.prefill_program.bind(*self._input_names, donate=cache_inputs)
        shape = (n_slots, cache_cap, cfg.n_kv_heads, cfg.d_head)
        self.caches: Dict[str, torch.Tensor] = {
            name: torch.zeros(shape, dtype=torch.float32, device=self.device)
            for name in cache_inputs}

    def _call(self, fn, tokens, start, n_new, *extra) -> np.ndarray:
        dev = self.device
        outs = fn(to_tensor(tokens, dev), to_tensor(start, dev), to_tensor(n_new, dev),
                  *[to_tensor(e, dev) for e in extra],
                  *[self.caches[n] for n in sorted(self.caches)])
        logits = outs[0].cpu().numpy()
        for name, arr in zip(self.cache_names, outs[1:]):
            self.caches[name.replace("new_", "")] = arr
        return logits

    def backend_summary(self) -> Dict[str, Dict[str, Dict[str, int]]]:
        """Per-phase, per-op backend assignment counts:
        ``{"prefill"|"decode": {op: {backend: node_count}}}``."""
        out: Dict[str, Dict[str, Dict[str, int]]] = {}
        for phase, prog in (("prefill", self.prefill_program),
                            ("decode", self.decode_program)):
            per_op: Dict[str, Dict[str, int]] = {}
            assignment = prog.assignment
            for node in prog.graph.nodes:
                counts = per_op.setdefault(node.op, {})
                b = assignment[node.name]
                counts[b] = counts.get(b, 0) + 1
            out[phase] = per_op
        return out

    def prefill(self, tokens: np.ndarray, start: np.ndarray,
                n_new: np.ndarray) -> np.ndarray:
        """tokens (B, chunk) -> logits (B, chunk, V); caches advance."""
        return self._call(self._pre, tokens, start, n_new)

    def decode(self, tokens: np.ndarray, start: np.ndarray,
               n_new: np.ndarray) -> np.ndarray:
        """tokens (B, 1) -> logits (B, V); caches advance."""
        return self._call(self._dec, tokens, start, n_new)


class PagedProgramStepper(ProgramStepper):
    """Paged variant: the per-slot dense caches are replaced by one shared
    page pool per layer plus per-sequence block tables
    (:class:`~repro_torch.runtime.kv_cache.BlockPool` owns the host-side
    block bookkeeping; this class owns the device page tensors and the
    compiled paged Programs).

    The engine's view is unchanged — same ``prefill(tokens, start, n_new)``
    / ``decode(...)`` signatures — because this class records the written
    rows with the pool itself (it sees the token values and ``n_new``),
    applies any pending copy-on-write page copies to the device tensors,
    and threads the freshly built block tables into the Program call.
    What the engine gains on top is the admission interface:
    :meth:`try_admit` (claim cached prefix blocks + reserve worst-case
    growth; ``None`` = not enough blocks right now), :meth:`attach` and
    :meth:`release`.
    """

    paged = True

    def __init__(self, cfg: GraphLMConfig, params: Mapping[str, Any], *,
                 n_slots: int, chunk: int, page_size: int, n_blocks: int,
                 max_pages: int, kv_dtype: str = "float32",
                 policy: Optional[BackendPolicy] = None,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.n_slots = n_slots
        self.chunk = chunk
        self.page_size = page_size
        self.n_blocks = n_blocks
        self.max_pages = max_pages
        self.kv_dtype = kv_dtype
        self.cache_cap = max_pages * page_size   # per-sequence logical cap
        self.device = resolve_device(device)
        dec_g = build_paged_decode_graph(cfg, params, batch=n_slots, n_blocks=n_blocks,
                                         page_size=page_size, max_pages=max_pages,
                                         kv_dtype=kv_dtype)
        pre_g = build_paged_prefill_graph(cfg, params, batch=n_slots, chunk=chunk,
                                          n_blocks=n_blocks, page_size=page_size,
                                          max_pages=max_pages, kv_dtype=kv_dtype)
        self.decode_program = compile(dec_g, policy=policy, device=self.device)
        self.prefill_program = compile(pre_g, policy=policy, device=self.device)
        self.cache_names = list(dec_g.outputs[1:])  # new_cache_* (+ _scale)
        pools = init_paged_cache_inputs(cfg, n_blocks, page_size, kv_dtype=kv_dtype)
        cache_inputs = sorted(pools)
        self._input_names = ("tokens", "start", "n_new", "block_tables", *cache_inputs)
        self._dec = self.decode_program.bind(*self._input_names, donate=cache_inputs)
        self._pre = self.prefill_program.bind(*self._input_names, donate=cache_inputs)
        self.caches: Dict[str, torch.Tensor] = {
            name: torch.zeros(arr.shape, dtype=torch.int8 if arr.dtype == np.int8
                              else torch.float32, device=self.device)
            for name, arr in pools.items()}
        self.pool = BlockPool(
            n_blocks, page_size, kv_dtype=kv_dtype,
            page_bytes=kv_page_bytes(cfg.n_layers, cfg.n_kv_heads, cfg.d_head,
                                     page_size, kv_dtype))
        self._slot_seq: Dict[int, int] = {}

    # ---------------------------- admission --------------------------- #
    def try_admit(self, prompt: np.ndarray,
                  max_new_tokens: int) -> Optional[Tuple[int, int]]:
        """Claim the request's cached prefix and reserve its worst-case
        block count.  Returns ``(sequence id, reused_tokens)`` or ``None``
        when the pool cannot currently cover it (leave it queued)."""
        return self.pool.admit([int(t) for t in prompt], max_new_tokens)

    def attach(self, slot: int, sid: int) -> None:
        self._slot_seq[slot] = sid

    def release(self, slot: int, *, register: bool = True) -> None:
        """Return the slot's blocks to the pool; a finished sequence
        (``register=True``) leaves its pages in the prefix index for
        future prompts to share."""
        self.pool.release(self._slot_seq.pop(slot), register=register)

    # ------------------------------ steps ----------------------------- #
    def _record_writes(self, tokens: np.ndarray, start: np.ndarray,
                       n_new: np.ndarray) -> None:
        """Mirror this step's row writes into the pool (allocating pages
        and triggering CoW), then apply the resulting page copies to the
        device tensors BEFORE the Program call writes the new rows."""
        for s in range(self.n_slots):
            n = int(n_new[s])
            if n == 0:
                continue
            sid = self._slot_seq[s]
            seq = self.pool.sequence(sid)
            if seq.n_tokens != int(start[s]):
                raise RuntimeError(f"slot {s}: pool at {seq.n_tokens}, engine "
                                   f"writing at {int(start[s])}")
            self.pool.append(sid, [int(t) for t in tokens[s, :n]])
        copies = self.pool.take_copies()
        if copies:
            src = torch.tensor([c[0] for c in copies], dtype=torch.long, device=self.device)
            dst = torch.tensor([c[1] for c in copies], dtype=torch.long, device=self.device)
            # axis 0 is the block id of every cache tensor — the page pools
            # AND the int8 (N, Hk) scale sidecars — so one copy keeps a
            # quantized CoW page bit-identical to its source.  In place: the
            # stepper owns these tensors (every Program op is functional and
            # hands back new ones), so nothing else can see the write.
            for arr in self.caches.values():
                arr.index_copy_(0, dst, arr[src])

    def _tables(self) -> np.ndarray:
        bt = np.zeros((self.n_slots, self.max_pages), np.int32)
        for s, sid in self._slot_seq.items():
            table = self.pool.block_table(sid)
            bt[s, :len(table)] = table
        return bt

    def prefill(self, tokens: np.ndarray, start: np.ndarray,
                n_new: np.ndarray) -> np.ndarray:
        self._record_writes(tokens, start, n_new)
        return self._call(self._pre, tokens, start, n_new, self._tables())

    def decode(self, tokens: np.ndarray, start: np.ndarray,
               n_new: np.ndarray) -> np.ndarray:
        self._record_writes(tokens, start, n_new)
        return self._call(self._dec, tokens, start, n_new, self._tables())


# --------------------------------------------------------------------------- #
# The engine
# --------------------------------------------------------------------------- #

@dataclass
class _SlotState:
    req: EngineRequest
    pos: int = 0          # prompt tokens prefilled so far
    length: int = 0       # valid cache entries
    next_token: int = 0
    decoding: bool = False


class Engine:
    """Deterministic tick-based serving loop over a :class:`ProgramStepper`.

    Each :meth:`step` is one tick: expire deadlines, admit queued requests
    to free slots, then run either one prefill-chunk Program call or one
    decode Program call over the whole slot batch.  When both phases have
    work the engine alternates, which bounds any request's inter-token gap
    to roughly one chunk of someone else's prompt.

    With a :class:`PagedProgramStepper`, admission is also gated on BLOCK
    availability, a prefix hit fast-forwards prefill past the reused rows,
    and a finished sequence leaves its pages in the prefix index.
    """

    def __init__(self, stepper: ProgramStepper, *, eos_id: int = -1,
                 max_queue: Optional[int] = None):
        self.stepper = stepper
        self.n_slots = stepper.n_slots
        self.chunk = stepper.chunk
        self.cache_cap = stepper.cache_cap
        self.paged = stepper.paged
        self.eos_id = eos_id
        self.sched = SlotScheduler(self.n_slots, max_queue=max_queue)
        self.slots: List[Optional[_SlotState]] = [None] * self.n_slots
        self.tick = 0
        self.finished: List[EngineRequest] = []
        self.dropped: List[EngineRequest] = []
        self.metrics = EngineMetrics(n_slots=self.n_slots)
        self._last_was_prefill = False
        self._t0: Optional[float] = None
        # (head uid, pool version) of the last admission gate refusal —
        # skips re-running the prefix lookup every tick while nothing that
        # could free blocks has happened
        self._gate_blocked: Optional[Tuple[int, int]] = None

    def submit(self, req: EngineRequest) -> bool:
        """Admission control: False (with ``req.dropped`` set) when the
        queue is full or the request could never fit the cache.  The fit
        check uses the unpadded prompt: the cache stores at most
        ``len(prompt) + max_new_tokens - 1`` rows (prefill padding rows are
        dropped by the cache write)."""
        req.submit_tick = self.tick
        req.t_submit = time.perf_counter()
        if len(req.prompt) == 0 or req.max_new_tokens < 1:
            return self._reject(req, "empty")
        if len(req.prompt) + req.max_new_tokens - 1 > self.cache_cap:
            return self._reject(req, "too_long")
        if self.paged and not self.stepper.pool.fits_ever(
                len(req.prompt), req.max_new_tokens):
            return self._reject(req, "too_long")
        if not self.sched.submit(req):
            req.dropped = "queue_full"
            self.metrics.n_rejected += 1
            self._finalize(req)
            return False
        return True

    def _reject(self, req: EngineRequest, reason: str) -> bool:
        req.dropped = reason
        self.sched.reject(req)
        self.metrics.n_rejected += 1
        self._finalize(req)
        return False

    def _finalize(self, req: EngineRequest) -> None:
        req.finish_tick = self.tick
        req.t_done = time.perf_counter()
        if req.on_finish is not None:
            req.on_finish(req)

    def _emit(self, st: _SlotState, tok: int) -> None:
        req = st.req
        now = time.perf_counter()
        req.out_tokens.append(tok)
        self.metrics.tokens_out += 1
        if req.t_first is None:
            req.t_first = now
            req.first_token_tick = self.tick
            self.metrics.ttfts_s.append(req.ttft_s or 0.0)
        if req._t_last_token is not None:
            gap = now - req._t_last_token
            req.max_gap_s = max(req.max_gap_s, gap)
            self.metrics.max_intertoken_gap_s = max(
                self.metrics.max_intertoken_gap_s, gap)
        req._t_last_token = now
        if req._last_token_tick is not None:
            req.max_gap_ticks = max(req.max_gap_ticks,
                                    self.tick - req._last_token_tick)
        req._last_token_tick = self.tick
        if req.on_token is not None:
            req.on_token(req, tok)

    def _finish_slot(self, slot: int) -> None:
        req = self.sched.finish(slot)
        req.done = True
        self.slots[slot] = None
        if self.paged:
            # finished sequences donate their pages to the prefix index
            self.stepper.release(slot, register=True)
        self.finished.append(req)
        self.metrics.n_finished += 1
        self._finalize(req)
        self.metrics.latencies_s.append(req.latency_s or 0.0)

    def _drop_slot(self, slot: int, reason: str) -> None:
        req = self.sched.drop(slot)
        req.dropped = reason
        self.slots[slot] = None
        if self.paged:
            self.stepper.release(slot, register=False)
        self.dropped.append(req)
        self.metrics.n_dropped += 1
        self._finalize(req)

    def _expire(self) -> None:
        expired = self.sched.drop_queued(
            lambda r: r.deadline_tick is not None and self.tick >= r.deadline_tick)
        for req in expired:
            req.dropped = "deadline"
            self.dropped.append(req)
            self.metrics.n_dropped += 1
            self._finalize(req)
        for slot, st in enumerate(self.slots):
            if st is not None and st.req.deadline_tick is not None \
                    and self.tick >= st.req.deadline_tick:
                self._drop_slot(slot, "deadline")

    def step(self) -> None:
        """One scheduling tick (see class docstring)."""
        if self._t0 is None:
            self._t0 = time.perf_counter()
        self.tick += 1
        self.metrics.ticks += 1
        self._expire()
        if self.paged:
            self._admit_paged()
        else:
            for slot, req in self.sched.admit():
                self.slots[slot] = _SlotState(req=req)
        prefill = [i for i, st in enumerate(self.slots)
                   if st is not None and not st.decoding]
        decode = [i for i, st in enumerate(self.slots)
                  if st is not None and st.decoding]
        if prefill and (not decode or not self._last_was_prefill):
            self._prefill_tick(prefill)
            self._last_was_prefill = True
        elif decode:
            self._decode_tick(decode)
            self._last_was_prefill = False
        self.metrics.wall_s = time.perf_counter() - self._t0

    def _admit_paged(self) -> None:
        """Admission gated on BLOCK availability, not slot count alone.  The
        gate performs the pool admission (claims cached prefix blocks +
        reserves worst-case growth) so consecutive admissions in one tick
        see each other's reservations."""
        pool = self.stepper.pool
        head = self.sched.peek()
        if head is not None and self._gate_blocked == (head.uid, pool.version):
            return
        claims: Dict[int, Tuple[int, int]] = {}
        refused: List[EngineRequest] = []

        def gate(req: EngineRequest) -> bool:
            admitted = self.stepper.try_admit(req.prompt, req.max_new_tokens)
            if admitted is None:
                refused.append(req)
                return False
            claims[id(req)] = admitted
            return True

        for slot, req in self.sched.admit(gate):
            sid, reused = claims[id(req)]
            self.stepper.attach(slot, sid)
            # a prefix hit fast-forwards prefill past the reused rows
            self.slots[slot] = _SlotState(req=req, pos=reused)
        # remember a refused head: until a block reaches refcount 0 or a
        # reservation returns (pool.version bump), re-running its prefix
        # lookup every tick cannot change the answer
        self._gate_blocked = (refused[0].uid, pool.version) if refused else None

    def _prefill_tick(self, slots: List[int]) -> None:
        t_begin = time.perf_counter()
        b, c = self.n_slots, self.chunk
        tokens = np.zeros((b, c), np.int32)
        start = np.zeros((b,), np.int32)
        n_new = np.zeros((b,), np.int32)
        for s in slots:
            st = self.slots[s]
            prompt = st.req.prompt
            n = min(c, len(prompt) - st.pos)
            tokens[s, :n] = prompt[st.pos:st.pos + n]
            start[s] = st.pos
            n_new[s] = n
        logits = self.stepper.prefill(tokens, start, n_new)
        self.metrics.prefill_ticks += 1
        self.metrics.busy_slot_ticks += len(slots)
        for s in slots:
            st = self.slots[s]
            n = int(n_new[s])
            st.pos += n
            if st.pos >= len(st.req.prompt):
                st.decoding = True
                st.length = len(st.req.prompt)
                first = int(np.argmax(logits[s, n - 1]))
                st.next_token = first
                self._emit(st, first)
                self._maybe_finish(s, first)
        self.metrics.prefill_wall_s += time.perf_counter() - t_begin

    def _decode_tick(self, slots: List[int]) -> None:
        t_begin = time.perf_counter()
        b = self.n_slots
        tokens = np.zeros((b, 1), np.int32)
        start = np.zeros((b,), np.int32)
        n_new = np.zeros((b,), np.int32)
        for s in slots:
            st = self.slots[s]
            tokens[s, 0] = st.next_token
            start[s] = st.length
            n_new[s] = 1
        logits = self.stepper.decode(tokens, start, n_new)
        self.metrics.decode_ticks += 1
        self.metrics.busy_slot_ticks += len(slots)
        for s in slots:
            st = self.slots[s]
            st.length += 1
            tok = int(np.argmax(logits[s]))
            st.next_token = tok
            self._emit(st, tok)
            self._maybe_finish(s, tok)
        self.metrics.decode_tokens += len(slots)
        self.metrics.decode_wall_s += time.perf_counter() - t_begin

    def _maybe_finish(self, slot: int, tok: int) -> None:
        st = self.slots[slot]
        if tok == self.eos_id or len(st.req.out_tokens) >= st.req.max_new_tokens:
            self._finish_slot(slot)

    def has_work(self) -> bool:
        return self.sched.has_work()

    def run(self, max_ticks: int = 100_000) -> List[EngineRequest]:
        """Drive until queue and slots drain; returns newly finished
        requests (handed out exactly once)."""
        while self.has_work() and self.tick < max_ticks:
            self.step()
        out, self.finished = self.finished, []
        return out


# --------------------------------------------------------------------------- #
# Unbatched reference + the serving factory
# --------------------------------------------------------------------------- #

class UnbatchedReference:
    """No-batching greedy loop over B=1 Programs compiled from the same
    graphs as the engine's — the token-exactness oracle.

    ``chunk=None`` prefills the whole prompt in one Program call; an
    integer chunk reproduces the engine's chunked prefill.  Programs are
    compiled lazily per distinct chunk and cached."""

    def __init__(self, cfg: GraphLMConfig, params: Mapping[str, Any], *,
                 cache_cap: int, policy: Optional[BackendPolicy] = None,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.params = dict(params)
        self.cache_cap = cache_cap
        self.device = resolve_device(device)
        self._policy = policy
        self._decode: Optional[Tuple[Any, List[str]]] = None
        self._prefills: Dict[int, Tuple[Any, List[str]]] = {}

    def _compiled(self, graph) -> Tuple[Any, List[str]]:
        prog = compile(graph, policy=self._policy, device=self.device)
        cache_inputs = _cache_names(self.cfg)
        names = ("tokens", "start", "n_new", *cache_inputs)
        return prog.bind(*names, donate=cache_inputs), list(graph.outputs[1:])

    def _prefill_for(self, chunk: int) -> Tuple[Any, List[str]]:
        if chunk not in self._prefills:
            g = build_prefill_graph(self.cfg, self.params, batch=1,
                                    chunk=chunk, cache_cap=self.cache_cap)
            self._prefills[chunk] = self._compiled(g)
        return self._prefills[chunk]

    def _decode_fn(self) -> Tuple[Any, List[str]]:
        if self._decode is None:
            g = build_decode_graph(self.cfg, self.params, batch=1,
                                   cache_cap=self.cache_cap)
            self._decode = self._compiled(g)
        return self._decode

    def generate(self, prompt: np.ndarray, max_new_tokens: int, *,
                 chunk: Optional[int] = None, eos_id: int = -1) -> List[int]:
        prompt = np.asarray(prompt, np.int32)
        if len(prompt) == 0 or max_new_tokens < 1:
            raise ValueError("need a non-empty prompt and max_new_tokens >= 1")
        c = len(prompt) if chunk is None else chunk
        if len(prompt) + max_new_tokens - 1 > self.cache_cap:
            raise ValueError(f"prompt {len(prompt)} + {max_new_tokens} new "
                             f"tokens exceeds cache cap {self.cache_cap}")
        pre, cache_outs = self._prefill_for(c)
        dev = self.device
        shape = (1, self.cache_cap, self.cfg.n_kv_heads, self.cfg.d_head)
        caches = {k: torch.zeros(shape, dtype=torch.float32, device=dev)
                  for k in _cache_names(self.cfg)}

        def call(fn, outs, tokens, start, n_new):
            res = fn(to_tensor(tokens, dev), to_tensor(start, dev),
                     to_tensor(n_new, dev), *[caches[k] for k in sorted(caches)])
            for name, arr in zip(outs, res[1:]):
                caches[name.replace("new_", "")] = arr
            return res[0].cpu().numpy()

        pos = 0
        logits = None
        while pos < len(prompt):
            n = min(c, len(prompt) - pos)
            toks = np.zeros((1, c), np.int32)
            toks[0, :n] = prompt[pos:pos + n]
            logits = call(pre, cache_outs, toks, np.asarray([pos], np.int32),
                          np.asarray([n], np.int32))
            pos += n
        out = [int(np.argmax(logits[0, n - 1]))]
        dec, dec_outs = self._decode_fn()
        length = len(prompt)
        while out[-1] != eos_id and len(out) < max_new_tokens:
            logits = call(dec, dec_outs, np.asarray([[out[-1]]], np.int32),
                          np.asarray([length], np.int32), np.asarray([1], np.int32))
            length += 1
            out.append(int(np.argmax(logits[0])))
        return out


# Options of repro's build_lm_serving that the port serves only at their
# default so far: option -> (default, ROADMAP.md item that ports it).
_NOT_PORTED = {
    "quantize": (None, "Queue 1 item 6 (int8)"),
    "spec_k": (0, "Queue 1 item 7 (speculative decoding)"),
    "self_heal": (False, "Queue 1 item 8 (self-heal, tier-aware scheduling)"),
    "tier_aware": (False, "Queue 1 item 8 (self-heal, tier-aware scheduling)"),
    "mesh": (None, "Queue 1 item 12 (tensor-parallel serving)"),
    "tp": (None, "Queue 1 item 12 (tensor-parallel serving)"),
}


def build_lm_serving(cfg: Optional[GraphLMConfig] = None, *,
                     n_slots: int = 4, chunk: int = 8, cache_cap: int = 64,
                     policy: Optional[BackendPolicy] = None,
                     seed: int = 0, eos_id: int = -1,
                     max_queue: Optional[int] = None,
                     params: Optional[Mapping[str, Any]] = None,
                     paged: bool = False, page_size: int = 8,
                     n_blocks: Optional[int] = None,
                     max_pages: Optional[int] = None,
                     kv_dtype: str = "float32",
                     device: DeviceLike = None,
                     **options: Any) -> Tuple[Engine, UnbatchedReference]:
    """Compile the serving Programs for a graph LM and return the engine
    plus its unbatched reference, sharing one set of weights on ``device``
    (``None`` means ``"cuda"``).

    ``params`` may be the JAX package's numpy weights or tensors (tensors
    already on the device are shared, not copied); by default they are
    ``init_lm_params(cfg, seed)``.

    ``paged=True`` swaps the dense per-slot caches for the paged KV cache
    (:class:`PagedProgramStepper`): ``cache_cap`` becomes the per-sequence
    logical capacity (rounded up to whole pages of ``page_size``, or
    ``max_pages`` pages) and ``n_blocks`` sizes the shared pool —
    defaulting to the same total memory as the dense layout (``n_slots *
    ceil(cache_cap / page_size)`` pages).  ``kv_dtype="int8"`` (paged only)
    stores the pools in int8 with per-(page, kv-head) scale sidecars and
    routes the hot path through the ``*_q`` ops.  The reference stays dense
    fp32 either way: it is the paged engine's token-exactness oracle.

    ``repro``'s other options (``quantize``, ``spec_k``, ``self_heal``,
    ``tier_aware``, ``mesh``, ``tp``) are accepted at their defaults only;
    anything else raises ``NotImplementedError`` naming the ROADMAP item
    that ports it."""
    for name, value in options.items():
        if name not in _NOT_PORTED:
            raise TypeError(f"build_lm_serving() got an unexpected keyword argument {name!r}")
        default, item = _NOT_PORTED[name]
        if value != default:
            raise NotImplementedError(
                f"build_lm_serving({name}={value!r}) is not ported yet: "
                f"see ROADMAP.md {item}")
    cfg = cfg or GraphLMConfig()
    if kv_dtype != "float32" and not paged:
        raise ValueError("kv_dtype requires paged=True")
    dev = resolve_device(device)
    params = params_from_numpy(
        params if params is not None else init_lm_params(cfg, seed), dev)
    if paged:
        mp = max_pages if max_pages is not None else -(-cache_cap // page_size)
        nb = n_blocks if n_blocks is not None else n_slots * mp
        stepper: ProgramStepper = PagedProgramStepper(
            cfg, params, n_slots=n_slots, chunk=chunk, page_size=page_size,
            n_blocks=nb, max_pages=mp, kv_dtype=kv_dtype, policy=policy, device=dev)
    else:
        stepper = ProgramStepper(cfg, params, n_slots=n_slots, chunk=chunk,
                                 cache_cap=cache_cap, policy=policy, device=dev)
    engine = Engine(stepper, eos_id=eos_id, max_queue=max_queue)
    reference = UnbatchedReference(cfg, params,
                                   cache_cap=max(cache_cap, stepper.cache_cap),
                                   policy=policy, device=dev)
    return engine, reference
