"""Program-backed serving engine, dense or paged KV cache — counterpart of
:mod:`repro.runtime.engine`.

Both engine steps are compiled :class:`~repro_torch.core.program.Program`\\ s
over the GraphIR LM (:mod:`repro_torch.models.graph_lm`):

* decode Program — tokens (B, 1) + caches -> next-token logits, one call
  per decode tick over the whole fixed slot batch;
* prefill Program — tokens (B, chunk) + caches -> per-position logits;
  long prompts are split into fixed-size chunks interleaved with decode
  ticks.

``quantize="int8"`` compiles every Program with int8 weights, all of them
(and the reference) from one :func:`shared_calibration`, so they share
activation scales.  ``spec_k > 0`` adds greedy speculative decoding: a
draft Program (the target's first ``draft_layers`` layers, ``spec_k`` steps
unrolled) proposes tokens and a verify Program scores them in one call
(for int8 pages: the decode step unrolled, its accepted writes replayed by
a commit Program), so the output stays token-identical to plain decode.
With int8 weights the verify is the decode step unrolled as well (a port
addition, :func:`~repro_torch.models.graph_lm.build_verify_seq_graph`).

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

Self-healing (``self_heal=True``): every stepper call runs under the
:mod:`repro_torch.ft` watchdogs — a
:class:`~repro_torch.ft.watchdog.HangDetector` deadline (``hang_timeout``)
and a :class:`~repro_torch.ft.watchdog.StepWatchdog` straggler tracker.  A
tick that raises (a CUDA out-of-memory error included), or that overruns
the hang deadline, is discarded: the engine restores the block pool to the
checkpoint taken at the start of the tick (:meth:`Engine.checkpoint`),
tears the slots down and requeues every in-flight request at its original
queue position.  Resume is page-level on every stepper: a requeued request
keeps every committed KV row (the paged stepper its sequence and block
table, int8 scale sidecars included; the dense stepper its per-slot cache
rows, relocated by :meth:`ProgramStepper.relocate_slots` when it lands in
another slot), so prefill fast-forwards past them and re-executes only the
failed tick's token position — through the prefill Program, as in
``repro``, so a request that was decoding scores its resumed token with the
chunk kernel.  Greedy output after a crash or hang equals an uninterrupted
run's, and no token is re-emitted to a streaming callback.  Kernel launches
are asynchronous, so on a CUDA device the guard synchronises inside itself
(:meth:`Engine._guarded_call`); a sticky CUDA error (an illegal address)
poisons the context and is not healed in-process.

Tier-aware overload control (``tier_aware=True``): a full queue sheds its
lowest-priority member to admit a higher-priority arrival, and when the
highest-priority queued request would miss its TTFT budget
(``slo_ttft_ticks`` and/or its deadline) while every slot is busy, the
lowest-priority running slot is preempted; the victim requeues at its
original position and resumes through the page-level path above.

Streaming: per-token ``on_token`` / ``on_finish`` callbacks on each
request, and :class:`AsyncEngine`, an asyncio front end whose
``generate`` is an async iterator over one request's tokens.

Tensor-parallel serving (``tp=N`` or ``mesh=``): one process a rank, each
running this engine on the same requests.  Every Program that touches the
caches compiles with ``compile(mesh=...)``; each rank holds the whole
weights and its ``1/tp`` slice of the KV heads of every cache, page pool
and scale sidecar (:meth:`ProgramStepper._place_caches`, by the decode
Program's partition), runs its heads of every attention node through the
``tp`` backends (the ``cuda`` kernels on its slice, the output
all-gathered) and emits exactly the single-rank engine's tokens.  A model
whose KV heads do not divide tp (GQA-small) keeps whole caches on every
rank and runs attention replicated.  Host decisions are the same on every
rank because every rank sees the same requests and the same logits; a
tick's outcome (ok, crash, hang) is agreed with one ``all_reduce(MAX)``
before any rank commits or recovers (:meth:`Engine._guarded_call`).  A rank
that fails inside a collective, leaving its peer waiting there, is not
healed: the peer's collective times out.
"""

from __future__ import annotations

import asyncio
import time
from contextlib import nullcontext
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.device import DeviceLike, resolve_device, to_tensor
from repro_torch.core.program import compile
from repro_torch.core.selector import AutotunePolicy, BackendPolicy, FixedPolicy
from repro_torch.ft.coordinator import Coordinator
from repro_torch.ft.watchdog import HangDetector, StepWatchdog
from repro_torch.models.graph_lm import (GraphLMConfig, build_decode_graph,
                                         build_draft_graph, build_paged_decode_graph,
                                         build_paged_prefill_graph,
                                         build_paged_verify_graph,
                                         build_paged_verify_seq_graph,
                                         build_prefill_graph, build_spec_commit_graph,
                                         build_verify_graph, build_verify_seq_graph,
                                         expand_spec_ranges,
                                         init_cache_inputs, init_lm_params,
                                         init_paged_cache_inputs, params_from_numpy)
from repro_torch.runtime.batching import SlotScheduler
from repro_torch.runtime.kv_cache import BlockPool, kv_page_bytes

__all__ = [
    "EngineRequest", "EngineMetrics", "Engine", "ProgramStepper",
    "PagedProgramStepper", "UnbatchedReference", "AsyncEngine", "build_lm_serving",
    "padded_len",
    "shared_calibration", "EngineCheckpoint", "CheckpointSlot", "TickFailure",
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
    tier: Optional[str] = None              # workload tier label (loadgen)
    deadline_tick: Optional[int] = None     # absolute engine tick to finish by
    on_token: Optional[Callable[["EngineRequest", int], None]] = None
    on_finish: Optional[Callable[["EngineRequest"], None]] = None

    out_tokens: List[int] = field(default_factory=list)
    done: bool = False
    dropped: Optional[str] = None
    submit_tick: int = -1
    first_token_tick: Optional[int] = None
    finish_tick: Optional[int] = None
    n_requeues: int = 0                     # times requeued (recovery or
    #                                         tier preemption)
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
    # self-healing counters (all zero when self_heal is off)
    failed_ticks: int = 0       # discarded ticks (crash + hang)
    n_crash_failures: int = 0
    n_hang_failures: int = 0
    n_recoveries: int = 0
    requeued_requests: int = 0  # slot preemptions summed over recoveries
    straggler_ticks: int = 0    # StepWatchdog rolling-median flags
    recovered_rows: int = 0     # KV rows resumed from surviving state
    #                             (pages / dense slot rows) instead of
    #                             being re-prefilled after a requeue
    # tier-aware overload counters (all zero when tier_aware is off)
    n_preempted: int = 0        # running low-tier slots preempted for a
    #                             high-tier request at TTFT risk
    n_tier_shed: int = 0        # queued low-tier requests shed to make
    #                             room for a higher-tier arrival
    # speculative decoding (all zero when spec_k == 0)
    spec_ticks: int = 0         # draft+verify ticks (counted in decode_ticks)
    spec_proposed: int = 0      # draft tokens offered to verification
    spec_accepted: int = 0      # draft tokens the target model agreed with
    # decode-phase throughput: tokens emitted by decode/spec ticks over the
    # wall time spent inside those ticks
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
    def accept_rate(self) -> float:
        return (self.spec_accepted / self.spec_proposed
                if self.spec_proposed > 0 else 0.0)

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
            "self_heal": {
                "failed_ticks": self.failed_ticks,
                "n_crash_failures": self.n_crash_failures,
                "n_hang_failures": self.n_hang_failures,
                "n_recoveries": self.n_recoveries,
                "requeued_requests": self.requeued_requests,
                "straggler_ticks": self.straggler_ticks,
                "recovered_rows": self.recovered_rows,
            },
            "overload": {
                "n_preempted": self.n_preempted,
                "n_tier_shed": self.n_tier_shed,
            },
            "spec": {
                "spec_ticks": self.spec_ticks,
                "proposed": self.spec_proposed,
                "accepted": self.spec_accepted,
                "accept_rate": self.accept_rate,
                "decode_tokens": self.decode_tokens,
                "decode_wall_s": self.decode_wall_s,
                "decode_tokens_per_s": self.decode_tokens_per_s,
            },
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


def _stage_names(width: int) -> List[str]:
    """Per-stage inputs of a decode-unrolled verify Program."""
    return [*[f"tokens.s{j}" for j in range(width)], *[f"n_new.s{j}" for j in range(width)]]


class _TPFirstPolicy(BackendPolicy):
    """The policy of an engine on a serving mesh: the attention ops take
    their ``tp`` backend whenever tp divides both head counts, and every
    other decision goes to the wrapped policy.  A GQA-small model (tp does
    not divide Hk) falls through to the replicated backends, its caches
    whole on every rank.  Where the heads divide but the ``cuda`` backend
    refuses one rank's slice of them, it raises: the caches are sharded
    then, and no replicated body could read them."""

    def __init__(self, base: BackendPolicy):
        self.base = base

    def choose(self, node, in_specs):
        from repro_torch.kernels.serving_ops import (TP_ATTENTION_OPS, _tp_state,
                                                     tp_heads_divide, tp_local_supported)
        _, tp = _tp_state()
        if node.op in TP_ATTENTION_OPS and tp > 1 and tp_heads_divide(in_specs, tp):
            if not tp_local_supported(node.op, in_specs, node.attrs, tp):
                raise ValueError(
                    f"node {node.name}: the cuda backend of {node.op} does not take one "
                    f"rank's {in_specs[0].shape[-2] // tp} of {in_specs[0].shape[-2]} query "
                    f"heads ({[s.shape for s in in_specs]}), and the tp backend runs it")
            return "tp"
        return self.base.choose(node, in_specs)


class ProgramStepper:
    """Owns the compiled Programs plus the cache tensors they thread.
    Step dispatch goes through :meth:`Program.bind`, the positional
    fast-call path.  ``quantize``/``calib_ranges`` compile every Program
    with int8 weights and the given shared activation ranges; ``spec_k``
    adds the speculative Programs (:meth:`_init_spec`).  ``mesh`` (a
    :class:`~repro_torch.launch.mesh.ProcessMesh` of
    :func:`~repro_torch.launch.mesh.make_serving_mesh`) makes this one rank of
    a tensor-parallel engine (the module docstring)."""

    paged = False

    def __init__(self, cfg: GraphLMConfig, params: Mapping[str, Any], *,
                 n_slots: int, chunk: int, cache_cap: int,
                 policy: Optional[BackendPolicy] = None,
                 quantize: Optional[str] = None,
                 calib_ranges: Optional[Mapping[str, Any]] = None,
                 spec_k: int = 0, draft_layers: Optional[int] = None,
                 device: DeviceLike = None, mesh: Optional[Any] = None):
        self.cfg = cfg
        self.n_slots = n_slots
        self.chunk = chunk
        self.cache_cap = cache_cap
        self.device = resolve_device(device)
        self.mesh = mesh
        if mesh is not None:
            policy = _TPFirstPolicy(policy or FixedPolicy())
        with self._mesh_ctx():
            self._dense_init(params, policy=policy, quantize=quantize,
                             calib_ranges=calib_ranges, spec_k=spec_k,
                             draft_layers=draft_layers)

    def _dense_init(self, params, *, policy, quantize, calib_ranges, spec_k, draft_layers):
        cfg, n_slots, chunk, cache_cap = self.cfg, self.n_slots, self.chunk, self.cache_cap
        qkw = dict(policy=policy, quantize=quantize, calib_ranges=calib_ranges,
                   device=self.device, mesh=self.mesh)
        dec_g = build_decode_graph(cfg, params, batch=n_slots, cache_cap=cache_cap)
        pre_g = build_prefill_graph(cfg, params, batch=n_slots, chunk=chunk,
                                    cache_cap=cache_cap)
        self.decode_program = compile(dec_g, **qkw)
        self.prefill_program = compile(pre_g, **qkw)
        self.cache_names = list(dec_g.outputs[1:])  # new_cache_*
        cache_inputs = _cache_names(cfg)
        self._cache_input_names = cache_inputs
        self._input_names = ("tokens", "start", "n_new", *cache_inputs)
        self._dec = self.decode_program.bind(*self._input_names, donate=cache_inputs)
        self._pre = self.prefill_program.bind(*self._input_names, donate=cache_inputs)
        shape = (n_slots, cache_cap, cfg.n_kv_heads, cfg.d_head)
        self.caches: Dict[str, torch.Tensor] = self._place_caches(
            self.decode_program, {name: (shape, torch.float32) for name in cache_inputs})
        verify_g, ver_bind = None, None
        w = spec_k + 1
        if spec_k > 0 and quantize is not None:
            verify_g = build_verify_seq_graph(cfg, params, batch=n_slots, width=w,
                                              cache_cap=cache_cap)
            ver_bind = ("start", *_stage_names(w), *cache_inputs)
        elif spec_k > 0:
            verify_g = build_verify_graph(cfg, params, batch=n_slots, width=w,
                                          cache_cap=cache_cap)
        self._init_spec(params, policy=policy, quantize=quantize,
                        calib_ranges=calib_ranges, spec_k=spec_k,
                        draft_layers=draft_layers, verify_graph=verify_g,
                        verify_bind_names=ver_bind, verify_spec_ranges=ver_bind is not None)

    def _mesh_ctx(self):
        """The serving-mesh context of compiles and Program calls (no-op on
        one rank): publishes the mesh to the ``tp`` backends' supports
        guards at compile time and to their bodies and the partitioned
        executor at call time."""
        if self.mesh is None:
            return nullcontext()
        from repro_torch.kernels.serving_ops import serving_mesh
        return serving_mesh(self.mesh)

    def _place_caches(self, program, caches: Mapping[str, Tuple[tuple, torch.dtype]]
                      ) -> Dict[str, torch.Tensor]:
        """Zeroed cache tensors on the device, ``name -> (global shape,
        dtype)``; on a serving mesh of tp > 1 each holds this rank's slice
        of every dim ``program``'s partition shards on "model" (the KV
        heads of caches, pools and scale sidecars), so a rank never
        allocates the whole cache."""
        tp = self.mesh.shape["model"] if self.mesh is not None else 1
        specs = program.partition["specs"] if tp > 1 else {}
        out = {}
        for name, (shape, dtype) in caches.items():
            spec = tuple(specs.get(name, ()))
            local = tuple(n // tp if i < len(spec) and spec[i] == "model" else n
                          for i, n in enumerate(shape))
            out[name] = torch.zeros(local, dtype=dtype, device=self.device)
        return out

    def _call(self, fn, tokens, start, n_new, *extra) -> np.ndarray:
        dev = self.device
        with self._mesh_ctx():
            outs = fn(to_tensor(tokens, dev), to_tensor(start, dev), to_tensor(n_new, dev),
                      *[to_tensor(e, dev) for e in extra],
                      *[self.caches[n] for n in sorted(self.caches)])
        logits = outs[0].cpu().numpy()
        self._set_caches(outs[1:])
        return logits

    def _set_caches(self, outs: Sequence[torch.Tensor]) -> None:
        for name, arr in zip(self.cache_names, outs):
            self.caches[name.replace("new_", "")] = arr

    def _verify_seq_call(self, tokens, start, n_new, *extra):
        """Call a decode-unrolled verify Program: stage j gets token column
        j and the mask ``n_new > j``.  Returns (stage logits, the rest of
        the outputs)."""
        dev, w = self.device, self.spec_k + 1
        cols = [to_tensor(tokens[:, j:j + 1], dev) for j in range(w)]
        masks = [to_tensor((n_new > j).astype(np.int32), dev) for j in range(w)]
        with self._mesh_ctx():
            outs = self._ver(to_tensor(start, dev), *[to_tensor(e, dev) for e in extra], *cols,
                             *masks, *[self.caches[n] for n in sorted(self.caches)])
        return torch.stack(outs[:w], dim=1).cpu().numpy(), list(outs[w:])

    def _init_spec(self, params: Mapping[str, Any], *,
                   policy: Optional[BackendPolicy],
                   quantize: Optional[str],
                   calib_ranges: Optional[Mapping[str, Any]],
                   spec_k: int, draft_layers: Optional[int],
                   verify_graph, verify_donate: bool = True,
                   verify_bind_names: Optional[Tuple[str, ...]] = None,
                   verify_spec_ranges: bool = False) -> None:
        """Compile the speculative-decoding Programs (shared by the dense
        and paged steppers; ``verify_graph`` is the flavour's verify variant
        of the target model).

        The draft model is early-exit self-speculative: the target's first
        ``draft_layers`` layers plus its embedding and head, so there is no
        second set of weights, and because its value names match the
        target's, the one shared calibration covers it
        (:func:`expand_spec_ranges` maps the ranges onto the unrolled
        step-suffixed names).  Its caches are private per-slot dense
        buffers of ``cache_cap + spec_k + 1`` rows: a draft call writes up
        to spec_k+1 rows past the committed length and is never rolled
        back (stale rows are overwritten by the next catch-up or draft
        call, and draft attention never reads past its kv length)."""
        self.spec_k = spec_k
        self._verify_seq = verify_bind_names is not None
        if spec_k == 0:
            return
        cfg = self.cfg
        dl = draft_layers if draft_layers is not None else max(1, cfg.n_layers // 2)
        if not 1 <= dl <= cfg.n_layers:
            raise ValueError(f"draft_layers {dl} outside [1, {cfg.n_layers}]")
        self.draft_layers = dl
        draft_cfg = replace(cfg, n_layers=dl)
        self.draft_cap = self.cache_cap + spec_k + 1
        draft_ranges = (expand_spec_ranges(dict(calib_ranges), spec_k)
                        if calib_ranges is not None else None)
        draft_g = build_draft_graph(draft_cfg, dict(params), batch=self.n_slots,
                                    cache_cap=self.draft_cap, spec_k=spec_k)
        draft_pre_g = build_prefill_graph(draft_cfg, dict(params), batch=self.n_slots,
                                          chunk=self.chunk, cache_cap=self.draft_cap)
        kw = dict(policy=policy, quantize=quantize, device=self.device, mesh=self.mesh)
        self.draft_program = compile(draft_g, calib_ranges=draft_ranges, **kw)
        self.draft_prefill_program = compile(draft_pre_g, calib_ranges=calib_ranges, **kw)
        # the kv8 seq verify's value names are step-suffixed like the
        # draft's, so it needs the expanded calibration to see the same
        # static scales the decode Program uses
        self.verify_program = compile(
            verify_graph, calib_ranges=draft_ranges if verify_spec_ranges else calib_ranges,
            **kw)
        draft_cache_inputs = _cache_names(draft_cfg)
        names = ("tokens", "start", "n_new", *draft_cache_inputs)
        self._draft = self.draft_program.bind(*names, donate=draft_cache_inputs)
        self._draft_pre = self.draft_prefill_program.bind(*names, donate=draft_cache_inputs)
        # the kv8 verify only READS the pages (its cache inputs are not
        # threaded back out), so they are not donated; the commit is
        self._ver = self.verify_program.bind(
            *(verify_bind_names if verify_bind_names is not None else self._input_names),
            donate=self._cache_input_names if verify_donate else ())
        self._draft_cache_names = list(draft_g.outputs[spec_k:])
        shape = (self.n_slots, self.draft_cap, cfg.n_kv_heads, cfg.d_head)
        self.draft_caches: Dict[str, torch.Tensor] = self._place_caches(
            self.draft_program, {name: (shape, torch.float32) for name in draft_cache_inputs})

    def relocate_slots(self, moves: Sequence[Tuple[int, int]]) -> None:
        """Copy per-slot cache rows ``src -> dst`` — dense page-level resume
        for a request re-admitted to another slot than the one whose rows it
        committed.  One batched gather per cache tensor (axis 0 is the slot
        axis), in place: every source is read (the gather makes a copy)
        before any destination is written, so a pair of swapped slots
        relocates correctly.  Only the main caches move; the private draft
        caches are rebuilt by draft catch-up (resume resets ``draft_len`` to
        0), the path a cold admission takes."""
        if not moves:
            return
        src = torch.tensor([m[0] for m in moves], dtype=torch.long, device=self.device)
        dst = torch.tensor([m[1] for m in moves], dtype=torch.long, device=self.device)
        for arr in self.caches.values():
            arr[dst] = arr[src]

    def backend_summary(self) -> Dict[str, Dict[str, Dict[str, int]]]:
        """Per-phase, per-op backend assignment counts:
        ``{"prefill"|"decode"[|"verify"|"draft"]: {op: {backend: node_count}}}``."""
        phases = [("prefill", self.prefill_program), ("decode", self.decode_program)]
        if self.spec_k:
            phases += [("verify", self.verify_program), ("draft", self.draft_program)]
        out: Dict[str, Dict[str, Dict[str, int]]] = {}
        for phase, prog in phases:
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

    def verify(self, tokens: np.ndarray, start: np.ndarray,
               n_new: np.ndarray) -> np.ndarray:
        """tokens (B, spec_k+1) — committed next token + draft proposals —
        -> per-position logits (B, spec_k+1, V); the main caches advance by
        ``n_new[b]`` rows (rejected rows lie past the committed length the
        engine rolls back to, and are overwritten by the next write)."""
        if not self._verify_seq:
            return self._call(self._ver, tokens, start, n_new)
        logits, caches = self._verify_seq_call(tokens, start, n_new)
        self._set_caches(caches)
        return logits

    def _draft_call(self, fn, tokens, start, n_new):
        dev = self.device
        with self._mesh_ctx():
            outs = fn(to_tensor(tokens, dev), to_tensor(start, dev), to_tensor(n_new, dev),
                      *[self.draft_caches[n] for n in sorted(self.draft_caches)])
        k = len(outs) - len(self._draft_cache_names)
        for name, arr in zip(self._draft_cache_names, outs[k:]):
            self.draft_caches[name.replace("new_", "")] = arr
        return outs[:k]

    def draft_prefill(self, tokens: np.ndarray, start: np.ndarray,
                      n_new: np.ndarray) -> None:
        """Advance the private draft caches over already-committed tokens
        (cold start and a prefix hit are both ``draft_len < length``
        catch-up).  Drafting starts from the committed next token, so the
        logits are not read back."""
        self._draft_call(self._draft_pre, tokens, start, n_new)

    def draft(self, tokens: np.ndarray, start: np.ndarray,
              n_new: np.ndarray) -> np.ndarray:
        """One unrolled draft call: tokens (B, 1) — the committed next
        token — -> (B, spec_k) greedy proposals; the draft caches advance
        spec_k+1 rows (the last makes a full accept need no catch-up)."""
        toks = self._draft_call(self._draft, tokens, start, n_new)
        return torch.cat(toks, dim=1).cpu().numpy()


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
                 quantize: Optional[str] = None,
                 calib_ranges: Optional[Mapping[str, Any]] = None,
                 spec_k: int = 0, draft_layers: Optional[int] = None,
                 device: DeviceLike = None, mesh: Optional[Any] = None):
        self.cfg = cfg
        self.n_slots = n_slots
        self.chunk = chunk
        self.page_size = page_size
        self.n_blocks = n_blocks
        self.max_pages = max_pages
        self.kv_dtype = kv_dtype
        self.cache_cap = max_pages * page_size   # per-sequence logical cap
        self.device = resolve_device(device)
        self.mesh = mesh
        if mesh is not None:
            policy = _TPFirstPolicy(policy or FixedPolicy())
        with self._mesh_ctx():
            self._paged_init(params, policy=policy, quantize=quantize,
                             calib_ranges=calib_ranges, spec_k=spec_k,
                             draft_layers=draft_layers)

    def _paged_init(self, params, *, policy, quantize, calib_ranges, spec_k, draft_layers):
        cfg, n_slots, chunk = self.cfg, self.n_slots, self.chunk
        page_size, n_blocks, max_pages = self.page_size, self.n_blocks, self.max_pages
        kv_dtype = self.kv_dtype
        dec_g = build_paged_decode_graph(cfg, params, batch=n_slots, n_blocks=n_blocks,
                                         page_size=page_size, max_pages=max_pages,
                                         kv_dtype=kv_dtype)
        pre_g = build_paged_prefill_graph(cfg, params, batch=n_slots, chunk=chunk,
                                          n_blocks=n_blocks, page_size=page_size,
                                          max_pages=max_pages, kv_dtype=kv_dtype)
        qkw = dict(policy=policy, quantize=quantize, calib_ranges=calib_ranges,
                   device=self.device, mesh=self.mesh)
        self.decode_program = compile(dec_g, **qkw)
        self.prefill_program = compile(pre_g, **qkw)
        self.cache_names = list(dec_g.outputs[1:])  # new_cache_* (+ _scale)
        pools = init_paged_cache_inputs(cfg, n_blocks, page_size, kv_dtype=kv_dtype)
        cache_inputs = sorted(pools)
        self._cache_input_names = cache_inputs
        self._input_names = ("tokens", "start", "n_new", "block_tables", *cache_inputs)
        self._dec = self.decode_program.bind(*self._input_names, donate=cache_inputs)
        self._pre = self.prefill_program.bind(*self._input_names, donate=cache_inputs)
        self.caches: Dict[str, torch.Tensor] = self._place_caches(self.decode_program, {
            name: (arr.shape, torch.int8 if arr.dtype == np.int8 else torch.float32)
            for name, arr in pools.items()})
        self.pool = BlockPool(
            n_blocks, page_size, kv_dtype=kv_dtype,
            page_bytes=kv_page_bytes(cfg.n_layers, cfg.n_kv_heads, cfg.d_head,
                                     page_size, kv_dtype))
        self._slot_seq: Dict[int, int] = {}
        verify_g = None
        ver_bind: Optional[Tuple[str, ...]] = None
        w = spec_k + 1
        kv8 = kv_dtype == "int8"
        if spec_k > 0 and kv8:
            # quantize-on-write makes int8 page bytes history-dependent, so
            # the kv8 verify is the decode step unrolled w times in one
            # Program (logits bit-identical to plain decode) rather than the
            # chunk-shaped verify of the fp32 flavours
            verify_g = build_paged_verify_seq_graph(
                cfg, params, batch=n_slots, width=w, n_blocks=n_blocks,
                page_size=page_size, max_pages=max_pages)
            ver_bind = ("start", "block_tables", *_stage_names(w), *cache_inputs)
        elif spec_k > 0 and quantize is not None:
            verify_g = build_verify_seq_graph(cfg, params, batch=n_slots, width=w,
                                              paged=(n_blocks, page_size, max_pages))
            ver_bind = ("start", "block_tables", *_stage_names(w), *cache_inputs)
        elif spec_k > 0:
            verify_g = build_paged_verify_graph(
                cfg, params, batch=n_slots, width=w, n_blocks=n_blocks,
                page_size=page_size, max_pages=max_pages, kv_dtype=kv_dtype)
        self._init_spec(params, policy=policy, quantize=quantize,
                        calib_ranges=calib_ranges, spec_k=spec_k,
                        draft_layers=draft_layers, verify_graph=verify_g,
                        verify_donate=not kv8, verify_bind_names=ver_bind,
                        verify_spec_ranges=ver_bind is not None)
        if spec_k > 0 and kv8:
            commit_g = build_spec_commit_graph(cfg, batch=n_slots, width=w,
                                               n_blocks=n_blocks, page_size=page_size,
                                               max_pages=max_pages)
            self.spec_commit_program = compile(commit_g, policy=policy, device=self.device,
                                               mesh=self.mesh)
            # j-major, i-minor: the order the seq verify graph emits its
            # per-stage fp32 rows in
            kv_names = [x for j in range(w) for i in range(cfg.n_layers)
                        for x in (f"k_new{i}.s{j}", f"v_new{i}.s{j}")]
            self._commit = self.spec_commit_program.bind(
                "start", "block_tables", *[f"n_new.s{j}" for j in range(w)], *kv_names,
                *cache_inputs, donate=cache_inputs)
            self._pending_kv: Optional[List[torch.Tensor]] = None

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

    def verify(self, tokens: np.ndarray, start: np.ndarray,
               n_new: np.ndarray) -> np.ndarray:
        """fp32 pages: the speculative rows go through the normal paged
        write and the engine calls :meth:`BlockPool.truncate` afterwards to
        roll the rejected tail back (fp32 page writes are exact, so rejected
        rows leave no residue).

        int8 pages: the verify Program is the decode step unrolled
        ``spec_k+1`` times, threading its quantize-on-write page state
        internally and then discarding it, so each stage's logits are
        bit-identical to plain decode's at that position while the live
        pages stay untouched.  The pool bookkeeping and copy-on-write still
        happen first, so the block tables cover the speculative rows; the
        per-stage fp32 K/V rows come back and wait for :meth:`commit_spec`.

        int8 weights over fp32 pages: the decode step unrolled too, writing
        its rows as it goes (fp32 writes are exact)."""
        self._record_writes(tokens, start, n_new)
        if not self._verify_seq:
            return self._call(self._ver, tokens, start, n_new, self._tables())
        logits, rest = self._verify_seq_call(tokens, start, n_new, self._tables())
        if self.kv_dtype == "int8":
            self._pending_kv = rest
        else:
            self._set_caches(rest)
        return logits

    def commit_spec(self, start: np.ndarray, n_acc: np.ndarray) -> None:
        """kv8 only: replay the accepted prefix (``n_acc[b]`` rows) of the
        verify call's writes against the live pages, in the verify's order
        (stage j-major, layer i-minor).  The pool already covers these rows
        (recorded before the verify call, then truncated back to the
        accepted length), so this is only the write-chain Program.
        Replaying a write that already happened is bit-idempotent:
        identical rows quantize to identical bytes and never raise a page
        scale."""
        dev, w = self.device, self.spec_k + 1
        masks = [to_tensor((n_acc > j).astype(np.int32), dev) for j in range(w)]
        with self._mesh_ctx():
            outs = self._commit(to_tensor(start, dev), to_tensor(self._tables(), dev), *masks,
                                *self._pending_kv,
                                *[self.caches[n] for n in sorted(self.caches)])
        self._set_caches(outs)
        self._pending_kv = None


# --------------------------------------------------------------------------- #
# The engine
# --------------------------------------------------------------------------- #

@dataclass
class _SlotState:
    req: EngineRequest
    pos: int = 0          # stream tokens prefilled so far
    length: int = 0       # valid cache entries
    next_token: int = 0
    decoding: bool = False
    # committed rows present in the private draft cache (speculative
    # engines only); a cold start, a prefix hit and a post-recovery resume
    # all catch up from here, so recovery never rolls draft caches back
    draft_len: int = 0
    # the token stream prefill walks: the request's prompt, or — for a
    # requeued request — prompt + tokens generated before the requeue
    # (argmax at its final position is the NEXT token, so nothing is
    # re-emitted)
    stream: Optional[np.ndarray] = None

    @property
    def prompt(self) -> np.ndarray:
        return self.req.prompt if self.stream is None else self.stream


class TickFailure(RuntimeError):
    """A guarded tick crashed or overran the hang deadline.  With
    ``self_heal`` the engine recovers internally; this escapes only when
    recovery is disabled or ``max_recoveries`` consecutive failures give up
    (a deterministic crash loop is not something to retry forever)."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


@dataclass
class CheckpointSlot:
    """In-flight state of one slot, enough to rebuild it: the request's
    identity, every token generated so far (the resume stream is ``prompt +
    out_tokens``), the committed KV rows (``rows`` — what page-level resume
    fast-forwards past), and — paged — the sequence id and block table
    whose pages survive recovery."""

    slot: int
    uid: int
    prompt: np.ndarray
    out_tokens: List[int]
    rows: int = 0
    sid: Optional[int] = None
    block_table: List[int] = field(default_factory=list)

    @property
    def stream(self) -> np.ndarray:
        return np.concatenate([np.asarray(self.prompt, np.int32),
                               np.asarray(self.out_tokens, np.int32)])


@dataclass
class EngineCheckpoint:
    """Host-side engine state captured at the start of a guarded tick —
    everything recovery needs (queued requests stay in the scheduler and are
    only mutated between ticks, so they need no snapshot)."""

    tick: int
    slots: List[CheckpointSlot]
    pool: Optional[Dict[str, Any]] = None    # BlockPool.snapshot()


@dataclass
class _Resume:
    """Pending resume of a requeued in-flight request (keyed by uid).
    ``slot``/``rows`` drive dense page-level resume: the per-slot cache rows
    this request committed in ``slot`` are still valid unless an intervening
    admission overwrote them (``Engine._dense_rows`` tracks the owner of
    every slot's rows)."""

    stream: np.ndarray
    sid: Optional[int] = None
    slot: Optional[int] = None
    rows: int = 0


class Engine:
    """Deterministic tick-based serving loop over a :class:`ProgramStepper`.

    Each :meth:`step` is one tick: expire deadlines, admit queued requests
    to free slots, then run either one prefill-chunk Program call or one
    decode Program call over the whole slot batch.  When both phases have
    work the engine alternates, which bounds any request's inter-token gap
    to roughly one chunk of someone else's prompt.

    With a :class:`PagedProgramStepper`, admission is also gated on BLOCK
    availability, a prefix hit fast-forwards prefill past the reused rows,
    and a finished sequence leaves its pages in the prefix index.  With a
    stepper built with ``spec_k > 0`` every decode tick is a speculative
    tick (:meth:`_spec_decode_tick`).  ``self_heal`` and ``tier_aware`` are
    the module docstring's.
    """

    def __init__(self, stepper: ProgramStepper, *, eos_id: int = -1,
                 max_queue: Optional[int] = None,
                 self_heal: bool = False,
                 hang_timeout: Optional[float] = None,
                 max_recoveries: int = 8,
                 coordinator: Optional[Coordinator] = None,
                 host_id: str = "engine",
                 tier_aware: bool = False,
                 slo_ttft_ticks: Optional[int] = None):
        self.stepper = stepper
        self.n_slots = stepper.n_slots
        self.chunk = stepper.chunk
        self.cache_cap = stepper.cache_cap
        self.paged = stepper.paged
        self.spec_k = getattr(stepper, "spec_k", 0)
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
        # ---- tier-aware overload control ----
        self.tier_aware = tier_aware
        self.slo_ttft_ticks = slo_ttft_ticks
        # dense page-level resume: slot -> uid whose cache rows occupy that
        # slot (an admission overwrites them; resume checks this before
        # trusting surviving rows)
        self._dense_rows: Dict[int, int] = {}
        # ---- self-healing (ft/ watchdogs wired into the tick loop) ----
        self.self_heal = self_heal
        self.hang_timeout = hang_timeout
        self.max_recoveries = max_recoveries
        self._watchdog = StepWatchdog()
        self._hang = (HangDetector(hang_timeout, lambda: None)
                      if hang_timeout is not None else None)
        # the device whose queued work a guarded call waits for (see
        # _guarded_call); None off the card or without self_heal
        self._sync_device = (stepper.device if self_heal and stepper.device.type == "cuda"
                             else None)
        mesh = getattr(stepper, "mesh", None)
        # the serving mesh whose ranks agree each tick's outcome (tp > 1)
        self._tp_mesh = mesh if mesh is not None and mesh.shape["model"] > 1 else None
        self._resume: Dict[int, _Resume] = {}      # uid -> pending resume
        self._consec_failures = 0
        self.coordinator = coordinator
        self.host_id = host_id
        if coordinator is not None:
            coordinator.register(host_id)

    def submit(self, req: EngineRequest) -> bool:
        """Admission control: False (with ``req.dropped`` set) when the
        queue is full or the request could never fit the cache.  The fit
        check uses the unpadded prompt: the cache stores at most
        ``len(prompt) + max_new_tokens - 1`` rows (prefill padding rows are
        dropped by the cache write).  With ``tier_aware`` a full queue sheds
        its lowest-priority member (strictly below the arrival's priority)
        instead of turning the arrival away."""
        req.submit_tick = self.tick
        req.t_submit = time.perf_counter()
        if len(req.prompt) == 0 or req.max_new_tokens < 1:
            return self._reject(req, "empty")
        if len(req.prompt) + req.max_new_tokens - 1 > self.cache_cap:
            return self._reject(req, "too_long")
        if self.paged and not self.stepper.pool.fits_ever(
                len(req.prompt), req.max_new_tokens):
            return self._reject(req, "too_long")
        if (self.tier_aware and self.sched.max_queue is not None
                and self.sched.queue_len >= self.sched.max_queue):
            victim = self.sched.shed_lowest(req.priority)
            if victim is not None:
                victim.dropped = "shed_low_tier"
                self.metrics.n_rejected += 1
                self.metrics.n_tier_shed += 1
                # a preempted request shed from the queue still owns its
                # pool sequence; those blocks must come back
                self._release_resume(victim)
                self._finalize(victim)
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

    def _release_resume(self, req: EngineRequest) -> None:
        """Forget a requeued request's pending resume, returning the pool
        sequence it still owns (it leaves the queue without a slot)."""
        res = self._resume.pop(req.uid, None)
        if res is not None and res.sid is not None:
            self.stepper.pool.release(res.sid, register=False)

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
            # a requeued in-flight request still owns its pool sequence
            self._release_resume(req)
            self.dropped.append(req)
            self.metrics.n_dropped += 1
            self._finalize(req)
        for slot, st in enumerate(self.slots):
            if st is not None and st.req.deadline_tick is not None \
                    and self.tick >= st.req.deadline_tick:
                self._drop_slot(slot, "deadline")

    # ------------------------------------------------------------------ #
    # tier-aware overload control
    # ------------------------------------------------------------------ #
    def _ttft_budget(self, req: EngineRequest) -> Optional[int]:
        """Absolute tick by which ``req`` must emit its first token: the
        tighter of the engine-wide TTFT SLO (relative to submit) and the
        request's own deadline.  ``None`` when neither applies."""
        budget = (None if self.slo_ttft_ticks is None
                  else req.submit_tick + self.slo_ttft_ticks)
        if req.deadline_tick is not None:
            budget = (req.deadline_tick if budget is None
                      else min(budget, req.deadline_tick))
        return budget

    def _overload_control(self) -> None:
        """Preempt a running low-tier slot when the highest-priority queued
        request would otherwise blow its TTFT budget.

        Deterministic trigger: every slot is busy, the queue head outranks
        the lowest-priority running request, and the head's remaining
        budget no longer covers its own chunked prefill (with decode
        interleaving, one chunk lands roughly every other tick) plus one
        tick of slack.  At most one slot is preempted per tick; the victim
        is the lowest-priority slot, ties broken toward the most remaining
        work (it would hold the slot longest)."""
        head = self.sched.peek()
        if head is None or any(s is None for s in self.slots):
            return
        budget = self._ttft_budget(head)
        if budget is None:
            return
        need = 2 * -(-len(head.prompt) // self.chunk) + 1
        if self.tick + need < budget:
            return
        victim: Optional[Tuple[Tuple[int, int], int]] = None
        for slot, st in enumerate(self.slots):
            p = st.req.priority
            if p >= head.priority:
                continue
            key = (p, -(st.req.max_new_tokens - len(st.req.out_tokens)))
            if victim is None or key < victim[0]:
                victim = (key, slot)
        if victim is not None:
            self._preempt_slot(victim[1])

    def _preempt_slot(self, slot: int) -> None:
        """Move a running request back to the queue at its original submit
        position, keeping what it computed: its pool sequence (paged —
        pages and reservations stay live) or its dense cache rows, plus
        ``prompt + out_tokens`` as the resume stream.  Not a terminal
        state: busy -> queued keeps conservation, as recovery's requeue."""
        st = self.slots[slot]
        req = self.sched.preempt(slot)
        req.n_requeues += 1
        rows = st.length if st.decoding else st.pos
        stream = np.concatenate([np.asarray(req.prompt, np.int32),
                                 np.asarray(req.out_tokens, np.int32)])
        sid = self.stepper._slot_seq.pop(slot) if self.paged else None
        self._resume[req.uid] = _Resume(stream=stream, sid=sid, slot=slot, rows=rows)
        self.slots[slot] = None
        self.metrics.n_preempted += 1
        self._gate_blocked = None

    # ------------------------------------------------------------------ #
    def step(self) -> None:
        """One scheduling tick (see class docstring)."""
        if self._t0 is None:
            self._t0 = time.perf_counter()
        self.tick += 1
        self.metrics.ticks += 1
        self._expire()
        if self.tier_aware:
            self._overload_control()
        if self.paged:
            self._admit_paged()
        else:
            self._admit_dense()
        prefill = [i for i, st in enumerate(self.slots)
                   if st is not None and not st.decoding]
        decode = [i for i, st in enumerate(self.slots)
                  if st is not None and st.decoding]
        ckpt = self.checkpoint() if self.self_heal and (prefill or decode) else None
        try:
            if prefill and (not decode or not self._last_was_prefill):
                self._prefill_tick(prefill)
                self._last_was_prefill = True
            elif decode:
                if self.spec_k:
                    self._spec_decode_tick(decode)
                else:
                    self._decode_tick(decode)
                self._last_was_prefill = False
            self._consec_failures = 0
            if self.coordinator is not None:
                self.coordinator.heartbeat(self.host_id)
        except TickFailure as failure:
            if not self.self_heal:
                raise
            self._recover(ckpt, failure)
        self.metrics.wall_s = time.perf_counter() - self._t0

    def _admit_dense(self) -> None:
        """Slot admission for the dense cache, with page-level resume:
        committed per-slot cache rows survive a discarded tick or a
        preemption (writes are positional, and rows a failed tick wrote past
        the committed length are overwritten before they are read), so a
        resumed request fast-forwards past them — relocating the rows when
        it lands in another slot.  An intervening admission overwrites a
        slot's rows; ``owners`` is the pre-tick map (nothing is written
        until this tick's Program call), and a clobbered resume falls back
        to a full re-prefill of its stream."""
        owners = dict(self._dense_rows)
        moves: List[Tuple[int, int]] = []
        for slot, req in self.sched.admit():
            res = self._resume.pop(req.uid, None)
            if res is None:
                self.slots[slot] = _SlotState(req=req)
            elif res.rows > 0 and res.slot is not None and owners.get(res.slot) == req.uid:
                if res.slot != slot:
                    moves.append((res.slot, slot))
                self.slots[slot] = _SlotState(req=req, pos=res.rows, stream=res.stream)
                self.metrics.recovered_rows += res.rows
            else:
                self.slots[slot] = _SlotState(req=req, stream=res.stream)
            self._dense_rows[slot] = req.uid
        self.stepper.relocate_slots(moves)

    def _admit_paged(self) -> None:
        """Admission gated on BLOCK availability, not slot count alone.  The
        gate performs the pool admission (claims cached prefix blocks +
        reserves worst-case growth) so consecutive admissions in one tick
        see each other's reservations.  A requeued request kept its
        sequence (blocks + reservations), so it needs no pool admission and
        resumes from its surviving block table."""
        pool = self.stepper.pool
        head = self.sched.peek()
        if head is not None and self._gate_blocked == (head.uid, pool.version):
            return
        claims: Dict[int, Tuple[int, int]] = {}
        refused: List[EngineRequest] = []

        def gate(req: EngineRequest) -> bool:
            res = self._resume.get(req.uid)
            if res is not None and res.sid is not None:
                return True
            admitted = self.stepper.try_admit(req.prompt, req.max_new_tokens)
            if admitted is None:
                refused.append(req)
                return False
            claims[id(req)] = admitted
            return True

        for slot, req in self.sched.admit(gate):
            res = self._resume.pop(req.uid, None)
            if res is not None and res.sid is not None:
                # prefill fast-forwards past every row already in the pool
                self.stepper.attach(slot, res.sid)
                done = pool.sequence(res.sid).n_tokens
                self.slots[slot] = _SlotState(req=req, pos=done, stream=res.stream)
                self.metrics.recovered_rows += done
                continue
            sid, reused = claims[id(req)]
            self.stepper.attach(slot, sid)
            # a prefix hit fast-forwards prefill past the reused rows
            self.slots[slot] = _SlotState(req=req, pos=reused)
        # remember a refused head: until a block reaches refcount 0 or a
        # reservation returns (pool.version bump), re-running its prefix
        # lookup every tick cannot change the answer
        self._gate_blocked = (refused[0].uid, pool.version) if refused else None

    def _guarded_call(self, fn, *args):
        """One stepper call under the ft/ watchdogs.

        With ``self_heal``, a raised exception becomes a
        :class:`TickFailure` ("crash"), and a call that returns after the
        :class:`~repro_torch.ft.watchdog.HangDetector` deadline fired is
        treated as hung — its result is discarded by raising before any
        slot state or emission is touched.  The
        :class:`~repro_torch.ft.watchdog.StepWatchdog` rolling median flags
        straggler ticks either way.

        On a CUDA device the guard also waits for the call's device work
        (``torch.cuda.synchronize``) before it reads the deadline.  Some
        stepper calls (``draft_prefill``, ``commit_spec``) read nothing back
        and return once their launches are queued: without the wait the
        deadline would time the launches, not the device, and a device
        error would surface in the next guarded call, charged to the wrong
        tick and restored from the wrong checkpoint.  ``repro`` runs these
        paths on the CPU and does not wait.  Without ``self_heal`` nothing
        waits, so the ticks keep their launch overlap.

        On a tensor-parallel engine every rank agrees the call's outcome
        with its peers (:meth:`_agree`) before it returns or raises, so a
        rank whose own call went through fails the tick with a peer that
        crashed or hung, and no rank commits a tick another discards."""
        self._watchdog.start()
        try:
            failure: Optional[str] = None
            error: Optional[BaseException] = None
            try:
                if self.self_heal and self._hang is not None:
                    with self._hang as hd:
                        out = fn(*args)
                        self._sync()
                    if hd.fired:
                        failure = "hang"
                else:
                    out = fn(*args)
                    self._sync()
            except Exception as e:
                if self._tp_mesh is None and not self.self_heal:
                    raise
                failure, error = f"crash: {type(e).__name__}: {e}", e
            if self._tp_mesh is not None:
                failure = self._agree(failure)
            if failure is not None:
                if not self.self_heal:
                    raise error or TickFailure(failure)
                raise TickFailure(failure) from error
        finally:
            if self._watchdog.stop():
                self.metrics.straggler_ticks += 1
        return out

    def _agree(self, failure: Optional[str]) -> Optional[str]:
        """The tick's outcome agreed across the ranks of a tensor-parallel
        engine, before any rank commits or recovers: one ``all_reduce(MAX)``
        of 0 (ok), 1 (crash) or 2 (hang).  A rank whose own call went
        through fails the tick with its peer."""
        from repro_torch.sharding.collectives import agree_status
        code = 0 if failure is None else (2 if failure == "hang" else 1)
        agreed = agree_status(self._tp_mesh, code)
        if agreed == 2:
            return "hang"
        if agreed == 1:
            return failure if code == 1 else "crash: a peer rank failed this tick"
        return None

    def _sync(self) -> None:
        if self._sync_device is not None:
            torch.cuda.synchronize(self._sync_device)

    def _prefill_tick(self, slots: List[int]) -> None:
        t_begin = time.perf_counter()
        b, c = self.n_slots, self.chunk
        tokens = np.zeros((b, c), np.int32)
        start = np.zeros((b,), np.int32)
        n_new = np.zeros((b,), np.int32)
        for s in slots:
            st = self.slots[s]
            stream = st.prompt
            n = min(c, len(stream) - st.pos)
            tokens[s, :n] = stream[st.pos:st.pos + n]
            start[s] = st.pos
            n_new[s] = n
        logits = self._guarded_call(self.stepper.prefill, tokens, start, n_new)
        self.metrics.prefill_ticks += 1
        self.metrics.busy_slot_ticks += len(slots)
        for s in slots:
            st = self.slots[s]
            n = int(n_new[s])
            st.pos += n
            if st.pos >= len(st.prompt):
                st.decoding = True
                st.length = len(st.prompt)
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
        logits = self._guarded_call(self.stepper.decode, tokens, start, n_new)
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

    def _draft_catch_up(self, slots: List[int]) -> None:
        """Bring every slot's private draft cache up to its committed
        length with batched draft-prefill chunks over the committed token
        stream (prompt + every generated token)."""
        b, c = self.n_slots, self.chunk
        while True:
            behind = [s for s in slots if self.slots[s].draft_len < self.slots[s].length]
            if not behind:
                return
            tokens = np.zeros((b, c), np.int32)
            start = np.zeros((b,), np.int32)
            n_new = np.zeros((b,), np.int32)
            for s in behind:
                st = self.slots[s]
                full = np.concatenate([np.asarray(st.req.prompt, np.int32),
                                       np.asarray(st.req.out_tokens, np.int32)])
                n = min(c, st.length - st.draft_len)
                tokens[s, :n] = full[st.draft_len:st.draft_len + n]
                start[s] = st.draft_len
                n_new[s] = n
            self._guarded_call(self.stepper.draft_prefill, tokens, start, n_new)
            for s in behind:
                self.slots[s].draft_len += int(n_new[s])

    def _spec_decode_tick(self, slots: List[int]) -> None:
        """Speculative decode tick: one draft call proposes ``spec_k``
        greedy tokens per slot, one verify call scores them (plus the
        committed next token) against the target, and the greedy acceptance
        walk emits every proposal that matches the target's own argmax, so
        the emitted stream is token-identical to plain decode.  Rejected
        rows are rolled back with :meth:`BlockPool.truncate` (paged) or
        overwritten by the next write at the committed position (dense)."""
        t_begin = time.perf_counter()
        b, k = self.n_slots, self.spec_k
        width = k + 1
        self._draft_catch_up(slots)
        tokens = np.zeros((b, 1), np.int32)
        start = np.zeros((b,), np.int32)
        n_new = np.zeros((b,), np.int32)
        for s in slots:
            st = self.slots[s]
            tokens[s, 0] = st.next_token
            start[s] = st.length
            n_new[s] = 1
        draft_toks = self._guarded_call(self.stepper.draft, tokens, start, n_new)
        vtokens = np.zeros((b, width), np.int32)
        vstart = np.zeros((b,), np.int32)
        vn_new = np.zeros((b,), np.int32)
        for s in slots:
            st = self.slots[s]
            remaining = st.req.max_new_tokens - len(st.req.out_tokens)
            n = min(width, remaining)   # never write past the request cap
            vtokens[s, 0] = st.next_token
            vtokens[s, 1:n] = draft_toks[s, :n - 1]
            vstart[s] = st.length
            vn_new[s] = n
        logits = self._guarded_call(self.stepper.verify, vtokens, vstart, vn_new)
        self.metrics.decode_ticks += 1
        self.metrics.spec_ticks += 1
        self.metrics.busy_slot_ticks += len(slots)
        # greedy acceptance walk: position i's argmax is what plain decode
        # would emit after vtokens[:i+1]; keep walking while the next fed
        # draft token IS that argmax.  Every slot is walked before any state
        # changes, since the kv8 commit below is one batched (guarded) call.
        emits: Dict[int, List[int]] = {}
        for s in slots:
            st = self.slots[s]
            n = int(vn_new[s])
            emit: List[int] = []
            for i in range(n):
                g = int(np.argmax(logits[s, i]))
                emit.append(g)
                if g == self.eos_id or \
                        len(st.req.out_tokens) + len(emit) >= st.req.max_new_tokens:
                    break
                if i + 1 < n and int(vtokens[s, i + 1]) == g:
                    continue
                break
            emits[s] = emit      # len >= 1: position 0 re-scores the committed token
        if self.paged:
            # roll back the rejected speculative rows; rows 0..length+e-1
            # hold exactly the committed stream
            for s in slots:
                self.stepper.pool.truncate(self.stepper._slot_seq[s],
                                           self.slots[s].length + len(emits[s]))
            if self.stepper.kv_dtype == "int8":
                # the kv8 verify left the live pages untouched; replay the
                # accepted prefix of its writes now that the block tables
                # are truncated back to exactly those rows
                commit_n = np.zeros((b,), np.int32)
                for s in slots:
                    commit_n[s] = len(emits[s])
                self._guarded_call(self.stepper.commit_spec, vstart, commit_n)
        emitted_total = 0
        for s in slots:
            st = self.slots[s]
            emit = emits[s]
            e = len(emit)
            self.metrics.spec_proposed += int(vn_new[s]) - 1
            self.metrics.spec_accepted += e - 1
            st.length += e
            st.draft_len = st.length   # accepted rows == draft-cache rows
            st.next_token = emit[-1]
            for tok in emit:
                self._emit(st, tok)
            emitted_total += e
            self._maybe_finish(s, emit[-1])
        self.metrics.decode_tokens += emitted_total
        self.metrics.decode_wall_s += time.perf_counter() - t_begin

    def _maybe_finish(self, slot: int, tok: int) -> None:
        st = self.slots[slot]
        if tok == self.eos_id or len(st.req.out_tokens) >= st.req.max_new_tokens:
            self._finish_slot(slot)

    # ------------------------------------------------------------------ #
    # self-healing: checkpoint / recover
    # ------------------------------------------------------------------ #
    def checkpoint(self) -> EngineCheckpoint:
        """In-flight state as of now: per-slot prompt + generated tokens
        (+ sequence id and block table when paged) and a full
        :meth:`~repro_torch.runtime.kv_cache.BlockPool.snapshot`.  Taken at
        the start of every guarded tick; host-side slot state is only
        mutated after a successful stepper call, so the checkpoint stays
        valid through any failure of the tick it guards."""
        slots: List[CheckpointSlot] = []
        for slot, st in enumerate(self.slots):
            if st is None:
                continue
            entry = CheckpointSlot(slot=slot, uid=st.req.uid, prompt=st.req.prompt,
                                   out_tokens=list(st.req.out_tokens),
                                   rows=st.length if st.decoding else st.pos)
            if self.paged:
                entry.sid = self.stepper._slot_seq[slot]
                entry.block_table = self.stepper.pool.block_table(entry.sid)
            slots.append(entry)
        pool = self.stepper.pool.snapshot() if self.paged else None
        return EngineCheckpoint(tick=self.tick, slots=slots, pool=pool)

    def _recover(self, ckpt: EngineCheckpoint, failure: TickFailure) -> None:
        """Discard the failed tick and rebuild from ``ckpt``: restore the
        pool (bookkeeping back in lockstep with the device pages — the
        failed tick's recorded-but-unwritten rows and index entries
        vanish), drop a kv8 verify's rows that were never committed,
        preempt every slot back into the queue at its original position,
        and stage each request's resume stream.  The next ticks re-admit
        them FIFO; paged requests keep their sequence, so prefill
        fast-forwards past every surviving row."""
        self.metrics.failed_ticks += 1
        if failure.reason == "hang":
            self.metrics.n_hang_failures += 1
        else:
            self.metrics.n_crash_failures += 1
        self._consec_failures += 1
        if self._consec_failures > self.max_recoveries:
            raise TickFailure(f"giving up after {self._consec_failures} consecutive "
                              f"tick failures (last: {failure.reason})") from failure
        if self.paged:
            self.stepper.pool.restore(ckpt.pool)   # ends in check_integrity
            self.stepper._slot_seq.clear()
            if hasattr(self.stepper, "_pending_kv"):
                # the retried verify stashes its own; a stale one must never
                # reach a commit
                self.stepper._pending_kv = None
        for entry in ckpt.slots:
            req = self.sched.preempt(entry.slot)
            if req.uid != entry.uid:
                raise RuntimeError(f"slot {entry.slot}: checkpoint uid {entry.uid}, "
                                   f"live {req.uid}")
            req.n_requeues += 1
            self._resume[req.uid] = _Resume(stream=entry.stream, sid=entry.sid,
                                            slot=entry.slot, rows=entry.rows)
            self.slots[entry.slot] = None
            self.metrics.requeued_requests += 1
        self._gate_blocked = None
        self._last_was_prefill = False
        self.metrics.n_recoveries += 1
        if self.coordinator is not None:
            # a hang past the membership deadline shows up as a death;
            # re-registering is the "restarted engine" membership event
            self.coordinator.sweep()
            self.coordinator.register(self.host_id)

    def reset_metrics(self) -> None:
        """Zero the metrics window (e.g. after warm-up) without touching
        scheduler state, slots or caches."""
        self.metrics = EngineMetrics(n_slots=self.n_slots)
        self._t0 = None

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
# Async front end
# --------------------------------------------------------------------------- #

_DONE = object()


class AsyncEngine:
    """Cooperative asyncio facade: per-token streaming via ``async for``.

    Single-threaded and deterministic: :meth:`run` interleaves engine
    ticks with consumer wakeups on the current event loop; no background
    threads.  Tokens arrive through each request's ``on_token`` /
    ``on_finish`` callbacks."""

    def __init__(self, engine: Engine):
        self.engine = engine
        self._uid = 0

    async def generate(self, prompt: np.ndarray, max_new_tokens: int, *,
                       priority: int = 0, deadline_tick: Optional[int] = None):
        """Async iterator of generated token ids for one request.  A request
        rejected at submit raises ``RuntimeError``, and so does one dropped
        mid-flight (its stream is truncated)."""
        q: asyncio.Queue = asyncio.Queue()
        self._uid += 1
        req = EngineRequest(
            uid=self._uid, prompt=np.asarray(prompt, np.int32),
            max_new_tokens=max_new_tokens, priority=priority,
            deadline_tick=deadline_tick,
            on_token=lambda r, t: q.put_nowait(t),
            on_finish=lambda r: q.put_nowait(_DONE))
        if not self.engine.submit(req):
            raise RuntimeError(f"request rejected: {req.dropped}")
        while True:
            tok = await q.get()
            if tok is _DONE:
                break
            yield tok
        if req.dropped is not None:
            raise RuntimeError(
                f"request {req.uid} dropped after "
                f"{len(req.out_tokens)} tokens: {req.dropped}")

    async def run(self, max_ticks: int = 100_000) -> None:
        """Drive the engine until drained, yielding to consumers between
        ticks."""
        while self.engine.has_work() and self.engine.tick < max_ticks:
            self.engine.step()
            await asyncio.sleep(0)


# --------------------------------------------------------------------------- #
# Unbatched reference + the serving factory
# --------------------------------------------------------------------------- #

class UnbatchedReference:
    """No-batching greedy loop over B=1 Programs compiled from the same
    graphs (and, for int8 weights, the same calibration ranges) as the
    engine's — the token-exactness oracle.

    ``chunk=None`` prefills the whole prompt in one Program call; an
    integer chunk reproduces the engine's chunked prefill.  Programs are
    compiled lazily per distinct chunk and cached."""

    def __init__(self, cfg: GraphLMConfig, params: Mapping[str, Any], *,
                 cache_cap: int, policy: Optional[BackendPolicy] = None,
                 quantize: Optional[str] = None,
                 calib_ranges: Optional[Mapping[str, Any]] = None,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.params = dict(params)
        self.cache_cap = cache_cap
        self.device = resolve_device(device)
        self._policy = policy
        self._quantize = quantize
        self._ranges = calib_ranges
        self._decode: Optional[Tuple[Any, List[str]]] = None
        self._prefills: Dict[int, Tuple[Any, List[str]]] = {}

    def _compiled(self, graph) -> Tuple[Any, List[str]]:
        prog = compile(graph, policy=self._policy, quantize=self._quantize,
                       calib_ranges=self._ranges, device=self.device)
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
                 chunk: Optional[int] = None, eos_id: int = -1,
                 record: Optional[List] = None) -> List[int]:
        """Greedy tokens for one prompt.  ``record`` (a list) receives one
        ``(kind, inputs)`` pair per Program call, ``kind`` "prefill" or
        "decode" and ``inputs`` the call's graph inputs by name (the
        cache tensors as the call read them) — calibration batches."""
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

        def call(fn, outs, tokens, start, n_new, kind):
            if record is not None:
                record.append((kind, {"tokens": tokens, "start": start, "n_new": n_new,
                                      **caches}))
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
                          np.asarray([n], np.int32), "prefill")
            pos += n
        out = [int(np.argmax(logits[0, n - 1]))]
        dec, dec_outs = self._decode_fn()
        length = len(prompt)
        while out[-1] != eos_id and len(out) < max_new_tokens:
            logits = call(dec, dec_outs, np.asarray([[out[-1]]], np.int32),
                          np.asarray([length], np.int32), np.asarray([1], np.int32),
                          "decode")
            length += 1
            out.append(int(np.argmax(logits[0])))
        return out


def _merge_ranges(*range_dicts: Mapping[str, Any]) -> Dict[str, Any]:
    """Union of calibration ranges over value names: min lo, max hi.

    ``channel_mean`` is taken from the first dict that has the value —
    exact averaging would need per-batch counts.  It only feeds
    quantize-time bias correction, which never fires for the bias-free
    graph-LM dense nodes."""
    from repro_torch.core.quant import ValueRange
    out: Dict[str, Any] = {}
    for d in range_dicts:
        for name, vr in d.items():
            if name in out:
                prev = out[name]
                out[name] = ValueRange(min(prev[0], vr[0]), max(prev[1], vr[1]),
                                       getattr(prev, "channel_mean", None))
            else:
                out[name] = vr
    return out


def shared_calibration(cfg: GraphLMConfig, params: Mapping[str, Any], *,
                       chunk: int, cache_cap: int, seed: int = 0,
                       n_prompts: int = 3, max_new_tokens: int = 4,
                       device: DeviceLike = None) -> Dict[str, Any]:
    """One calibration for every Program variant of this model.

    Records real serving traffic (a few fp32 reference generations on
    ``device``) as input batches for the B=1 prefill and decode graphs,
    calibrates each on the same device, and merges the ranges by value
    name.  The graph builders use identical value names across batch and
    chunk variants, so the result drives ``compile(..., quantize="int8",
    calib_ranges=...)`` for the engine's batched Programs and the unbatched
    reference alike: every variant gets the same static activation scales,
    the precondition for batched-vs-unbatched token-exactness under int8.
    The prompts are ``repro``'s (same seed, same draws)."""
    from repro_torch.core.quant import calibrate
    dev = resolve_device(device)
    ref = UnbatchedReference(cfg, params, cache_cap=cache_cap, device=dev)
    rng = np.random.default_rng(seed)
    record: List[Tuple[str, Dict[str, Any]]] = []
    for _ in range(n_prompts):
        plen = int(rng.integers(1, max(2, 2 * chunk)))
        prompt = rng.integers(0, cfg.vocab, size=plen).astype(np.int32)
        ref.generate(prompt, max_new_tokens, chunk=chunk, record=record)
    pre_batches = [inputs for kind, inputs in record if kind == "prefill"]
    dec_batches = [inputs for kind, inputs in record if kind == "decode"]
    g_pre = build_prefill_graph(cfg, params, batch=1, chunk=chunk, cache_cap=cache_cap)
    g_dec = build_decode_graph(cfg, params, batch=1, cache_cap=cache_cap)
    return _merge_ranges(calibrate(g_pre, pre_batches, device=dev),
                         calibrate(g_dec, dec_batches, device=dev))


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
                     quantize: Optional[str] = None,
                     spec_k: int = 0,
                     draft_layers: Optional[int] = None,
                     self_heal: bool = False,
                     hang_timeout: Optional[float] = None,
                     max_recoveries: int = 8,
                     coordinator: Optional[Coordinator] = None,
                     tier_aware: bool = False,
                     slo_ttft_ticks: Optional[int] = None,
                     mesh: Optional[Any] = None,
                     tp: Optional[int] = None,
                     device: DeviceLike = None) -> Tuple[Engine, UnbatchedReference]:
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

    ``quantize="int8"`` compiles every Program, the reference's included,
    with int8 weights and the activation ranges of one
    :func:`shared_calibration` (run here, on ``device``).

    ``spec_k > 0`` turns on greedy speculative decoding: every decode tick
    drafts ``spec_k`` tokens with an early-exit draft model (the target's
    first ``draft_layers`` layers, default ``n_layers // 2``) and verifies
    them in one call; the output stays token-identical to plain decode.

    ``self_heal=True`` discards a tick whose stepper call raises (a CUDA
    out-of-memory error included) or overruns ``hang_timeout`` seconds,
    restores the pool, requeues every in-flight request and resumes it from
    its surviving KV rows, token-identical to an uninterrupted run; after
    ``max_recoveries`` consecutive failures it gives up with
    :class:`TickFailure`.  ``coordinator`` sees every recovery as a
    membership event.  ``tier_aware=True`` turns on tier-aware overload
    control: a full queue sheds its lowest-priority member to admit a
    higher-priority arrival, and a running low-tier slot is preempted
    (resuming later through the same page-level path) when the
    highest-priority queued request would otherwise miss its TTFT budget
    (``slo_ttft_ticks`` and/or its deadline).

    ``mesh`` (of :func:`~repro_torch.launch.mesh.make_serving_mesh`) or ``tp``
    (a tensor-parallel degree: the process group of ``tp`` ranks already
    initialised, or made by :func:`~repro_torch.launch.mesh.make_serving_mesh`
    from the environment, on ``device``) makes this process one rank of a
    tensor-parallel engine: every rank calls this with the same arguments
    and serves the same requests (the module docstring).  The reference
    stays single-rank: it is the oracle.  ``AutotunePolicy`` is refused
    there, since each rank would time its own candidates."""
    if tp is not None:
        if mesh is not None:
            raise ValueError("pass mesh or tp, not both")
        from repro_torch.launch.mesh import make_serving_mesh
        mesh = make_serving_mesh(tp, device=device)
    if mesh is not None and mesh.shape["model"] > 1:
        if not hasattr(mesh, "rank"):
            raise TypeError(f"mesh {mesh!r} has no process group (make_serving_mesh)")
        if device is not None and resolve_device(device) != mesh.device:
            raise ValueError(f"device {device!r} is not the rank's {mesh.device}")
        device = mesh.device
        if isinstance(policy, AutotunePolicy):
            raise ValueError("AutotunePolicy under tensor parallelism: each rank would time "
                             "its own candidates and could pick other backends; compile with "
                             "a fixed or cost-model policy")
    cfg = cfg or GraphLMConfig()
    if kv_dtype != "float32" and not paged:
        raise ValueError("kv_dtype requires paged=True")
    dev = resolve_device(device)
    params = params_from_numpy(
        params if params is not None else init_lm_params(cfg, seed), dev)
    ranges = None
    if quantize is not None:
        ranges = shared_calibration(cfg, params, chunk=chunk, cache_cap=cache_cap,
                                    seed=seed, device=dev)
    qkw = dict(policy=policy, quantize=quantize, calib_ranges=ranges, device=dev)
    if paged:
        mp = max_pages if max_pages is not None else -(-cache_cap // page_size)
        nb = n_blocks if n_blocks is not None else n_slots * mp
        stepper: ProgramStepper = PagedProgramStepper(
            cfg, params, n_slots=n_slots, chunk=chunk, page_size=page_size,
            n_blocks=nb, max_pages=mp, kv_dtype=kv_dtype, spec_k=spec_k,
            draft_layers=draft_layers, mesh=mesh, **qkw)
    else:
        stepper = ProgramStepper(cfg, params, n_slots=n_slots, chunk=chunk,
                                 cache_cap=cache_cap, spec_k=spec_k,
                                 draft_layers=draft_layers, mesh=mesh, **qkw)
    engine = Engine(stepper, eos_id=eos_id, max_queue=max_queue,
                    self_heal=self_heal, hang_timeout=hang_timeout,
                    max_recoveries=max_recoveries, coordinator=coordinator,
                    tier_aware=tier_aware, slo_ttft_ticks=slo_ttft_ticks)
    reference = UnbatchedReference(cfg, params,
                                   cache_cap=max(cache_cap, stepper.cache_cap), **qkw)
    return engine, reference
