"""Trace-driven load generation and SLO goodput evaluation — counterpart
of :mod:`repro.runtime.loadgen`, copied so that the port never imports the
JAX package.  numpy only: the same :class:`TraceConfig` gives the same
trace, and the same sha256 :meth:`Trace.digest`, in both packages
(``tests/test_torch_loadgen.py``).

Production serving is judged by **goodput under SLO**: traffic is bursty,
requests come in priority tiers with latency expectations, many prompts
share long prefixes, and what matters is how many requests per second
finish while meeting their time-to-first-token and inter-token-gap targets
— plus what happens to the rest (shed at admission, dropped at deadline;
never silently lost).

* :func:`generate_trace` — a **seeded, deterministic** trace of
  :class:`TraceRequest`\\ s: the same :class:`TraceConfig` always yields a
  byte-identical trace (:meth:`Trace.digest` pins this).  Arrivals are
  bursty (gamma interarrivals with configurable squared coefficient of
  variation, or a 2-state Markov-modulated process), prompt/output lengths
  are lognormal mixtures, requests are assigned weighted priority
  **tiers**, and a configurable fraction draws its prompt head from shared
  **prefix populations** — the workload shape that exercises the
  BlockPool's content-addressed prefix reuse.

* :func:`run_load` — drives a :class:`~repro_torch.runtime.engine.Engine`
  through a trace (submitting each request at its arrival tick) and scores
  the outcome against an :class:`SLO`: per-tier and overall goodput,
  p50/p95/p99 TTFT and inter-token gap (in deterministic engine ticks AND
  wall seconds), and full shed/drop accounting.  Offered == finished +
  shed + dropped per tier, always.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.runtime.engine import Engine, EngineRequest, _pct_dict

__all__ = ["TierSpec", "PrefixPopulation", "TraceConfig", "TraceRequest",
           "Trace", "SLO", "generate_trace", "run_load"]


# --------------------------------------------------------------------------- #
# trace model
# --------------------------------------------------------------------------- #

@dataclass(frozen=True)
class TierSpec:
    """One priority tier of the workload.  ``weight`` is the sampling
    weight; ``deadline_ticks`` (optional) becomes each request's absolute
    engine deadline relative to its submit tick — the overload-shedding
    knob (expired work is dropped, and reported as dropped)."""

    name: str
    priority: int = 0
    weight: float = 1.0
    deadline_ticks: Optional[int] = None


@dataclass(frozen=True)
class PrefixPopulation:
    """A shared prompt head.  Requests drawn from a population start with
    the same ``prefix_len`` tokens, so a paged engine's prefix index
    serves them from cached pages after the first arrival."""

    name: str
    prefix_len: int
    weight: float = 1.0


@dataclass(frozen=True)
class TraceConfig:
    """Knobs for one deterministic workload trace (see module docstring).

    ``burstiness`` is the squared coefficient of variation of the gamma
    interarrivals — 1.0 is Poisson, larger is burstier (many near-zero
    gaps separated by long quiet stretches).  ``arrival="mmpp"`` instead
    alternates exponential arrivals between a burst state (rate x
    ``mmpp_burst_factor``) and a compensating idle state, switching with
    probability ``mmpp_p_switch`` per arrival; the stationary mean stays
    ``mean_interarrival_ticks``."""

    seed: int = 0
    n_requests: int = 64
    vocab: int = 61
    # arrivals
    mean_interarrival_ticks: float = 2.0
    arrival: str = "gamma"                  # "gamma" | "mmpp"
    burstiness: float = 4.0                 # gamma cv^2 (1.0 = Poisson)
    mmpp_burst_factor: float = 4.0          # burst-state rate multiplier
    mmpp_p_switch: float = 0.1              # state-switch prob per arrival
    # lengths (lognormal, clipped)
    prompt_len_mean: float = 12.0
    prompt_len_sigma: float = 0.5
    prompt_len_max: int = 48
    new_tokens_mean: float = 8.0
    new_tokens_sigma: float = 0.5
    new_tokens_max: int = 32
    # mix
    tiers: Tuple[TierSpec, ...] = (
        TierSpec("interactive", priority=1, weight=0.5, deadline_ticks=None),
        TierSpec("batch", priority=0, weight=0.5),
    )
    prefix_populations: Tuple[PrefixPopulation, ...] = ()
    prefix_share_p: float = 0.0             # P(request joins a population)


@dataclass(frozen=True)
class TraceRequest:
    """One request of a generated trace (pure data, engine-agnostic)."""

    uid: int
    arrival_tick: int
    prompt: np.ndarray                      # (prompt_len,) int32
    max_new_tokens: int
    tier: str
    priority: int
    deadline_ticks: Optional[int] = None    # relative to submit
    population: Optional[str] = None


@dataclass
class Trace:
    """A generated trace plus its shared-prefix dictionary."""

    config: TraceConfig
    requests: List[TraceRequest]
    prefixes: Dict[str, np.ndarray] = field(default_factory=dict)

    def digest(self) -> str:
        """sha256 over a canonical byte serialization — equal configs
        must produce equal digests (the determinism bar of
        ``tests/test_loadgen.py``)."""
        h = hashlib.sha256()
        for r in self.requests:
            head = (f"{r.uid}|{r.arrival_tick}|{r.max_new_tokens}|"
                    f"{r.tier}|{r.priority}|{r.deadline_ticks}|"
                    f"{r.population}|").encode()
            h.update(head)
            h.update(np.asarray(r.prompt, np.int32).tobytes())
        return h.hexdigest()

    def stats(self) -> Dict[str, Any]:
        """Empirical trace shape — what the property tests hold against
        the configured means."""
        arrivals = [r.arrival_tick for r in self.requests]
        inter = np.diff(arrivals) if len(arrivals) > 1 else np.asarray([0.0])
        tiers: Dict[str, int] = {}
        pops: Dict[str, int] = {}
        for r in self.requests:
            tiers[r.tier] = tiers.get(r.tier, 0) + 1
            if r.population is not None:
                pops[r.population] = pops.get(r.population, 0) + 1
        return {
            "n_requests": len(self.requests),
            "digest": self.digest(),
            "span_ticks": arrivals[-1] if arrivals else 0,
            "mean_interarrival_ticks": float(np.mean(inter)),
            "mean_prompt_len": float(np.mean(
                [len(r.prompt) for r in self.requests])),
            "mean_new_tokens": float(np.mean(
                [r.max_new_tokens for r in self.requests])),
            "tiers": tiers,
            "populations": pops,
            "shared_prefix_requests": sum(pops.values()),
        }


def _lognormal(rng: np.random.Generator, mean: float, sigma: float,
               hi: int) -> int:
    """Integer lognormal with the given MEAN (mu compensated for sigma),
    clipped to [1, hi]."""
    mu = np.log(mean) - 0.5 * sigma * sigma
    return int(np.clip(round(rng.lognormal(mu, sigma)), 1, hi))


def _weighted(rng: np.random.Generator, items: Sequence[Any]) -> Any:
    w = np.asarray([it.weight for it in items], np.float64)
    return items[int(rng.choice(len(items), p=w / w.sum()))]


def generate_trace(cfg: TraceConfig) -> Trace:
    """Deterministically expand ``cfg`` into a :class:`Trace`."""
    if not cfg.tiers:
        raise ValueError("need at least one tier")
    if cfg.arrival not in ("gamma", "mmpp"):
        raise ValueError(f"unknown arrival process {cfg.arrival!r}")
    rng = np.random.default_rng(cfg.seed)
    prefixes = {
        p.name: rng.integers(0, cfg.vocab, size=p.prefix_len).astype(np.int32)
        for p in cfg.prefix_populations}

    mean = cfg.mean_interarrival_ticks
    shape = 1.0 / cfg.burstiness          # gamma: cv^2 == burstiness
    burst_mean = mean / cfg.mmpp_burst_factor
    # idle-state mean chosen so the 50/50 stationary mix preserves `mean`
    idle_mean = 2.0 * mean - burst_mean
    in_burst = True

    reqs: List[TraceRequest] = []
    t = 0.0
    for uid in range(cfg.n_requests):
        if uid > 0:
            if cfg.arrival == "gamma":
                t += rng.gamma(shape, mean / shape)
            else:
                if rng.random() < cfg.mmpp_p_switch:
                    in_burst = not in_burst
                t += rng.exponential(burst_mean if in_burst else idle_mean)
        tier = _weighted(rng, cfg.tiers)
        plen = _lognormal(rng, cfg.prompt_len_mean, cfg.prompt_len_sigma,
                          cfg.prompt_len_max)
        max_new = _lognormal(rng, cfg.new_tokens_mean, cfg.new_tokens_sigma,
                             cfg.new_tokens_max)
        population = None
        if cfg.prefix_populations and rng.random() < cfg.prefix_share_p:
            population = _weighted(rng, cfg.prefix_populations).name
        # the fresh tail is drawn even for population members, AFTER the
        # membership decision, so every request consumes an identical
        # number of rng draws per branch and the trace stays reproducible
        if population is not None:
            head = prefixes[population]
            tail_len = max(plen, 1)
            tail = rng.integers(0, cfg.vocab, size=tail_len).astype(np.int32)
            prompt = np.concatenate([head, tail])
        else:
            prompt = rng.integers(0, cfg.vocab, size=plen).astype(np.int32)
        reqs.append(TraceRequest(
            uid=uid, arrival_tick=int(t), prompt=prompt,
            max_new_tokens=max_new, tier=tier.name, priority=tier.priority,
            deadline_ticks=tier.deadline_ticks, population=population))
    return Trace(config=cfg, requests=reqs, prefixes=prefixes)


# --------------------------------------------------------------------------- #
# SLO scoring
# --------------------------------------------------------------------------- #

@dataclass(frozen=True)
class SLO:
    """Per-request latency objectives in deterministic engine ticks (the
    tick clock is what makes goodput reproducible across machines; the
    report carries wall-second percentiles alongside for operators).  A
    finished request MEETS the SLO iff its TTFT and its worst inter-token
    gap are both within bounds."""

    ttft_ticks: int = 20
    gap_ticks: int = 4

    def met(self, req: EngineRequest) -> bool:
        return (req.done
                and req.ttft_ticks is not None
                and req.ttft_ticks <= self.ttft_ticks
                and req.max_gap_ticks <= self.gap_ticks)


# admission-time rejection reasons = "shed" (the request was turned away
# by admission control — including a queued victim evicted by tier-aware
# overload shedding); anything else with `dropped` set (deadline expiry)
# is a mid-flight drop
_SHED_REASONS = ("queue_full", "too_long", "empty", "shed_low_tier")


def _tier_summary(reqs: List[EngineRequest], slo: SLO,
                  wall_s: float) -> Dict[str, Any]:
    fin = [r for r in reqs if r.done]
    shed = [r for r in reqs if r.dropped in _SHED_REASONS]
    dropped = [r for r in reqs
               if r.dropped is not None and r.dropped not in _SHED_REASONS]
    incomplete = [r for r in reqs if not r.done and r.dropped is None]
    met = [r for r in fin if slo.met(r)]
    ttfts = [r.ttft_ticks for r in fin if r.ttft_ticks is not None]
    gaps = [r.max_gap_ticks for r in fin]
    good_tokens = sum(len(r.out_tokens) for r in met)
    return {
        "n_offered": len(reqs),
        "n_finished": len(fin),
        "n_shed": len(shed),
        "n_dropped": len(dropped),
        "n_incomplete": len(incomplete),   # 0 unless max_ticks cut us off
        "n_slo_met": len(met),
        # None, not 0.0, when nothing finished: a tier with no data has
        # no attainment — the same no-data-is-null contract as `_pct`
        "slo_attainment": len(met) / len(fin) if fin else None,
        "goodput_requests_per_s": len(met) / wall_s if wall_s > 0 else 0.0,
        "goodput_tokens_per_s": good_tokens / wall_s if wall_s > 0 else 0.0,
        "ttft_ticks": _pct_dict(ttfts),
        "gap_ticks": _pct_dict(gaps),
        "ttft_s": _pct_dict([r.ttft_s for r in fin if r.ttft_s is not None]),
        "p99_within_slo": bool(ttfts and gaps
                               and _pct_dict(ttfts)["p99"] <= slo.ttft_ticks
                               and _pct_dict(gaps)["p99"] <= slo.gap_ticks),
    }


def run_load(engine: Engine, trace: Trace, slo: SLO, *,
             max_ticks: int = 200_000,
             tier_blind: bool = False) -> Dict[str, Any]:
    """Drive ``engine`` through ``trace`` and score it against ``slo``.

    Each request is submitted when the engine's tick clock reaches its
    arrival tick (ticks advance even while the engine idles, so quiet
    stretches of a bursty trace really are quiet).  Returns the load
    report: overall + per-tier goodput/shedding/percentiles, trace stats,
    the engine metrics summary, and pool stats when paged.  Conservation
    (offered == finished + shed + dropped) is asserted, not assumed.

    ``tier_blind=True`` strips every request's priority at submit (tier
    labels are kept for scoring): the engine schedules pure FIFO with
    tier-blind queue-full shedding — the baseline tier-aware scheduling is
    compared against."""
    pending = sorted(trace.requests, key=lambda r: (r.arrival_tick, r.uid))
    base = engine.tick      # engine may have been warmed already
    submitted: List[EngineRequest] = []
    i = 0
    while (i < len(pending) or engine.has_work()) \
            and engine.tick - base < max_ticks:
        now = engine.tick - base
        while i < len(pending) and pending[i].arrival_tick <= now:
            tr = pending[i]
            req = EngineRequest(
                uid=tr.uid, prompt=tr.prompt,
                max_new_tokens=tr.max_new_tokens,
                priority=0 if tier_blind else tr.priority,
                tier=tr.tier,
                deadline_tick=(None if tr.deadline_ticks is None
                               else engine.tick + tr.deadline_ticks))
            submitted.append(req)
            engine.submit(req)      # False -> shed; req.dropped says why
            i += 1
        engine.step()
    wall_s = engine.metrics.wall_s
    report: Dict[str, Any] = {
        "slo": {"ttft_ticks": slo.ttft_ticks, "gap_ticks": slo.gap_ticks},
        "trace": trace.stats(),
        "ticks": engine.tick - base,
        "wall_s": wall_s,
        "overall": _tier_summary(submitted, slo, wall_s),
        "tiers": {
            tier.name: _tier_summary(
                [r for r in submitted if r.tier == tier.name], slo, wall_s)
            for tier in trace.config.tiers},
        "engine": engine.metrics.summary(),
    }
    if engine.paged:
        report["pool"] = engine.stepper.pool.stats()
    ov = report["overall"]
    assert (ov["n_finished"] + ov["n_shed"] + ov["n_dropped"]
            + ov["n_incomplete"] == ov["n_offered"]), \
        "load accounting lost a request"
    return report
