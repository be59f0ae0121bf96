"""The port's load generator (repro_torch.runtime.loadgen) against the JAX
package's, on the CPU — tests/test_loadgen.py on the port, plus:

* the same TraceConfig gives the same sha256 digest and the same requests
  in both packages, for gamma, mmpp and prefix-population traces and for
  chip_smoke.py phase 16's exact config (phi3-mini's vocab, 48 requests);
* ``run_load`` on the same trace and weights gives the same per-tier
  counts, ticks and engine counters as the JAX package's ``run_load``."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

import repro  # noqa: F401
from repro.runtime import engine as jeng
from repro.runtime import loadgen as jload
from repro_torch.runtime import loadgen as tload
from repro_torch.runtime.batching import SlotScheduler
from repro_torch.runtime.engine import EngineRequest
from repro_torch.runtime.loadgen import (SLO, PrefixPopulation, TierSpec, Trace, TraceConfig,
                                         generate_trace, run_load)
from test_torch_fault_injection import make_engine

CFG = TraceConfig(
    seed=3, n_requests=40, mean_interarrival_ticks=2.0,
    prompt_len_mean=8.0, prompt_len_max=24,
    new_tokens_mean=5.0, new_tokens_max=10,
    tiers=(TierSpec("interactive", priority=1, weight=0.6, deadline_ticks=500),
           TierSpec("batch", priority=0, weight=0.4)),
    prefix_populations=(PrefixPopulation("sys", prefix_len=8),
                        PrefixPopulation("fewshot", prefix_len=12)),
    prefix_share_p=0.5)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _in(m, cfg):
    """``cfg`` (the port's TraceConfig) rebuilt from module ``m``'s classes."""
    kw = {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}
    kw["tiers"] = tuple(m.TierSpec(**t.__dict__) for t in cfg.tiers)
    kw["prefix_populations"] = tuple(m.PrefixPopulation(**p.__dict__)
                                     for p in cfg.prefix_populations)
    return m.TraceConfig(**kw)


def _same_trace(cfg):
    t, j = generate_trace(cfg), jload.generate_trace(_in(jload, cfg))
    assert t.digest() == j.digest()
    for a, b in zip(t.requests, j.requests):
        assert (a.uid, a.arrival_tick, a.max_new_tokens, a.tier, a.priority,
                a.deadline_ticks, a.population) == \
            (b.uid, b.arrival_tick, b.max_new_tokens, b.tier, b.priority,
             b.deadline_ticks, b.population)
        assert np.array_equal(a.prompt, b.prompt)
    assert t.stats() == j.stats()
    return t


# --------------------------------------------------------------------------- #
# determinism, and the same traces as the JAX package
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arrival", ["gamma", "mmpp"])
def test_same_seed_byte_identical(arrival):
    cfg = TraceConfig(seed=11, n_requests=64, arrival=arrival,
                      prefix_populations=CFG.prefix_populations, prefix_share_p=0.4)
    a, b = generate_trace(cfg), generate_trace(cfg)
    assert a.digest() == b.digest()
    for ra, rb in zip(a.requests, b.requests):
        assert ra.arrival_tick == rb.arrival_tick
        assert ra.tier == rb.tier and ra.population == rb.population
        assert np.array_equal(ra.prompt, rb.prompt)
    for name in a.prefixes:
        assert np.array_equal(a.prefixes[name], b.prefixes[name])


@pytest.mark.parametrize("cfg", [
    TraceConfig(seed=11, n_requests=64),
    TraceConfig(seed=11, n_requests=64, arrival="mmpp"),
    TraceConfig(seed=11, n_requests=64, arrival="mmpp",
                prefix_populations=CFG.prefix_populations, prefix_share_p=0.4),
    CFG,
    TraceConfig(seed=0, n_requests=600, burstiness=1.0, mean_interarrival_ticks=0.7)],
    ids=["gamma", "mmpp", "mmpp-prefix", "gamma-prefix", "poisson"])
def test_digest_equals_the_jax_package(cfg):
    _same_trace(cfg)


def test_phase16_trace_equals_the_jax_package():
    """chip_smoke.py phase 16's TraceConfig (phi3-mini's vocab, 2x the drain
    rate of 4 slots at chunk 64) gives the JAX package's trace."""
    cfg = _chip_smoke().phase16_trace_config()
    assert (cfg.n_requests, cfg.vocab, cfg.arrival, cfg.burstiness) == (48, 32064, "gamma", 4.0)
    assert cfg.mean_interarrival_ticks == (256 // 64 + 1 + 24) / (2 * 4)
    trace = _same_trace(cfg)
    assert max(len(r.prompt) for r in trace.requests) <= 768
    assert max(r.max_new_tokens for r in trace.requests) <= 64


def test_different_seeds_diverge():
    a = generate_trace(TraceConfig(seed=0, n_requests=32))
    b = generate_trace(TraceConfig(seed=1, n_requests=32))
    assert a.digest() != b.digest()


def test_digest_covers_prompts():
    t = generate_trace(TraceConfig(seed=5, n_requests=8))
    mutated = Trace(config=t.config, requests=list(t.requests), prefixes=t.prefixes)
    r0 = mutated.requests[0]
    bent = np.array(r0.prompt, np.int32)
    bent[0] = (bent[0] + 1) % 61
    mutated.requests[0] = type(r0)(
        uid=r0.uid, arrival_tick=r0.arrival_tick, prompt=bent,
        max_new_tokens=r0.max_new_tokens, tier=r0.tier, priority=r0.priority,
        deadline_ticks=r0.deadline_ticks, population=r0.population)
    assert mutated.digest() != t.digest()


def test_config_validation():
    with pytest.raises(ValueError, match="tier"):
        generate_trace(TraceConfig(tiers=()))
    with pytest.raises(ValueError, match="arrival"):
        generate_trace(TraceConfig(arrival="nope"))


# --------------------------------------------------------------------------- #
# distribution shape
# --------------------------------------------------------------------------- #

def _shape_ok(cfg):
    s = generate_trace(cfg).stats()
    n = cfg.n_requests
    tol = 6.0 * np.sqrt(max(cfg.burstiness, cfg.mmpp_burst_factor) / n)
    assert abs(s["mean_interarrival_ticks"] - cfg.mean_interarrival_ticks) \
        <= max(tol * cfg.mean_interarrival_ticks, 1.0), s
    assert abs(s["mean_prompt_len"] - cfg.prompt_len_mean) \
        <= 0.25 * cfg.prompt_len_mean + 6.0 / np.sqrt(n), s
    assert abs(s["mean_new_tokens"] - cfg.new_tokens_mean) \
        <= 0.25 * cfg.new_tokens_mean + 6.0 / np.sqrt(n), s
    assert sum(s["tiers"].values()) == n
    assert set(s["tiers"]) <= {t.name for t in cfg.tiers}
    assert s["shared_prefix_requests"] == sum(s["populations"].values())


def test_distribution_means_default():
    _shape_ok(TraceConfig(seed=0, n_requests=600))
    _shape_ok(TraceConfig(seed=1, n_requests=600, arrival="mmpp"))


@pytest.mark.parametrize("seed,share", [(0, 0.0), (7, 0.3), (21, 1.0)])
def test_population_members_start_with_their_prefix(seed, share):
    trace = generate_trace(TraceConfig(seed=seed, n_requests=120,
                                       prefix_populations=CFG.prefix_populations,
                                       prefix_share_p=share))
    for r in trace.requests:
        if r.population is not None:
            head = trace.prefixes[r.population]
            assert np.array_equal(r.prompt[:len(head)], head)
        assert len(r.prompt) >= 1 and r.max_new_tokens >= 1


# --------------------------------------------------------------------------- #
# conservation through SlotScheduler (no model — pure scheduling)
# --------------------------------------------------------------------------- #

def _to_engine_req(tr):
    return EngineRequest(uid=tr.uid, prompt=tr.prompt, max_new_tokens=tr.max_new_tokens,
                         priority=tr.priority, tier=tr.tier)


def test_trace_conserved_through_scheduler():
    trace = generate_trace(CFG)
    sched = SlotScheduler(n_slots=3, max_queue=6)
    accepted, shed = [], []
    for tr in trace.requests:
        req = _to_engine_req(tr)
        (accepted if sched.submit(req) else shed).append(req)
        if tr.uid % 3 == 0:
            for slot, _ in sched.admit():
                sched.finish(slot)
    while sched.has_work():
        admitted = sched.admit()
        if not admitted:
            break
        for slot, _ in admitted:
            sched.finish(slot)
    sched.check_conservation()
    assert len(accepted) + len(shed) == len(trace.requests)
    assert sched.n_rejected == len(shed)
    assert sched.n_finished == len(accepted)
    got = {}
    for r in accepted + shed:
        got[r.tier] = got.get(r.tier, 0) + 1
    assert got == trace.stats()["tiers"]


def test_fifo_among_equal_priority():
    trace = generate_trace(TraceConfig(seed=9, n_requests=30,
                                       tiers=(TierSpec("only", priority=0),)))
    sched = SlotScheduler(n_slots=1)
    for tr in trace.requests:
        assert sched.submit(_to_engine_req(tr))
    served = []
    while sched.has_work():
        for slot, req in sched.admit():
            served.append(req.uid)
            sched.finish(slot)
    assert served == sorted(served)


def test_priority_tiers_preempt_queue_order():
    sched = SlotScheduler(n_slots=1)
    batch = [EngineRequest(uid=i, prompt=np.ones(1, np.int32), max_new_tokens=1,
                           priority=0) for i in range(3)]
    inter = [EngineRequest(uid=10 + i, prompt=np.ones(1, np.int32), max_new_tokens=1,
                           priority=1) for i in range(3)]
    for r in batch + inter:
        sched.submit(r)
    served = []
    while sched.has_work():
        for slot, req in sched.admit():
            served.append(req.uid)
            sched.finish(slot)
    assert served == [10, 11, 12, 0, 1, 2]


# --------------------------------------------------------------------------- #
# run_load end to end, against the JAX package's
# --------------------------------------------------------------------------- #

RUN_CFG = TraceConfig(
    seed=21, n_requests=18, mean_interarrival_ticks=1.0, burstiness=5.0,
    prompt_len_mean=7.0, prompt_len_max=20, new_tokens_mean=4.0, new_tokens_max=8,
    tiers=CFG.tiers, prefix_populations=(PrefixPopulation("sys", prefix_len=8),),
    prefix_share_p=0.5)
COUNTS = ("n_offered", "n_finished", "n_shed", "n_dropped", "n_incomplete", "n_slo_met")


def _counts(report):
    return ({t: {k: v[k] for k in COUNTS} for t, v in
             [("overall", report["overall"]), *report["tiers"].items()]},
            {k: report["overall"][k] for k in ("ttft_ticks", "gap_ticks")},
            report["ticks"], report["pool"], report["trace"]["digest"])


@pytest.mark.parametrize("tier_blind", [False, True])
def test_run_load_report_matches_the_jax_package(tier_blind):
    slo = SLO(ttft_ticks=30, gap_ticks=6)
    engine, _ = make_engine("paged-fp32", n_slots=2, max_queue=3)
    trace = generate_trace(RUN_CFG)
    report = run_load(engine, trace, slo, tier_blind=tier_blind)
    ov = report["overall"]
    assert ov["n_offered"] == RUN_CFG.n_requests
    assert ov["n_finished"] + ov["n_shed"] + ov["n_dropped"] + ov["n_incomplete"] == \
        ov["n_offered"]
    assert ov["n_shed"] > 0, "overload did not shed — queue bound inert"
    for key in ("n_offered", "n_finished", "n_shed", "n_dropped", "n_slo_met"):
        assert sum(t[key] for t in report["tiers"].values()) == ov[key], key
    assert ov["n_slo_met"] <= ov["n_finished"]
    if ov["n_finished"]:
        assert 0.0 <= ov["slo_attainment"] <= 1.0
    assert report["pool"]["hit_rate"] > 0, "prefix population never hit"
    assert report["trace"]["digest"] == trace.digest()
    if report["wall_s"] > 0:
        assert ov["goodput_requests_per_s"] == pytest.approx(ov["n_slo_met"] / report["wall_s"])
    jengine, _ = make_engine("paged-fp32", jax=True, n_slots=2, max_queue=3)
    jreport = jload.run_load(jengine, jload.generate_trace(_in(jload, RUN_CFG)),
                             jload.SLO(ttft_ticks=30, gap_ticks=6), tier_blind=tier_blind)
    assert _counts(report) == _counts(jreport)
    # the tick-counted engine numbers (the straggler flags and the spec
    # section's wall times are each package's own clock)
    for sec, skip in (("self_heal", {"straggler_ticks"}), ("overload", set())):
        assert {k: v for k, v in report["engine"][sec].items() if k not in skip} == \
            {k: v for k, v in jreport["engine"][sec].items() if k not in skip}


def test_slo_met_logic():
    for m, cls in ((tload, EngineRequest), (jload, jeng.EngineRequest)):
        r = cls(uid=0, prompt=np.ones(1, np.int32), max_new_tokens=4)
        slo = m.SLO(ttft_ticks=10, gap_ticks=3)
        verdicts = [slo.met(r)]
        r.done = True
        r.submit_tick, r.first_token_tick = 5, 14
        r.max_gap_ticks = 3
        verdicts.append(slo.met(r))
        r.max_gap_ticks = 4
        verdicts.append(slo.met(r))
        r.first_token_tick, r.max_gap_ticks = 16, 0
        verdicts.append(slo.met(r))
        assert verdicts == [False, True, False, False]


def test_tier_summary_of_nothing_is_null():
    s = tload._tier_summary([], SLO(), 0.0)
    assert s == jload._tier_summary([], jload.SLO(), 0.0)
    assert s["slo_attainment"] is None and s["ttft_ticks"]["p99"] is None
