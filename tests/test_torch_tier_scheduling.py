"""Tier-aware overload scheduling on the port, on the CPU —
tests/test_tier_scheduling.py on the port's engines (dense, paged fp32,
paged int8), the scheduler's mechanism side by side with the JAX
package's; the overload experiment of benchmarks/serve_bench.py at the
tiny model, where the port and JAX give the same ``n_preempted``,
``n_tier_shed`` and per-tier counts; the summary()'s self-heal and
overload sections with JAX's keys; and the three directed BlockPool
snapshot / restore / truncate cases of tests/test_pool_properties.py
that tests/test_torch_paged_pool.py does not drive."""

import numpy as np
import pytest

import repro  # noqa: F401
from repro.runtime import batching as jbatching
from repro.runtime import engine as jeng
from repro.runtime import kv_cache as jkv
from repro.runtime import loadgen as jload
from repro_torch.runtime import batching as tbatching
from repro_torch.runtime import loadgen as tload
from repro_torch.runtime.engine import EngineMetrics, EngineRequest
from repro_torch.runtime.kv_cache import BlockPool, pages_needed
from test_torch_fault_injection import make_engine

SCHEDULERS = [pytest.param((jbatching.SlotScheduler, jeng.EngineRequest), id="jax"),
              pytest.param((tbatching.SlotScheduler, EngineRequest), id="port")]


def _req(uid, priority=0, n=4, max_new=4, deadline=None, cls=EngineRequest):
    rng = np.random.default_rng(100 + uid)
    return cls(uid=uid, priority=priority,
               prompt=rng.integers(2, 61, size=n).astype(np.int32),
               max_new_tokens=max_new, deadline_tick=deadline)


# --------------------------------------------------------------------------- #
# SlotScheduler.shed_lowest / preempt — the mechanism, beside JAX's
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("pkg", SCHEDULERS)
def test_shed_lowest_picks_lowest_priority_then_most_recent(pkg):
    Sched, cls = pkg
    sched = Sched(n_slots=1)
    reqs = [_req(i, priority=p, cls=cls) for i, p in enumerate([1, 0, 0, 2])]
    for r in reqs:
        assert sched.submit(r)
    assert sched.shed_lowest(min_priority=2) is reqs[2]
    assert sched.n_rejected == 1 and sched.queue_len == 3
    sched.check_conservation()
    assert sched.shed_lowest(2) is reqs[1]
    assert sched.shed_lowest(2) is reqs[0]
    assert sched.shed_lowest(2) is None
    assert sched.queue_len == 1 and sched.peek() is reqs[3]
    sched.check_conservation()


@pytest.mark.parametrize("pkg", SCHEDULERS)
def test_shed_lowest_floor_is_strict(pkg):
    Sched, cls = pkg
    sched = Sched(n_slots=1)
    a, b = _req(0, priority=1, cls=cls), _req(1, priority=1, cls=cls)
    sched.submit(a)
    sched.submit(b)
    assert sched.shed_lowest(min_priority=1) is None
    assert sched.shed_lowest(min_priority=2) is b
    sched.check_conservation()


@pytest.mark.parametrize("pkg", SCHEDULERS)
def test_shed_lowest_preserves_admission_order(pkg):
    Sched, cls = pkg
    sched = Sched(n_slots=2)
    reqs = [_req(i, priority=p, cls=cls) for i, p in enumerate([0, 2, 0, 1])]
    for r in reqs:
        sched.submit(r)
    assert sched.shed_lowest(2) is reqs[2]
    assert [r for _, r in sched.admit()] == [reqs[1], reqs[3]]
    sched.check_conservation()


def test_preempt_requeues_at_the_original_position_like_jax():
    """Random submit / admit / preempt / finish / shed sequences through
    both schedulers: the same admissions (by uid, slot) and counters after
    every operation; preempt ignores max_queue and moves no counter."""
    rng = np.random.default_rng(5)
    for trial in range(20):
        scheds = [(jbatching.SlotScheduler(3, max_queue=4), jeng.EngineRequest),
                  (tbatching.SlotScheduler(3, max_queue=4), EngineRequest)]
        uid = 0
        for _ in range(40):
            op = rng.integers(0, 5)
            pri = int(rng.integers(0, 3))
            slot = int(rng.integers(0, 3))
            logs = []
            for sched, cls in scheds:
                if op == 0:
                    res = sched.submit(_req(uid, priority=pri, cls=cls))
                elif op == 1:
                    res = [(s, r.uid) for s, r in sched.admit()]
                elif op == 2:
                    res = sched.preempt(slot).uid if sched.active[slot] is not None else None
                elif op == 3:
                    res = sched.finish(slot).uid if sched.active[slot] is not None else None
                else:
                    v = sched.shed_lowest(pri)
                    res = None if v is None else v.uid
                sched.check_conservation()
                logs.append((res, sched.queue_len, sched.busy_slots, sched.n_submitted,
                             sched.n_rejected, sched.n_finished, sched.n_dropped))
            assert logs[0] == logs[1], (trial, op)
            uid += op == 0


# --------------------------------------------------------------------------- #
# Engine.submit — tier-aware queue shedding (the policy)
# --------------------------------------------------------------------------- #

def test_full_queue_sheds_low_tier_for_high_tier():
    engine, _ = make_engine("dense", n_slots=1, tier_aware=True, max_queue=2)
    busy = _req(0, priority=1, max_new=8)
    assert engine.submit(busy)
    engine.step()
    low1, low2 = _req(1, priority=0), _req(2, priority=0)
    assert engine.submit(low1) and engine.submit(low2)
    assert engine.sched.queue_len == 2
    high = _req(3, priority=1)
    assert engine.submit(high), high.dropped
    assert low2.dropped == "shed_low_tier"
    assert low2.finish_tick is not None
    assert engine.metrics.n_tier_shed == 1
    assert engine.sched.queue_len == 2
    engine.sched.check_conservation()
    engine.run()
    assert busy.done and low1.done and high.done
    assert not low2.done
    engine.sched.check_conservation()


def test_full_queue_shed_skips_equal_tier():
    engine, _ = make_engine("dense", n_slots=1, tier_aware=True, max_queue=1)
    assert engine.submit(_req(0, priority=0, max_new=8))
    engine.step()
    queued = _req(1, priority=0)
    assert engine.submit(queued)
    same = _req(2, priority=0)
    assert not engine.submit(same)
    assert same.dropped == "queue_full" and queued.dropped is None
    assert engine.metrics.n_tier_shed == 0
    engine.sched.check_conservation()
    engine.run()


def test_tier_blind_engine_rejects_high_tier_instead():
    engine, _ = make_engine("dense", n_slots=1, max_queue=1)
    assert engine.submit(_req(0, priority=0, max_new=8))
    engine.step()
    low = _req(1, priority=0)
    assert engine.submit(low)
    high = _req(2, priority=1)
    assert not engine.submit(high)
    assert high.dropped == "queue_full" and low.dropped is None
    engine.sched.check_conservation()
    engine.run()


# --------------------------------------------------------------------------- #
# preemption — pages, not recompute
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("variant", ["dense", "paged-fp32", "paged-int8"])
def test_preemption_admits_high_tier_and_victim_is_token_identical(variant):
    """One slot, a long low-tier decode, then a high-tier arrival with a
    tight TTFT budget: the low-tier slot is preempted, the high tier meets
    its budget, and the victim resumes token-identical to an undisturbed
    run — from its surviving pages (paged), or by a full re-prefill once
    the preemptor overwrote its dense slot rows.  The ticks and counters
    equal the JAX package's engine's."""
    def undisturbed(req_fn):
        engine, _ = make_engine(variant, n_slots=1)
        r = req_fn()
        assert engine.submit(r)
        engine.run()
        assert r.done
        return list(r.out_tokens)

    low_fn = lambda cls=EngineRequest: _req(0, priority=0, n=12, max_new=12, cls=cls)  # noqa
    high_fn = lambda cls=EngineRequest: _req(1, priority=1, n=3, max_new=3, cls=cls)   # noqa
    want_low, want_high = undisturbed(low_fn), undisturbed(high_fn)

    records = []
    for jax, cls in ((False, EngineRequest), (True, jeng.EngineRequest)):
        engine, _ = make_engine(variant, jax=jax, n_slots=1, tier_aware=True,
                                slo_ttft_ticks=6)
        low = low_fn(cls)
        assert engine.submit(low)
        for _ in range(4):
            engine.step()
        high = high_fn(cls)
        assert engine.submit(high)
        engine.run()
        m = engine.metrics
        records.append([(r.out_tokens, r.first_token_tick, r.finish_tick, r.n_requeues)
                        for r in (low, high)] + [m.n_preempted, m.recovered_rows,
                                                 m.prefill_ticks, m.decode_ticks])
        if not jax:
            port = (engine, low, high)
    assert records[0] == records[1]
    engine, low, high = port
    assert engine.metrics.n_preempted >= 1 and low.n_requeues >= 1
    assert low.done and high.done
    assert high.finish_tick < low.finish_tick
    assert high.ttft_ticks <= 6 + 1
    if engine.paged:
        assert engine.metrics.recovered_rows > 0
    else:
        assert engine.metrics.recovered_rows == 0
    assert low.out_tokens == want_low
    assert high.out_tokens == want_high
    engine.sched.check_conservation()
    if engine.paged:
        engine.stepper.pool.check_integrity()
        assert engine.stepper.pool.live_sequences == 0


def test_preemption_never_fires_against_equal_or_higher_tier():
    engine, _ = make_engine("dense", n_slots=1, tier_aware=True, slo_ttft_ticks=2)
    first = _req(0, priority=1, max_new=10)
    assert engine.submit(first)
    engine.step()
    second = _req(1, priority=1)
    assert engine.submit(second)
    engine.run()
    assert engine.metrics.n_preempted == 0
    assert first.done and second.done
    assert first.finish_tick <= second.finish_tick
    engine.sched.check_conservation()


def test_preemption_requires_tier_aware():
    engine, _ = make_engine("dense", n_slots=1, slo_ttft_ticks=6)
    low = _req(0, priority=0, n=12, max_new=12)
    assert engine.submit(low)
    for _ in range(4):
        engine.step()
    high = _req(1, priority=1, n=3, max_new=3)
    assert engine.submit(high)
    engine.run()
    assert engine.metrics.n_preempted == 0
    assert low.finish_tick < high.finish_tick
    engine.sched.check_conservation()


def test_preempted_then_shed_victim_releases_its_pages():
    engine, _ = make_engine("paged-fp32", n_slots=1, tier_aware=True,
                            slo_ttft_ticks=6, max_queue=1)
    low = _req(0, priority=0, n=12, max_new=12)
    assert engine.submit(low)
    for _ in range(4):
        engine.step()
    mid = _req(1, priority=1, n=3, max_new=6)
    assert engine.submit(mid)
    for _ in range(12):
        engine.step()
        if engine.metrics.n_preempted:
            break
    assert engine.metrics.n_preempted == 1 and not low.done
    assert engine.stepper.pool.live_sequences >= 1
    high = _req(2, priority=2, n=3, max_new=3)
    assert engine.submit(high)
    assert low.dropped == "shed_low_tier"
    engine.run()
    assert mid.done and high.done
    assert engine.metrics.n_tier_shed == 1
    engine.sched.check_conservation()
    engine.stepper.pool.check_integrity()
    assert engine.stepper.pool.live_sequences == 0


def test_preempted_victim_expiring_in_the_queue_releases_its_pages():
    """The deadline path of the same leak: a preempted request that expires
    while queued returns its pool sequence."""
    engine, _ = make_engine("paged-fp32", n_slots=1, tier_aware=True, slo_ttft_ticks=6)
    low = _req(0, priority=0, n=12, max_new=12, deadline=20)
    assert engine.submit(low)
    for _ in range(4):
        engine.step()
    high = _req(1, priority=1, n=3, max_new=30)
    assert engine.submit(high)
    engine.run()
    assert engine.metrics.n_preempted == 1
    assert low.dropped == "deadline" and high.done
    engine.sched.check_conservation()
    engine.stepper.pool.check_integrity()
    assert engine.stepper.pool.live_sequences == 0


# --------------------------------------------------------------------------- #
# the overload experiment at the tiny model, against JAX
# --------------------------------------------------------------------------- #

def _overload(pkg, tier_aware, trace):
    """benchmarks/serve_bench.py's run_policy at the tiny model: 2 slots,
    chunk 4, max_queue 4, a pool sized so slots are the bottleneck."""
    cfg = trace.config
    n_slots, page = 2, 8
    n_blocks = (n_slots + 2 * n_slots) * pages_needed(cfg.prompt_len_max,
                                                      cfg.new_tokens_max, page)
    engine, _ = make_engine("paged-fp32", jax=pkg is jload, n_slots=n_slots,
                            n_blocks=n_blocks, max_queue=2 * n_slots, self_heal=True,
                            tier_aware=tier_aware,
                            slo_ttft_ticks=12 if tier_aware else None)
    cls = jeng.EngineRequest if pkg is jload else EngineRequest
    warm = cls(uid=-1, prompt=trace.requests[0].prompt, max_new_tokens=2)
    engine.submit(warm)
    engine.run()
    engine.reset_metrics()
    report = pkg.run_load(engine, trace, pkg.SLO(ttft_ticks=12, gap_ticks=12),
                          tier_blind=not tier_aware)
    keys = ("n_offered", "n_finished", "n_shed", "n_dropped", "n_incomplete", "n_slo_met")
    return ({t: {k: v[k] for k in keys} for t, v in report["tiers"].items()},
            engine.metrics.n_preempted, engine.metrics.n_tier_shed, report["ticks"])


def test_overload_matches_jax_and_tier_aware_wins():
    """serve_bench's overload trace (smoke size, seed 0 -> trace seed 3) at
    2x the drain rate: tier-blind and tier-aware give the same per-tier
    counts, preemptions and sheds in both packages, and tier-aware's
    high-tier attainment over offered requests is strictly above
    tier-blind's."""
    chunk, n_slots, prompt_mean, new_mean = 4, 2, 8.0, 6.0
    cost = (prompt_mean // chunk + 1) + new_mean
    kw = dict(seed=3, n_requests=32, vocab=61,
              mean_interarrival_ticks=cost / (2.0 * n_slots), arrival="gamma",
              burstiness=4.0, prompt_len_mean=prompt_mean, prompt_len_sigma=0.4,
              prompt_len_max=16, new_tokens_mean=new_mean, new_tokens_sigma=0.8,
              new_tokens_max=24)
    tiers = lambda m: (m.TierSpec("interactive", priority=1, weight=0.35,  # noqa: E731
                                  deadline_ticks=400), m.TierSpec("batch", priority=0,
                                                                  weight=0.65))
    traces = {m: m.generate_trace(m.TraceConfig(tiers=tiers(m), **kw)) for m in (jload, tload)}
    assert traces[jload].digest() == traces[tload].digest()
    att = {}
    for aware in (False, True):
        port = _overload(tload, aware, traces[tload])
        assert port == _overload(jload, aware, traces[jload])
        tiers_, n_pre, n_shed, _ = port
        hi = tiers_["interactive"]
        att[aware] = hi["n_slo_met"] / hi["n_offered"]
        assert (n_pre > 0) == aware and (n_shed > 0 or not aware)
    assert att[True] > att[False], att


# --------------------------------------------------------------------------- #
# metrics and the pool's snapshot / restore / truncate
# --------------------------------------------------------------------------- #

def test_summary_sections_have_the_jax_keys():
    """The self-heal and overload sections are JAX's key for key (zero
    when the features are off); every JAX key is in the port's summary
    (the port adds the prefill wall time)."""
    t, j = EngineMetrics(n_slots=2).summary(), jeng.EngineMetrics(n_slots=2).summary()
    for sec in ("self_heal", "overload", "spec", "latency_s", "ttft_s"):
        assert t[sec] == j[sec], sec
    assert set(t["self_heal"]) == {"failed_ticks", "n_crash_failures", "n_hang_failures",
                                   "n_recoveries", "requeued_requests", "straggler_ticks",
                                   "recovered_rows"}
    assert set(t["overload"]) == {"n_preempted", "n_tier_shed"}
    assert set(j) <= set(t)


def test_restore_rejects_mismatched_pool():
    snap = BlockPool(8, 4).snapshot()
    with pytest.raises(ValueError, match="blocks"):
        BlockPool(4, 4).restore(snap)


@pytest.mark.parametrize("Pool", [jkv.BlockPool, BlockPool], ids=["jax", "port"])
def test_restore_rolls_back_post_snapshot_admissions(Pool):
    pool = Pool(16, 4)
    sid0, _ = pool.admit(list(range(6)), 4)
    pool.append(sid0, list(range(6)))
    snap = pool.snapshot()
    sid1, _ = pool.admit(list(range(20, 30)), 4)
    pool.append(sid1, list(range(20, 30)))
    pool.release(sid0)
    pool.restore(snap)
    assert pool.sequence(sid0).n_tokens == 6
    with pytest.raises(KeyError):
        pool.sequence(sid1)
    assert pool.snapshot() == snap
    pool.release(sid0, register=False)
    pool.check_integrity()


def test_truncate_then_restore_round_trips_the_index():
    pools = [jkv.BlockPool(8, 4), BlockPool(8, 4)]
    snaps = []
    for pool in pools:
        sid, _ = pool.admit([1, 2, 3], 8)
        pool.append(sid, [1, 2, 3])
        snap = pool.snapshot()
        idx0 = pool.stats()["indexed_full_pages"]
        pool.append(sid, [4, 5, 6, 7, 8])
        assert pool.stats()["indexed_full_pages"] > idx0
        pool.truncate(sid, 3)
        pool.restore(snap)
        assert pool.stats()["indexed_full_pages"] == idx0
        assert pool.snapshot() == snap
        snaps.append(snap)
        pool.release(sid, register=False)
        pool.check_integrity()
    assert snaps[0] == snaps[1]
