"""The port's paged serving engine on the CPU, fp32 and int8 pages: the
paged graphs compile node for node as repro's, and the engine is
token-exact against its own (dense fp32) UnbatchedReference on cold
requests, a prefix hit and copy-on-write divergence off a shared partial
tail page; admission waits on blocks and rejects what can never fit.
Mirrors tests/test_paged_serving.py and tests/test_kv8_serving.py."""

import numpy as np
import pytest

import repro  # noqa: F401
import repro_torch  # noqa: F401
from repro.core.program import compile as jcompile
from repro.models import graph_lm as jlm
from repro_torch.core.program import compile as tcompile
from repro_torch.models import graph_lm as tlm
from repro_torch.runtime.engine import EngineRequest, build_lm_serving

TINY_ARGS = dict(vocab=61, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64)
TINY = tlm.GraphLMConfig(**TINY_ARGS)
KV = ["float32", "int8"]


def scenario(engine, request_cls):
    """Three waves on one engine: 7 cold requests; a 24-token prefix, cold
    then warm; a 21-token prompt (a 5-row partial tail page) that finishes,
    then 3 requests extending it, whose first writes copy that page.
    Returns the requests of each wave and pool counters after it."""
    waves = {}

    def run(name, reqs):
        for r in reqs:
            assert engine.submit(r), r.dropped
            if name != "cold":
                engine.run(max_ticks=engine.tick + 500)  # one at a time
        engine.run(max_ticks=engine.tick + 4000)
        pool = engine.stepper.pool
        pool.check_integrity()
        engine.sched.check_conservation()
        waves[name] = (reqs, dict(pool.stats()))

    rng = np.random.default_rng(11)
    run("cold", [request_cls(uid=i, prompt=rng.integers(0, 61, int(rng.integers(1, 13)))
                             .astype(np.int32), max_new_tokens=int(rng.integers(1, 7)))
                 for i in range(7)])
    rng = np.random.default_rng(12)
    prefix = rng.integers(0, 61, 24).astype(np.int32)
    run("prefix", [request_cls(uid=100 + i, prompt=np.concatenate(
        [prefix, rng.integers(0, 61, 3 - i).astype(np.int32)]), max_new_tokens=5)
        for i in range(2)])
    rng = np.random.default_rng(13)
    pre = rng.integers(0, 61, 21).astype(np.int32)
    run("cow_seed", [request_cls(uid=200, prompt=pre, max_new_tokens=2)])
    reqs = [request_cls(uid=201 + i, prompt=np.concatenate(
        [pre, rng.integers(0, 61, 2 + i).astype(np.int32)]), max_new_tokens=4)
        for i in range(3)]
    for r in reqs:                  # concurrent: all share the cached tail page
        assert engine.submit(r), r.dropped
    engine.run(max_ticks=engine.tick + 4000)
    engine.stepper.pool.check_integrity()
    waves["cow"] = (reqs, dict(engine.stepper.pool.stats()))
    return waves


def paged_serving(kv_dtype, params=None, **kw):
    kw = {"n_slots": 3, "chunk": 4, "cache_cap": 48, "page_size": 8, **kw}
    return build_lm_serving(TINY, paged=True, kv_dtype=kv_dtype, device="cpu",
                            params=params if params is not None
                            else jlm.init_lm_params(jlm.GraphLMConfig(**TINY_ARGS), 0), **kw)


@pytest.fixture(scope="module", params=KV)
def served(request):
    engine, reference = paged_serving(request.param)
    return request.param, engine, reference, scenario(engine, EngineRequest)


@pytest.mark.parametrize("kv_dtype", KV)
@pytest.mark.parametrize("mode", ["decode", "prefill"])
def test_paged_graphs_are_equal_node_for_node(mode, kv_dtype):
    params = jlm.init_lm_params(jlm.GraphLMConfig(**TINY_ARGS), 0)
    kw = dict(batch=3, n_blocks=9, page_size=4, max_pages=3, kv_dtype=kv_dtype)
    if mode == "prefill":
        kw["chunk"] = 4
    name = f"build_paged_{mode}_graph"
    jg = jcompile(getattr(jlm, name)(jlm.GraphLMConfig(**TINY_ARGS), params, **kw)).graph
    tg = tcompile(getattr(tlm, name)(TINY, params, **kw), device="cpu").graph
    assert tg.name == jg.name
    assert [(n.name, n.op, n.inputs, n.outputs, n.attrs) for n in tg.nodes] == \
        [(n.name, n.op, n.inputs, n.outputs, n.attrs) for n in jg.nodes]
    assert tg.outputs == jg.outputs
    assert {k: (v.shape, v.dtype) for k, v in tg.inputs.items()} == \
        {k: (v.shape, v.dtype) for k, v in jg.inputs.items()}
    assert {k: (v.shape, v.dtype) for k, v in tg.value_info.items()} == \
        {k: (v.shape, v.dtype) for k, v in jg.value_info.items()}
    jc = jlm.init_paged_cache_inputs(jlm.GraphLMConfig(**TINY_ARGS), 9, 4, kv_dtype=kv_dtype)
    tc = tlm.init_paged_cache_inputs(TINY, 9, 4, kv_dtype=kv_dtype)
    assert {k: (v.shape, v.dtype) for k, v in jc.items()} == \
        {k: (v.shape, v.dtype) for k, v in tc.items()}


def test_paged_engine_uses_the_kernel_backends(served):
    kv_dtype, engine, _, _ = served
    q = "_q" if kv_dtype == "int8" else ""
    summary = engine.stepper.backend_summary()
    assert summary["prefill"][f"paged_chunk_attention{q}"] == {"cuda": TINY.n_layers}
    assert summary["decode"][f"paged_decode_attention{q}"] == {"cuda": TINY.n_layers}
    assert summary["decode"][f"paged_cache_update{q}"] == {"ref": 2 * TINY.n_layers}
    assert engine.stepper.pool.kv_dtype == kv_dtype
    assert str(engine.stepper.caches["cache_k0"].dtype) == f"torch.{kv_dtype}"


@pytest.mark.parametrize("wave", ["cold", "prefix", "cow_seed", "cow"])
def test_paged_engine_is_token_exact_against_its_reference(served, wave):
    _, _, reference, waves = served
    for r in waves[wave][0]:
        assert r.done and r.dropped is None, (r.uid, r.dropped)
        assert r.out_tokens == reference.generate(r.prompt, r.max_new_tokens), r.uid


def test_cold_wave_drains_the_pool(served):
    stats = served[3]["cold"][1]
    assert stats["live_blocks"] == 0 and stats["reserved_blocks"] == 0


def test_prefix_hit_fast_forwards_prefill(served):
    waves = served[3]
    (cold, warm), stats = waves["prefix"]
    assert stats["hit_tokens"] - waves["cold"][1]["hit_tokens"] >= 24
    assert (warm.first_token_tick - warm.submit_tick
            < cold.first_token_tick - cold.submit_tick)


def test_cow_divergence_copies_the_shared_tail(served):
    waves = served[3]
    assert waves["cow"][1]["cow_count"] > waves["cow_seed"][1]["cow_count"]
    assert waves["cow"][1]["hit_tokens"] - waves["cow_seed"][1]["hit_tokens"] >= 3 * 20


@pytest.mark.parametrize("kv_dtype", KV)
def test_block_admission_defers_then_drains(kv_dtype):
    """Each request reserves pages_needed(8, 9) = 2 pages of 8, so only two
    fit the 5-block pool at once: slots 3 and 4 sit free while admission
    waits on blocks."""
    engine, reference = paged_serving(kv_dtype, n_slots=4, cache_cap=32, n_blocks=5)
    rng = np.random.default_rng(15)
    reqs = [EngineRequest(uid=i, prompt=rng.integers(0, 61, 8).astype(np.int32),
                          max_new_tokens=9) for i in range(6)]
    for r in reqs:
        assert engine.submit(r)
    engine.step()
    assert engine.sched.busy_slots == 2
    engine.run(max_ticks=4000)
    for r in reqs:
        assert r.done and r.out_tokens == reference.generate(r.prompt, 9), r.uid
    assert engine.stepper.pool.n_admit_deferred > 0
    engine.stepper.pool.check_integrity()


@pytest.mark.parametrize("kv_dtype", KV)
def test_submit_rejects_what_can_never_fit(kv_dtype):
    engine, _ = paged_serving(kv_dtype, n_slots=2, cache_cap=32, n_blocks=6)
    too_long = EngineRequest(uid=1, prompt=np.zeros(30, np.int32), max_new_tokens=4)
    assert not engine.submit(too_long) and too_long.dropped == "too_long"
    edge = EngineRequest(uid=2, prompt=np.zeros(32, np.int32), max_new_tokens=1)
    assert engine.submit(edge)
    engine.run(max_ticks=500)
    assert edge.done
    # a table that fits but a pool that cannot: 4 pages needed, 3 blocks
    engine, _ = paged_serving(kv_dtype, n_slots=2, cache_cap=32, n_blocks=3)
    big = EngineRequest(uid=3, prompt=np.zeros(20, np.int32), max_new_tokens=8)
    assert not engine.submit(big) and big.dropped == "too_long"
    assert engine.metrics.n_rejected == 1


def test_paged_defaults_and_option_checks():
    engine, reference = paged_serving("float32", n_slots=2, cache_cap=20, page_size=8)
    st = engine.stepper
    assert (st.max_pages, st.n_blocks, st.cache_cap) == (3, 6, 24)   # dense memory
    assert reference.cache_cap == 24 and engine.cache_cap == 24
    engine, _ = paged_serving("int8", n_slots=2, cache_cap=20, max_pages=5, n_blocks=7)
    assert (engine.stepper.max_pages, engine.stepper.n_blocks) == (5, 7)
    assert engine.stepper.caches["cache_v1_scale"].shape == (7, TINY.n_kv_heads)
    with pytest.raises(ValueError, match="paged=True"):
        build_lm_serving(TINY, kv_dtype="int8", device="cpu")
    with pytest.raises(ValueError, match="kv_dtype"):
        build_lm_serving(TINY, paged=True, kv_dtype="int4", device="cpu")
