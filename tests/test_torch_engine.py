"""The port's dense serving engine on the CPU: token-exact against its own
UnbatchedReference and against repro's engine (Pallas kernels in interpret
mode) on the same weights and prompts, including a prompt of exactly
cache_cap; admission control, deadlines, metrics, and the options of
repro's build_lm_serving (the tensor-parallel ones' errors)."""

import numpy as np
import pytest

import repro  # noqa: F401
import repro_torch  # noqa: F401
from repro.core.selector import FixedPolicy as JFixed
from repro.models.graph_lm import GraphLMConfig as JConfig
from repro.models.graph_lm import init_lm_params
from repro.runtime.engine import EngineRequest as JRequest
from repro.runtime.engine import build_lm_serving as jbuild
from repro_torch.models.graph_lm import GraphLMConfig
from repro_torch.runtime.batching import SlotScheduler
from repro_torch.runtime.engine import EngineRequest, _pct, build_lm_serving

CFG_ARGS = dict(vocab=37, d_model=16, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=32)
CFG = GraphLMConfig(**CFG_ARGS)
SLOTS, CHUNK, CAP = 3, 4, 24
# tests/test_serving_backends.py's Pallas-preferring policy, plus dense and
# rmsnorm, so that the JAX engine runs the four kernels this slice ports
PALLAS = JFixed(prefer=("xla", "ref"),
                per_op={"chunk_attention": ("pallas", "xla", "ref"),
                        "decode_attention": ("pallas", "ref"),
                        "dense": ("pallas", "xla", "ref"),
                        "rmsnorm": ("pallas", "ref")})


def _prompts(seed=0, n=6):
    rng = np.random.default_rng(seed)
    out = [(rng.integers(0, CFG.vocab, int(rng.integers(1, 14))).astype(np.int32),
            int(rng.integers(1, 7))) for _ in range(n)]
    # a prompt of exactly cache_cap: admissible with one new token
    out.append((rng.integers(0, CFG.vocab, CAP).astype(np.int32), 1))
    return out


@pytest.fixture(scope="module")
def serving():
    return build_lm_serving(CFG, n_slots=SLOTS, chunk=CHUNK, cache_cap=CAP,
                            params=init_lm_params(JConfig(**CFG_ARGS), 0), device="cpu")


@pytest.fixture(scope="module")
def port_run(serving):
    engine, _ = serving
    reqs = [EngineRequest(uid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(_prompts())]
    for r in reqs:
        assert engine.submit(r)
    engine.run()
    engine.sched.check_conservation()
    return reqs


def test_engine_uses_the_kernel_backends(serving):
    summary = serving[0].stepper.backend_summary()
    assert summary["prefill"]["chunk_attention"] == {"cuda": CFG.n_layers}
    assert summary["decode"]["decode_attention"] == {"cuda": CFG.n_layers}
    assert summary["prefill"]["dense"] == {"cuda": 7 * CFG.n_layers + 1}
    assert summary["decode"]["rmsnorm"] == {"cuda": 2 * CFG.n_layers + 1}


def test_engine_is_token_exact_against_its_reference(serving, port_run):
    _, reference = serving
    for r in port_run:
        assert r.done and r.dropped is None
        assert len(r.out_tokens) == r.max_new_tokens
        assert r.out_tokens == reference.generate(r.prompt, r.max_new_tokens, chunk=CHUNK)
    one_shot = reference.generate(port_run[0].prompt, port_run[0].max_new_tokens)
    assert one_shot == port_run[0].out_tokens


def test_engine_is_token_exact_against_the_jax_engine(port_run):
    jengine, _ = jbuild(JConfig(**CFG_ARGS), n_slots=SLOTS, chunk=CHUNK, cache_cap=CAP,
                        params=init_lm_params(JConfig(**CFG_ARGS), 0), policy=PALLAS)
    assert jengine.stepper.backend_summary()["decode"]["dense"] == \
        {"pallas": 7 * CFG.n_layers + 1}
    jreqs = [JRequest(uid=i, prompt=p, max_new_tokens=n)
             for i, (p, n) in enumerate(_prompts())]
    for r in jreqs:
        assert jengine.submit(r)
    jengine.run()
    assert [r.out_tokens for r in port_run] == [r.out_tokens for r in jreqs]


def test_metrics_count_ticks_and_tokens(serving, port_run):
    m = serving[0].metrics
    assert m.tokens_out == sum(r.max_new_tokens for r in port_run)
    assert m.n_finished == len(port_run)
    assert m.ticks >= m.prefill_ticks + m.decode_ticks > 0
    s = m.summary()
    assert s["ttft_s"]["n_samples"] == len(port_run)
    assert 0.0 < s["busy_slot_fraction"] <= 1.0
    assert _pct([], 50) is None and _pct([2.0], 99) == 2.0


def test_admission_control_and_deadlines():
    engine, _ = build_lm_serving(CFG, n_slots=1, chunk=CHUNK, cache_cap=8,
                                 max_queue=1, device="cpu")
    empty = EngineRequest(uid=0, prompt=np.zeros(0, np.int32), max_new_tokens=2)
    long = EngineRequest(uid=1, prompt=np.ones(8, np.int32), max_new_tokens=2)
    assert not engine.submit(empty) and empty.dropped == "empty"
    assert not engine.submit(long) and long.dropped == "too_long"
    a = EngineRequest(uid=2, prompt=np.ones(3, np.int32), max_new_tokens=3)
    b = EngineRequest(uid=3, prompt=np.ones(3, np.int32), max_new_tokens=3,
                      deadline_tick=2)
    c = EngineRequest(uid=4, prompt=np.ones(3, np.int32), max_new_tokens=3)
    assert engine.submit(a)
    engine.step()                        # a takes the only slot
    assert engine.submit(b)
    assert not engine.submit(c) and c.dropped == "queue_full"
    done = engine.run()
    assert [r.uid for r in done] == [2]
    assert b.dropped == "deadline" and not b.done
    assert engine.metrics.n_rejected == 3 and engine.metrics.n_dropped == 1
    engine.sched.check_conservation()


def test_scheduler_is_priority_fifo():
    sched = SlotScheduler(2)
    reqs = [EngineRequest(uid=i, prompt=np.ones(1, np.int32), max_new_tokens=1,
                          priority=p) for i, p in enumerate([0, 1, 0, 1])]
    for r in reqs:
        assert sched.submit(r)
    assert [r.uid for _, r in sched.admit()] == [1, 3]
    sched.finish(0)
    assert [r.uid for _, r in sched.admit()] == [0]
    sched.check_conservation()


@pytest.mark.parametrize("option,value,item", [
    ("quantize", "int8", "item 6"), ("spec_k", 2, "item 7"),
    ("self_heal", True, "item 8"), ("tier_aware", True, "item 8"),
    ("mesh", object(), "item 12"), ("tp", 3, "item 12")])
def test_options_outside_the_slice_name_their_roadmap_item(option, value, item):
    if option in ("quantize", "spec_k"):
        # items 6 and 7 are ported: the option builds its engine
        engine, _ = build_lm_serving(CFG, n_slots=1, chunk=2, cache_cap=8, device="cpu",
                                     **{option: value})
        assert engine.spec_k == (value if option == "spec_k" else 0)
        ops = {n.op for n in engine.stepper.decode_program.graph.nodes}
        assert ("dense_q" in ops) == (option == "quantize")
        return
    if option in ("self_heal", "tier_aware"):
        # item 8 is ported: the option builds its engine and serves
        engine, _ = build_lm_serving(CFG, n_slots=1, chunk=2, cache_cap=8, device="cpu",
                                     **{option: value})
        assert getattr(engine, option) is True
        req = EngineRequest(uid=0, prompt=np.ones(3, np.int32), max_new_tokens=2)
        assert engine.submit(req)
        engine.run()
        assert req.done and len(req.out_tokens) == 2
        return
    # item 12 is ported: the option asks for tensor-parallel ranks, with
    # JAX's errors where the request cannot be met — mesh and tp together,
    # and more ranks than the group has (a single process here; the
    # 2-rank group's case is in test_torch_sharded_serving.py)
    if option == "mesh":
        with pytest.raises(ValueError, match="pass mesh or tp, not both"):
            build_lm_serving(CFG, device="cpu", mesh=value, tp=2)
        return
    with pytest.raises(ValueError, match=f"tp={value} needs 1..1 devices"):
        build_lm_serving(CFG, device="cpu", tp=value)
    build_lm_serving(CFG, n_slots=1, chunk=2, cache_cap=4, device="cpu",
                     **{option: {"quantize": None, "spec_k": 0, "self_heal": False,
                                 "tier_aware": False, "mesh": None, "tp": None}[option]})


def test_unknown_option_is_a_type_error():
    with pytest.raises(TypeError):
        build_lm_serving(CFG, device="cpu", no_such_option=1)
