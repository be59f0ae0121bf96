"""Speculative decoding on the port against the JAX package on the CPU:
tests/test_speculative.py's tests but the fault-injection ones (they need
self-heal, ROADMAP item 8) on the port's engines — greedy output with
speculation token-identical to the fp32 dense reference for the dense,
paged fp32 and paged int8 engines, and the kv8 spec engine bitwise equal
to the non-speculative kv8 engine; plus the draft, verify and commit
graphs node for node and name for name against JAX's builders,
``greedy_token``'s ties, the verify ops against JAX's ``ref`` at T = 2-5,
and a spec engine's tokens equal to JAX's."""

import numpy as np
import pytest
import torch

import repro  # noqa: F401
import repro_torch  # noqa: F401
from repro.core.registry import get_impl as jget
from repro.models import graph_lm as jlm
from repro.runtime import engine as jeng
from repro_torch.core.registry import get_impl
from repro_torch.models import graph_lm as tlm
from repro_torch.runtime.engine import EngineRequest, build_lm_serving
from repro_torch.runtime.kv_cache import BlockPool

TINY_ARGS = dict(vocab=61, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64)
TINY = tlm.GraphLMConfig(**TINY_ARGS)
VARIANTS = {"dense": {}, "paged-fp32": {"paged": True, "page_size": 8},
            "paged-int8": {"paged": True, "page_size": 8, "kv_dtype": "int8"},
            "spec": {"spec_k": 3}}


def make_engine(variant, **overrides):
    """tests/conftest.py's make_engine on the port (CPU)."""
    kw = {"n_slots": 3, "chunk": 4, "cache_cap": 48, **VARIANTS[variant], **overrides}
    return build_lm_serving(TINY, device="cpu", **kw)


def _reqs(seed, n=7, plo=1, phi=13, mlo=1, mhi=7, cls=EngineRequest):
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=rng.integers(0, TINY.vocab, size=int(rng.integers(plo, phi)))
                .astype(np.int32), max_new_tokens=int(rng.integers(mlo, mhi)))
            for i in range(n)]


def _exact(engine, ref, reqs):
    for r in reqs:
        assert engine.submit(r), r.dropped
    engine.run(max_ticks=engine.tick + 4000)
    for r in reqs:
        assert r.done and r.dropped is None, (r.uid, r.dropped)
        want = ref.generate(r.prompt, r.max_new_tokens)
        assert r.out_tokens == want, (r.uid, r.out_tokens, want)
    engine.sched.check_conservation()
    if engine.paged:
        engine.stepper.pool.check_integrity()


def _prefix_pair(seed):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, TINY.vocab, size=24).astype(np.int32)
    cold = EngineRequest(uid=100, prompt=np.concatenate(
        [prefix, rng.integers(0, TINY.vocab, size=3).astype(np.int32)]), max_new_tokens=5)
    warm = EngineRequest(uid=101, prompt=np.concatenate(
        [prefix, rng.integers(0, TINY.vocab, size=2).astype(np.int32)]), max_new_tokens=5)
    return cold, warm


# --------------------------------------------------------------------------- #
# token-exactness against the unbatched reference (all three engine flavours)
# --------------------------------------------------------------------------- #

def test_spec_dense_token_exact():
    engine, ref = make_engine("spec")
    assert engine.spec_k == 3
    _exact(engine, ref, _reqs(21))
    m = engine.metrics
    assert m.spec_ticks > 0 and m.spec_ticks == m.decode_ticks
    assert 0 <= m.spec_accepted <= m.spec_proposed


def test_spec_paged_fp32_token_exact_cold_and_prefix_hit():
    engine, ref = make_engine("paged-fp32", spec_k=3)
    _exact(engine, ref, _reqs(21))
    assert engine.stepper.pool.stats()["live_blocks"] == 0
    cold, warm = _prefix_pair(22)
    _exact(engine, ref, [cold])
    hits0 = engine.stepper.pool.hit_tokens
    _exact(engine, ref, [warm])
    assert engine.stepper.pool.hit_tokens - hits0 >= 24


def test_spec_kv8_token_exact_cold():
    engine, ref = make_engine("paged-int8", spec_k=3)
    _exact(engine, ref, _reqs(21))
    assert engine.stepper.pool.stats()["live_blocks"] == 0


def test_spec_kv8_prefix_hit_exact():
    engine, ref = make_engine("paged-int8", spec_k=3)
    cold, warm = _prefix_pair(22)
    _exact(engine, ref, [cold])
    hits0 = engine.stepper.pool.hit_tokens
    _exact(engine, ref, [warm])
    assert engine.stepper.pool.hit_tokens - hits0 >= 24


def test_spec_composes_with_int8_weight_programs():
    """quantize="int8" (weights) + kv_dtype="int8" (pages) + speculation,
    against the int8-Program dense reference."""
    engine, ref = make_engine("paged-int8", n_slots=2, cache_cap=32, quantize="int8", spec_k=2)
    _exact(engine, ref, _reqs(24, n=4, phi=11, mhi=5))


def test_spec_dense_composes_with_int8_weights():
    engine, ref = make_engine("spec", quantize="int8")
    summary = engine.stepper.backend_summary()
    assert set(summary) == {"prefill", "decode", "verify", "draft"}
    for phase in summary:
        assert set(summary[phase]["dense_q"]) == {"ref"} and "dense" not in summary[phase]
    _exact(engine, ref, _reqs(24, n=4, phi=11, mhi=5))


@pytest.mark.parametrize("seed", [0, 24])
def test_spec_kv8_bitwise_matches_nonspec_engine(seed):
    """The unrolled verify and the replayed commit reproduce plain decode's
    quantize-on-write history exactly, so the speculative kv8 engine's
    output equals the non-speculative kv8 engine's on any seed."""
    def run(spec_k):
        engine, _ = make_engine("paged-int8", spec_k=spec_k)
        reqs = _reqs(seed, n=6, mlo=1, mhi=9)
        for r in reqs:
            assert engine.submit(r)
        engine.run(max_ticks=engine.tick + 4000)
        assert all(r.done and r.dropped is None for r in reqs)
        engine.stepper.pool.check_integrity()
        return {r.uid: list(r.out_tokens) for r in reqs}

    assert run(spec_k=3) == run(spec_k=0)


def test_spec_kv8_commit_replay_is_idempotent():
    """Replaying the last commit against the pages it produced changes no
    bit: identical rows quantize to identical bytes and never raise a page
    scale."""
    engine, _ = make_engine("paged-int8", spec_k=3)
    st = engine.stepper
    calls = []
    commit = st.commit_spec

    def spy(start, n_acc):
        calls.append((start.copy(), n_acc.copy(), list(st._pending_kv)))
        commit(start, n_acc)

    st.commit_spec = spy
    reqs = _reqs(3, n=3, mlo=6, mhi=9)
    for r in reqs:
        assert engine.submit(r)
    while not calls:
        engine.step()
    before = {k: v.clone() for k, v in st.caches.items()}
    start, n_acc, kv = calls[-1]
    st._pending_kv = kv
    commit(start, n_acc)
    for k, v in st.caches.items():
        assert torch.equal(v, before[k]), k


# --------------------------------------------------------------------------- #
# acceptance metrics and config validation
# --------------------------------------------------------------------------- #

def test_full_model_draft_accepts_everything():
    engine, ref = make_engine("spec", n_slots=2, draft_layers=TINY.n_layers)
    reqs = [EngineRequest(uid=i, prompt=np.asarray([3 + i, 5, 7], np.int32),
                          max_new_tokens=12) for i in range(2)]
    _exact(engine, ref, reqs)
    m = engine.metrics
    assert m.spec_proposed > 0
    assert m.spec_accepted == m.spec_proposed and m.accept_rate == 1.0
    assert m.spec_ticks <= 8
    spec = m.summary()["spec"]
    assert spec["accept_rate"] == 1.0 and spec["proposed"] == m.spec_proposed
    assert spec["decode_tokens"] == 22


def test_spec_metrics_zero_when_disabled():
    engine, ref = make_engine("dense", n_slots=2, cache_cap=32)
    _exact(engine, ref, _reqs(5, n=3, phi=8, mhi=4))
    m = engine.metrics
    assert m.spec_ticks == 0 and m.spec_proposed == 0 and m.accept_rate == 0.0
    assert m.decode_tokens > 0 and m.decode_wall_s > 0


def test_draft_layers_validation():
    for dl in (TINY.n_layers + 1, 0):
        with pytest.raises(ValueError, match="draft_layers"):
            make_engine("dense", n_slots=2, cache_cap=32, spec_k=2, draft_layers=dl)


# --------------------------------------------------------------------------- #
# BlockPool.truncate — the reject path's bookkeeping
# --------------------------------------------------------------------------- #

def test_truncate_drops_tail_blocks_and_recredits_reservation():
    pool = BlockPool(8, 4)
    sid, reused = pool.admit([1, 2, 3], max_new_tokens=9)
    assert reused == 0
    pool.append(sid, [1, 2, 3])
    pool.append(sid, [10, 11, 12, 13, 14, 15, 16])
    assert len(pool.block_table(sid)) == 3
    reserved0 = pool.sequence(sid).reserved
    pool.truncate(sid, 5)
    seq = pool.sequence(sid)
    assert seq.n_tokens == 5 and seq.tokens == [1, 2, 3, 10, 11]
    assert len(pool.block_table(sid)) == 2
    assert seq.reserved == reserved0 + 1
    pool.check_integrity()
    pool.append(sid, [20, 21, 22, 23, 24])
    assert pool.sequence(sid).n_tokens == 10
    pool.check_integrity()
    pool.release(sid)
    assert pool.stats()["live_blocks"] == 0


def test_truncate_deindexes_speculatively_registered_pages():
    pool = BlockPool(8, 4)
    sid, _ = pool.admit([1, 2, 3, 4], max_new_tokens=6)
    pool.append(sid, [1, 2, 3, 4])
    pool.append(sid, [5, 6, 7, 8])
    idx0 = pool.stats()["indexed_full_pages"]
    assert idx0 >= 1
    pool.truncate(sid, 5)
    assert pool.stats()["indexed_full_pages"] == idx0 - 1
    pool.check_integrity()
    sid2, reused = pool.admit([1, 2, 3, 4, 5, 6, 7, 8], max_new_tokens=2)
    assert reused <= 4
    pool.release(sid2, register=False)
    pool.release(sid, register=False)
    pool.check_integrity()


def test_truncate_bounds_checked():
    pool = BlockPool(4, 4)
    sid, _ = pool.admit([1, 2], max_new_tokens=2)
    pool.append(sid, [1, 2])
    with pytest.raises(ValueError):
        pool.truncate(sid, 3)
    pool.truncate(sid, 2)
    assert pool.sequence(sid).n_tokens == 2
    pool.check_integrity()


# --------------------------------------------------------------------------- #
# the graphs against JAX's builders
# --------------------------------------------------------------------------- #

def _graphs(pkg, kind):
    cfg = pkg.GraphLMConfig(**TINY_ARGS)
    p = jlm.init_lm_params(jlm.GraphLMConfig(**TINY_ARGS), 0)
    paged = dict(n_blocks=12, page_size=8, max_pages=6)
    return {
        "verify": lambda: pkg.build_verify_graph(cfg, p, batch=3, width=4, cache_cap=48),
        "paged_verify": lambda: pkg.build_paged_verify_graph(cfg, p, batch=3, width=4,
                                                             **paged),
        "paged_verify_kv8": lambda: pkg.build_paged_verify_graph(cfg, p, batch=3, width=4,
                                                                 kv_dtype="int8", **paged),
        "paged_verify_seq": lambda: pkg.build_paged_verify_seq_graph(cfg, p, batch=3, width=4,
                                                                     **paged),
        "spec_commit": lambda: pkg.build_spec_commit_graph(cfg, batch=3, width=4, **paged),
        "draft": lambda: pkg.build_draft_graph(replace_layers(pkg, 1), p, batch=3,
                                               cache_cap=52, spec_k=3),
    }[kind]()


def replace_layers(pkg, n):
    return pkg.GraphLMConfig(**{**TINY_ARGS, "n_layers": n})


@pytest.mark.parametrize("kind", ["verify", "paged_verify", "paged_verify_kv8",
                                  "paged_verify_seq", "spec_commit", "draft"])
def test_spec_graphs_equal_jax_node_for_node(kind):
    """Node names, ops, inputs, outputs and attrs, graph inputs and outputs
    and param names: value names must match, since one calibration
    drives every variant."""
    gt, gj = _graphs(tlm, kind), _graphs(jlm, kind)
    assert gt.name == gj.name and gt.outputs == gj.outputs
    assert {k: (tuple(v.shape), v.dtype) for k, v in gt.inputs.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in gj.inputs.items()}
    assert [(n.name, n.op, n.inputs, n.outputs, n.attrs) for n in gt.nodes] == \
        [(n.name, n.op, n.inputs, n.outputs, n.attrs) for n in gj.nodes]
    assert sorted(gt.params) == sorted(gj.params)
    if "spec.one" in gj.params:
        assert np.array_equal(gt.params["spec.one"], gj.params["spec.one"])


@pytest.mark.parametrize("kind", ["verify", "draft", "paged_verify_seq"])
def test_spec_graphs_compile_as_jax_compiles_them(kind):
    """After either package's default simplify pipeline the graphs are
    still node for node the same."""
    from repro.core.program import compile as jcompile
    from repro_torch.core.program import compile as tcompile
    pt, pj = tcompile(_graphs(tlm, kind), device="cpu"), jcompile(_graphs(jlm, kind))
    assert [(n.name, n.op, n.inputs) for n in pt.graph.nodes] == \
        [(n.name, n.op, n.inputs) for n in pj.graph.nodes]
    assert sorted(pt.graph.params) == sorted(pj.graph.params)


def test_expand_spec_ranges_matches_jax():
    ranges = {"l0.h1": (-1.0, 2.0), "x0": (0.0, 3.0)}
    assert tlm.expand_spec_ranges(ranges, 2) == jlm.expand_spec_ranges(ranges, 2)
    assert tlm.expand_spec_ranges(ranges, 2)["l0.h1.s2"] == (-1.0, 2.0)


def test_spec_graph_builders_validate_like_jax():
    for fn in (lambda pkg: pkg.build_draft_graph(pkg.GraphLMConfig(**TINY_ARGS), {},
                                                 batch=1, cache_cap=8, spec_k=0),
               lambda pkg: pkg.build_draft_graph(pkg.GraphLMConfig(**TINY_ARGS), {},
                                                 batch=1, cache_cap=3, spec_k=3),
               lambda pkg: pkg.build_paged_verify_seq_graph(
                   pkg.GraphLMConfig(**TINY_ARGS), {}, batch=1, width=0, n_blocks=2,
                   page_size=4, max_pages=2)):
        with pytest.raises(ValueError):
            fn(jlm)
        with pytest.raises(ValueError):
            fn(tlm)


# --------------------------------------------------------------------------- #
# the speculative ops
# --------------------------------------------------------------------------- #

def test_greedy_token_ties_break_to_the_lowest_id():
    logits = np.zeros((4, 9), np.float32)
    logits[0, [2, 5]] = 3.0              # a two-way tie
    logits[1, :] = -1.0                  # all equal
    logits[2, [8, 0]] = 7.0              # tie across the ends
    logits[3, 4] = 1.0
    (t,) = get_impl("greedy_token", "ref")([torch.from_numpy(logits)], {})
    assert t.dtype == torch.int32 and t.shape == (4, 1)
    assert t[:, 0].tolist() == [2, 0, 0, 4] == np.argmax(logits, axis=-1).tolist()
    (tj,) = jget("greedy_token", "ref")([logits], {})
    assert np.asarray(tj)[:, 0].tolist() == t[:, 0].tolist()


def _verify_inputs(op, t, seed):
    """Inputs of one verify op at T = t: starts reaching into the last
    page and past it (rows dropped from the patch), ragged tables."""
    rng = np.random.default_rng(seed)
    b, hq, hk, d, n, p, mp = 3, 4, 2, 8, 16, 4, 5

    def rn(*s):
        return rng.standard_normal(s).astype(np.float32)

    start = np.asarray([0, 9, mp * p - t + 1], np.int32)
    q = rn(b, t, hq, d)
    if op == "verify_attention":
        return [q, rn(b, mp * p, hk, d), rn(b, mp * p, hk, d), start]
    tables = rng.permutation(n)[:b * mp].reshape(b, mp).astype(np.int32)
    if op == "paged_verify_attention":
        return [q, rn(n, p, hk, d), rn(n, p, hk, d), tables, start]
    pk = rng.integers(-127, 128, (n, p, hk, d)).astype(np.int8)
    pv = rng.integers(-127, 128, (n, p, hk, d)).astype(np.int8)
    ks, vs = (np.abs(rn(n, hk)) * 0.02 for _ in range(2))
    return [q, pk, ks, pv, vs, tables, start, rn(b, t, hk, d), rn(b, t, hk, d)]


@pytest.mark.parametrize("t", [2, 3, 4, 5])
@pytest.mark.parametrize("op", ["verify_attention", "paged_verify_attention",
                                "paged_verify_attention_q"])
def test_verify_ops_match_jax_ref(op, t):
    """The port's ``ref`` and ``cuda`` backends (the kernel's plain version
    on CPU tensors) against JAX's ``ref`` at T = spec_k + 1 = 2-5, within
    1e-5 (fp32, another summation order); ``ref`` and ``cuda`` are the
    chunk ops' own backends bit for bit."""
    inputs = _verify_inputs(op, t, seed=t)
    for scale in (None, 0.0):
        attrs = {"scale": scale}
        (want,) = jget(op, "ref")(inputs, attrs)
        want = np.asarray(want)
        t_in = [torch.from_numpy(a) for a in inputs]
        for backend in ("ref", "cuda"):
            (got,) = get_impl(op, backend)(t_in, attrs)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{backend} scale={scale}")
    base = {"verify_attention": "chunk_attention",
            "paged_verify_attention": "paged_chunk_attention"}.get(op)
    if base is not None:
        for backend in ("ref", "cuda"):
            (a,) = get_impl(op, backend)(t_in, {})
            (b,) = get_impl(base, backend)(t_in, {})
            assert torch.equal(a, b)


def test_paged_verify_q_never_reads_its_rows_from_the_pages():
    """Two-source: the call's own rows come from k_new/v_new, so pages
    holding garbage at those rows give the same output."""
    inputs = _verify_inputs("paged_verify_attention_q", 4, seed=11)
    q, pk, ks, pv, vs, tables, start = inputs[:7]
    (a,) = get_impl("paged_verify_attention_q", "ref")([torch.from_numpy(x) for x in inputs],
                                                       {})
    pk2, pv2 = pk.copy(), pv.copy()
    p = pk.shape[1]
    for b in range(q.shape[0]):
        for i in range(4):
            pos = int(start[b]) + i
            if pos < tables.shape[1] * p:
                blk = tables[b, pos // p]
                pk2[blk, pos % p] = 127
                pv2[blk, pos % p] = -127
    changed = list(inputs)
    changed[1], changed[3] = pk2, pv2
    (b_,) = get_impl("paged_verify_attention_q", "ref")([torch.from_numpy(x) for x in changed],
                                                        {})
    assert torch.equal(a, b_)


def test_verify_ops_cuda_supports_any_t():
    """The cuda guards are the chunk kernels' (no T % block_q rule): every
    T from 1 to 9 is supported at phi3-mini's heads."""
    from repro_torch.core.ir import TensorSpec as S
    from repro_torch.core.registry import backends_for
    for t in range(1, 10):
        q = S((4, t, 32, 96))
        assert "cuda" in backends_for("verify_attention",
                                      [q, S((4, 1024, 32, 96)), S((4, 1024, 32, 96)),
                                       S((4,), "int32")], {})
        pk, sc = S((64, 16, 32, 96), "int8"), S((64, 32))
        new = S((4, t, 32, 96))
        assert "cuda" in backends_for("paged_verify_attention_q",
                                      [q, pk, sc, pk, sc, S((4, 16), "int32"),
                                       S((4,), "int32"), new, new], {})


# --------------------------------------------------------------------------- #
# against the JAX package's engine
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("variant", ["spec", "paged-fp32", "paged-int8"])
def test_spec_engine_tokens_equal_jax(variant):
    kw = {"n_slots": 3, "chunk": 4, "cache_cap": 48, **VARIANTS[variant]}
    kw.setdefault("spec_k", 3)
    et, _ = build_lm_serving(TINY, device="cpu", **kw)
    ej, _ = jeng.build_lm_serving(jlm.GraphLMConfig(**TINY_ARGS), **kw)
    out = []
    for engine, cls in ((et, EngineRequest), (ej, jeng.EngineRequest)):
        reqs = _reqs(21, cls=cls)
        for r in reqs:
            assert engine.submit(r)
        engine.run(max_ticks=engine.tick + 4000)
        m = engine.metrics
        out.append(([list(r.out_tokens) for r in reqs],
                    (m.spec_ticks, m.spec_proposed, m.spec_accepted)))
    assert out[0] == out[1]


# --------------------------------------------------------------------------- #
# int8 weights: the verify is the decode step unrolled (a port addition)
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("variant", ["dense", "paged-fp32"])
@pytest.mark.parametrize("seed", [0, 24])
def test_spec_int8_weights_bitwise_matches_nonspec_engine(variant, seed):
    """With int8 weights every verify stage is plain decode, so the
    speculative engine's tokens equal the non-speculative int8-weight
    engine's on any seed (the chunk-shaped verify rounds activations near a
    quantization step the other way; at phi3-mini width that flipped a
    token on the card)."""
    def run(spec_k):
        engine, _ = make_engine(variant, quantize="int8", spec_k=spec_k)
        if spec_k:
            ops = {n.op for n in engine.stepper.verify_program.graph.nodes}
            assert "verify_attention" not in ops and "paged_verify_attention" not in ops
        reqs = _reqs(seed, n=6, mlo=1, mhi=9)
        for r in reqs:
            assert engine.submit(r)
        engine.run(max_ticks=engine.tick + 4000)
        assert all(r.done and r.dropped is None for r in reqs)
        if engine.paged:
            engine.stepper.pool.check_integrity()
        return {r.uid: list(r.out_tokens) for r in reqs}

    assert run(spec_k=3) == run(spec_k=0)


def test_int8_weight_verify_stages_are_plain_decode_bitwise():
    engine, _ = make_engine("spec", quantize="int8")
    st = engine.stepper
    b, w = st.n_slots, st.spec_k + 1
    prompt = np.arange(3, 9, dtype=np.int32)
    toks = np.zeros((b, st.chunk), np.int32)
    toks[0, :4] = prompt[:4]
    st.prefill(toks, np.zeros(b, np.int32), np.asarray([4, 0, 0], np.int32))
    toks[0, :2] = prompt[4:]
    logits = st.prefill(toks, np.asarray([4, 0, 0], np.int32), np.asarray([2, 0, 0], np.int32))
    fed, dec = [int(np.argmax(logits[0, 1]))], []
    for i in range(w):
        t = np.zeros((b, 1), np.int32)
        t[0, 0] = fed[-1]
        lg = st.decode(t, np.asarray([6 + i, 0, 0], np.int32), np.asarray([1, 0, 0], np.int32))
        dec.append(lg[0])
        fed.append(int(np.argmax(lg[0])))
    vt = np.zeros((b, w), np.int32)
    vt[0] = fed[:w]
    ver = st.verify(vt, np.asarray([6, 0, 0], np.int32), np.asarray([w, 0, 0], np.int32))
    for i in range(w):
        assert ver[0, i].tobytes() == dec[i].tobytes(), i


def test_verify_seq_graph_layouts():
    cfg = replace_layers(tlm, 2)
    p = tlm.init_lm_params(cfg, 0)
    dense = tlm.build_verify_seq_graph(cfg, p, batch=2, width=3, cache_cap=16)
    paged = tlm.build_verify_seq_graph(cfg, p, batch=2, width=3, paged=(6, 4, 4))
    for g in (dense, paged):
        assert g.outputs == ["logits.s0", "logits.s1", "logits.s2", "new_cache_k0",
                             "new_cache_v0", "new_cache_k1", "new_cache_v1"]
        assert {n.op for n in g.nodes} >= {"embedding", "dense", "rmsnorm", "swiglu"}
    assert "block_tables" in paged.inputs and "block_tables" not in dense.inputs
    assert sum(n.op == "decode_attention" for n in dense.nodes) == 6
    assert sum(n.op == "paged_decode_attention" for n in paged.nodes) == 6
    with pytest.raises(ValueError):
        tlm.build_verify_seq_graph(cfg, p, batch=2, width=3)
    with pytest.raises(ValueError):
        tlm.build_verify_seq_graph(cfg, p, batch=2, width=0, cache_cap=16)
