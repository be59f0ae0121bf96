"""Tensor-parallel serving in the port (``build_lm_serving(tp=2)``) on the
CPU: two gloo ranks spawned by ``repro_torch.launch.mesh.spawn_ranks``,
the counterpart of tests/test_sharded_serving.py.

Three spawns, each running several checks:

* op level: each of the nine ``tp`` attention backends, run on two ranks
  that hold their slice of the cache heads, is bitwise equal to the
  single-rank ``cuda`` backend (on CPU tensors: the kernels' plain
  versions) and within 1e-5 of the JAX package's per-device ``xla`` body
  on the same inputs; ``tree_decode_attention`` (the KV length split over
  the ranks) within 1e-5 of the dense answer, with length-0 rows kept;
  ``ring_allgather_matmul`` within 1e-5 of the whole product; the
  requests the group cannot meet (``tp=3`` on two ranks, ``nccl`` on the
  CPU) raise;
* the engine at JAX's TINY config: TP=2 tokens equal to the single-rank
  port engine's and to JAX's single-device ``build_lm_serving`` tokens —
  dense and the Hk=1 fallback (caches whole on every rank), paged fp32
  and paged int8 cold and on a prefix hit, speculative (``spec_k=2``),
  and ``self_heal`` under JAX's injected faults (the tp2 column of
  tests/test_fault_injection.py) plus the faults only one rank sees: a
  hang past the deadline on one rank's fake clock, and a crash on one
  rank after its call returned — each tick's outcome agreed across the
  ranks, the pool intact;
* ``python -m repro_torch.launch.serve --engine --tp 2`` prints the request
  lines of JAX's single-device ``serve --engine``.

The ranks import this module to find their functions: it imports no JAX at
module level.  Each spawn has a timeout, so a deadlocked rank fails its
test instead of holding the suite.
"""

import concurrent.futures
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

TINY = dict(vocab=61, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64)
SPAWN_TIMEOUT = 120.0
TP = 2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --------------------------------------------------------------------------- #
# op level (spawn 1)
# --------------------------------------------------------------------------- #

ATTN_OPS = ("chunk_attention", "verify_attention", "decode_attention",
            "paged_chunk_attention", "paged_verify_attention", "paged_decode_attention",
            "paged_chunk_attention_q", "paged_decode_attention_q", "paged_verify_attention_q")


def op_inputs(op, seed=0):
    """Seeded numpy inputs of one attention op: B 2, Hq 4, Hk 2, D 8; chunk
    and verify T 4; a dense cache of 12 rows or a pool of 6 pages of 4;
    no length-0 row (there the kernels and JAX's ``ref`` differ by
    design)."""
    rng = np.random.default_rng(seed)
    b, hq, hk, d, t = 2, 4, 2, 8, 4
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    decode = "decode" in op
    q = f32(b, hq, d) if decode else f32(b, t, hq, d)
    pos = np.array([7, 5], np.int32) if decode else np.array([3, 0], np.int32)
    if not op.startswith("paged"):
        return [q, f32(b, 12, hk, d), f32(b, 12, hk, d), pos]
    tables = np.array([[0, 2], [1, 3]], np.int32)
    if not op.endswith("_q"):
        return [q, f32(6, 4, hk, d), f32(6, 4, hk, d), tables, pos]
    pk = rng.integers(-127, 128, size=(6, 4, hk, d)).astype(np.int8)
    pv = rng.integers(-127, 128, size=(6, 4, hk, d)).astype(np.int8)
    ks = rng.uniform(0.01, 0.1, size=(6, hk)).astype(np.float32)
    vs = rng.uniform(0.01, 0.1, size=(6, hk)).astype(np.float32)
    ins = [q, pk, ks, pv, vs, tables, pos]
    if op == "paged_verify_attention_q":
        ins += [f32(b, t, hk, d), f32(b, t, hk, d)]
    return ins


TREE_CASES = [  # (B, Hq, Hk, D, S, lengths): phase 3's engine decode, gemma3 global (cut)
    (4, 4, 4, 16, 64, [45, 25, 9, 0]),
    (4, 4, 1, 32, 64, [60, 33, 32, 0]),
]


def _ops_rank():
    torch.set_num_threads(1)
    from repro_torch.core.registry import get_impl
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.gemm import gemm
    from repro_torch.kernels.serving_ops import _TP_LAYOUT, serving_mesh, tp_slice
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models.graph_lm import GraphLMConfig
    from repro_torch.runtime.engine import build_lm_serving
    from repro_torch.sharding.collectives import ring_allgather_matmul, tree_decode_attention
    mesh = make_serving_mesh(TP, device="cpu")
    out = {"ops": {}, "tree": [], "errors": {}}
    for op in ATTN_OPS:
        full = [torch.from_numpy(x) for x in op_inputs(op)]
        attrs = {"scale": None}
        single = get_impl(op, "cuda")(full, attrs)[0]
        local = list(full)
        for idx, dim in _TP_LAYOUT[op][1]:           # the caches a rank holds
            local[idx] = tp_slice(full[idx], dim, mesh)
        with serving_mesh(mesh):
            got = get_impl(op, "tp")(local, attrs)[0]
        out["ops"][op] = (bool(torch.equal(got, single)), got.numpy())
    rng = np.random.default_rng(3)
    for b, hq, hk, d, s, lens in TREE_CASES:
        q = torch.from_numpy(rng.standard_normal((b, hq, d)).astype(np.float32))
        k = torch.from_numpy(rng.standard_normal((b, s, hk, d)).astype(np.float32))
        v = torch.from_numpy(rng.standard_normal((b, s, hk, d)).astype(np.float32))
        lengths = torch.tensor(lens, dtype=torch.int32)
        part = s // TP
        rows = slice(mesh.rank * part, (mesh.rank + 1) * part)
        got = tree_decode_attention(mesh, q, k[:, rows].contiguous(), v[:, rows].contiguous(),
                                    lengths)
        want = flash_decode(q, k, v, lengths)
        out["tree"].append((float((got - want).abs().max()), got.numpy(), q.numpy(),
                            k.numpy(), v.numpy(), lens))
    x = torch.from_numpy(rng.standard_normal((6, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 5)).astype(np.float32))
    got = ring_allgather_matmul(mesh, x[mesh.rank * 3:(mesh.rank + 1) * 3], w)
    out["ring"] = float((got - gemm(x, w)).abs().max())
    for name, call in (
            ("tp3", lambda: build_lm_serving(GraphLMConfig(**TINY), tp=3, device="cpu")),
            ("nccl", lambda: make_serving_mesh(TP, backend="nccl", device="cpu"))):
        try:
            call()
            out["errors"][name] = None
        except ValueError as e:
            out["errors"][name] = str(e)
    return out


@pytest.fixture(scope="module")
def ops_run(runs):
    return runs["ops"].result()


@pytest.mark.parametrize("op", ATTN_OPS)
def test_tp_backend_bitwise_equal_to_cuda_and_close_to_jax_xla(op, ops_run):
    import repro  # noqa: F401
    from repro.core.registry import get_impl as jget_impl
    from repro.kernels import serving_ops as jso
    for rank in range(TP):
        equal, got = ops_run[rank]["ops"][op]
        assert equal, (op, rank)
        np.testing.assert_array_equal(got, ops_run[0]["ops"][op][1])
    ins = op_inputs(op)
    if op == "decode_attention":     # repro's tp body for it is this private xla lowering
        want = jso._decode_attention_xla_dense(*ins, {"scale": None})
    else:
        want = jget_impl(op, "xla")(ins, {"scale": None})[0]
    np.testing.assert_allclose(ops_run[0]["ops"][op][1], np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_tree_decode_attention_against_the_dense_answer(ops_run):
    """Within 1e-5 of ``flash_decode`` on the whole cache, on both ranks,
    length-0 rows included (both give 0 there).  JAX's dense ``ref`` gives
    the mean of V at length 0 (its partial has l = S on an empty row): the
    rows of nonzero length agree with it, the length-0 row is 0 here."""
    import repro  # noqa: F401
    from repro.kernels.ops import decode_attention
    for rank in range(TP):
        for err, *_ in ops_run[rank]["tree"]:
            assert err <= 1e-5
    for err, got, q, k, v, lens in ops_run[0]["tree"]:
        want = np.asarray(decode_attention(q, k, v, np.asarray(lens, np.int32), backend="ref"))
        live = np.asarray(lens) > 0
        np.testing.assert_allclose(got[live], want[live], rtol=1e-5, atol=1e-5)
        assert not np.any(got[~live]) and np.all(np.isfinite(got))
        np.testing.assert_allclose(want[~live], v[~live].mean(axis=1).repeat(
            q.shape[1] // v.shape[2], axis=1), rtol=1e-5, atol=1e-5)


def test_ring_allgather_matmul_against_the_dense_answer(ops_run):
    assert all(r["ring"] <= 1e-5 for r in ops_run)


def test_group_requests_that_cannot_be_met_raise(ops_run):
    """JAX's ValueError for more ranks than the group holds; nccl refused
    where the ranks share a device (here the CPU)."""
    for r in ops_run:
        assert r["errors"]["tp3"] == "tp=3 needs 1..2 devices"
        assert "nccl needs one card a rank" in r["errors"]["nccl"]


# --------------------------------------------------------------------------- #
# the engine (spawn 2)
# --------------------------------------------------------------------------- #

def reqs(seed, n=5, vocab=61):
    from repro_torch.runtime.engine import EngineRequest
    rng = np.random.default_rng(seed)
    return [EngineRequest(uid=i, prompt=rng.integers(0, vocab, size=int(rng.integers(1, 13)))
                          .astype(np.int32), max_new_tokens=int(rng.integers(1, 7)))
            for i in range(n)]


def prefix_pair(seed):
    """(cold, warm) prompts sharing a 24-token prefix (three 8-row pages)."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, 61, size=24).astype(np.int32)
    return (np.concatenate([prefix, rng.integers(0, 61, size=3).astype(np.int32)]),
            np.concatenate([prefix, rng.integers(0, 61, size=2).astype(np.int32)]))


def heal_prompts():
    rng = np.random.default_rng(42)
    head = rng.integers(0, 61, size=6).astype(np.int32)
    out = []
    for i in range(6):
        tail = rng.integers(0, 61, size=int(rng.integers(2, 9))).astype(np.int32)
        out.append(np.concatenate([head, tail]) if i % 2 else tail)
    return out


PAGED = dict(n_slots=3, chunk=4, cache_cap=48, paged=True, page_size=8)
# name -> (config overrides, build kwargs, request seed, prefix-pair seed)
ENGINES = {
    "dense": ({}, dict(n_slots=3, chunk=4, cache_cap=48), 7, None),
    "gqa_small": (dict(n_layers=1, n_kv_heads=1), dict(n_slots=2, chunk=4, cache_cap=32), 3,
                  None),
    "paged_fp32": ({}, PAGED, 8, 12),
    "paged_int8": ({}, dict(PAGED, kv_dtype="int8"), 21, 13),
    "spec": ({}, dict(n_slots=3, chunk=4, cache_cap=48, spec_k=2), 7, None),
    # kv8 speculation: its commit Program writes the verify's whole fp32
    # rows into head-sharded pages
    "spec_paged_int8": ({}, dict(PAGED, kv_dtype="int8", spec_k=2), 21, None),
}
HEAL = {  # name -> (calls that fail on every rank, a fault only one rank sees)
    "heal_clean": ((), None),
    "heal_both_3_7_11": ((3, 7, 11), None),
    "heal_both_9_13": ((9, 13), None),
    "heal_hang_rank0": ((), ("hang", 0, 5)),
    "heal_crash_after_rank1": ((), ("crash", 1, 6)),
}
HANG_TIMEOUT = 30.0


def drive(engine, rs):
    for r in rs:
        assert engine.submit(r), r.dropped
    engine.run(max_ticks=engine.tick + 4000)
    for r in rs:
        assert r.done and r.dropped is None, (r.uid, r.dropped)
    return [tuple(r.out_tokens) for r in rs]


def serve_engine_case(name, build, tp=None, device="cpu"):
    """Tokens of one ENGINES case: its requests, then (paged) a cold prompt
    and a warm one that hits its prefix; plus what the test checks of the
    engine."""
    from repro_torch.models.graph_lm import GraphLMConfig
    from repro_torch.runtime.engine import EngineRequest
    over, kw, seed, pseed = ENGINES[name]
    engine, _ = build(GraphLMConfig(**dict(TINY, **over)), tp=tp, device=device, **kw)
    toks = drive(engine, reqs(seed, n=3 if name == "gqa_small" else 5))
    facts = {"assignment": engine.stepper.decode_program.assignment,
             "cache_heads": sorted({int(c.shape[2]) for c in engine.stepper.caches.values()
                                    if c.dim() == 4})}
    if pseed is not None:
        cold, warm = prefix_pair(pseed)
        toks += drive(engine, [EngineRequest(uid=100, prompt=cold, max_new_tokens=5)])
        hits0 = engine.stepper.pool.hit_tokens
        toks += drive(engine, [EngineRequest(uid=101, prompt=warm, max_new_tokens=5)])
        facts["hit_tokens"] = engine.stepper.pool.hit_tokens - hits0
        engine.stepper.pool.check_integrity()
    return toks, facts


class _FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def serve_heal_case(name, build, tp=None, rank=0):
    """The tp2 fault column: paged fp32, self_heal, 6 prompts sharing a
    head; faults injected at stepper calls on every rank, or on one rank
    only (a hang on its fake clock, or a crash after its call returned)."""
    from repro_torch.ft import watchdog
    from repro_torch.models.graph_lm import GraphLMConfig
    from repro_torch.runtime.engine import EngineRequest
    both, single = HEAL[name]
    clock = _FakeClock()
    real = watchdog.time.perf_counter
    watchdog.time.perf_counter = clock
    try:
        engine, _ = build(GraphLMConfig(**TINY), tp=tp, device="cpu", self_heal=True,
                          hang_timeout=HANG_TIMEOUT, **dict(PAGED))
        rs = [EngineRequest(uid=i, prompt=p, max_new_tokens=6)
              for i, p in enumerate(heal_prompts())]
        for r in rs:
            assert engine.submit(r)
        calls = [0]
        for phase in ("decode", "prefill"):
            orig = getattr(engine.stepper, phase)

            def wrapped(*args, _orig=orig):
                calls[0] += 1
                if calls[0] in both:
                    raise RuntimeError(f"injected fault at call {calls[0]}")
                out = _orig(*args)
                if single is not None and rank == single[1] and calls[0] == single[2]:
                    if single[0] == "hang":
                        clock.t += HANG_TIMEOUT + 1.0
                    else:
                        raise RuntimeError(f"injected fault on rank {rank} after call")
                return out
            setattr(engine.stepper, phase, wrapped)
        engine.run()
    finally:
        watchdog.time.perf_counter = real
    assert all(r.done and r.dropped is None for r in rs)
    engine.stepper.pool.check_integrity()
    assert engine.stepper.pool.live_sequences == 0
    m = engine.metrics
    return [tuple(r.out_tokens) for r in rs], {
        "recoveries": m.n_recoveries, "hangs": m.n_hang_failures,
        "crashes": m.n_crash_failures, "recovered_rows": m.recovered_rows}


def stream_async(build, tp=None):
    """ENGINES["dense"]'s requests streamed through ``AsyncEngine``."""
    import asyncio
    from repro_torch.models.graph_lm import GraphLMConfig
    from repro_torch.runtime import AsyncEngine
    engine, _ = build(GraphLMConfig(**TINY), tp=tp, device="cpu", **ENGINES["dense"][1])
    aeng = AsyncEngine(engine)

    async def main():
        async def collect(r):
            return tuple([t async for t in aeng.generate(r.prompt, r.max_new_tokens)])
        return await asyncio.gather(*[collect(r) for r in reqs(ENGINES["dense"][2])],
                                    aeng.run())
    return list(asyncio.run(main())[:-1])


def _engine_rank():
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.runtime.engine import build_lm_serving
    mesh = make_serving_mesh(TP, device="cpu")
    out = {name: serve_engine_case(name, build_lm_serving, tp=TP) for name in ENGINES}
    out.update({name: serve_heal_case(name, build_lm_serving, tp=TP, rank=mesh.rank)
                for name in HEAL})
    out["async"] = stream_async(build_lm_serving, tp=TP)
    return out


def _jax_tokens():
    """JAX's single-device engine on the same cases (in the parent)."""
    import repro  # noqa: F401
    from repro.models.graph_lm import GraphLMConfig as JCfg
    from repro.runtime.engine import EngineRequest as JReq
    from repro.runtime.engine import build_lm_serving as jbuild

    out = {}
    for name in ENGINES:
        over, kw, seed, pseed = ENGINES[name]
        engine, _ = jbuild(JCfg(**dict(TINY, **over)), **kw)
        rs = [JReq(uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens)
              for r in reqs(seed, n=3 if name == "gqa_small" else 5)]
        toks = drive(engine, rs)
        if pseed is not None:
            cold, warm = prefix_pair(pseed)
            toks += drive(engine, [JReq(uid=100, prompt=cold, max_new_tokens=5)])
            toks += drive(engine, [JReq(uid=101, prompt=warm, max_new_tokens=5)])
        out[name] = toks
    engine, _ = jbuild(JCfg(**TINY), self_heal=True, **PAGED)
    rs = [JReq(uid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(heal_prompts())]
    out["heal"] = drive(engine, rs)
    return out


SERVE_ARGS = ["--engine", "--requests", "6", "--max-new", "5"]


def _serve_port():
    """``launch.serve --tp 2`` of the port in a process of its own."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *SERVE_ARGS,
                           "--tp", "2", "--device", "cpu"], capture_output=True, text=True,
                          env=env, timeout=SPAWN_TIMEOUT, cwd=ROOT)


def _serve_jax() -> str:
    """JAX's single-device ``serve --engine`` lines, in this process."""
    import contextlib
    import io
    from repro.launch import serve as jserve
    buf, argv = io.StringIO(), sys.argv
    sys.argv = ["serve", *SERVE_ARGS]
    try:
        with contextlib.redirect_stdout(buf):
            jserve.main()
    finally:
        sys.argv = argv
    return buf.getvalue()


@pytest.fixture(scope="module")
def runs():
    """The three spawns, started together; JAX's tokens and lines and the
    single-rank port's tokens are computed here meanwhile."""
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.runtime.engine import build_lm_serving
    pool = concurrent.futures.ThreadPoolExecutor(3)
    out = {"ops": pool.submit(spawn_ranks, _ops_rank, TP, timeout=SPAWN_TIMEOUT),
           "engine": pool.submit(spawn_ranks, _engine_rank, TP, timeout=SPAWN_TIMEOUT),
           "serve": pool.submit(_serve_port)}
    try:
        out["jax"] = _jax_tokens()
        out["jax_serve"] = _serve_jax()
        single = {name: serve_engine_case(name, build_lm_serving) for name in ENGINES}
        single["heal"] = serve_heal_case("heal_clean", build_lm_serving)
        out["single"] = single
        yield out
    finally:
        pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def engine_run(runs):
    """(the ranks' results, JAX's tokens, the single-rank port's tokens)"""
    return runs["engine"].result(), runs["jax"], runs["single"]


@pytest.mark.parametrize("name", list(ENGINES))
def test_tp_engine_token_identical(name, engine_run):
    ranks, jax_toks, single = engine_run
    want, single_facts = single[name]
    assert want == jax_toks[name]
    for rank in range(TP):
        toks, facts = ranks[rank][name]
        assert toks == want, (name, rank)
        tp_nodes = [n for n, b in facts["assignment"].items() if b == "tp"]
        if name == "gqa_small":
            # Hk = 1 does not divide tp = 2: whole caches, replicated attention
            assert not tp_nodes and facts["cache_heads"] == [1]
        else:
            assert tp_nodes, facts["assignment"]
            assert facts["cache_heads"] == [TINY["n_kv_heads"] // TP]
            assert all(b == "cuda" for n, b in facts["assignment"].items()
                       if n.endswith(".attn") and n not in tp_nodes) and \
                len(tp_nodes) == TINY["n_layers"]
        if "hit_tokens" in facts:
            assert facts["hit_tokens"] >= 24, "sharded pages never hit"


def test_tp_async_engine_streams_the_single_rank_tokens(engine_run):
    ranks, _, single = engine_run
    want = single["dense"][0][:len(reqs(ENGINES["dense"][2]))]
    assert all(r["async"] == want for r in ranks)


@pytest.mark.parametrize("name", list(HEAL))
def test_tp_self_heal_token_identical(name, engine_run):
    ranks, jax_toks, single = engine_run
    want = jax_toks["heal"]
    assert single["heal"][0] == want
    both, single_fault = HEAL[name]
    for rank in range(TP):
        toks, m = ranks[rank][name]
        assert toks == want, (name, rank)
        if both:
            assert m["recoveries"] >= 1 and m["crashes"] == m["recoveries"]
        elif single_fault is not None:
            # the rank that saw nothing recovered with its peer
            assert m["recoveries"] == 1, (rank, m)
            kind = "hangs" if single_fault[0] == "hang" else "crashes"
            assert m[kind] == 1, (rank, m)
            assert m["recovered_rows"] > 0
        else:
            assert m["recoveries"] == 0
    assert ranks[0][name][1] == ranks[1][name][1]


# --------------------------------------------------------------------------- #
# launch.serve --tp 2 (spawn 3)
# --------------------------------------------------------------------------- #

def test_launch_serve_tp2_request_lines_equal_jax(runs):
    port = runs["serve"].result()
    assert port.returncode == 0, port.stderr[-3000:]

    def lines(text):
        return [ln for ln in text.splitlines() if ln.startswith("  req")]

    assert lines(port.stdout) == lines(runs["jax_serve"]) and len(lines(port.stdout)) == 3
    head = [ln for ln in port.stdout.splitlines() if ln.startswith("engine:")]
    assert head == ["engine: slots=4 chunk=8 int8=False paged=False kv_dtype=float32 "
                    "requests=6 mesh={'model': 2}"]
    assert port.stdout.count("[mesh] tp=2 rank") == TP     # the ranks' lines may interleave
