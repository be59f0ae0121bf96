"""Sharded serve steps of the port (``repro_torch.runtime.serve``'s
``make_prefill_step`` / ``make_decode_step`` on a ``(data 2, model 2)``
process mesh of four gloo ranks spawned by ``spawn_ranks``) on the CPU —
the counterpart of
tests/test_pipeline_moe.py::TestPipeline::test_seq_shard_decode_matches_replicated,
held to JAX's unsharded ``LM``.

Reduced configs cover every branch of ``cache_specs`` on that mesh:
stablelm-12b (1 KV head: the length over "model" with the fallback, over
"data" at batch 1), gemma3-1b (the same, with rolling window buffers),
qwen2-moe-a2.7b (4 KV heads: the heads over "model"), deepseek-v2-lite-16b
(the MLA latent ``ckv`` / ``kpe`` length) and mamba2-370m (``ssm`` heads,
``conv_x`` channels).  ``qwen2-moe-a2.7b:cf1`` is the MoE config with
global dispatch at a capacity factor of 1: prefill drops tokens, so the
data ranks must pool the capacity over the global batch as JAX's step does.  Weights are JAX's ``init_params(PRNGKey(0))``
through ``params_from_numpy``; prompts of 16 seeded tokens into a cache of
32 at batch 2 and batch 1, then DECODE_STEPS decode steps of seeded tokens,
with ``seq_shard_fallback`` on and off.  Bars (JAX's side computed here
while the ranks run):

* every rank's prefill logits and decode logits within 1e-4 of JAX's
  unsharded ``LM.prefill`` / ``LM.decode_step``;
* each rank's prefill cache slices within 1e-5 of JAX's prefill cache
  sliced by JAX's ``cache_specs`` at the rank's coordinates;
* the sequence-sharded and the replicated steps within 1e-4 of each other.

The ranks import this module to find their function: it imports no JAX at
module level.
"""

import concurrent.futures
import dataclasses
import os
import pickle
import time
import types

import numpy as np
import pytest
import torch

ARCHS = ("stablelm-12b", "gemma3-1b", "qwen2-moe-a2.7b", "qwen2-moe-a2.7b:cf1",
         "deepseek-v2-lite-16b", "mamba2-370m")
MESH = ((2, 2), ("data", "model"))
BATCHES = (2, 1)
PROMPT, CAP, DECODE_STEPS = 16, 32, 4
SPAWN_TIMEOUT = 120.0
TOL = 1e-4


def _config(get_reduced, name):
    """The reduced config of ``name`` (either package's ``get_reduced``); a
    ``:cf<x>`` suffix sets global dispatch at capacity factor x."""
    arch, _, cf = name.partition(":cf")
    cfg = get_reduced(arch)
    if not cf:
        return cfg
    return cfg.with_overrides(moe=dataclasses.replace(cfg.moe, dispatch="global",
                                                      capacity_factor=float(cf)))


def _cases(arch):
    """(batch, seq_shard_fallback) pairs run for ``arch``: all, but only
    batch 2 with the fallback for a ``:cf`` config (its rows are split only
    at batch 2, and its 4 KV heads divide "model" either way)."""
    if ":cf" in arch:
        return [(2, True)]
    return [(b, fb) for b in BATCHES for fb in (True, False)]


def _tokens(vocab):
    rng = np.random.default_rng(7)
    prompts = rng.integers(0, vocab, (2, PROMPT)).astype(np.int32)
    steps = rng.integers(0, vocab, (DECODE_STEPS, 2)).astype(np.int32)
    return prompts, steps


def _rank(weights_file):
    torch.set_num_threads(1)
    from repro_torch.configs import get_reduced
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.lm import LM, params_from_numpy
    from repro_torch.runtime.serve import make_decode_step, make_prefill_step
    mesh = make_mesh(*MESH, device="cpu")
    deadline = time.monotonic() + SPAWN_TIMEOUT
    while not os.path.exists(weights_file):          # the parent is still drawing them
        assert time.monotonic() < deadline, "no weights"
        time.sleep(0.05)
    with open(weights_file, "rb") as f:
        weights = pickle.load(f)
    out = {"coords": dict(mesh.coords), "runs": {}}
    for arch, w in zip(ARCHS, weights):
        cfg = _config(get_reduced, arch)
        model = LM(cfg)
        params = params_from_numpy(w, "cpu")
        prompts, steps = (torch.from_numpy(a) for a in _tokens(cfg.vocab))
        for b, fb in _cases(arch):
            kw = dict(batch=b, cache_cap=CAP, seq_shard_fallback=fb)
            prefill = make_prefill_step(model, cfg, mesh, seq=PROMPT, **kw)
            decode = make_decode_step(model, cfg, mesh, **kw)
            logits, caches, lengths = prefill(params, {"tokens": prompts[:b]})
            rec = {"prefill": logits.numpy(),
                   "cache": [x.numpy() for x in tree_leaves(caches)], "decode": []}
            for t in range(DECODE_STEPS):
                logits, caches = decode(params, steps[t, :b], caches, lengths)
                lengths = lengths + 1
                rec["decode"].append(logits.numpy())
            out["runs"][arch, b, fb] = rec
    return out


def _jax_weights(arch):
    import jax
    from repro.configs import get_reduced as jget_reduced
    from repro.models.lm import LM as JLM
    return jax.tree.map(np.asarray, jax.jit(JLM(_config(jget_reduced, arch)).init_params)(
        jax.random.PRNGKey(0)))


def _jax_serve(arch, weights):
    """JAX's unsharded prefill and decode logits at each batch, its prefill
    caches' leaves and their specs on the mesh with and without the
    fallback."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_reduced as jget_reduced
    from repro.models.lm import LM as JLM
    from repro.sharding.specs import cache_specs
    cfg = _config(jget_reduced, arch)
    model = JLM(cfg)
    params = jax.tree.map(jnp.asarray, weights)
    duck = types.SimpleNamespace(axis_names=MESH[1], shape=dict(zip(MESH[1], MESH[0])))
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    prefill = jax.jit(lambda p, t: model.prefill(p, {"tokens": t}, cache_cap=CAP))
    decode = jax.jit(model.decode_step)
    prompts, steps = _tokens(cfg.vocab)
    out = {}
    for b in sorted({b for b, _ in _cases(arch)}):
        logits, caches, lengths = prefill(params, jnp.asarray(prompts[:b]))
        rec = {"prefill": np.asarray(logits),
               "cache": [np.asarray(x) for x in jax.tree.leaves(caches)],
               "specs": {fb: jax.tree.leaves(cache_specs(caches, cfg, duck, b,
                                                         seq_shard_fallback=fb),
                                             is_leaf=is_spec) for fb in (True, False)},
               "decode": []}
        for t in range(DECODE_STEPS):
            logits, caches = decode(params, jnp.asarray(steps[t, :b]), caches, lengths)
            lengths = lengths + 1
            rec["decode"].append(np.asarray(logits))
        out[b] = rec
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results, and JAX's side computed while they run."""
    from repro_torch.launch.mesh import spawn_ranks
    d = tmp_path_factory.mktemp("serve_mesh")
    weights_file = d / "weights.pkl"
    pool = concurrent.futures.ThreadPoolExecutor(1 + len(ARCHS))
    try:
        fut = pool.submit(spawn_ranks, _rank, 4, str(weights_file), timeout=SPAWN_TIMEOUT)
        weights = list(pool.map(_jax_weights, ARCHS))
        with open(d / "weights.tmp", "wb") as f:
            pickle.dump(weights, f)
        os.replace(d / "weights.tmp", weights_file)
        jax_out = dict(zip(ARCHS, pool.map(_jax_serve, ARCHS, weights)))
        yield {"ranks": fut.result(), "jax": jax_out, "weights": dict(zip(ARCHS, weights))}
    finally:
        pool.shutdown(wait=True)


def _err(a, b):
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max())


CASES = [(a, b, fb) for a in ARCHS for b, fb in _cases(a)]
IDS = [f"{a}-b{b}-{'seqshard' if fb else 'replicated'}" for a, b, fb in CASES]


@pytest.mark.parametrize("arch,b,fb", CASES, ids=IDS)
def test_logits_match_jax(runs, arch, b, fb):
    want = runs["jax"][arch][b]
    for r in runs["ranks"]:
        got = r["runs"][arch, b, fb]
        assert _err(got["prefill"], want["prefill"]) < TOL
        for g, w in zip(got["decode"], want["decode"]):
            assert _err(g, w) < TOL


@pytest.mark.parametrize("arch,b,fb", CASES, ids=IDS)
def test_cache_slices_match_jax(runs, arch, b, fb):
    from repro_torch.launch.mesh import Mesh
    from repro_torch.sharding.specs import shard
    want = runs["jax"][arch][b]
    sharded = 0
    for r in runs["ranks"]:
        mesh = types.SimpleNamespace(block=Mesh(MESH[1], MESH[0]).block, coords=r["coords"])
        got = r["runs"][arch, b, fb]["cache"]
        assert len(got) == len(want["cache"])
        for g, w, spec in zip(got, want["cache"], want["specs"][fb]):
            sl = shard(torch.from_numpy(np.array(w)), spec, mesh).numpy()
            assert _err(g, sl) < 1e-5
            sharded += g.size < w.size
    assert sharded > 0          # every case shards some cache leaf


@pytest.mark.parametrize("arch,b", [(a, b) for a in ARCHS for b in BATCHES
                                    if (a, b, False) in CASES],
                         ids=[f"{a}-b{b}" for a in ARCHS for b in BATCHES
                              if (a, b, False) in CASES])
def test_seq_shard_decode_matches_replicated(runs, arch, b):
    for r in runs["ranks"]:
        seq, rep = r["runs"][arch, b, True], r["runs"][arch, b, False]
        for g, w in zip(seq["decode"], rep["decode"]):
            assert _err(g, w) < TOL


def test_global_dispatch_case_drops_tokens(runs):
    """The ``:cf1`` config's row 1 prefilled alone (the pool that the data
    rank holding it at batch 2 would route without the global batch)
    differs from row 1 of JAX's batch-2 prefill: the capacity binds, so the
    sharded steps above pool it over the global batch to match."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.lm import LM, params_from_numpy
    name = "qwen2-moe-a2.7b:cf1"
    cfg = _config(get_reduced, name)
    prompts, _ = _tokens(cfg.vocab)
    with torch.no_grad():
        alone, _, _ = LM(cfg).prefill(params_from_numpy(runs["weights"][name], "cpu"),
                                      {"tokens": torch.from_numpy(prompts[1:2])},
                                      cache_cap=CAP)
    assert _err(alone.numpy(), runs["jax"][name][2]["prefill"][1:]) > 10 * TOL


def test_unservable_cache_sharding_raises():
    """A cache leaf sharded along a dim no decode layer serves sharded (here
    the head width of k) raises instead of being replicated silently."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.runtime.serve import ServeShard
    from repro_torch.sharding.specs import P
    mesh = make_test_mesh(2, 2)
    shard = ServeShard(types.SimpleNamespace(block=mesh.block, coords={"data": 0, "model": 1}),
                       {"k": P(None, None, None, "model")})
    with pytest.raises(ValueError, match="no decode step serves"):
        shard.split("k", 1)
    ok = ServeShard(types.SimpleNamespace(block=mesh.block, coords={"data": 0, "model": 1}),
                    {"k": P("data", "model", None, None)})
    assert ok.split("k", 1) == (2, 1) and ok.heads("k", 4, 1) is None
