"""The port's mesh paths at the published bfloat16 on a ``(data 2, model
2)`` process mesh of four gloo ranks (one spawn, ``spawn_ranks``), held
against the JAX package on the CPU:

* ``tree_decode_attention`` at bf16 over "model" (two ranks a group, each
  holding half of the cache rows) against JAX's formula
  (``repro.sharding.collectives.tree_decode_attention``: each shard's
  Pallas partial in interpret mode, m_glob, alpha and the sums in float32,
  one rounding to bf16), in the narrow layout and MLA's wide one: within
  one bf16 ulp (+ the fp32 parity tolerance, 2e-5).
* ``make_prefill_step`` / ``make_decode_step`` at bf16 on reduced gemma3-1b
  (1 KV head: the length over "model" with ``seq_shard_fallback``) and
  deepseek-v2-lite-16b (MLA's latent ``ckv`` / ``kpe``), set to bfloat16 on
  the kernels' backends (``CUDA_BACKENDS``: their plain versions here), at
  batch 2 with the fallback and without it and at batch 1 (the length over
  "data"), prompts of 16 seeded tokens into a cache of 32, then 4
  teacher-forced decode steps, against JAX's unsharded bf16 ``LM``: each
  part (the prefill logits, the decode logits) within twice JAX's own
  bf16-vs-fp32 gap on the same weights (the repo's bf16 convention).
* Two bf16 ``make_train_step(mesh=...)`` steps of reduced phi3-mini-3.8b
  against the port's one-process bf16 step, held as
  tests/test_torch_bf16_mesh_train.py holds the port against JAX, within
  twice JAX's own bf16-vs-fp32 gap over the same two steps: the ``loss``
  and ``grad_norm`` of the two steps as one part each; each gathered
  master's update (its master less its initial value) by the L2 norm of
  its difference relative to the one-process update, every leaf within
  twice the largest of JAX's own per-leaf gaps (a bar under 1: a leaf, or
  a ZeRO-1 slice of one, left unchanged reads 1 or its share's square root,
  a flipped update 2) and the median leaf within twice JAX's median; the
  gathered moments mu and nu leaf by leaf within twice JAX's own gap on the
  same leaf; the gathered params each their master rounded once to bf16.

The weights are the port's seed-0 init (its tree is JAX's), handed to JAX
and to the ranks as numpy arrays bit for bit.  JAX's side is computed here
while the ranks run; the ranks import this module to find their function:
it imports no JAX at module level.
"""

import concurrent.futures
import os
import pickle
import time

import numpy as np
import pytest
import torch

MESH = ((2, 2), ("data", "model"))
SERVE_ARCHS = ("gemma3-1b", "deepseek-v2-lite-16b")
SERVE_CASES = ((2, True), (2, False), (1, True))     # (batch, seq_shard_fallback)
PROMPT, CAP, DECODE_STEPS = 16, 32, 4
TRAIN_ARCH, TRAIN_STEPS, LR = "phi3-mini-3.8b", 2, 1e-3
# (B, S, Hq, Hk, D, Dv, lengths): gemma3's MQA group; MLA's absorbed layout
TREE_CASES = ((2, 64, 4, 1, 64, 64, (40, 64)), (2, 32, 4, 1, 576, 512, (12, 32)))
SPAWN_TIMEOUT = 120.0
F32_TOL = 2e-5


def _bf16_config(get_reduced, arch):
    return get_reduced(arch).with_overrides(dtype="bfloat16", param_dtype="bfloat16")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array bit for bit (bf16 as ml_dtypes' bfloat16)."""
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _tree_inputs(case):
    """(q, k, v) as float32 arrays holding bf16 values, and the lengths."""
    b, s, hq, hk, d, dv, lens = case
    rng = np.random.default_rng(s + d)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(torch.bfloat16).float().numpy()
               for shape in ((b, hq, d), (b, s, hk, d), (b, s, hk, dv)))
    return q, k, v, np.asarray(lens, np.int32)


def _tokens(vocab):
    rng = np.random.default_rng(7)
    return (rng.integers(0, vocab, (2, PROMPT)).astype(np.int32),
            rng.integers(0, vocab, (DECODE_STEPS, 2)).astype(np.int32))


def _batches(vocab):
    from repro_torch.data import SyntheticLM
    ds = SyntheticLM(vocab=vocab, seq_len=16, batch=4, seed=2)
    return [ds.batch_at(i) for i in range(TRAIN_STEPS)]


def _state_leaves(state):
    """The masters, mu and nu as lists of float32 arrays."""
    from repro_torch.core.tree import tree_leaves
    return {k: [x.numpy() for x in tree_leaves(state[k])] for k in ("master", "mu", "nu")}


def _rel_gaps(got, want, base=None) -> np.ndarray:
    """Each leaf's ``|got - want| / |want|`` by L2, of the steps taken from
    ``base`` where it is given (the update), else of the values."""
    out = []
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        if base is not None:
            g, w = g - base[i], w - base[i]
        out.append(float(np.linalg.norm((g - w).astype(np.float64)))
                   / float(np.linalg.norm(w.astype(np.float64))))
    return np.asarray(out)


def _one_process_steps(model, cfg, params, opt_cfg, batches):
    """The port's one-process bf16 steps: (each step's metrics, the state's
    leaves, the masters at step 0)."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.runtime.train import make_train_step
    step = make_train_step(model, cfg, opt_cfg, donate=False)
    state, metrics = adamw.init(params, opt_cfg), []
    init = [x.numpy() for x in tree_leaves(state["master"])]
    for batch in batches:
        params, state, m = step(params, state, batch)
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    return metrics, _state_leaves(state), init


def _rank(weights_file):
    torch.set_num_threads(1)
    from repro_torch.configs import get_reduced
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.lm import CUDA_BACKENDS, LM, params_from_numpy, strip_derived
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.serve import make_decode_step, make_prefill_step
    from repro_torch.runtime.train import make_train_step, train_state_shardings
    from repro_torch.sharding.collectives import tree_decode_attention
    from repro_torch.sharding.specs import gather_tree, shard_tree
    mesh = make_mesh(*MESH, device="cpu")
    out = {"coords": dict(mesh.coords), "tree": [], "serve": {}}
    i = mesh.coords["model"]
    for case in TREE_CASES:
        q, k, v, lengths = (torch.from_numpy(a) for a in _tree_inputs(case))
        rows = slice(i * k.shape[1] // 2, (i + 1) * k.shape[1] // 2)
        bf = [x.to(torch.bfloat16) for x in (q, k[:, rows].contiguous(), v[:, rows].contiguous())]
        got = tree_decode_attention(mesh, *bf, lengths, axis="model", backend="cuda")
        out["tree"].append((str(got.dtype), got.float().numpy()))

    deadline = time.monotonic() + SPAWN_TIMEOUT
    while not os.path.exists(weights_file):          # the parent is still drawing them
        assert time.monotonic() < deadline, "no weights"
        time.sleep(0.05)
    with open(weights_file, "rb") as f:
        weights = pickle.load(f)
    with torch.no_grad():
        for arch in SERVE_ARCHS:
            cfg = _bf16_config(get_reduced, arch).with_overrides(backends=CUDA_BACKENDS)
            model = LM(cfg)
            params = params_from_numpy(weights[arch], "cpu")
            prompts, steps = (torch.from_numpy(a) for a in _tokens(cfg.vocab))
            for b, fb in SERVE_CASES:
                kw = dict(batch=b, cache_cap=CAP, seq_shard_fallback=fb)
                prefill = make_prefill_step(model, cfg, mesh, seq=PROMPT, **kw)
                decode = make_decode_step(model, cfg, mesh, **kw)
                logits, caches, lengths = prefill(params, {"tokens": prompts[:b]})
                rec = {"dtype": str(logits.dtype), "prefill": logits.float().numpy(),
                       "decode": []}
                for t in range(DECODE_STEPS):
                    logits, caches = decode(params, steps[t, :b], caches, lengths)
                    lengths = lengths + 1
                    rec["decode"].append(logits.float().numpy())
                out["serve"][arch, b, fb] = rec

    cfg = _bf16_config(get_reduced, TRAIN_ARCH)
    model, opt_cfg, batches = LM(cfg), AdamWConfig(lr=LR), _batches(cfg.vocab)
    params = strip_derived(params_from_numpy(weights[TRAIN_ARCH], "cpu"))
    p_spec, o_spec, _ = train_state_shardings(model, cfg, mesh, batches[0], opt_cfg)
    p, s = shard_tree(params, p_spec, mesh), shard_tree(adamw.init(params, opt_cfg), o_spec, mesh)
    step = make_train_step(model, cfg, opt_cfg, mesh=mesh, batch_example=batches[0],
                           donate=False)
    metrics = []
    for batch in batches:
        p, s, m = step(p, s, batch)
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    out["train"] = {
        "metrics": metrics,
        "params": [(str(x.dtype), _to_numpy(x)) for x in tree_leaves(gather_tree(p, p_spec,
                                                                                  mesh))],
        "state": _state_leaves({k: gather_tree(s[k], o_spec[k], mesh)
                                for k in ("master", "mu", "nu")}),
        "state_dtypes": sorted({str(x.dtype) for k in ("master", "mu", "nu")
                                for x in tree_leaves(s[k])})}
    if mesh.rank == 0:
        out["one_process"] = _one_process_steps(model, cfg, params, opt_cfg, batches)
    return out


def _port_weights():
    """The port's seed-0 init of each config at bf16, as numpy trees."""
    from repro_torch.configs import get_reduced
    from repro_torch.core.tree import tree_map
    from repro_torch.models.lm import LM, strip_derived
    out = {}
    for arch in SERVE_ARCHS + (TRAIN_ARCH,):
        model = LM(_bf16_config(get_reduced, arch))
        out[arch] = tree_map(_to_numpy, strip_derived(model.init_params(0, device="cpu")))
    return out


def _jax_tree(case):
    """JAX's tree decode over two shards of the rows, written out as
    repro.sharding.collectives.tree_decode_attention's ``local`` computes
    it (a shard_map needs two devices)."""
    import jax.numpy as jnp
    from repro.kernels.flash_decode import flash_decode_partial
    q, k, v, lengths = _tree_inputs(case)
    q, k, v = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    s_loc = k.shape[1] // 2
    parts = [flash_decode_partial(q, k[:, i * s_loc:(i + 1) * s_loc],
                                  v[:, i * s_loc:(i + 1) * s_loc],
                                  jnp.clip(jnp.asarray(lengths) - i * s_loc, 0, s_loc),
                                  block_kv=16, interpret=True) for i in range(2)]
    m_glob = jnp.maximum(parts[0][1], parts[1][1])
    alpha = [jnp.exp(m - m_glob) for _, m, _ in parts]
    l_glob = sum(l * a for (_, _, l), a in zip(parts, alpha))
    acc_glob = sum(acc.astype(jnp.float32) * a[..., None] for (acc, _, _), a in zip(parts, alpha))
    out = (acc_glob / jnp.maximum(l_glob, 1e-30)[..., None]).astype(q.dtype)
    return np.asarray(out.astype(jnp.float32))


def _jax_serve(arch, weights):
    """JAX's unsharded prefill and teacher-forced decode logits at bf16 and
    at fp32 on the upcast weights, at each batch."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_reduced as jget_reduced
    from repro.models.lm import LM as JLM
    prompts, steps = _tokens(jget_reduced(arch).vocab)
    out = {}
    for dtype in ("bfloat16", "float32"):
        cfg = jget_reduced(arch).with_overrides(dtype=dtype, param_dtype=dtype)
        model = JLM(cfg)
        params = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype)
                              if a.dtype.itemsize == 2 else jnp.asarray(a), weights)
        prefill = jax.jit(lambda p, t: model.prefill(p, {"tokens": t}, cache_cap=CAP))
        decode = jax.jit(model.decode_step)
        for b in sorted({b for b, _ in SERVE_CASES}):
            logits, caches, lengths = prefill(params, jnp.asarray(prompts[:b]))
            rec = {"prefill": np.asarray(logits.astype(jnp.float32)), "decode": []}
            for t in range(DECODE_STEPS):
                logits, caches = decode(params, jnp.asarray(steps[t, :b]), caches, lengths)
                lengths = lengths + 1
                rec["decode"].append(np.asarray(logits.astype(jnp.float32)))
            out[dtype, b] = rec
    return out


def _jax_train_gaps(weights):
    """JAX's own bf16-vs-fp32 gap over TRAIN_STEPS steps: each metric's
    largest over the steps, and each leaf's relative gap of the update of
    the masters and of mu and nu."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_reduced as jget_reduced
    from repro.optim import adamw as jadamw
    from repro.runtime.train import make_train_step as jmake_train_step
    from repro.models.lm import LM as JLM
    opt = jadamw.AdamWConfig(lr=LR)
    runs = {}
    for dtype in ("bfloat16", "float32"):
        cfg = jget_reduced(TRAIN_ARCH).with_overrides(dtype=dtype, param_dtype=dtype)
        params = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), weights)
        state, model = jadamw.init(params, opt), JLM(cfg)
        step, metrics = jmake_train_step(model, cfg, opt, donate=False), []
        for batch in _batches(cfg.vocab):
            params, state, m = step(params, state, {k: jnp.asarray(v) for k, v in batch.items()})
            metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
        runs[dtype] = metrics, {k: [np.asarray(x) for x in jax.tree.leaves(state[k])]
                                for k in ("master", "mu", "nu")}
    (m16, s16), (m32, s32) = runs["bfloat16"], runs["float32"]
    gaps = {k: max(abs(a[k] - b[k]) for a, b in zip(m16, m32)) for k in ("loss", "grad_norm")}
    init = [np.asarray(x, np.float32) for x in jax.tree.leaves(weights)]
    gaps["master"] = _rel_gaps(s32["master"], s16["master"], init)
    gaps.update({k: _rel_gaps(s32[k], s16[k]) for k in ("mu", "nu")})
    return gaps


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results, and JAX's side computed while they run."""
    from repro_torch.launch.mesh import spawn_ranks
    d = tmp_path_factory.mktemp("bf16_mesh")
    weights_file = d / "weights.pkl"
    pool = concurrent.futures.ThreadPoolExecutor(2 + len(SERVE_ARCHS))
    try:
        fut = pool.submit(spawn_ranks, _rank, 4, str(weights_file), timeout=SPAWN_TIMEOUT)
        weights = _port_weights()
        with open(d / "weights.tmp", "wb") as f:
            pickle.dump(weights, f)
        os.replace(d / "weights.tmp", weights_file)
        serve = [pool.submit(_jax_serve, a, weights[a]) for a in SERVE_ARCHS]
        train = pool.submit(_jax_train_gaps, weights[TRAIN_ARCH])
        jax_out = {"tree": [_jax_tree(c) for c in TREE_CASES],
                   "serve": {a: f.result() for a, f in zip(SERVE_ARCHS, serve)},
                   "train": train.result()}
        yield {"ranks": fut.result(), "jax": jax_out}
    finally:
        pool.shutdown(wait=True)


@pytest.mark.parametrize("case", range(len(TREE_CASES)), ids=["narrow", "wide-mla"])
def test_tree_decode_bf16_matches_jax_formula(runs, case):
    want = runs["jax"]["tree"][case]
    for r in runs["ranks"]:
        dtype, got = r["tree"][case]
        assert dtype == "torch.bfloat16" and got.shape == want.shape
        mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), np.float32(2.0 ** -126))
        ulp = np.exp2(np.floor(np.log2(mag)) - 7)
        assert np.all(np.abs(got - want) <= ulp + F32_TOL), float(np.max(np.abs(got - want)))


SERVE_IDS = [f"{a}-b{b}-{'seqshard' if fb else 'replicated'}" for a in SERVE_ARCHS
             for b, fb in SERVE_CASES]


@pytest.mark.parametrize("arch,b,fb", [(a, b, fb) for a in SERVE_ARCHS for b, fb in SERVE_CASES],
                         ids=SERVE_IDS)
def test_mesh_serve_bf16_within_twice_jax_own_gap(runs, arch, b, fb):
    want, ref32 = runs["jax"]["serve"][arch]["bfloat16", b], \
        runs["jax"]["serve"][arch]["float32", b]
    for part in ("prefill", "decode"):
        w, w32 = np.stack(want[part] if part == "decode" else [want[part]]), \
            np.stack(ref32[part] if part == "decode" else [ref32[part]])
        gap = float(np.abs(w - w32).max())
        assert gap > 0.0
        for r in runs["ranks"]:
            got = r["serve"][arch, b, fb]
            assert got["dtype"] == "torch.bfloat16"
            g = np.stack(got[part] if part == "decode" else [got[part]])
            assert g.shape == w.shape
            assert float(np.abs(g - w).max()) <= 2.0 * gap, (part, r["coords"])


def test_mesh_train_bf16_within_twice_jax_own_gap(runs):
    gaps = runs["jax"]["train"]
    one_metrics, one_state, init = runs["ranks"][0]["one_process"]
    own = gaps["master"]
    bar = 2.0 * own.max()
    assert own.min() > 0.0 and bar < 1.0     # an unchanged leaf reads 1, a flipped update 2
    for r in runs["ranks"]:
        tr = r["train"]
        for key in ("loss", "grad_norm"):
            diff = max(abs(a[key] - b[key]) for a, b in zip(tr["metrics"], one_metrics))
            assert 0.0 < gaps[key] and diff <= 2.0 * gaps[key], (key, diff, gaps[key])
        got = _rel_gaps(tr["state"]["master"], one_state["master"], init)
        assert len(got) == len(own) == len(init), r["coords"]
        assert np.all(got <= bar), (r["coords"], np.flatnonzero(got > bar), got.max(), bar)
        assert np.median(got) <= 2.0 * np.median(own), (r["coords"], np.median(got))
        for key in ("mu", "nu"):
            got = _rel_gaps(tr["state"][key], one_state[key])
            assert gaps[key].min() > 0.0 and np.all(got <= 2.0 * gaps[key]), \
                (r["coords"], key, np.flatnonzero(got > 2.0 * gaps[key]))
        assert tr["state_dtypes"] == ["torch.float32"]
        for (dtype, p), master in zip(tr["params"], tr["state"]["master"]):
            assert dtype == "torch.bfloat16"
            assert np.array_equal(_to_numpy(torch.from_numpy(master).to(torch.bfloat16)), p)
