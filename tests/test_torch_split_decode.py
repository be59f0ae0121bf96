"""Split-KV decode in the port held against the JAX package on the CPU:
the partial kernel's plain version (what ``flash_decode_partial`` runs on
CPU tensors) against JAX's ``flash_decode_partial`` in interpret mode,
``combine_partials_ref``, the ``decode_attention`` ``cuda_split`` backend
against JAX's ``pallas_split`` (interpret) and ``ref``, the re-derived
``supports`` guard with its differences from JAX's, and the engine served
under a policy that picks the split.  Tolerance 2e-5: fp32 on both sides,
summed in another order."""

import numpy as np
import pytest
import torch

import repro  # noqa: F401  (registers repro's ops)
import repro_torch  # noqa: F401  (registers the port's ops)
from repro.core.ir import TensorSpec as JSpec
from repro.core.registry import backends_for as jbackends_for
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_decode import flash_decode_partial as jpartial
from repro_torch.core.ir import Node, TensorSpec
from repro_torch.core.registry import backends_for
from repro_torch.core.selector import FixedPolicy
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_decode import flash_decode_partial

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(b, s, hq, hk, d, dv=None, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, d)).astype(np.float32),
            rng.standard_normal((b, s, hk, d)).astype(np.float32),
            rng.standard_normal((b, s, hk, dv or d)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("hq,hk,d,dv", [(1, 1, 8, 8), (2, 1, 16, 16), (4, 2, 8, 12),
                                        (8, 1, 32, 16)])
def test_partial_matches_jax_interpret(hq, hk, d, dv):
    q, k, v = _qkv(3, 40, hq, hk, d, dv, seed=hq + d)
    lengths = np.asarray([0, 17, 40], np.int32)
    ja, jm, jl = (np.asarray(x) for x in jpartial(q, k, v, lengths, block_kv=8,
                                                   interpret=True))
    acc, m, l = flash_decode_partial(*_t(q, k, v, lengths))
    assert acc.shape == (1, 3, hq, dv) and m.shape == l.shape == (1, 3, hq)
    np.testing.assert_allclose(acc[0].numpy(), ja, **TOL)
    np.testing.assert_allclose(m[0].numpy(), jm, **TOL)
    np.testing.assert_allclose(l[0].numpy(), jl, **TOL)
    # length 0: the Pallas kernel's finite -1e30 and nothing accumulated
    assert float(m[0, 0].max()) == float(np.float32(-1e30)) and float(l[0, 0].abs().max()) == 0.0
    assert float(acc[0, 0].abs().max()) == 0.0


@pytest.mark.parametrize("n_splits", [2, 4, 8])
def test_each_shard_is_jaxs_partial_of_that_shard(n_splits):
    """One call over n_splits shards equals JAX's backend loop: a
    flash_decode_partial per shard of its rows, lengths clipped to it."""
    b, s, hq, hk, d = 4, 32, 4, 2, 8
    q, k, v = _qkv(b, s, hq, hk, d, seed=n_splits)
    lengths = np.asarray([0, 5, s // n_splits, s], np.int32)
    acc, m, l = flash_decode_partial(*_t(q, k, v, lengths), n_splits=n_splits)
    part = s // n_splits
    for i in range(n_splits):
        len_i = np.clip(lengths - i * part, 0, part).astype(np.int32)
        ja, jm, jl = (np.asarray(x) for x in jpartial(
            q, k[:, i * part:(i + 1) * part], v[:, i * part:(i + 1) * part], len_i,
            block_kv=min(8, part), interpret=True))
        np.testing.assert_allclose(acc[i].numpy(), ja, **TOL)
        np.testing.assert_allclose(m[i].numpy(), jm, **TOL)
        np.testing.assert_allclose(l[i].numpy(), jl, **TOL)


def test_combine_partials_matches_jax():
    rng = np.random.default_rng(5)
    n, b, h, dv = 4, 3, 2, 6
    outs = rng.standard_normal((n, b, h, dv)).astype(np.float32)
    ms = rng.standard_normal((n, b, h)).astype(np.float32)
    ls = (np.abs(rng.standard_normal((n, b, h))) + 0.1).astype(np.float32)
    # empty shards: one per row of b=1, all of b=2
    for i in (0, 2):
        outs[i, 1], ms[i, 1], ls[i, 1] = 0.0, -1e30, 0.0
    outs[:, 2], ms[:, 2], ls[:, 2] = 0.0, -1e30, 0.0
    want = np.asarray(jref.combine_partials_ref(outs, ms, ls))
    got = tref.combine_partials_ref(*_t(outs, ms, ls)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(got[2] == 0.0) and np.isfinite(got).all()


@pytest.mark.parametrize("hq,hk", [(2, 1), (4, 2)])
@pytest.mark.parametrize("n_splits", [2, 4])
def test_cuda_split_matches_jax_split_and_ref(hq, hk, n_splits):
    """test_decode_split_parity's inputs: lengths straddling the shard
    edges, one shard fully empty."""
    b, s, d = 3, 32, 8
    q, k, v = _qkv(b, s, hq, hk, d, seed=11)
    lengths = np.asarray([3, s // n_splits, s], np.int32)
    jsplit = np.asarray(jops.decode_attention(q, k, v, lengths, backend="pallas_split",
                                              n_splits=n_splits, interpret=True))
    jref_out = np.asarray(jops.decode_attention(q, k, v, lengths, backend="ref"))
    got = tops.decode_attention(*_t(q, k, v, lengths), backend="cuda_split",
                                n_splits=n_splits).numpy()
    np.testing.assert_allclose(got, jsplit, **TOL)
    np.testing.assert_allclose(got, jref_out, **TOL)


def test_cuda_split_lengths_none_and_scale():
    q, k, v = _qkv(2, 16, 4, 2, 8, seed=3)
    for scale in (None, 0.0, 0.3):
        want = np.asarray(jops.decode_attention(q, k, v, None, backend="pallas_split",
                                                scale=scale, interpret=True))
        got = tops.decode_attention(*_t(q, k, v), None, backend="cuda_split",
                                    scale=scale).numpy()
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("backend", ["cuda", "ref"])
def test_decode_attention_partial_matches_jax(backend):
    q, k, v = _qkv(3, 24, 4, 2, 8, seed=4)
    lengths = np.asarray([1, 13, 24], np.int32)
    jb = "pallas" if backend == "cuda" else "ref"
    want = [np.asarray(x) for x in jops.decode_attention_partial(
        q, k, v, lengths, backend=jb, block_kv=8, interpret=True)]
    got = tops.decode_attention_partial(*_t(q, k, v, lengths), backend=backend)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, **TOL)


@pytest.mark.parametrize("backend", ["cuda", "ref"])
def test_decode_attention_partial_empty_row(backend):
    """An empty row gives acc 0, m -1e30, l 0 (JAX's dense ``ref`` partial
    gives l = S there); combined with a shard that holds valid rows, both
    give JAX's attention."""
    q, k, v = _qkv(2, 16, 4, 2, 8, seed=5)
    lengths = np.asarray([0, 9], np.int32)
    acc, m, l = tops.decode_attention_partial(*_t(q, k, v, lengths), backend=backend)
    assert torch.all(acc[0] == 0) and torch.all(m[0] == -1e30) and torch.all(l[0] == 0)
    halves = [tops.decode_attention_partial(*_t(q, k[:, i * 8:(i + 1) * 8],
                                                v[:, i * 8:(i + 1) * 8],
                                                np.asarray([8, 8 if i == 0 else 0], np.int32)),
                                            backend=backend) for i in range(2)]
    got = tref.combine_partials_ref(*(torch.stack(t) for t in zip(*halves)))
    want = np.asarray(jops.decode_attention(q, k, v, np.asarray([16, 8], np.int32),
                                            backend="ref"))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _dec_specs(s, hq=2, hk=1, d=8, dtype="float32", ts=TensorSpec, dv=None):
    return [ts((1, hq, d), dtype), ts((1, s, hk, d), dtype), ts((1, s, hk, dv or d), dtype),
            ts((1,), "int32")]


@pytest.mark.parametrize("s,n_splits,attrs,port,jax", [
    (32, 2, {}, True, True),
    (32, 4, {}, True, True),
    (32, 3, {}, False, False),      # both: S % n_splits
    (32, 1, {}, False, False),      # both: n_splits >= 2
    (8, 2, {}, True, False),        # JAX: shards of < 8 rows (TPU sublanes)
    (12, 4, {}, True, False),       # JAX: 3-row shards
    (1200, 2, {}, True, False),     # JAX: 600 % block_kv 512 != 0 (BlockSpec)
    (128, 2, {"block_kv": 32}, True, True),
    (80, 2, {"block_kv": 32}, True, False),   # JAX: 40 % 32 != 0; port ignores block_kv
])
def test_split_supports_guard_and_its_differences_from_jax(s, n_splits, attrs, port, jax):
    attrs = {**attrs, "n_splits": n_splits}
    assert ("cuda_split" in backends_for("decode_attention", _dec_specs(s), attrs)) == port
    assert ("pallas_split" in jbackends_for("decode_attention",
                                            _dec_specs(s, ts=JSpec), attrs)) == jax


def test_split_supports_what_only_the_port_rejects():
    """The port's partial kernel takes fp32 with D <= 640 and Dv <= 512
    (the dense kernel's wide layout) within the shared memory, and bf16 in
    both layouts (its bf16 entry, as the cuda backend's: MLA's D 576 / Dv
    512 since the wide one takes bf16 rows; Dv past 512 in neither).  JAX's
    split guard reads only S and n_splits."""
    assert "cuda_split" not in backends_for("decode_attention", _dec_specs(32, d=640), {})
    for specs in (_dec_specs(32, dtype="bfloat16"),
                  _dec_specs(32, d=576, dtype="bfloat16", dv=512)):
        assert "cuda_split" in backends_for("decode_attention", specs, {})
    assert "cuda" not in backends_for("decode_attention", _dec_specs(32, d=640), {})
    assert "cuda" not in backends_for("decode_attention", _dec_specs(32, d=576, dtype="bfloat16"),
                                      {})
    assert "cuda" in backends_for("decode_attention", _dec_specs(32, dtype="bfloat16"), {})
    assert "cuda" in backends_for("decode_attention",
                                  _dec_specs(32, hq=16, d=576, dtype="bfloat16", dv=512), {})
    assert "pallas_split" in jbackends_for("decode_attention",
                                           _dec_specs(32, d=640, ts=JSpec), {})
    assert "pallas_split" in jbackends_for("decode_attention",
                                           _dec_specs(32, dtype="bfloat16", ts=JSpec), {})


def test_default_policy_never_picks_the_split():
    node = Node("att", "decode_attention", ["q", "k", "v", "l"], ["o"])
    for s in (16, 32, 1024):
        specs = _dec_specs(s)
        assert "cuda_split" in backends_for("decode_attention", specs, {})
        assert FixedPolicy().resolve(node, specs) == "cuda"
        assert FixedPolicy(prefer=("ref",)).resolve(node, specs) == "ref"
    split = FixedPolicy(per_op={"decode_attention": ("cuda_split", "cuda", "ref")})
    assert split.resolve(node, _dec_specs(32)) == "cuda_split"


def test_engine_token_exact_under_the_split_policy():
    from repro_torch.models.graph_lm import GraphLMConfig
    from repro_torch.runtime.engine import EngineRequest, build_lm_serving
    cfg = GraphLMConfig(vocab=41, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=48)
    policy = FixedPolicy(per_op={"decode_attention": ("cuda_split", "cuda", "ref")})
    engine, reference = build_lm_serving(cfg, n_slots=3, chunk=4, cache_cap=32,
                                         policy=policy, device="cpu")
    summary = engine.stepper.backend_summary()
    assert summary["decode"]["decode_attention"] == {"cuda_split": cfg.n_layers}
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (3, 9, 14, 6)]
    reqs = [EngineRequest(uid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
    for r in reqs:
        assert engine.submit(r)
    engine.run(max_ticks=500)
    for r in reqs:
        assert r.done and r.out_tokens == reference.generate(r.prompt, 6, chunk=4)
