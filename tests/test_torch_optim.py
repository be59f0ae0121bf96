"""The port's optimizer, schedules and gradient compression
(``repro_torch.optim``) held against the JAX package's on the CPU.

* AdamW: 20 updates on the same gradients (a nested tree; every fifth step
  large enough to clip) against ``repro.optim.adamw`` with and without a
  schedule.  The leaf sums of ``global_norm`` are library reductions in
  another order than ``jnp.sum``'s, and XLA's ``pow``/``cos`` are not
  PyTorch's, so the parity is a tolerance: params and masters within 2e-6
  relative, elementwise (seen: 5e-7), the moments within 1e-5 of each
  leaf's largest magnitude (a moment near zero after cancellation carries
  the absolute error of its inputs: 5e-5 relative seen there), the grad
  norm within 1e-6 relative; ``step`` int32 and equal.  The mirrors of
  tests/test_substrate.py's TestAdamW, and the master-alias trap: the
  masters of f32 params are copies, and the in-place update gives the
  functional one's bits.
* Schedules at steps 0-120 within 1e-6 relative (seen: 2.2e-7; XLA's cos).
* Compression: ``quantize`` / ``dequantize`` / ``compress_decompress``
  bitwise JAX's (IEEE division, round half to even), the quantisation and
  error-feedback properties of tests/test_property.py as seeded loops
  (hypothesis is not installed here), and ``compressed_psum_mean`` over two
  gloo ranks against JAX's single-device round on each rank's gradients,
  averaged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch  # noqa: F401
from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro.optim import schedule as jschedule
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.optim import adamw, compress, schedule
from repro_torch.optim.adamw import AdamWConfig

SPAWN_TIMEOUT = 120.0


def _tree(rng, scale=1.0):
    f = lambda *s: np.asarray(rng.standard_normal(s) * scale, np.float32)  # noqa: E731
    return {"a": f(7, 5), "b": [f(3), f(2, 4, 6)], "c": {"x": f(11), "y": f()}}


def _t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("with_schedule", [False, True])
def test_adamw_20_steps_match_jax(with_schedule):
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    grads = [_tree(rng, 10.0 if i % 5 == 0 else 0.1) for i in range(20)]
    jcfg = jadamw.AdamWConfig(lr=1e-2, schedule=jschedule.warmup_cosine(1e-2, 5, 20)
                              if with_schedule else None)
    cfg = AdamWConfig(lr=1e-2, schedule=schedule.warmup_cosine(1e-2, 5, 20)
                      if with_schedule else None)
    jp = jax.tree.map(jnp.asarray, p0)
    js = jadamw.init(jp, jcfg)
    p, s = _t(p0), adamw.init(_t(p0), cfg)
    jupdate = jax.jit(lambda g, st, pp: jadamw.update(g, st, pp, jcfg))
    clipped = 0
    for g in grads:
        jp, js, jm = jupdate(jax.tree.map(jnp.asarray, g), js, jp)
        p, s, m = adamw.update(_t(g), s, p, cfg)
        clipped += float(m["grad_norm"]) > cfg.grad_clip
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= 1e-6 * float(jm["grad_norm"])
        assert abs(float(m["lr"]) - float(jm["lr"])) <= 1e-6 * float(jm["lr"])
        for a, b in zip(jax.tree.leaves(jp) + jax.tree.leaves(js["master"]),
                        tree_leaves(p) + tree_leaves(s["master"])):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=2e-6, atol=0)
        for key in ("mu", "nu"):
            for a, b in zip(jax.tree.leaves(js[key]), tree_leaves(s[key])):
                a = np.asarray(a)
                assert np.abs(b.numpy() - a).max() <= 1e-5 * np.abs(a).max(), key
    assert clipped >= 4
    assert s["step"].dtype == torch.int32 and s["step"].shape == () and int(s["step"]) == 20
    assert sorted(s) == sorted(js) == ["master", "mu", "nu", "step"]


# --------------------------------------------------------------------------- #
# tests/test_substrate.py's TestAdamW on the port
# --------------------------------------------------------------------------- #

def test_quadratic_convergence():
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, grad_clip=0.0)
    state = adamw.init(params, cfg)
    for _ in range(300):
        w = params["w"].detach().requires_grad_(True)
        g, = torch.autograd.grad(torch.sum((w - target) ** 2), w)
        params, state, _ = adamw.update({"w": g}, state, params, cfg)
    assert float(torch.sum((params["w"] - target) ** 2)) < 1e-3


def test_grad_clip_bounds_update():
    params = {"w": torch.zeros(4)}
    cfg = AdamWConfig(lr=1.0, grad_clip=1.0, weight_decay=0.0)
    state = adamw.init(params, cfg)
    _, _, m = adamw.update({"w": torch.full((4,), 1e6)}, state, params, cfg)
    assert float(m["grad_norm"]) > 1e5  # reported pre-clip


def test_master_fp32_with_bf16_params():
    params = {"w": torch.ones(8, dtype=torch.bfloat16)}
    cfg = AdamWConfig(lr=1e-4, master_fp32=True)
    state = adamw.init(params, cfg)
    assert state["master"]["w"].dtype == torch.float32
    g = {"w": torch.full((8,), 1e-3, dtype=torch.bfloat16)}
    p2, s2, _ = adamw.update(g, state, params, cfg)
    assert p2["w"].dtype == torch.bfloat16
    # tiny updates accumulate in the master even when bf16 can't see them
    for _ in range(3):
        p2, s2, _ = adamw.update(g, s2, p2, cfg)
    assert not torch.equal(s2["master"]["w"], state["master"]["w"])


def test_schedule():
    f = schedule.warmup_cosine(1.0, 10, 100)
    assert float(f(torch.tensor(5))) == pytest.approx(0.5)
    assert float(f(torch.tensor(10))) == pytest.approx(1.0, abs=0.01)
    assert float(f(torch.tensor(100))) == pytest.approx(0.1, abs=0.01)


@pytest.mark.parametrize("make", [
    lambda m: m.warmup_cosine(1e-3, 20, 100), lambda m: m.warmup_cosine(1.0, 10, 100),
    lambda m: m.warmup_cosine(3e-4, 0, 50, floor=0.0), lambda m: m.constant(3e-4)],
    ids=["lr1e-3", "lr1", "no-warmup", "constant"])
def test_schedules_match_jax_at_steps_0_to_120(make):
    jf, f = make(jschedule), make(schedule)
    for i in range(121):
        want = float(jf(jnp.asarray(i, jnp.int32)))
        got = f(torch.tensor(i, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        assert abs(float(got) - want) <= 1e-6 * abs(want), i


def test_master_never_aliases_the_params_and_inplace_gives_the_same_bits():
    """For f32 params ``p.to(torch.float32)`` is ``p`` itself: a master made
    that way would take the in-place step twice.  The masters are copies,
    and the donated (in-place) update equals the functional one bitwise."""
    rng = np.random.default_rng(1)
    cfg = AdamWConfig(lr=1e-2, schedule=schedule.warmup_cosine(1e-2, 2, 10))
    p_f = _t(_tree(rng))
    p_i = tree_map(torch.clone, p_f)
    s_f, s_i = adamw.init(p_f, cfg), adamw.init(p_i, cfg)
    for p, m in zip(tree_leaves(p_i), tree_leaves(s_i["master"])):
        assert m.data_ptr() != p.data_ptr() and torch.equal(m, p)
    for _ in range(4):
        g = _t(_tree(rng))
        p_f, s_f, _ = adamw.update(g, s_f, p_f, cfg)
        out_p, out_s, _ = adamw.update(g, s_i, p_i, cfg, inplace=True)
        assert out_p is p_i and out_s is s_i
        for a, b in zip(tree_leaves(p_f) + tree_leaves(s_f), tree_leaves(p_i) + tree_leaves(s_i)):
            assert torch.equal(a, b)
        for p, m in zip(tree_leaves(p_f), tree_leaves(s_f["master"])):
            assert m.data_ptr() != p.data_ptr()


# --------------------------------------------------------------------------- #
# gradient compression
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("seed", range(5))
def test_quantize_and_compress_decompress_bitwise_jax(seed):
    rng = np.random.default_rng(seed)
    g = np.asarray(rng.standard_normal(257) * 10 ** rng.uniform(-3, 3), np.float32)
    err = np.asarray(rng.standard_normal(257) * 1e-3, np.float32)
    jq, js = jcompress.quantize(jnp.asarray(g))
    q, s = compress.quantize(torch.from_numpy(g))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(compress.dequantize(q, s).numpy(),
                                  np.asarray(jcompress.dequantize(jq, js)))
    jd, je = jcompress.compress_decompress(jnp.asarray(g), jnp.asarray(err))
    d, e = compress.compress_decompress(torch.from_numpy(g), torch.from_numpy(err))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))


@pytest.mark.parametrize("seed", range(10))
def test_quantize_error_bounded(seed):
    """tests/test_property.py's bound, on seeded draws."""
    rng = np.random.default_rng(100 + seed)
    g = torch.from_numpy(rng.uniform(-1e3, 1e3, int(rng.integers(1, 65))).astype(np.float32))
    q, s = compress.quantize(g)
    assert float((compress.dequantize(q, s) - g).abs().max()) <= float(s) / 2 + 1e-6


@pytest.mark.parametrize("seed", range(10))
def test_error_feedback_drift_bounded(seed):
    """sum of decompressed grads ~= sum of true grads (the EF property of
    tests/test_property.py, on seeded draws)."""
    rng = np.random.default_rng(seed)
    err = torch.zeros(32)
    total_true, total_sent = np.zeros(32, np.float32), np.zeros(32, np.float32)
    scale_max = 0.0
    for _ in range(20):
        g = torch.from_numpy(rng.standard_normal(32).astype(np.float32))
        sent, err = compress.compress_decompress(g, err)
        total_true += g.numpy()
        total_sent += sent.numpy()
        scale_max = max(scale_max, float(g.abs().max()))
    # drift is at most one quantisation step (the residual still carried)
    assert np.abs(total_true - total_sent).max() <= scale_max / 127 * 20 + 1e-4


def _psum_inputs(rank):
    rng = np.random.default_rng(10 + rank)
    return _tree(rng), _tree(rng, 1e-3)


def _psum_rank():
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_serving_mesh
    mesh = make_serving_mesh(2, device="cpu")
    g, e = _psum_inputs(mesh.rank)
    means, errs = compress.compressed_psum_mean(mesh, "model")(_t(g), _t(e))
    return [x.numpy() for x in tree_leaves(means)], [x.numpy() for x in tree_leaves(errs)]


def test_compressed_psum_mean_over_two_gloo_ranks_matches_jax():
    from repro.launch.mesh import make_serving_mesh as jmake_serving_mesh
    from repro_torch.launch.mesh import make_test_mesh, spawn_ranks
    ranks = spawn_ranks(_psum_rank, 2, timeout=SPAWN_TIMEOUT)
    jmesh = jmake_serving_mesh(1)
    want_d, want_e = [], []
    for r in range(2):
        g, e = _psum_inputs(r)
        d, ne = jcompress.compressed_psum_mean(jmesh, "model")(
            jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, e))
        want_d.append([np.asarray(x) for x in jax.tree.leaves(d)])
        want_e.append([np.asarray(x) for x in jax.tree.leaves(ne)])
    for r, (means, errs) in enumerate(ranks):
        for got, a, b in zip(means, want_d[0], want_d[1]):
            np.testing.assert_array_equal(got, (a + b) / np.float32(2))
        for got, want in zip(errs, want_e[r]):
            np.testing.assert_array_equal(got, want)
    # one rank on the axis: no collective, JAX's single-device round itself
    g, e = _psum_inputs(0)
    means, _ = compress.compressed_psum_mean(make_test_mesh(1, 1), "data")(_t(g), _t(e))
    for got, want in zip(tree_leaves(means), want_d[0]):
        np.testing.assert_array_equal(got.numpy(), want)
