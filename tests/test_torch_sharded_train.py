"""Sharded training in the port (``make_train_step(mesh=...)`` on a
``(data 2, model 2)`` process mesh of four gloo ranks spawned by
``repro_torch.launch.mesh.spawn_ranks``) on the CPU — the counterpart of
tests/test_sharding_multidev.py's train, compression / ring and elastic
checkpoint tests.

One spawn, whose ranks:

* shard JAX's ``init_params(PRNGKey(0))`` weights by
  ``train_state_shardings`` and take one ``make_train_step(mesh=...)`` step
  on JAX's case (SyntheticLM seq 16, batch 4, seed 2,
  ``AdamWConfig(lr=1e-3)``) for reduced stablelm-12b, qwen2-moe-a2.7b with
  ``dispatch="global"`` and a capacity factor of 1 (tokens drop, so the
  capacity positions and the balance loss must come from the global batch)
  and mamba2-370m; the loss and every gathered param leaf must lie within
  1e-4 of JAX's single-device step (JAX's own bar) and of the port's
  single-device step, every rank's shards must be the slices of JAX's
  ``param_specs`` / ``opt_state_specs`` at its coordinates with some
  ``mu`` leaf sharded, and ``donate=True`` must give ``donate=False``'s
  bits in place;
* run ``compressed_psum_mean`` over "data", ``ring_allgather_matmul``,
  ``all_gather_heads`` over "model" and ``all_reduce_axis`` over "data"
  on that mesh;
* save a ``P("data", "model")`` leaf from (2, 2) through ``io.save`` and
  ``CheckpointManager`` and restore it onto (4, 1) and (1, 4) meshes of the
  same ranks: each rank's slice bitwise; JAX's ``io.restore`` reads the
  port's mesh-saved file bit for bit.

JAX's side is computed here while the ranks run.  The ranks import this
module to find their function: it imports no JAX at module level.
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

ARCHS = (("stablelm-12b", None), ("qwen2-moe-a2.7b", 1.0), ("mamba2-370m", None))
MESH = ((2, 2), ("data", "model"))
ELASTIC = ((4, 1), (1, 4))
SPAWN_TIMEOUT = 120.0
TOL = 1e-4


def _cfg(get_reduced, arch, capacity_factor):
    """The reduced config, the MoE one with global dispatch at
    ``capacity_factor`` (either package's ``get_reduced``)."""
    cfg = get_reduced(arch)
    if capacity_factor is None:
        return cfg
    return cfg.with_overrides(moe=dataclasses.replace(cfg.moe, dispatch="global",
                                                      capacity_factor=capacity_factor))


def _batch(vocab):
    from repro_torch.data import SyntheticLM
    return SyntheticLM(vocab=vocab, seq_len=16, batch=4, seed=2).batch_at(0)


def _collective_inputs():
    rng = np.random.default_rng(1)
    grads = {"a": rng.standard_normal((8, 16)).astype(np.float32),
             "b": rng.standard_normal((4,)).astype(np.float32)}
    x = rng.standard_normal((16, 8)).astype(np.float32)
    w = rng.standard_normal((8, 12)).astype(np.float32)
    return grads, x, w


def _elastic_leaf():
    return np.random.default_rng(2).standard_normal((8, 16)).astype(np.float32)


def _rank(weights_file, ckpt_dir):
    torch.set_num_threads(1)
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint import io
    from repro_torch.configs import get_reduced
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.lm import LM, params_from_numpy, strip_derived
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.compress import compressed_psum_mean
    from repro_torch.runtime.train import make_train_step, train_state_shardings
    from repro_torch.sharding.collectives import (all_gather_heads, all_reduce_axis,
                                                  ring_allgather_matmul)
    from repro_torch.sharding.specs import P, gather_tree, shard, shard_tree
    mesh = make_mesh(*MESH, device="cpu")
    out = {"coords": dict(mesh.coords), "train": {}}
    deadline = time.monotonic() + SPAWN_TIMEOUT
    while not os.path.exists(weights_file):          # the parent is still drawing them
        assert time.monotonic() < deadline, "no weights"
        time.sleep(0.05)
    with open(weights_file, "rb") as f:
        weights = pickle.load(f)
    for (arch, cf), w in zip(ARCHS, weights):
        cfg = _cfg(get_reduced, arch, cf)
        model, opt_cfg, batch = LM(cfg), AdamWConfig(lr=1e-3), _batch(cfg.vocab)
        params = strip_derived(params_from_numpy(w, "cpu"))
        p_spec, o_spec, _ = train_state_shardings(model, cfg, mesh, batch, opt_cfg)
        p = shard_tree(params, p_spec, mesh)
        s = shard_tree(adamw.init(params, opt_cfg), o_spec, mesh)
        p2, s2, m = make_train_step(model, cfg, opt_cfg, mesh=mesh, batch_example=batch,
                                    donate=False)(p, s, batch)
        rec = {"metrics": {k: float(v) for k, v in m.items()},
               "params": [x.numpy() for x in tree_leaves(gather_tree(p2, p_spec, mesh))],
               "param_shapes": [tuple(x.shape) for x in tree_leaves(p)],
               "mu_shapes": [tuple(x.shape) for x in tree_leaves(s["mu"])]}
        if arch == "stablelm-12b":
            p3, s3, _ = make_train_step(model, cfg, opt_cfg, mesh=mesh, batch_example=batch,
                                        donate=True)(p, s, batch)
            pairs = list(zip(tree_leaves(p2) + tree_leaves(s2), tree_leaves(p3) + tree_leaves(s3)))
            rec["donated_in_place"] = p3 is p and s3 is s
            rec["donate_bitwise"] = all(torch.equal(a, b) for a, b in pairs)
        out["train"][arch] = rec

    grads, x, w = _collective_inputs()
    t = tree_map(torch.from_numpy, grads)
    mean, _ = compressed_psum_mean(mesh, axis="data")(t, tree_map(torch.zeros_like, t))
    rows = slice(8 * mesh.coords["model"], 8 * mesh.coords["model"] + 8)
    code = torch.full((2,), float(mesh.rank))
    out["collectives"] = {
        "mean": {k: v.numpy() for k, v in mean.items()},
        "ring": ring_allgather_matmul(mesh, torch.from_numpy(x[rows]), torch.from_numpy(w),
                                      axis="model").numpy(),
        "heads": all_gather_heads(code[None], mesh, 0).numpy(),
        "reduce": all_reduce_axis(code, mesh, "data").numpy()}

    spec = {"w": P("data", "model")}
    state = {"w": shard(torch.from_numpy(_elastic_leaf()), spec["w"], mesh)}
    io.save(f"{ckpt_dir}/io", 1, state, specs=spec, mesh=mesh)
    CheckpointManager(f"{ckpt_dir}/manager").save(1, state, specs=spec, mesh=mesh)
    target = {"w": torch.empty((8, 16), device="meta")}
    out["elastic"] = {}
    for shape in ELASTIC:
        mesh2 = make_mesh(shape, MESH[1], device="cpu")
        got = [io.restore(f"{ckpt_dir}/{d}", target, device="cpu", specs=spec,
                          mesh=mesh2)["w"].numpy() for d in ("io", "manager")]
        out["elastic"][shape] = (dict(mesh2.coords), got)
    return out


def _jax_weights(case):
    """JAX's ``init_params(PRNGKey(0))`` of a case (jitted: the weights are
    the input of both sides, whatever their last bits)."""
    import jax
    from repro.configs import get_reduced as jget_reduced
    from repro.models.lm import LM as JLM
    return jax.tree.map(np.asarray, jax.jit(JLM(_cfg(jget_reduced, *case)).init_params)(
        jax.random.PRNGKey(0)))


def _jax_step(case, weights):
    """JAX's single-device step of a case, and its specs."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_reduced as jget_reduced
    from repro.models.lm import LM as JLM
    from repro.optim import adamw as jadamw
    from repro.runtime.train import make_train_step as jmake_train_step
    from repro.sharding.specs import opt_state_specs, param_specs
    duck = types.SimpleNamespace(axis_names=MESH[1], shape=dict(zip(MESH[1], MESH[0])))
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    jcfg = _cfg(jget_reduced, *case)
    jmodel, jopt = JLM(jcfg), jadamw.AdamWConfig(lr=1e-3)
    jp = jax.tree.map(jnp.asarray, weights)
    batch = {k: jnp.asarray(v) for k, v in _batch(jcfg.vocab).items()}
    p1, _, m1 = jmake_train_step(jmodel, jcfg, jopt, donate=False)(
        jp, jadamw.init(jp, jopt), batch)
    pspec = param_specs(jp, jcfg, duck)
    return {"params": [np.asarray(x) for x in jax.tree.leaves(p1)],
            "metrics": {k: float(v) for k, v in m1.items()},
            "shapes": [tuple(x.shape) for x in jax.tree.leaves(jp)],
            "pspec": jax.tree.leaves(pspec, is_leaf=is_spec),
            "mspec": jax.tree.leaves(opt_state_specs(jp, pspec, duck), is_leaf=is_spec)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results, and JAX's and the single-device port's steps
    (computed while the ranks run)."""
    from repro_torch.launch.mesh import spawn_ranks
    ckpt = tmp_path_factory.mktemp("mesh_ckpt")
    # the weights go through a file, written while the ranks start (a large
    # argument would hold each rank's start until the one before it has
    # imported its modules)
    weights_file = ckpt / "weights.pkl"
    pool = concurrent.futures.ThreadPoolExecutor(1 + len(ARCHS))   # XLA compiles in parallel
    try:
        fut = pool.submit(spawn_ranks, _rank, 4, str(weights_file), str(ckpt),
                          timeout=SPAWN_TIMEOUT)
        weights = list(pool.map(_jax_weights, ARCHS))
        with open(ckpt / "weights.tmp", "wb") as f:
            pickle.dump(weights, f)
        os.replace(ckpt / "weights.tmp", weights_file)
        jax_cases = list(pool.map(_jax_step, ARCHS, weights))
        single = [_port_single(arch, cf, w) for (arch, cf), w in zip(ARCHS, weights)]
        yield {"ranks": fut.result(), "jax": jax_cases, "single": single, "ckpt": ckpt}
    finally:
        pool.shutdown(wait=True)


def _port_single(arch, cf, weights):
    """The port's single-device step on the same weights and batch."""
    from repro_torch.configs import get_reduced
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models.lm import LM, params_from_numpy, strip_derived
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.train import make_train_step
    cfg = _cfg(get_reduced, arch, cf)
    params = strip_derived(params_from_numpy(weights, "cpu"))
    opt_cfg = AdamWConfig(lr=1e-3)
    p, _, m = make_train_step(LM(cfg), cfg, opt_cfg, donate=False)(
        params, adamw.init(params, opt_cfg), _batch(cfg.vocab))
    return {"params": [x.numpy() for x in tree_leaves(p)],
            "metrics": {k: float(v) for k, v in m.items()}}


def _slice_shape(shape, spec, mesh_shape):
    """The shape of one rank's slice of ``shape`` under a JAX spec."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            out[dim] //= mesh_shape[a]
    return tuple(out)


@pytest.mark.parametrize("case", range(len(ARCHS)), ids=[a for a, _ in ARCHS])
def test_mesh_step_matches_jax_single_device(case, runs):
    want = runs["jax"][case]
    for rank in runs["ranks"]:
        got = rank["train"][ARCHS[case][0]]
        assert abs(got["metrics"]["loss"] - want["metrics"]["loss"]) < TOL
        assert sorted(got["metrics"]) == sorted(want["metrics"])
        err = max(float(np.abs(a - b).max()) for a, b in zip(got["params"], want["params"]))
        assert err < TOL, (ARCHS[case], err)


@pytest.mark.parametrize("case", range(len(ARCHS)), ids=[a for a, _ in ARCHS])
def test_mesh_step_equals_port_single_device(case, runs):
    want = runs["single"][case]
    for rank in runs["ranks"]:
        got = rank["train"][ARCHS[case][0]]
        for k, v in want["metrics"].items():
            assert abs(got["metrics"][k] - v) <= 1e-5 * max(abs(v), 1.0), k
        err = max(float(np.abs(a - b).max()) for a, b in zip(got["params"], want["params"]))
        assert err < TOL, (ARCHS[case], err)


def test_moe_case_drops_tokens():
    """The capacity factor of 1 drops tokens on one device: the global
    positions decide which."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.lm import LM, strip_derived
    losses = []
    for cf in (1.0, 8.0):
        cfg = _cfg(get_reduced, "qwen2-moe-a2.7b", cf)
        model = LM(cfg)
        params = strip_derived(model.init_params(0, device="cpu"))
        batch = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab).items()}
        with torch.no_grad():
            losses.append(float(model.train_loss(params, batch)[1]["ce"]))
    assert losses[0] != losses[1]


def test_shards_are_jax_spec_slices_with_zero1_moments(runs):
    mesh_shape = dict(zip(MESH[1], MESH[0]))
    sharded_mu = 0
    for case, (arch, _) in zip(runs["jax"], ARCHS):
        for rank in runs["ranks"]:
            got = rank["train"][arch]
            assert got["param_shapes"] == [_slice_shape(s, sp, mesh_shape) for s, sp in
                                           zip(case["shapes"], case["pspec"])]
            assert got["mu_shapes"] == [_slice_shape(s, sp, mesh_shape) for s, sp in
                                        zip(case["shapes"], case["mspec"])]
            sharded_mu += sum(m != s for m, s in zip(got["mu_shapes"], got["param_shapes"]))
    assert sharded_mu, "no moment leaf is sharded over 'data'"


def test_donated_mesh_step_is_bitwise_in_place(runs):
    for rank in runs["ranks"]:
        got = rank["train"]["stablelm-12b"]
        assert got["donated_in_place"] and got["donate_bitwise"]


def test_collectives_over_an_axis_of_the_2d_mesh(runs):
    from repro_torch.optim.compress import compress_decompress
    grads, x, w = _collective_inputs()
    for rank in runs["ranks"]:
        got = rank["collectives"]
        c = rank["coords"]
        for k, g in grads.items():
            deq, _ = compress_decompress(torch.from_numpy(g), torch.zeros(g.shape))
            np.testing.assert_array_equal(got["mean"][k], deq.numpy())
            assert float(np.abs(got["mean"][k] - g).max() / np.abs(g).max()) < 0.02
        np.testing.assert_allclose(got["ring"], x @ w, rtol=0, atol=1e-4)
        same_data = [r for r in range(4) if r // 2 == c["data"]]      # row-major ranks
        same_model = [r for r in range(4) if r % 2 == c["model"]]
        np.testing.assert_array_equal(got["heads"][:, 0], np.array(same_data, np.float32))
        np.testing.assert_array_equal(got["reduce"], np.full(2, sum(same_model), np.float32))


def test_elastic_checkpoint_across_meshes(runs):
    import jax
    import jax.numpy as jnp
    from repro.checkpoint import io as jio
    w = _elastic_leaf()
    for rank in runs["ranks"]:
        for shape in ELASTIC:
            coords, got = rank["elastic"][shape]
            rows, cols = 8 // shape[0], 16 // shape[1]
            want = w[coords["data"] * rows:(coords["data"] + 1) * rows,
                     coords["model"] * cols:(coords["model"] + 1) * cols]
            for g in got:
                np.testing.assert_array_equal(g, want)
    for d in ("io", "manager"):
        r = jio.restore(str(runs["ckpt"] / d), {"w": jax.ShapeDtypeStruct((8, 16), jnp.float32)})
        np.testing.assert_array_equal(np.asarray(r["w"]), w)


def test_layout_mesh_raises():
    from repro_torch.configs import get_reduced
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.lm import LM
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.train import make_train_step
    cfg = get_reduced("stablelm-12b")
    with pytest.raises(ValueError, match="no process group"):
        make_train_step(LM(cfg), cfg, AdamWConfig(), mesh=make_test_mesh(2, 2),
                        batch_example=_batch(cfg.vocab))
