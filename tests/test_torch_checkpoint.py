"""The port's checkpoints and data pipeline (``repro_torch.checkpoint``,
``repro_torch.data``) held against the JAX package's on the CPU.

tests/test_substrate.py's TestCheckpoint and TestData on the port; a
checkpoint written by either package restored by the other bit for bit
(the keys, dtypes and values of every array, the int32 ``step``
included); a bfloat16 leaf written as JAX writes it (raw ``V2`` bytes) and
refused on restore by both; the SIGTERM hook; ``SyntheticLM``,
``pack_documents`` and ``PrefetchLoader`` bitwise JAX's.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch  # noqa: F401
from repro.checkpoint import io as jio
from repro.data import PrefetchLoader as JPrefetchLoader
from repro.data import SyntheticLM as JSyntheticLM
from repro.data import pack_documents as jpack_documents
from repro.models.lm import LM as JLM
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.configs import get_reduced
from repro_torch.core.tree import leaves_with_paths, tree_leaves, tree_map
from repro_torch.data import PrefetchLoader, SyntheticLM, pack_documents
from repro_torch.models.lm import LM, params_from_numpy, strip_derived
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.train import make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((4, 8), generator=g),
                       "stack": [torch.ones((2, 3)), torch.zeros((5,))]},
            "step": torch.tensor(7, dtype=torch.int32)}


def _meta(tree):
    return tree_map(lambda t: torch.empty_like(t, device="meta"), tree)


# --------------------------------------------------------------------------- #
# tests/test_substrate.py's TestCheckpoint on the port
# --------------------------------------------------------------------------- #

def test_roundtrip(tmp_path):
    state = _state()
    ckpt_io.save(str(tmp_path), 7, state)
    restored = ckpt_io.restore(str(tmp_path), state)
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        assert torch.equal(a, b) and a.dtype == b.dtype and a.shape == b.shape


def test_atomicity_tmp_dir_ignored(tmp_path):
    ckpt_io.save(str(tmp_path), 1, _state())
    os.makedirs(tmp_path / "step_00000002.tmp")     # a crash mid-save of step 2
    assert ckpt_io.list_steps(str(tmp_path)) == [1]


def test_manager_rotation_and_resume(tmp_path):
    mgr = CheckpointManager(str(tmp_path), interval=2, keep=2, async_save=False)
    state = _state()
    for step in range(1, 9):
        mgr.maybe_save(step, state, {"loss": 1.0 / step})
    assert mgr.latest_step() == 8
    assert len(ckpt_io.list_steps(str(tmp_path))) == 2  # rotated
    assert ckpt_io.restore_metadata(str(tmp_path))["step"] == 8


def test_async_save_copies_on_the_caller(tmp_path):
    """The device-to-host copy happens in ``save``: the state may be updated
    in place at once, while the file is written off-thread."""
    mgr = CheckpointManager(str(tmp_path), interval=1, async_save=True)
    state = _state()
    want = tree_map(torch.clone, state)
    mgr.save(3, state)
    for t in tree_leaves(state):
        t.add_(1)
    mgr.wait()
    assert mgr.latest_step() == 3
    for a, b in zip(tree_leaves(want), tree_leaves(mgr.restore(_meta(want), device="cpu"))):
        assert torch.equal(a, b)


def test_restore_onto_a_device_from_a_meta_target(tmp_path):
    """The elastic path of the port: a target of ``meta`` tensors (shapes
    and dtypes, no memory) restored onto the device asked for."""
    state = _state()
    ckpt_io.save(str(tmp_path), 1, state)
    restored = ckpt_io.restore(str(tmp_path), _meta(state), device="cpu")
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        assert b.device == torch.device("cpu") and torch.equal(a, b)


def test_shape_mismatch_and_missing_keys_rejected(tmp_path):
    ckpt_io.save(str(tmp_path), 1, {"w": torch.ones((4,))})
    with pytest.raises(ValueError):
        ckpt_io.restore(str(tmp_path), {"w": torch.empty((5,), device="meta")}, device="cpu")
    with pytest.raises(KeyError):
        ckpt_io.restore(str(tmp_path), {"v": torch.empty((4,))})
    with pytest.raises(FileNotFoundError):
        ckpt_io.restore(str(tmp_path / "none"), {"w": torch.empty((4,))})


def test_train_resume_bitexact(tmp_path):
    """Crash/restart: the resumed run repeats the uninterrupted one bit for
    bit (JAX's test allows 1e-6; the port's step is deterministic)."""
    cfg = get_reduced("minitron-4b")
    model = LM(cfg)
    opt_cfg = AdamWConfig(lr=1e-3)
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=16, batch=4, seed=1)
    step_fn = make_train_step(model, cfg, opt_cfg, donate=False)

    def run(n_steps, params, state, start=0):
        for i in range(start, n_steps):
            params, state, _ = step_fn(params, state, ds.batch_at(i))
        return params, state

    p0 = strip_derived(model.init_params(0, device="cpu"))
    s0 = adamw.init(p0, opt_cfg)
    p_full, _ = run(6, p0, s0)
    p_half, s_half = run(3, p0, s0)
    ckpt_io.save(str(tmp_path), 3, {"params": p_half, "opt": s_half})
    rest = ckpt_io.restore(str(tmp_path), _meta({"params": p_half, "opt": s_half}), device="cpu")
    p_res, _ = run(6, rest["params"], rest["opt"], start=3)
    for a, b in zip(tree_leaves(p_full), tree_leaves(p_res)):
        assert torch.equal(a, b)


def test_save_on_signal_checkpoints_and_exits_143(tmp_path):
    code = f"""
import os, signal, sys, torch
sys.path.insert(0, {os.path.join(ROOT, 'src')!r})
from repro_torch.checkpoint import CheckpointManager
mgr = CheckpointManager({str(tmp_path)!r})
state = {{"w": torch.arange(6.0)}}
mgr.save_on_signal(lambda: (5, state))
os.kill(os.getpid(), signal.SIGTERM)
print("not reached")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 143, out.stderr
    assert "not reached" not in out.stdout
    assert ckpt_io.restore_metadata(str(tmp_path)) == {"keys": ["w"], "preempted": True,
                                                        "step": 5}
    assert torch.equal(ckpt_io.restore(str(tmp_path), {"w": torch.empty(6)})["w"],
                       torch.arange(6.0))


# --------------------------------------------------------------------------- #
# across the packages
# --------------------------------------------------------------------------- #

def _train_state():
    """JAX's reduced gemma3-1b params and a fresh AdamW state, and the port's
    trees of the same values."""
    from repro.configs import get_reduced as jget_reduced
    jparams = JLM(jget_reduced("gemma3-1b")).init_params(jax.random.PRNGKey(0))
    jstate = {"params": jparams, "opt": jadamw.init(jparams, jadamw.AdamWConfig())}
    params = strip_derived(params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"))
    state = {"params": params, "opt": adamw.init(params, AdamWConfig())}
    state["opt"]["step"].fill_(11)
    jstate["opt"]["step"] = jnp.asarray(11, jnp.int32)
    return jstate, state


def _npz(path, step):
    with np.load(os.path.join(path, f"step_{step:08d}", "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


def test_checkpoints_cross_the_packages_bit_for_bit(tmp_path):
    jstate, state = _train_state()
    jio.save(str(tmp_path / "jax"), 11, jstate, {"loss": 1.5})
    ckpt_io.save(str(tmp_path / "port"), 11, state, {"loss": 1.5})
    # the same files: keys, dtypes, shapes, values and metadata
    a, b = _npz(tmp_path / "jax", 11), _npz(tmp_path / "port", 11)
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k])
    assert a["opt/step"].dtype == np.int32 and a["opt/step"].shape == ()
    for side in ("jax", "port"):
        with open(tmp_path / side / "step_00000011" / "meta.json") as f:
            meta = json.load(f)
        assert meta == {"keys": sorted(a), "loss": 1.5, "step": 11}
    # JAX's checkpoint into the port: bit for bit, on the target's dtypes
    got = ckpt_io.restore(str(tmp_path / "jax"), _meta(state), device="cpu")
    for (path, x), y in zip(leaves_with_paths(state), tree_leaves(got)):
        assert x.dtype == y.dtype and torch.equal(x, y), path
    assert got["opt"]["step"].dtype == torch.int32 and int(got["opt"]["step"]) == 11
    # the port's into JAX
    target = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), jstate)
    jgot = jio.restore(str(tmp_path / "port"), target)
    for x, y in zip(jax.tree.leaves(jstate), jax.tree.leaves(jgot)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert jgot["opt"]["step"].dtype == jnp.int32


def test_bf16_leaves_are_written_as_jax_writes_them_and_refused_alike(tmp_path):
    """JAX's ``io.save`` writes a bfloat16 leaf as raw ``V2`` values and its
    ``restore`` cannot cast them back (``ValueError: No cast function
    available``).  The port writes the same bytes and refuses the same
    way, on either package's file: shared behaviour, not a port format."""
    vals = np.arange(6, dtype=np.float32) / 3
    jio.save(str(tmp_path / "jax"), 1, {"w": jnp.asarray(vals, jnp.bfloat16)})
    ckpt_io.save(str(tmp_path / "port"), 1, {"w": torch.from_numpy(vals).to(torch.bfloat16)})
    a, b = _npz(tmp_path / "jax", 1)["w"], _npz(tmp_path / "port", 1)["w"]
    assert a.dtype.kind == b.dtype.kind == "V" and a.dtype.itemsize == b.dtype.itemsize == 2
    assert a.tobytes() == b.tobytes()
    for side in ("jax", "port"):
        with pytest.raises(ValueError, match="No cast function"):
            jio.restore(str(tmp_path / side),
                        {"w": jax.ShapeDtypeStruct((6,), jnp.bfloat16)})
        with pytest.raises(ValueError, match="No cast function"):
            ckpt_io.restore(str(tmp_path / side), {"w": torch.empty(6, dtype=torch.bfloat16)})


# --------------------------------------------------------------------------- #
# data: tests/test_substrate.py's TestData, and bitwise JAX's
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("kw", [dict(vocab=101, seq_len=8, batch=2, seed=5),
                                dict(vocab=262144, seq_len=64, batch=4, seed=0),
                                dict(vocab=97, seq_len=16, batch=8, seed=3, n_docs=3)])
def test_synthetic_batches_are_jax_bit_for_bit(kw):
    ds, jds = SyntheticLM(**kw), JSyntheticLM(**kw)
    for step in (0, 1, 17, 1000):
        for shard, n in ((0, 1), (1, 2)):
            got = ds.batch_at(step, shard=shard, num_shards=n)
            want = jds.batch_at(step, shard=shard, num_shards=n)
            assert sorted(got) == sorted(want) == ["labels", "tokens"]
            for k in got:
                assert got[k].dtype == want[k].dtype == np.int32
                np.testing.assert_array_equal(got[k], want[k])
    first = next(iter(ds))
    np.testing.assert_array_equal(first["tokens"], jds.batch_at(0)["tokens"])


@pytest.mark.parametrize("seed", range(3))
def test_pack_documents_is_jax_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    docs = [rng.integers(2, 50, int(rng.integers(1, 30))) for _ in range(int(rng.integers(1, 10)))]
    for seq_len in (4, 7, 32):
        np.testing.assert_array_equal(pack_documents(docs, seq_len),
                                      jpack_documents(docs, seq_len))


def test_prefetch_loader_orders_steps_like_jax():
    ds = SyntheticLM(vocab=101, seq_len=8, batch=2, seed=5)
    loader, jloader = PrefetchLoader(ds.batch_at, prefetch=2), JPrefetchLoader(
        JSyntheticLM(vocab=101, seq_len=8, batch=2, seed=5).batch_at, start_step=0, prefetch=2)
    try:
        for want_step in range(5):
            (step, batch), (jstep, jbatch) = next(loader), next(jloader)
            assert step == jstep == want_step
            np.testing.assert_array_equal(batch["tokens"], jbatch["tokens"])
            np.testing.assert_array_equal(batch["tokens"], ds.batch_at(step)["tokens"])
    finally:
        loader.close()
        jloader.close()
    resumed = PrefetchLoader(ds.batch_at, start_step=3)
    assert next(resumed)[0] == 3
    resumed.close()
