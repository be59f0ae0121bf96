"""The port's training loss held against the JAX package's on the CPU.

``LM.train_loss`` / ``EncDec.train_loss`` and every gradient leaf of
``torch.autograd`` against ``jax.value_and_grad`` of JAX's ``train_loss``
on the same weights (JAX's ``init_params`` through ``params_from_numpy``,
the derived serving leaves stripped) and the same ``SyntheticLM`` batch,
at ``get_reduced`` of every config: the loss within 1e-5 relative, each
gradient leaf within 1e-4 of JAX's relative to the leaf's largest
magnitude (fp32 on both sides, summed in other orders; the largest seen is
4e-6).  The port's gradients with remat on and off are bitwise equal.
This file holds the dense configs, ``cross_entropy`` and the refusals;
tests/test_torch_train_loss_moe.py and tests/test_torch_train_loss_ssm.py
hold the MoE / MLA / encoder-decoder and the SSM / hybrid configs (one
file each, to keep every file's time short).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch  # noqa: F401
from repro.configs import get_reduced as jget_reduced
from repro.data import SyntheticLM as JSyntheticLM
from repro.models.encdec import EncDec as JEncDec
from repro.models.lm import LM as JLM
from repro.models.lm import cross_entropy as jcross_entropy
from repro_torch.configs import get_reduced
from repro_torch.core.tree import leaves_with_paths, tree_leaves
from repro_torch.data import SyntheticLM
from repro_torch.models.encdec import EncDec
from repro_torch.models.lm import (CUDA_BACKENDS, LM, cross_entropy, params_from_numpy,
                                   strip_derived, with_derived)
from repro_torch.runtime.train import make_train_step, value_and_grad
from repro_torch.optim.adamw import AdamWConfig

LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4
B, S = 2, 32


def train_case(arch):
    """JAX's model and weights, the port's model and trainable tree on the
    same weights, and one SyntheticLM batch as the drivers build it."""
    jcfg, cfg = jget_reduced(arch), get_reduced(arch)
    enc = bool(cfg.n_encoder_layers)
    jmodel = JEncDec(jcfg) if enc else JLM(jcfg)
    model = EncDec(cfg) if enc else LM(cfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    params = strip_derived(params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"))
    batch = SyntheticLM(vocab=cfg.vocab, seq_len=S, batch=B, seed=0).batch_at(0)
    rng = np.random.default_rng(0)
    if enc:
        batch["src_embeds"] = rng.standard_normal((B, S // 2, cfg.d_model), np.float32)
        batch["tokens"], batch["labels"] = batch["tokens"][:, :S // 2], batch["labels"][:, :S // 2]
    elif cfg.frontend == "embeds":
        batch["embeds"] = rng.standard_normal((B, S, cfg.d_model), np.float32)
    return jmodel, jparams, model, params, batch


def jax_key(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def check_train_loss_against_jax(arch):
    jmodel, jparams, model, params, batch = train_case(arch)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(jmodel.train_loss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics, grads = value_and_grad(model, params, batch)
    assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    for k in ("ce", "aux"):
        assert abs(float(metrics[k]) - float(jmetrics[k])) <= LOSS_RTOL * max(
            abs(float(jmetrics[k])), 1e-30), k
    jflat = {jax_key(p): np.asarray(g) for p, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    flat = {"/".join(map(str, p)): g for p, g in leaves_with_paths(grads)}
    assert list(flat) == list(jflat)              # JAX's tree, JAX's leaf order
    for key, g in flat.items():
        want = jflat[key]
        assert g.shape == want.shape and g.dtype == torch.float32, key
        err = float(np.abs(g.numpy() - want).max())
        assert err <= GRAD_TOL * float(np.abs(want).max()), (key, err)
    # remat recomputes each period in the backward pass: the same bits
    remat_off = value_and_grad(model, params, batch, remat=False)[2]
    for a, b in zip(tree_leaves(grads), tree_leaves(remat_off)):
        assert torch.equal(a, b)


DENSE = ["gemma3-1b", "phi3-mini-3.8b", "stablelm-12b", "minitron-4b", "pixtral-12b"]


@pytest.mark.parametrize("arch", DENSE)
def test_train_loss_and_grads_match_jax(arch):
    check_train_loss_against_jax(arch)


# --------------------------------------------------------------------------- #
# cross_entropy
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("vocab,padded", [(61, 61), (61, 64), (500, 512)])
def test_cross_entropy_ignores_every_negative_label_like_jax(vocab, padded):
    """Labels -1, -100 and -7 are all ignored (F.cross_entropy's
    ignore_index would ignore only one value), the padding columns are
    masked to -1e30 first, and an all-ignored batch gives 0."""
    import dataclasses
    jcfg = dataclasses.replace(jget_reduced("phi3-mini-3.8b"), vocab=vocab)
    cfg = dataclasses.replace(get_reduced("phi3-mini-3.8b"), vocab=vocab)
    assert cfg.vocab_padded == jcfg.vocab_padded
    rng = np.random.default_rng(vocab)
    logits = rng.standard_normal((3, 7, cfg.vocab_padded)).astype(np.float32) * 4
    labels = rng.integers(0, vocab, (3, 7)).astype(np.int32)
    labels[0, :3] = [-1, -100, -7]
    labels[2, 5] = -2
    for lab in (labels, np.full_like(labels, -1)):
        want = float(jcross_entropy(jnp.asarray(logits), jnp.asarray(lab), jcfg))
        got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(lab), cfg)
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-6 * max(abs(want), 1.0)
    # the padded columns weigh nothing however large they are
    if padded > vocab:
        big = logits.copy()
        big[..., vocab:] = 1e4
        np.testing.assert_equal(
            float(cross_entropy(torch.from_numpy(big), torch.from_numpy(labels), cfg)),
            float(cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), cfg)))


# --------------------------------------------------------------------------- #
# refusals and the trainable tree
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("op,backend", [*sorted(CUDA_BACKENDS.items()),
                                        ("decode_attention", "cuda_split"), ("dense", "tp")])
def test_backends_without_a_backward_pass_are_refused(op, backend):
    cfg = get_reduced("qwen2-moe-a2.7b").with_overrides(backends={op: backend})
    model = LM(cfg)
    params = strip_derived(model.init_params(0, device="cpu"))
    batch = SyntheticLM(vocab=cfg.vocab, seq_len=8, batch=1).batch_at(0)
    with pytest.raises(ValueError, match=f"op '{op}' runs on backend '{backend}'"):
        model.train_loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    with pytest.raises(ValueError, match=f"op '{op}'"):
        make_train_step(model, cfg, AdamWConfig())
    ecfg = get_reduced("seamless-m4t-medium").with_overrides(backends={op: backend})
    with pytest.raises(ValueError, match=f"op '{op}'"):
        EncDec(ecfg).train_loss({}, {})


def test_the_configs_own_backends_train():
    """mamba2's and zamba2's ``ssd: chunked`` is differentiable plain
    PyTorch, as JAX's is; the serving kernels' set is refused whole."""
    for arch in ("mamba2-370m", "zamba2-7b"):
        assert get_reduced(arch).backends == {"ssd": "chunked"}
        make_train_step(LM(get_reduced(arch)), get_reduced(arch), AdamWConfig())
    with pytest.raises(ValueError, match="no backward pass"):
        make_train_step(None, get_reduced("gemma3-1b").with_overrides(backends=CUDA_BACKENDS),
                        AdamWConfig())


def test_make_train_step_with_a_mesh_names_the_roadmap_item():
    """Sharded training (ROADMAP item 13f-ii) needs a process mesh: a mesh
    with no process group behind it raises, naming the mesh to build
    (tests/test_torch_sharded_train.py runs the sharded step)."""
    cfg = get_reduced("phi3-mini-3.8b")
    with pytest.raises(ValueError, match="make_mesh"):
        make_train_step(LM(cfg), cfg, AdamWConfig(), mesh=object())


@pytest.mark.parametrize("arch", ["gemma3-1b", "deepseek-v2-lite-16b"])
def test_derived_serving_leaves_are_stripped_refused_and_rederived(arch):
    """The trainable tree is JAX's; train_loss refuses params that still
    carry ``embed_t`` / ``wuk_h`` / ``wuv_h`` (a gradient into ``embed_t``
    would train a stale copy of the tied embedding); ``with_derived``
    rebuilds the serving tree from trained leaves, equal to
    ``params_from_numpy``'s."""
    jmodel, jparams, model, params, batch = train_case(arch)
    jkeys = [jax_key(p) for p, _ in jax.tree_util.tree_flatten_with_path(jparams)[0]]
    assert ["/".join(map(str, p)) for p, _ in leaves_with_paths(params)] == jkeys
    served = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    with pytest.raises(ValueError, match="strip_derived"):
        model.train_loss(served, {k: torch.from_numpy(v) for k, v in batch.items()})
    rebuilt = with_derived(params)
    got = {"/".join(map(str, p)): x for p, x in leaves_with_paths(rebuilt)}
    want = {"/".join(map(str, p)): x for p, x in leaves_with_paths(served)}
    assert sorted(got) == sorted(want) and len(got) > len(jkeys)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # the derived leaves follow a trained embedding, not the one they were built from
    if "embed_t" in got:
        params["embed"].add_(1.0)
        assert torch.equal(with_derived(params)["embed_t"], params["embed"].t())
