"""The port's train step (``repro_torch.runtime.train.make_train_step``)
held against the JAX package's on the CPU.

Three steps of ``make_train_step`` at reduced phi3-mini-3.8b and
qwen2-moe-a2.7b against ``repro.runtime.train.make_train_step`` on the
same weights and SyntheticLM batches: every step's metrics (``ce``,
``aux``, ``grad_norm``, ``lr``, ``loss``) within 1e-5 relative, then the
params and masters within 2e-5 absolute (2% of the lr of 1e-3: Adam's normalised
update m / (sqrt(v) + eps) turns a last-bit difference of a gradient near
zero into a difference of up to the lr's order in that element; seen 9e-6
after 3 steps) and the moments within 1e-5 of each leaf's largest
magnitude.  Also: the loss falls on synthetic data (tests/test_substrate.py
TestTrainLoop on the port), ``donate=False`` leaves its inputs untouched
and equals ``donate=True`` bit for bit, and the step is deterministic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch  # noqa: F401
from repro.configs import get_reduced as jget_reduced
from repro.models.lm import LM as JLM
from repro.optim import adamw as jadamw
from repro.runtime.train import make_train_step as jmake_train_step
from repro_torch.configs import get_reduced
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.data import SyntheticLM
from repro_torch.models.lm import LM, params_from_numpy, strip_derived
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import make_train_step

METRIC_RTOL, PARAM_ATOL, MOMENT_TOL = 1e-5, 2e-5, 1e-5


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "qwen2-moe-a2.7b"])
def test_three_train_steps_match_jax(arch):
    jcfg, cfg = jget_reduced(arch), get_reduced(arch)
    jmodel, model = JLM(jcfg), LM(cfg)
    jp = jmodel.init_params(jax.random.PRNGKey(0))
    p = strip_derived(params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))
    jopt, opt = jadamw.AdamWConfig(lr=1e-3), AdamWConfig(lr=1e-3)
    js, s = jadamw.init(jp, jopt), adamw.init(p, opt)
    jstep = jmake_train_step(jmodel, jcfg, jopt, donate=False)
    step = make_train_step(model, cfg, opt, donate=False)
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=32, batch=4, seed=0)
    for i in range(3):
        batch = ds.batch_at(i)
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in batch.items()})
        p, s, m = step(p, s, batch)
        assert sorted(m) == sorted(jm) == ["aux", "ce", "grad_norm", "loss", "lr"]
        for k in m:
            assert abs(float(m[k]) - float(jm[k])) <= METRIC_RTOL * abs(float(jm[k])), (i, k)
    for a, b in zip(jax.tree.leaves(jp) + jax.tree.leaves(js["master"]),
                    tree_leaves(p) + tree_leaves(s["master"])):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=PARAM_ATOL)
    for key in ("mu", "nu"):
        for a, b in zip(jax.tree.leaves(js[key]), tree_leaves(s[key])):
            a = np.asarray(a)
            assert np.abs(b.numpy() - a).max() <= MOMENT_TOL * np.abs(a).max(), key
    assert int(s["step"]) == int(js["step"]) == 3 and s["step"].dtype == torch.int32


def test_loss_decreases_on_synthetic():
    """tests/test_substrate.py TestTrainLoop on the port."""
    cfg = get_reduced("phi3-mini-3.8b")
    model = LM(cfg)
    params = strip_derived(model.init_params(0, device="cpu"))
    opt_cfg = AdamWConfig(lr=3e-3, weight_decay=0.0)
    state = adamw.init(params, opt_cfg)
    step = make_train_step(model, cfg, opt_cfg, donate=False)
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=32, batch=8, seed=0)
    losses = []
    for i in range(30):
        params, state, metrics = step(params, state, ds.batch_at(i % 4))
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses[::10]
    assert np.isfinite(losses).all()


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen2-moe-a2.7b"])
def test_donate_false_leaves_inputs_and_equals_donate_true(arch):
    """JAX's tests reuse p0 / s0 after a step: ``donate=False`` must leave
    them as they were; ``donate=True`` updates its inputs in place and
    returns them, with the same bits.  Two runs of the same steps agree
    bitwise (the step is deterministic)."""
    cfg = get_reduced(arch)
    model = LM(cfg)
    opt_cfg = AdamWConfig(lr=1e-3)
    p0 = strip_derived(model.init_params(0, device="cpu"))
    s0 = adamw.init(p0, opt_cfg)
    snap = tree_map(torch.clone, {"p": p0, "s": s0})
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=24, batch=2, seed=3)
    keep = make_train_step(model, cfg, opt_cfg, donate=False)
    p, s = p0, s0
    for i in range(2):
        p, s, _ = keep(p, s, ds.batch_at(i))
    for a, b in zip(tree_leaves({"p": p0, "s": s0}), tree_leaves(snap)):
        assert torch.equal(a, b)
    p_again, s_again = p0, s0
    for i in range(2):
        p_again, s_again, _ = keep(p_again, s_again, ds.batch_at(i))
    pd, sd = tree_map(torch.clone, p0), tree_map(torch.clone, s0)
    donate = make_train_step(model, cfg, opt_cfg, donate=True)
    for i in range(2):
        out_p, out_s, _ = donate(pd, sd, ds.batch_at(i))
        assert out_p is pd and out_s is sd
    for a, b, c in zip(tree_leaves({"p": p, "s": s}), tree_leaves({"p": pd, "s": sd}),
                       tree_leaves({"p": p_again, "s": s_again})):
        assert torch.equal(a, b) and torch.equal(a, c)
