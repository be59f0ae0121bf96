"""The port's train step at the published bfloat16 (bf16 params, f32
masters and moments), held against the JAX package's on the CPU.

Three steps of ``make_train_step`` at bf16 on reduced gemma3-1b and
phi3-mini-3.8b set to bfloat16, against JAX's bf16 step (its
``value_and_grad`` then ``adamw.update``, the body of JAX's
``make_train_step``, jitted in those two halves) on JAX's
``init_params(PRNGKey(0))`` weights, carried bit for bit by
``params_from_numpy``, and the same SyntheticLM batches.  The yardstick is
the repo's bf16 convention: JAX's own bf16 against its fp32 on the upcast
weights, and the port may differ from JAX's bf16 by at most twice that gap.

- Step 1's gradients, leaf by leaf, by the L2 norm of each leaf's
  difference: the largest element of the difference of two roundings
  swings with single elements (up to 2.7x JAX's on a 128-value leaf of
  gemma3-1b, where the L2 ratio is 1.5).
- The ``ce`` and ``grad_norm`` metrics of the three steps, each metric held
  as one part over the steps (the largest difference against twice JAX's
  largest gap; one step's gap alone can lie near 0 by chance).  At each
  step JAX computes them on the port's params of that step (bf16, and
  upcast for fp32), so a step compares the computation and not the
  trajectories, which part after step 1 (next point).
- Each leaf's update after step 3 (its master less its initial value), by
  the L2 norm of its difference from JAX's bf16 update relative to that
  update's norm: a master left at its initial value reads 1 on every leaf
  and an update of the flipped sign 2.  After Adam's normalised update
  m / sqrt(v) an element whose gradient lies near 0 may step by about 2 lr
  the other way in either run, so one leaf's gap swings (on gemma3-1b's
  (2, 64) norm leaf 10 the port reads 0.114 where JAX's own bf16-vs-fp32
  gap is 0.032): each leaf is held within twice the largest of JAX's own
  per-leaf gaps (0.18 on gemma3-1b, 0.10 on phi3-mini, so the bar stays
  under 1 and the test asserts it does), and the median leaf within twice
  JAX's median (0.092 against 0.088 on gemma3-1b, 0.047 against 0.050 on
  phi3-mini).
- The moments mu and nu after step 3, leaf by leaf, within twice JAX's own
  gap on the same leaf by the same relative L2 (they follow the gradients
  unnormalised: the largest ratio 1.53, on gemma3-1b's nu).
- The dtypes: params bf16, each its f32 master rounded once; masters and
  moments f32.
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
from repro_torch.configs import get_reduced
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.data import SyntheticLM
from repro_torch.models.lm import LM, params_from_numpy, strip_derived
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import make_train_step
from repro_torch.runtime.train import value_and_grad

ARCHS = ("gemma3-1b", "phi3-mini-3.8b")
STEPS, LR = 3, 1e-3
METRICS = ("ce", "grad_norm")


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jnp(t: torch.Tensor):
    """A bf16 tensor as a JAX array, bit for bit."""
    return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))


class _Jax:
    """JAX's step at one dtype, in its two jitted halves."""

    def __init__(self, cfg, opt_cfg):
        model = JLM(cfg)
        self.vg = jax.jit(jax.value_and_grad(lambda p, b: model.train_loss(p, b), has_aux=True))
        self.upd = jax.jit(lambda g, s, p: jadamw.update(g, s, p, opt_cfg))
        self.cast = (lambda a: a) if cfg.param_dtype == "bfloat16" else \
            (lambda a: a.astype(jnp.float32))

    def metrics(self, params, batch):
        """``ce`` and ``grad_norm`` of the loss at ``params`` (cast to this
        run's dtype)."""
        (_, aux), grads = self.vg(jax.tree.map(self.cast, params), batch)
        return {"ce": float(aux["ce"]), "grad_norm": float(jadamw.global_norm(grads))}

    def run(self, params, opt_cfg, batches):
        """Step 1's grads and the state after the last step."""
        params = jax.tree.map(self.cast, params)
        state, grads1 = jadamw.init(params, opt_cfg), None
        for batch in batches:
            _, grads = self.vg(params, batch)
            params, state, _ = self.upd(grads, state, params)
            grads1 = grads if grads1 is None else grads1
        return grads1, state


@pytest.fixture(scope="module", params=ARCHS)
def bf16_train(request):
    arch = request.param
    jcfg = jget_reduced(arch).with_overrides(dtype="bfloat16", param_dtype="bfloat16")
    jp = JLM(jcfg).init_params(jax.random.PRNGKey(0))
    ds = SyntheticLM(vocab=jcfg.vocab, seq_len=32, batch=4, seed=0)
    batches = [ds.batch_at(i) for i in range(STEPS)]
    jbatches = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    jopt = jadamw.AdamWConfig(lr=LR)
    j16, j32 = _Jax(jcfg, jopt), _Jax(jget_reduced(arch), jopt)
    jax_bf16, jax_f32 = j16.run(jp, jopt, jbatches), j32.run(jp, jopt, jbatches)

    cfg = get_reduced(arch).with_overrides(dtype="bfloat16", param_dtype="bfloat16")
    model, opt_cfg = LM(cfg), AdamWConfig(lr=LR)
    params = strip_derived(params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))
    _, _, grads = value_and_grad(model, params, batches[0])
    state = adamw.init(params, opt_cfg)
    step = make_train_step(model, cfg, opt_cfg, donate=False)
    init = [x.float().numpy() for x in tree_leaves(params)]     # the masters at step 0
    metrics = []         # (the port's, JAX bf16's, JAX fp32's) at each step's params
    for batch, jbatch in zip(batches, jbatches):
        jparams = tree_map(_jnp, params)
        want16, want32 = j16.metrics(jparams, jbatch), j32.metrics(jparams, jbatch)
        params, state, m = step(params, state, batch)
        metrics.append(({k: float(m[k]) for k in METRICS}, want16, want32))
    return jax_bf16, jax_f32, (grads, metrics, state, params), init


def _l2(x) -> float:
    return float(np.linalg.norm(x.ravel().astype(np.float64)))


def test_bf16_step1_gradients_within_twice_jax_own_gap(bf16_train):
    (jg16, _), (jg32, _), (grads, _, _, _), _ = bf16_train
    leaves = tree_leaves(grads)
    assert len(leaves) == len(jax.tree.leaves(jg16))
    for i, (g, a16, a32) in enumerate(zip(leaves, jax.tree.leaves(jg16), jax.tree.leaves(jg32))):
        assert g.dtype == torch.bfloat16 and a16.dtype == jnp.bfloat16
        gap = _l2(_f32(a16) - _f32(a32))
        assert 0.0 < gap and _l2(_f32(g) - _f32(a16)) <= 2.0 * gap, i


@pytest.mark.parametrize("key", METRICS)
def test_bf16_metrics_within_twice_jax_own_gap(bf16_train, key):
    _, _, (_, metrics, _, _), _ = bf16_train
    gap = max(abs(a16[key] - a32[key]) for _, a16, a32 in metrics)
    diff = max(abs(got[key] - a16[key]) for got, a16, _ in metrics)
    assert 0.0 < gap and diff <= 2.0 * gap, (diff, gap, metrics)


def _rel_gaps(got, want, base=None) -> np.ndarray:
    """Each leaf's ``|got - want| / |want|`` by L2, of the steps taken from
    ``base`` where it is given (the update), else of the values."""
    out = []
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = _f32(g), _f32(w)
        assert g.shape == w.shape, i
        if base is not None:
            g, w = g - base[i], w - base[i]
        out.append(_l2(g - w) / _l2(w))
    return np.asarray(out)


def test_bf16_masters_within_twice_jax_own_gap(bf16_train):
    (_, js16), (_, js32), (_, _, state, _), init = bf16_train
    want = jax.tree.leaves(js16["master"])
    own = _rel_gaps(jax.tree.leaves(js32["master"]), want, init)
    got = _rel_gaps(tree_leaves(state["master"]), want, init)
    assert len(got) == len(init) and own.min() > 0.0
    bar = 2.0 * own.max()
    assert bar < 1.0         # an unchanged leaf reads 1, a flipped update 2
    assert np.all(got <= bar), (np.flatnonzero(got > bar), got.max(), bar)
    assert np.median(got) <= 2.0 * np.median(own), (np.median(got), np.median(own))
    assert int(state["step"]) == int(js16["step"]) == STEPS


@pytest.mark.parametrize("key", ("mu", "nu"))
def test_bf16_moments_within_twice_jax_own_gap_per_leaf(bf16_train, key):
    (_, js16), (_, js32), (_, _, state, _), _ = bf16_train
    want = jax.tree.leaves(js16[key])
    own = _rel_gaps(jax.tree.leaves(js32[key]), want)
    got = _rel_gaps(tree_leaves(state[key]), want)
    assert len(got) == len(own) and own.min() > 0.0
    assert np.all(got <= 2.0 * own), (np.flatnonzero(got > 2.0 * own), (got / own).max())


def test_bf16_params_stay_bf16_and_the_state_f32(bf16_train):
    """The published dtypes: bf16 params, each its f32 master rounded once;
    f32 masters and moments, as JAX's state."""
    _, _, (_, _, state, params), _ = bf16_train
    for p, master in zip(tree_leaves(params), tree_leaves(state["master"])):
        assert p.dtype == torch.bfloat16 and master.dtype == torch.float32
        assert torch.equal(p, master.to(torch.bfloat16))
    for key in ("mu", "nu"):
        assert all(x.dtype == torch.float32 for x in tree_leaves(state[key]))
