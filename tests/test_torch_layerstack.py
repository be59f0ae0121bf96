"""The port's layer-stack LM (``repro_torch.models.lm``) held against
``repro.models.lm`` on the CPU, on ``get_reduced`` of every config it
serves: the same weights (``params_from_numpy``), prefill logits and
caches, then eight decode steps, within 1e-4 (a whole fp32 forward, summed
in other orders on the two sides).  Prompts of 24 tokens are longer than
the reduced window of 16, so gemma3's local layers take the rolling-buffer
branch.  Also the configs copied into the port, the teacher-forcing check
of ``tests/test_arch_smoke.py`` inside the port, and the configs the port
does not serve yet."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
import repro_torch  # noqa: F401
from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.configs import list_configs as jlist_configs
from repro.layers.common import rope_table as jrope_table
from repro.models.lm import LM as JLM
from repro_torch.configs import get_config, get_reduced, list_configs
from repro_torch.layers.common import rope_table
from repro_torch.models.lm import CUDA_BACKENDS, LM, params_from_numpy

SERVED = ["gemma3-1b", "phi3-mini-3.8b", "stablelm-12b", "minitron-4b"]
NOT_SERVED = {"qwen2-moe-a2.7b": "13b", "deepseek-v2-lite-16b": "13d", "mamba2-370m": "13c",
              "zamba2-7b": "13c", "seamless-m4t-medium": "13e"}
TOL = dict(rtol=1e-4, atol=1e-4)
B, S0, CAP, STEPS = 2, 24, 40, 8


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    """{path: leaf} of a dict/list tree (JAX arrays or tensors)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {} if tree is None else {prefix: tree}


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want), err_msg=what, **TOL)


def test_configs_are_copied_field_for_field():
    assert list_configs() == jlist_configs()
    for name in list_configs():
        for port, jax_ in ((get_config, jget_config), (get_reduced, jget_reduced)):
            assert dataclasses.asdict(port(name)) == dataclasses.asdict(jax_(name)), name


@pytest.mark.parametrize("arch", sorted(NOT_SERVED))
def test_unported_configs_raise_naming_their_item(arch):
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 item {NOT_SERVED[arch]}"):
        LM(get_reduced(arch))


def test_rope_tables_follow_jax_at_large_theta_and_positions():
    pos = np.arange(2000, 2100, dtype=np.int32)
    jc, js = jrope_table(jnp.asarray(pos), 256, 1e6)
    tc, ts = rope_table(torch.from_numpy(pos), 256, 1e6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=2e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=2e-6)


@pytest.mark.parametrize("arch", SERVED)
@pytest.mark.parametrize("backends", ["ref", "cuda"])
def test_prefill_and_decode_match_jax(arch, backends):
    """JAX with its default ``ref`` backends against the port with ``ref``,
    or with the ``cuda`` backends (the kernels' plain versions on the CPU)."""
    jcfg = jget_reduced(arch)
    cfg = get_reduced(arch)
    if backends == "cuda":
        cfg = cfg.with_overrides(backends=CUDA_BACKENDS)
    jmodel, model = JLM(jcfg), LM(cfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    params = params_from_numpy(_tree_np(jparams), "cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (B, S0 + STEPS)).astype(np.int32)

    jlg, jcaches, jlen = jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t}, cache_cap=CAP))(
        jparams, jnp.asarray(toks[:, :S0]))
    lg, caches, lengths = model.prefill(params, {"tokens": torch.from_numpy(toks[:, :S0])},
                                        cache_cap=CAP)
    _close(lg, jlg, "prefill logits")
    jflat, flat = _flat(jcaches), _flat(caches)
    assert sorted(flat) == sorted(jflat)
    for k in flat:
        assert tuple(flat[k].shape) == jflat[k].shape, k
        _close(flat[k], jflat[k], f"prefill cache {k}")
    assert lengths.dtype == torch.int32 and lengths.tolist() == np.asarray(jlen).tolist()

    jdecode = jax.jit(jmodel.decode_step)
    for t in range(S0, S0 + STEPS):
        jlg, jcaches = jdecode(jparams, jnp.asarray(toks[:, t]), jcaches, jlen)
        lg, caches = model.decode_step(params, torch.from_numpy(toks[:, t]), caches, lengths)
        jlen, lengths = jlen + 1, lengths + 1
        _close(lg, jlg, f"decode logits at {t}")
    jflat, flat = _flat(jcaches), _flat(caches)
    for k in flat:
        _close(flat[k], jflat[k], f"cache {k} after {STEPS} decode steps")


@pytest.mark.parametrize("arch", SERVED + ["pixtral-12b"])
def test_prefill_decode_match_forward_in_the_port(arch):
    """Teacher forcing inside the port (tests/test_arch_smoke.py's check):
    prefill + step-by-step decode equal the full causal forward at every
    position."""
    cfg = get_reduced(arch)
    model = LM(cfg)
    params = model.init_params(1, device="cpu")
    b, s, s0 = 2, 24, 16
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (b, s), generator=gen, dtype=torch.int32)
    batch = {"tokens": toks}
    if cfg.frontend == "embeds":
        batch["embeds"] = params["embed"][toks.long()]
    h, _, _ = model.forward(params, batch, mode="train")
    full_logits = model._head(params, h)
    pre = {k: v[:, :s0] for k, v in batch.items()}
    lg, caches, lengths = model.prefill(params, pre, cache_cap=s)
    errs = [float((lg - full_logits[:, s0 - 1]).abs().max())]
    for t in range(s0, s):
        lg, caches = model.decode_step(params, toks[:, t], caches, lengths)
        lengths = lengths + 1
        errs.append(float((lg - full_logits[:, t]).abs().max()))
    assert max(errs) < 5e-3, f"{arch}: decode diverges ({max(errs):.2e})"


def test_init_params_has_the_jax_tree_on_the_device():
    cfg = get_reduced("gemma3-1b")
    params = LM(cfg).init_params(0, device="cpu")
    jparams = _tree_np(JLM(jget_reduced("gemma3-1b")).init_params(jax.random.PRNGKey(0)))
    flat, jflat = _flat(params), _flat(jparams)
    assert sorted(flat) == sorted([*jflat, "/embed_t"])
    for k, v in jflat.items():
        assert tuple(flat[k].shape) == v.shape and flat[k].dtype == torch.float32, k
    assert torch.equal(params["embed_t"], params["embed"].t())
    assert params["embed_t"].is_contiguous()
    assert abs(float(params["embed"].std()) - 0.02) < 2e-3
    again = LM(cfg).init_params(0, device="cpu")
    assert all(torch.equal(again_v, flat[k]) for k, again_v in _flat(again).items())


def test_caches_keep_their_size_over_decode_steps():
    """gemma3's rolling local caches: decode does not grow any cache."""
    cfg = get_reduced("gemma3-1b")
    model = LM(cfg)
    params = model.init_params(2, device="cpu")
    _, caches, lengths = model.prefill(params, {"tokens": torch.arange(8)[None]}, cache_cap=64)
    size0 = sum(x.numel() for x in _flat(caches).values())
    for t in range(20):
        lg, caches = model.decode_step(params, torch.tensor([t % cfg.vocab]), caches, lengths)
        lengths = lengths + 1
        assert bool(torch.isfinite(lg).all())
    assert sum(x.numel() for x in _flat(caches).values()) == size0
