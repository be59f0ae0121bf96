"""The port's layer-stack LM (``repro_torch.models.lm``) held against
``repro.models.lm`` on the CPU, on ``get_reduced`` of every config it
serves: the same weights (``params_from_numpy``), prefill logits and
caches, then eight decode steps, within 1e-4 (a whole fp32 forward, summed
in other orders on the two sides).  Prompts of 24 tokens are longer than
the reduced window of 16, so gemma3's local layers take the rolling-buffer
branch; qwen2-moe-a2.7b runs its MoE FFNs (global dispatch, padded
experts) and mamba2-370m its SSD mixers (prompts off the chunk of 16);
deepseek-v2-lite-16b its MLA mixers (the latent cache, the absorbed decode
over a D = rank + rope head) and MoE with a shared expert; zamba2-7b its
Mamba2 blocks and the two alternating shared attention blocks (the stack's
``shared`` slot, ``emb0``, per-application caches).  Also the configs
copied into the port, ``params_from_numpy`` and ``init_params`` on the new
leaves, the teacher-forcing check of ``tests/test_arch_smoke.py`` inside
the port, and ``LM``'s refusal of the encoder-decoder config (served by
``EncDec``, tests/test_torch_encdec.py)."""

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

SERVED = ["gemma3-1b", "phi3-mini-3.8b", "stablelm-12b", "minitron-4b", "qwen2-moe-a2.7b",
          "mamba2-370m", "deepseek-v2-lite-16b", "zamba2-7b"]
NOT_SERVED = ["seamless-m4t-medium"]
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


@pytest.mark.parametrize("arch", NOT_SERVED)
def test_unported_configs_raise_naming_their_item(arch):
    """``LM`` refuses the encoder-decoder config and names the class that
    serves it."""
    with pytest.raises(ValueError, match="EncDec"):
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


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mamba2-370m"])
def test_params_from_numpy_carries_every_leaf_bit_for_bit(arch):
    """The JAX tree's MoE and Mamba2 leaves (router, stacked (n_periods, E,
    d, f) experts, shared expert, conv weights, A_log, D, dt_bias) arrive
    unchanged, and ``init_params`` draws the same tree."""
    jparams = _tree_np(JLM(jget_reduced(arch)).init_params(jax.random.PRNGKey(0)))
    params = params_from_numpy(jparams, "cpu")
    flat, jflat = _flat(params), _flat(jparams)
    want = {"qwen2-moe-a2.7b": ["/ffn/router", "/ffn/w_gate", "/ffn/w_up", "/ffn/w_down",
                                "/ffn/shared/w_gate"],
            "mamba2-370m": ["/mixer/conv_x", "/mixer/conv_B", "/mixer/A_log", "/mixer/D",
                            "/mixer/dt_bias", "/mixer/out_proj"]}[arch]
    for leaf in want:
        assert f"/stack/period/0{leaf}" in jflat, leaf
    for k, v in jflat.items():
        assert np.array_equal(flat[k].numpy(), v) and flat[k].dtype == torch.float32, k
    cfg = get_reduced(arch)
    if arch.startswith("qwen2"):
        mo = cfg.moe
        assert tuple(flat["/stack/period/0/ffn/w_gate"].shape) == \
            (cfg.plan.n_periods, mo.n_experts, cfg.d_model, mo.d_expert)
    drawn = _flat(LM(cfg).init_params(0, device="cpu"))
    assert sorted(drawn) == sorted(flat)
    assert all(tuple(drawn[k].shape) == tuple(v.shape) for k, v in flat.items())


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mamba2-370m", "gemma3-1b"])
def test_stacked_params_keep_their_shapes_and_scales(arch):
    """``stack_init`` draws each period leaf into one (n_periods, ...)
    tensor: the shapes are JAX's, every period is its own draw, and each
    leaf has its init's scale."""
    cfg = dataclasses.replace(get_reduced(arch), d_model=256)
    jcfg = dataclasses.replace(jget_reduced(arch), d_model=256)
    if cfg.moe is not None:       # wide enough experts for a scale to read
        mo = dataclasses.replace(cfg.moe, d_expert=256)
        cfg = cfg.with_overrides(moe=mo)
        jcfg = jcfg.with_overrides(moe=dataclasses.replace(jcfg.moe, d_expert=256))
    params = LM(cfg).init_params(3, device="cpu")
    jshapes = jax.eval_shape(lambda: JLM(jcfg).init_params(jax.random.PRNGKey(0)))
    flat, jflat = _flat(params), _flat(jshapes)
    assert sorted(flat) == sorted([*jflat, *(["/embed_t"] if cfg.tie_embeddings else [])])
    for k, v in jflat.items():
        assert tuple(flat[k].shape) == v.shape, k
    d = cfg.d_model
    scales = {"wq": d ** -0.5, "w_gate": d ** -0.5, "w_down": cfg.d_ff ** -0.5 if cfg.d_ff else 0,
              "router": 0.02, "wz": d ** -0.5, "conv_x": 0.5, "out_proj": None}
    if cfg.moe is not None:
        scales["w_down"] = cfg.moe.d_expert ** -0.5
    if cfg.ssm is not None:
        scales["out_proj"] = cfg.ssm.d_inner ** -0.5
    n = cfg.plan.n_periods
    for k, t in flat.items():
        name = k.rsplit("/", 1)[-1]
        if "/period/" not in k or scales.get(name) is None or "shared" in k:
            continue
        assert t.shape[0] == n
        for i in range(n):
            assert abs(float(t[i].std()) / scales[name] - 1.0) < 0.1, (k, i)
        assert not torch.equal(t[0], t[1]), f"{k}: the periods share one draw"
    if cfg.ssm is not None:
        a_log = flat["/stack/period/0/mixer/A_log"]
        h = cfg.ssm.n_heads
        assert torch.allclose(a_log[1], torch.log(torch.linspace(1.0, 16.0, h)))
        dt = torch.nn.functional.softplus(flat["/stack/period/0/mixer/dt_bias"])
        assert float(dt.min()) >= cfg.ssm.dt_min * 0.999 and float(dt.max()) <= cfg.ssm.dt_max * 1.001


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
