"""The port's encoder-decoder (``repro_torch.models.encdec.EncDec``) held
against ``repro.models.encdec.EncDec`` on the CPU at
``get_reduced("seamless-m4t-medium")``: the same weights
(``params_from_numpy`` of JAX's ``init_params`` tree), numpy-seeded source
embeddings and prompts, then the prefill logits, every self- and
cross-attention cache leaf and eight greedy-fed decode steps' logits,
within 1e-4 (a whole fp32 forward, summed in other orders on the two
sides), with the port on ``ref`` and on the ``cuda`` backends (the kernels'
plain versions on the CPU).  Also, inside the port: teacher forcing (prefill
+ decode equal the full decoder forward at every position) and a batch of
two sources decoded greedily, token for token each source alone."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
import repro_torch  # noqa: F401
from repro.configs import get_reduced as jget_reduced
from repro.models.encdec import EncDec as JEncDec
from repro_torch.configs import get_reduced
from repro_torch.models import EncDec
from repro_torch.models.lm import CUDA_BACKENDS, params_from_numpy

ARCH = "seamless-m4t-medium"
TOL = dict(rtol=1e-4, atol=1e-4)
B, S_SRC, T0, CAP, STEPS = 2, 20, 6, 16, 8


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {} if tree is None else {prefix: tree}


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want), err_msg=what, **TOL)


def _config(backends):
    cfg = get_reduced(ARCH)
    return cfg.with_overrides(backends=CUDA_BACKENDS) if backends == "cuda" else cfg


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((B, S_SRC, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, (B, T0 + STEPS)).astype(np.int32)
    return src, toks


@pytest.mark.parametrize("backends", ["ref", "cuda"])
def test_prefill_and_decode_match_jax(backends):
    cfg = _config(backends)
    jmodel, model = JEncDec(jget_reduced(ARCH)), EncDec(cfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    src, toks = _inputs(cfg)

    jlg, jcaches, jlen = jax.jit(lambda p, s, t: jmodel.prefill(
        p, {"src_embeds": s, "tokens": t}, cache_cap=CAP))(
        jparams, jnp.asarray(src), jnp.asarray(toks[:, :T0]))
    lg, caches, lengths = model.prefill(
        params, {"src_embeds": torch.from_numpy(src), "tokens": torch.from_numpy(toks[:, :T0])},
        cache_cap=CAP)
    _close(lg, jlg, "prefill logits")
    jflat, flat = _flat(jcaches), _flat(caches)
    assert sorted(flat) == sorted(jflat)
    assert any(k.endswith("/cross/k") for k in flat) and any(k.endswith("/mix/v") for k in flat)
    for k in flat:
        assert tuple(flat[k].shape) == jflat[k].shape, k
        _close(flat[k], jflat[k], f"prefill cache {k}")
    assert lengths.dtype == torch.int32 and lengths.tolist() == np.asarray(jlen).tolist()

    enc_lengths = np.full((B,), S_SRC, np.int32)
    jdecode = jax.jit(jmodel.decode_step)
    for t in range(T0, T0 + STEPS):
        jlg, jcaches = jdecode(jparams, jnp.asarray(toks[:, t]), jcaches, jlen,
                               jnp.asarray(enc_lengths))
        lg, caches = model.decode_step(params, torch.from_numpy(toks[:, t]), caches, lengths,
                                       torch.from_numpy(enc_lengths))
        jlen, lengths = jlen + 1, lengths + 1
        _close(lg, jlg, f"decode logits at {t}")
    jflat, flat = _flat(jcaches), _flat(caches)
    for k in flat:
        _close(flat[k], jflat[k], f"cache {k} after {STEPS} decode steps")


def test_params_from_numpy_carries_the_encdec_tree_and_init_params_draws_it():
    jparams = jax.tree.map(np.asarray, JEncDec(jget_reduced(ARCH)).init_params(
        jax.random.PRNGKey(0)))
    flat, jflat = _flat(params_from_numpy(jparams, "cpu")), _flat(jparams)
    assert sorted(flat) == sorted(jflat)          # untied head: no derived leaf
    for k, v in jflat.items():
        assert np.array_equal(flat[k].numpy(), v), k
    for leaf in ("/encoder/period/0/mixer/wq", "/decoder/period/0/cross/wk",
                 "/decoder/period/0/norm_x", "/enc_norm", "/lm_head"):
        assert leaf in flat, leaf
    drawn = _flat(EncDec(get_reduced(ARCH)).init_params(0, device="cpu"))
    assert sorted(drawn) == sorted(flat)
    assert all(tuple(drawn[k].shape) == tuple(v.shape) for k, v in flat.items())


def test_prefill_decode_match_forward_in_the_port():
    """Teacher forcing: prefill + step-by-step decode equal the full
    decoder forward over the same encoder output at every position."""
    cfg = get_reduced(ARCH)
    model = EncDec(cfg)
    params = model.init_params(1, device="cpu")
    src, toks = (torch.from_numpy(x) for x in _inputs(cfg, seed=1))
    enc_out = model.encode(params, src)
    h = params["embed"][toks.long()]
    h, _ = model._decode_trunk(params, h, mode="train", caches=None, lengths=None,
                               enc_out=enc_out, enc_lengths=None, cache_cap=None)
    full = model._head(params, h)
    lg, caches, lengths = model.prefill(params, {"src_embeds": src, "tokens": toks[:, :T0]},
                                        cache_cap=T0 + STEPS)
    enc_lengths = torch.full((B,), S_SRC, dtype=torch.int32)
    errs = [float((lg - full[:, T0 - 1]).abs().max())]
    for t in range(T0, T0 + STEPS):
        lg, caches = model.decode_step(params, toks[:, t], caches, lengths, enc_lengths)
        lengths = lengths + 1
        errs.append(float((lg - full[:, t]).abs().max()))
    assert max(errs) < 1e-4, f"decode diverges from the forward ({max(errs):.2e})"


@pytest.mark.parametrize("backends", ["ref", "cuda"])
def test_batch_of_two_equals_each_source_alone(backends):
    """Greedy decoding of two sources in one batch gives each source's
    batch-1 tokens."""
    cfg = _config(backends)
    model = EncDec(cfg)
    params = model.init_params(2, device="cpu")
    src, toks = (torch.from_numpy(x) for x in _inputs(cfg, seed=2))

    def greedy(s, t):
        lg, caches, lengths = model.prefill(params, {"src_embeds": s, "tokens": t},
                                            cache_cap=T0 + STEPS)
        enc_lengths = torch.full((s.shape[0],), S_SRC, dtype=torch.int32)
        out = [lg.argmax(-1)]
        for _ in range(STEPS - 1):
            lg, caches = model.decode_step(params, out[-1].to(torch.int32), caches, lengths,
                                           enc_lengths)
            lengths = lengths + 1
            out.append(lg.argmax(-1))
        return torch.stack(out, 1)

    both = greedy(src, toks[:, :T0])
    for i in range(B):
        assert both[i].tolist() == greedy(src[i:i + 1], toks[i:i + 1, :T0])[0].tolist()


def test_lm_and_the_serve_entry_point_refuse_the_encoder_config():
    from repro_torch.launch.serve import main
    from repro_torch.models.lm import LM
    with pytest.raises(ValueError, match="EncDec"):
        LM(get_reduced(ARCH))
    with pytest.raises(ValueError, match="no encoder"):
        EncDec(get_reduced("gemma3-1b"))
    import sys
    argv = sys.argv
    sys.argv = ["serve", "--arch", ARCH, "--device", "cpu"]
    try:
        with pytest.raises(SystemExit, match="token-LM"):
            main()
    finally:
        sys.argv = argv
