"""The bf16 partial decode of the port held against the JAX package on
the CPU.

``decode_attention_partial`` at bf16 returns JAX's dtypes: acc in q's dtype
(rounded once), m and l float32 (``src/repro/kernels/flash_decode.py``'s
Pallas partial and ``src/repro/kernels/ops.py``'s dense ``ref`` partial both
do).  Inputs are drawn with numpy from a seed and rounded to bf16 once; both
sides get the same bits.  The port's plain partial (what
``flash_decode_partial`` runs on CPU tensors, and the ``ref`` route) against
JAX's ``ref`` partial and JAX's Pallas partial in interpret mode, in the
narrow layout and MLA's wide one (D 576, Dv 512): acc within one bf16 ulp
(+ the fp32 parity tolerance, 2e-5, for the other summation order before
the rounding), m and l within 1e-5 relative.  The same for ``cuda_split``'s
plain route against JAX's ``pallas_split``.  The bf16 partial is the fp32
partial on the upcast inputs with acc rounded once, m and l bit for bit (what
the card's ``flash_decode_partial_bf16`` is held to in
tests/test_torch_gpu.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (registers repro's ops)
import repro_torch  # noqa: F401  (registers the port's ops)
from repro.kernels import ops as jops
from repro.kernels.flash_decode import flash_decode_partial as jpartial
from repro_torch.kernels import ops as tops
from repro_torch.kernels.flash_decode import flash_decode_partial, flash_decode_partial_plain

F32_TOL = 2e-5      # the fp32 parity tests' tolerance: another summation order
STAT_RTOL = 1e-5    # m and l: fp32 on both sides


def _bf16(rng, *shape):
    """(numpy bf16 array for JAX, the same bits as a torch bf16 tensor)."""
    a = rng.standard_normal(shape).astype(np.float32)
    j = jnp.asarray(a, jnp.bfloat16)
    t = torch.from_numpy(a).to(torch.bfloat16)
    assert np.array_equal(np.asarray(j).view(np.uint16),
                          t.view(torch.int16).numpy().view(np.uint16))
    return j, t


def _within_one_ulp(got: torch.Tensor, want) -> None:
    """bf16 ``got`` within one bf16 ulp of the larger magnitude + F32_TOL."""
    assert got.dtype == torch.bfloat16
    g, w = got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32))
    assert g.shape == w.shape
    mag = np.maximum(np.maximum(np.abs(g), np.abs(w)), np.float32(2.0 ** -126))
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    diff = np.abs(g - w)
    assert np.all(diff <= ulp + F32_TOL), float(np.max(diff - ulp))


def _stats_close(got: torch.Tensor, want) -> None:
    assert got.dtype == torch.float32 and np.asarray(want).dtype == np.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=STAT_RTOL, atol=0)


# (B, S, Hq, Hk, D, Dv, lengths): the narrow layout at gemma3's MQA group and
# at GQA 2, and MLA's absorbed wide layout
PARTIAL_CASES = [(2, 64, 4, 1, 64, 64, (40, 64)), (3, 32, 4, 2, 32, 32, (1, 17, 32)),
                 (2, 32, 4, 1, 576, 512, (20, 32))]
PARTIAL_IDS = ["narrow-mqa", "narrow-gqa2", "wide-mla"]


def _partial_inputs(b, s, hq, hk, d, dv, lens):
    rng = np.random.default_rng(s + d + hk)
    (jq, q), (jk, k), (jv, v) = _bf16(rng, b, hq, d), _bf16(rng, b, s, hk, d), \
        _bf16(rng, b, s, hk, dv)
    return (jq, jk, jv), (q, k, v), np.asarray(lens, np.int32)


@pytest.mark.parametrize("b,s,hq,hk,d,dv,lens", PARTIAL_CASES, ids=PARTIAL_IDS)
def test_bf16_partial_matches_jax_ref_and_pallas(b, s, hq, hk, d, dv, lens):
    (jq, jk, jv), (q, k, v), lengths = _partial_inputs(b, s, hq, hk, d, dv, lens)
    jref = jops.decode_attention_partial(jq, jk, jv, jnp.asarray(lengths), backend="ref")
    jpal = jpartial(jq, jk, jv, jnp.asarray(lengths), block_kv=16, interpret=True)
    assert [x.dtype for x in jref] == [x.dtype for x in jpal] == [jnp.bfloat16, jnp.float32,
                                                                  jnp.float32]
    for backend in ("cuda", "ref"):
        acc, m, l = tops.decode_attention_partial(q, k, v, torch.from_numpy(lengths),
                                                  backend=backend)
        assert (acc.dtype, m.dtype, l.dtype) == (torch.bfloat16, torch.float32, torch.float32)
        for want in (jref, jpal):
            _within_one_ulp(acc, want[0])
            _stats_close(m, want[1])
            _stats_close(l, want[2])


@pytest.mark.parametrize("b,s,hq,hk,d,dv,lens", PARTIAL_CASES, ids=PARTIAL_IDS)
def test_bf16_partial_is_the_fp32_partial_rounded_once(b, s, hq, hk, d, dv, lens):
    """What the card's bf16 entry is held to: the fp32 partial on the
    upcast inputs, acc rounded once, m and l bit for bit; an empty shard is
    (0, -1e30, 0) at bf16 too; fp32 inputs keep fp32 partials."""
    _, (q, k, v), lengths = _partial_inputs(b, s, hq, hk, d, dv, lens)
    lengths = torch.from_numpy(lengths)
    for n_splits in (1, 2, 4):
        got = flash_decode_partial(q, k, v, lengths, n_splits=n_splits)
        want = flash_decode_partial(q.float(), k.float(), v.float(), lengths, n_splits=n_splits)
        assert [x.dtype for x in want] == [torch.float32] * 3
        assert torch.equal(got[0], want[0].to(torch.bfloat16))
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
        empty = lengths[None, :] <= (s // n_splits) * torch.arange(n_splits)[:, None]
        assert bool((got[1][empty] == -1e30).all()) and bool((got[2][empty] == 0).all())
        if bool(empty.any()):
            assert float(got[0][empty].float().abs().max()) == 0.0
    sc = 1.0 / np.sqrt(d)
    assert torch.equal(flash_decode_partial_plain(q, k, v, lengths, sc, 2)[0],
                       flash_decode_partial(q, k, v, lengths, n_splits=2)[0])


@pytest.mark.parametrize("case,n_splits", [(0, 4), (1, 2), (2, 2)], ids=PARTIAL_IDS)
def test_bf16_cuda_split_matches_jax_pallas_split(case, n_splits):
    b, s, hq, hk, d, dv, lens = PARTIAL_CASES[case]
    (jq, jk, jv), (q, k, v), lengths = _partial_inputs(b, s, hq, hk, d, dv, lens)
    want = jops.decode_attention(jq, jk, jv, jnp.asarray(lengths), backend="pallas_split",
                                 n_splits=n_splits, interpret=True)
    assert want.dtype == jnp.bfloat16
    got = tops.decode_attention(q, k, v, torch.from_numpy(lengths), backend="cuda_split",
                                n_splits=n_splits)
    _within_one_ulp(got, want)
