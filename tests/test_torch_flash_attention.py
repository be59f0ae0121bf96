"""The port's ``attention`` op on the CPU against the JAX package: its
``ref`` backend and its ``cuda`` backend (the flash_attention kernel's
plain version on CPU tensors) against ``repro``'s Pallas
``flash_attention`` in interpret mode and its ``attention_ref``.  Inputs
from numpy with a seed; fp32 on both sides, summed in other orders:
2e-5.  Causal or not, windows of 1 to past the sequence, Sq < Skv (static
query offset), GQA 1/2/4, Dv != D."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
import repro_torch  # noqa: F401
from repro.core.ir import TensorSpec as JSpec
from repro.core.registry import get_op as jget_op
from repro.kernels.flash_attention import flash_attention as jflash_attention
from repro.kernels.ref import attention_ref as jattention_ref
from repro_torch.core.ir import TensorSpec
from repro_torch.core.registry import get_impl, get_op
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from repro_torch.kernels.ref import attention_mask

TOL = dict(rtol=2e-5, atol=2e-5)
# (B, Sq, Skv, Hq, Hk, D, Dv)
SHAPES = [(2, 16, 16, 4, 4, 16, 16), (1, 24, 24, 4, 2, 16, 16), (2, 8, 24, 4, 1, 16, 16),
          (1, 16, 40, 2, 1, 24, 16), (1, 40, 40, 4, 1, 32, 32)]
MASKS = [(True, None), (False, None), (True, 1), (True, 5), (False, 7), (True, 64)]


def _inputs(seed, b, sq, skv, hq, hk, d, dv):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, hq, d)).astype(np.float32),
            rng.standard_normal((b, skv, hk, d)).astype(np.float32),
            rng.standard_normal((b, skv, hk, dv)).astype(np.float32))


def _port(backend, q, k, v, **kw):
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    return ops.attention(q, k, v, backend=backend, **kw).numpy()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("causal,window", MASKS)
def test_backends_match_pallas_and_ref(shape, causal, window):
    q, k, v = _inputs(sum(shape), *shape)
    kw = dict(causal=causal, window=window)
    want_ref = np.asarray(jattention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
    for backend in ("ref", "cuda"):
        np.testing.assert_allclose(_port(backend, q, k, v, **kw), want_ref, **TOL)
    want = np.asarray(jflash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       interpret=True, **kw))
    np.testing.assert_allclose(_port("cuda", q, k, v, **kw), want, **TOL)


@pytest.mark.parametrize("scale", [None, 0.0, 0.3])
def test_explicit_scale_is_kept(scale):
    q, k, v = _inputs(7, 1, 8, 12, 4, 2, 16, 16)
    want = np.asarray(jflash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       scale=scale, window=4, interpret=True))
    for backend in ("ref", "cuda"):
        np.testing.assert_allclose(_port(backend, q, k, v, scale=scale, window=4), want, **TOL)


def test_dv_other_than_d_matches_pallas():
    q, k, v = _inputs(3, 1, 16, 16, 4, 2, 24, 16)
    want = np.asarray(jflash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       window=6, interpret=True))
    got = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), window=6)
    assert got.shape == (1, 16, 4, 16)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_a_row_that_sees_nothing_gives_zero():
    """Sq > Skv under a causal mask: rows before position 0 see no column.
    The kernel (and its plain version) finish them as 0; ``ref`` gives
    the mean of V, like ``repro``'s attention_ref."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(5, 1, 12, 8, 2, 1, 16, 16))
    out = flash_attention(q, k, v)
    assert float(out[:, :4].abs().max()) == 0.0
    ref = ops.attention(q, k, v)
    torch.testing.assert_close(out[:, 4:], ref[:, 4:], **TOL)
    torch.testing.assert_close(ref[:, 0, 0], v[:, :, 0].mean(dim=1), **TOL)


def test_mask_matches_jax():
    from repro.kernels.ref import attention_mask as jmask
    for causal, window in MASKS:
        for sq, skv in ((5, 9), (9, 9), (9, 5)):
            got = attention_mask(sq, skv, causal=causal, window=window, offset=skv - sq)
            want = jmask(sq, skv, causal=causal, window=window, offset=skv - sq)
            assert np.array_equal(got.numpy(), np.asarray(want))


def test_op_declaration_matches_jax():
    specs = [TensorSpec((2, 64, 4, 32), "float32"), TensorSpec((2, 128, 2, 32), "float32"),
             TensorSpec((2, 128, 2, 32), "float32")]
    jspecs = [JSpec(s.shape, s.dtype) for s in specs]
    for attrs in ({"causal": True}, {"causal": True, "window": 16}, {"causal": False}):
        got, want = get_op("attention").cost_fn(specs, attrs), \
            jget_op("attention").cost_fn(jspecs, attrs)
        assert (got.flops, got.bytes) == (want.flops, want.bytes)
        assert get_op("attention").shape_fn(specs, attrs)[0].shape == \
            jget_op("attention").shape_fn(jspecs, attrs)[0].shape
    cuda = get_impl("attention", "cuda")
    assert cuda.supports(specs, {})
    assert not cuda.supports([TensorSpec((1, 8, 2, 300), "float32")] * 3, {})
    assert not cuda.supports([TensorSpec((1, 8, 2, 32), "float64")] * 3, {})
    assert not cuda.supports([TensorSpec((1, 8, 3, 32), "float32"),
                              TensorSpec((1, 8, 2, 32), "float32"),
                              TensorSpec((1, 8, 2, 32), "float32")], {})


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, q, q, window=0)
    with pytest.raises(ValueError, match="unsupported"):
        flash_attention(torch.zeros(1, 4, 2, 300), torch.zeros(1, 4, 2, 300),
                        torch.zeros(1, 4, 2, 300))
    with pytest.raises(TypeError, match="float32"):
        flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros(1, 4, 3, 16), torch.zeros(1, 4, 3, 16))


def test_plain_version_is_the_window_mask_softmax():
    q, k, v = (torch.from_numpy(x) for x in _inputs(11, 1, 6, 10, 2, 2, 8, 8))
    out = flash_attention_plain(q, k, v, causal=True, window=3, scale=1 / math.sqrt(8))
    i = 2                                              # position 10 - 6 + 2 = 6
    s = (q[0, i, 0] / math.sqrt(8)) @ k[0, 4:7, 0].T   # columns 4, 5, 6
    torch.testing.assert_close(out[0, i, 0], torch.softmax(s, 0) @ v[0, 4:7, 0], **TOL)
