"""The port's kernel ops held against the JAX package's Pallas kernels.

On the CPU each ``cuda`` backend runs its kernel's plain PyTorch version;
it is compared with the ``pallas`` backend of the same op in ``repro``,
run in interpret mode.  Inputs come from numpy seeds.  Tolerance
rtol = atol = 2e-5: both sides are fp32, summed in another order.  The
``ref`` backends are compared with ``repro``'s ``ref`` oracles.  The
kernels themselves are tested on the card by ``test_torch_gpu.py``.
"""

import math

import numpy as np
import pytest
import torch

import repro  # noqa: F401
import repro_torch  # noqa: F401
from repro.core.registry import get_impl as jimpl
from repro_torch.core.registry import get_impl as timpl

TOL = dict(rtol=2e-5, atol=2e-5)
GQA = [(1, 1), (2, 1), (4, 2), (4, 4)]


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(op, backends, inputs, attrs):
    """Run ``op`` in repro (first backend) and the port (second) on the
    same numpy inputs; returns (jax result, port result) as numpy."""
    j = jimpl(op, backends[0])(list(inputs), dict(attrs))[0]
    t = timpl(op, backends[1])([torch.from_numpy(a) for a in inputs], dict(attrs))[0]
    assert t.dtype == torch.float32
    return np.asarray(j), t.numpy()


# --------------------------------------------------------------------------- #
# gemm (dense)
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("m,n,k", [(5, 37, 19), (1, 64, 64), (4, 3, 1), (70, 65, 200)])
def test_dense_cuda_matches_pallas(m, n, k):
    rng = _rng(m * 1000 + n + k)
    x, w = _f32(rng, m, k), _f32(rng, k, n, scale=1 / math.sqrt(k))
    j, t = _both("dense", ("pallas", "cuda"), [x, w], {})
    assert t.shape == (m, n)
    np.testing.assert_allclose(t, j, **TOL)


def test_dense_cuda_keeps_leading_dims():
    rng = _rng(7)
    x, w = _f32(rng, 2, 3, 8), _f32(rng, 8, 5)
    j, t = _both("dense", ("pallas", "cuda"), [x, w], {})
    assert t.shape == (2, 3, 5)
    np.testing.assert_allclose(t, j, **TOL)


def test_dense_ref_matches_ref():
    rng = _rng(8)
    x, w = _f32(rng, 6, 9), _f32(rng, 9, 4)
    j, t = _both("dense", ("ref", "ref"), [x, w], {})
    np.testing.assert_allclose(t, j, **TOL)


# --------------------------------------------------------------------------- #
# rmsnorm
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("shape", [(3, 8), (2, 5, 96), (1, 100)])
@pytest.mark.parametrize("backends", [("pallas", "cuda"), ("ref", "ref")])
def test_rmsnorm_matches(shape, residual, backends):
    rng = _rng(sum(shape) + residual)
    x = _f32(rng, *shape)
    w = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    inputs = [x, w] + ([_f32(rng, *shape)] if residual else [])
    j, t = _both("rmsnorm", backends, inputs, {"eps": 1e-6})
    np.testing.assert_allclose(t, j, **TOL)


# --------------------------------------------------------------------------- #
# decode_attention (flash_decode)
# --------------------------------------------------------------------------- #

def _decode_inputs(hq, hk, d, dv, seed, s=32, b=3):
    rng = _rng(seed)
    q, k, v = _f32(rng, b, hq, d), _f32(rng, b, s, hk, d), _f32(rng, b, s, hk, dv)
    lengths = np.array([0, s, 13], np.int32)[:b]   # an idle slot, a full cache
    return [q, k, v, lengths]


@pytest.mark.parametrize("scale", [None, 0.0])
@pytest.mark.parametrize("d,dv", [(8, 8), (96, 96), (8, 16)])
@pytest.mark.parametrize("hq,hk", GQA)
def test_decode_attention_cuda_matches_pallas(hq, hk, d, dv, scale):
    inputs = _decode_inputs(hq, hk, d, dv, seed=hq * 100 + hk * 10 + d + dv)
    j, t = _both("decode_attention", ("pallas", "cuda"), inputs, {"scale": scale})
    assert t.shape == (3, hq, dv)
    np.testing.assert_allclose(t, j, **TOL)
    # length 0 (an idle slot) gives 0, as the Pallas kernel does
    assert np.all(t[0] == 0.0) and np.all(j[0] == 0.0)


@pytest.mark.parametrize("hq,hk", GQA)
def test_decode_attention_ref_matches_ref(hq, hk):
    inputs = _decode_inputs(hq, hk, 8, 8, seed=hq + hk)
    j, t = _both("decode_attention", ("ref", "ref"), inputs, {"scale": None})
    np.testing.assert_allclose(t, j, **TOL)
    # the oracles give the mean of V for an empty cache; the kernels give 0
    v = inputs[2]
    np.testing.assert_allclose(t[0], np.repeat(v[0].mean(0), hq // hk, axis=0), **TOL)


def test_decode_cuda_rejects_what_the_kernel_does_not_take():
    from repro_torch.kernels.flash_decode import MAX_WIDE_D, decode_fits, flash_decode
    assert decode_fits(32, 32, 96, 96) and decode_fits(4, 2, 8, 16)
    assert not decode_fits(3, 2, 8, 8) and not decode_fits(4, 4, MAX_WIDE_D + 4, 8)
    q, k = torch.zeros(1, 3, 8), torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError):
        flash_decode(q, k, k, torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        flash_decode(torch.zeros(1, 2, 8), k, k, torch.zeros(1, dtype=torch.int64))
