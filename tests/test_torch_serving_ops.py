"""The port's serving ops held against repro.kernels.serving_ops on the CPU:
``embedding`` and ``cache_update`` bit for bit against ``ref``,
``chunk_attention`` ``cuda`` (its kernel's plain version here) against the
Pallas kernel in interpret mode, and ``ref`` against ``ref``.  Inputs come
from numpy seeds; tolerance rtol = atol = 2e-5 (fp32, another summation
order)."""

import numpy as np
import pytest
import torch

import repro  # noqa: F401
import repro_torch  # noqa: F401
from repro.core.registry import get_impl as jimpl
from repro_torch.core.registry import get_impl as timpl
from repro_torch.kernels.serving_ops import _chunk_attn_scale

TOL = dict(rtol=2e-5, atol=2e-5)
GQA = [(1, 1), (2, 1), (4, 2), (4, 4)]


def _both(op, backends, inputs, attrs=None):
    j = jimpl(op, backends[0])(list(inputs), dict(attrs or {}))[0]
    t = timpl(op, backends[1])([torch.from_numpy(a) for a in inputs], dict(attrs or {}))[0]
    return np.asarray(j), t.numpy()


def test_embedding_is_bitwise_equal():
    rng = np.random.default_rng(0)
    table = rng.standard_normal((11, 6)).astype(np.float32)
    ids = rng.integers(0, 11, (3, 5)).astype(np.int32)
    j, t = _both("embedding", ("ref", "ref"), [ids, table])
    assert t.shape == (3, 5, 6)
    assert np.array_equal(t, j)


@pytest.mark.parametrize("case", ["idle_slots", "ragged_final_chunk_at_capacity",
                                  "full_chunks"])
def test_cache_update_is_bitwise_equal(case):
    rng = np.random.default_rng(1)
    b, cap, t, h, d = 3, 10, 4, 2, 3
    cache = rng.standard_normal((b, cap, h, d)).astype(np.float32)
    new = rng.standard_normal((b, t, h, d)).astype(np.float32)
    start, n_new = {
        "idle_slots": ([0, 5, 2], [0, 3, 0]),
        # the final chunk starts past cap - T and writes only its 2 valid rows;
        # its padding rows must be dropped, never clipped onto row cap - 1
        "ragged_final_chunk_at_capacity": ([cap - 2, cap - 1, 0], [2, 1, 4]),
        "full_chunks": ([0, cap - t, 3], [t, t, t]),
    }[case]
    inputs = [cache, new, np.array(start, np.int32), np.array(n_new, np.int32)]
    j, tt = _both("cache_update", ("ref", "ref"), inputs)
    assert np.array_equal(tt, j)
    for bi in range(b):
        if n_new[bi] == 0:
            assert np.array_equal(tt[bi], cache[bi])


def test_cache_update_leaves_its_input_untouched():
    cache = torch.zeros(2, 6, 1, 2)
    new = torch.ones(2, 3, 1, 2)
    out = timpl("cache_update", "ref")(
        [cache, new, torch.tensor([1, 4], dtype=torch.int32),
         torch.tensor([3, 2], dtype=torch.int32)], {})[0]
    assert float(cache.abs().sum()) == 0.0
    assert out.shape == cache.shape and out.is_contiguous()
    assert float(out[0, 1:4].min()) == 1.0 and float(out[1, 4:6].min()) == 1.0
    assert float(out[0, 0].abs().sum()) == 0.0 and float(out[0, 4:].abs().sum()) == 0.0


def _chunk_inputs(hq, hk, d, seed, b=3, t=8, s=24):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hk, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hk, d)).astype(np.float32)
    start = np.array([0, s - t, 5], np.int32)[:b]       # start + T == cap
    return [q, k, v, start]


@pytest.mark.parametrize("scale", [None, 0.0])
@pytest.mark.parametrize("d", [8, 96])
@pytest.mark.parametrize("hq,hk", GQA)
def test_chunk_attention_cuda_matches_pallas(hq, hk, d, scale):
    inputs = _chunk_inputs(hq, hk, d, seed=hq * 10 + hk + d)
    j, t = _both("chunk_attention", ("pallas", "cuda"), inputs, {"scale": scale})
    assert t.shape == (3, 8, hq, d)
    np.testing.assert_allclose(t, j, **TOL)


@pytest.mark.parametrize("scale", [None, 0.0])
@pytest.mark.parametrize("hq,hk", GQA)
def test_chunk_attention_ref_matches_ref(hq, hk, scale):
    inputs = _chunk_inputs(hq, hk, 8, seed=hq + hk)
    j, t = _both("chunk_attention", ("ref", "ref"), inputs, {"scale": scale})
    np.testing.assert_allclose(t, j, **TOL)


def test_explicit_zero_scale_stays_zero():
    assert _chunk_attn_scale({"scale": 0.0}, 64) == 0.0
    assert _chunk_attn_scale({"scale": None}, 64) == 0.125
    assert _chunk_attn_scale({}, 16) == 0.25
    # scale 0: uniform weights over the allowed positions, in both packages
    inputs = _chunk_inputs(2, 1, 8, seed=3)
    _, t = _both("chunk_attention", ("ref", "cuda"), inputs, {"scale": 0.0})
    v, start = inputs[2], inputs[3]
    row0 = v[0, : start[0] + 1, 0].mean(0)
    np.testing.assert_allclose(t[0, 0, 0], row0, **TOL)
