"""The port's paged serving ops held against repro.kernels.serving_ops on the
CPU.  ``paged_cache_update`` and ``paged_cache_update_q`` must be bitwise
equal to repro's ``ref`` (pages and scales).  The four paged attention ops'
``cuda`` backends (their kernels' plain versions on CPU tensors) must match
repro's Pallas kernels in interpret mode at page 8 and repro's ``ref`` at
pages 1 and 5, on scrambled block tables with junk entries, within
rtol = atol = 2e-5 (fp32, another summation order).  Inputs come from
numpy seeds."""

import numpy as np
import pytest
import torch

import repro  # noqa: F401
import repro_torch  # noqa: F401
from repro.core.ir import TensorSpec as JSpec
from repro.core.registry import get_impl as jimpl
from repro.core.registry import get_op as jop
from repro_torch.core.ir import TensorSpec as TSpec
from repro_torch.core.registry import backends_for
from repro_torch.core.registry import get_impl as timpl
from repro_torch.core.registry import get_op as top

TOL = dict(rtol=2e-5, atol=2e-5)
GQA = [(1, 1), (2, 1), (4, 2), (4, 4)]


def _run(op, backend, inputs, attrs, jax_side):
    if jax_side:
        return [np.asarray(x) for x in jimpl(op, backend)(list(inputs), dict(attrs))]
    outs = timpl(op, backend)([torch.from_numpy(a) for a in inputs], dict(attrs))
    return [x.numpy() for x in outs]


def _tables(rng, b, mp, n, lengths, page):
    """Scrambled distinct blocks for every live page; junk (any id, even
    out of range) past each sequence's live pages."""
    perm = rng.permutation(n)
    tables = rng.integers(-3, n + 3, (b, mp)).astype(np.int32)
    used = 0
    for bi in range(b):
        live = -(-int(lengths[bi]) // page)
        tables[bi, :live] = perm[used:used + live]
        used += live
    return tables


def _pool(rng, n, page, hk, d, quant):
    if not quant:
        return [rng.standard_normal((n, page, hk, d)).astype(np.float32)]
    pages = rng.integers(-127, 128, (n, page, hk, d)).astype(np.int8)
    scales = (rng.random((n, hk)) * 0.05).astype(np.float32)
    pages[0], scales[0] = 0, 0.0               # an all-zero page, scale 0
    return [pages, scales]


# --------------------------------------------------------------------------- #
# cache writes: bitwise equal to repro's ref
# --------------------------------------------------------------------------- #

WRITES = {
    # start, n_new per slot (T = 4 rows per slot)
    "idle_slots": ([3, 9, 0], [0, 3, 0]),
    "ragged_final_chunk_at_capacity": ([14, 15, 2], [2, 1, 4]),
    "crossing_pages": ([6, 0, 11], [4, 4, 3]),
}


def _write_inputs(rng, case, quant, page=4, n=14, hk=2, d=3):
    b, mp, t = 3, 4, 4
    start, n_new = (np.asarray(x, np.int32) for x in WRITES[case])
    tables = _tables(rng, b, mp, n, np.full(b, mp * page), page)
    new = rng.standard_normal((b, t, hk, d)).astype(np.float32)
    new[0, 1] *= 40.0                          # a loud row: its page's scale grows
    pool = _pool(rng, n, page, hk, d, quant)
    if quant:
        return [pool[0], pool[1], new, tables, start, n_new]
    return [pool[0], new, tables, start, n_new]


@pytest.mark.parametrize("case", sorted(WRITES))
@pytest.mark.parametrize("quant", [False, True])
def test_paged_cache_update_is_bitwise_equal(case, quant):
    op = "paged_cache_update_q" if quant else "paged_cache_update"
    inputs = _write_inputs(np.random.default_rng(5), case, quant)
    n_pool = 2 if quant else 1                 # pages (and scales)
    for step in range(3):                      # chained writes, outputs fed back
        j = _run(op, "ref", inputs, {}, jax_side=True)
        t = _run(op, "ref", inputs, {}, jax_side=False)
        assert len(j) == len(t) == n_pool
        for a, b in zip(t, j):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        new = _write_inputs(np.random.default_rng(6 + step), case, quant)[n_pool]
        inputs = t + [new] + inputs[n_pool + 1:]


def test_paged_cache_update_q_keeps_zero_pages_and_grows_scales():
    """All-zero rows into an empty pool keep scale 0.0 and int8 zeros; a
    loud row then raises its page's scale and requantizes the quiet rows —
    bitwise as repro does, and untouched pages keep their bits."""
    rng = np.random.default_rng(7)
    pages = np.zeros((3, 8, 2, 8), np.int8)
    scales = np.zeros((3, 2), np.float32)
    tables = np.asarray([[0, 1]], np.int32)
    steps = [(np.zeros((1, 4, 2, 8), np.float32), 0, 4),
             (0.05 * rng.standard_normal((1, 4, 2, 8)).astype(np.float32), 4, 3),
             (10.0 * np.ones((1, 4, 2, 8), np.float32), 7, 1)]
    for new, start, n in steps:
        inputs = [pages, scales, new, tables, np.asarray([start], np.int32),
                  np.asarray([n], np.int32)]
        jp, js = _run("paged_cache_update_q", "ref", inputs, {}, jax_side=True)
        tp, ts = _run("paged_cache_update_q", "ref", inputs, {}, jax_side=False)
        assert np.array_equal(tp, jp) and np.array_equal(ts, js)
        if start == 0:
            assert (tp == 0).all() and (ts == 0.0).all()
        assert (ts >= scales).all()                          # scales only grow
        assert np.array_equal(tp[2], pages[2]) and ts[2].tolist() == [0.0, 0.0]
        pages, scales = tp, ts
    assert (scales[0] > 0).all() and (scales[1] == 0).all()  # row 7 is page 0


# --------------------------------------------------------------------------- #
# attention: cuda (plain version here) vs Pallas interpret and vs ref
# --------------------------------------------------------------------------- #

def _attn_inputs(rng, op, hq, hk, d, page, b=3, mp=4):
    quant = op.endswith("_q")
    cap = page * mp
    n = b * mp + 2
    if op.startswith("paged_decode"):
        lengths = np.asarray([cap, 7, 1], np.int32)[:b]
        q = rng.standard_normal((b, hq, d)).astype(np.float32)
        last = lengths
    else:
        t = 4
        last = np.asarray([0, cap - t, 5], np.int32)[:b]     # start + T == cap
        q = rng.standard_normal((b, t, hq, d)).astype(np.float32)
        lengths = last + t
    tables = _tables(rng, b, mp, n, np.minimum(lengths, cap), page)
    pk, pv = _pool(rng, n, page, hk, d, quant), _pool(rng, n, page, hk, d, quant)
    return [q, *pk, *pv, tables, last]


ATTN_OPS = ["paged_decode_attention", "paged_chunk_attention",
            "paged_decode_attention_q", "paged_chunk_attention_q"]


@pytest.mark.parametrize("scale", [None, 0.0])
@pytest.mark.parametrize("hq,hk", GQA)
@pytest.mark.parametrize("op", ATTN_OPS)
def test_paged_attention_cuda_matches_pallas(op, hq, hk, scale):
    inputs = _attn_inputs(np.random.default_rng(hq * 10 + hk), op, hq, hk, 8, page=8)
    j = _run(op, "pallas", inputs, {"scale": scale}, jax_side=True)[0]
    t = _run(op, "cuda", inputs, {"scale": scale}, jax_side=False)[0]
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, **TOL)


@pytest.mark.parametrize("page", [1, 5])
@pytest.mark.parametrize("op", ATTN_OPS)
def test_paged_attention_cuda_and_ref_match_ref(op, page):
    inputs = _attn_inputs(np.random.default_rng(page), op, 4, 2, 8, page=page)
    j = _run(op, "ref", inputs, {}, jax_side=True)[0]
    np.testing.assert_allclose(_run(op, "ref", inputs, {}, jax_side=False)[0], j, **TOL)
    np.testing.assert_allclose(_run(op, "cuda", inputs, {}, jax_side=False)[0], j, **TOL)


def test_paged_decode_of_an_empty_sequence_is_zero():
    """Length 0 (an idle slot) gives 0 in the kernels, as in Pallas."""
    rng = np.random.default_rng(9)
    for op in ("paged_decode_attention", "paged_decode_attention_q"):
        inputs = _attn_inputs(rng, op, 2, 1, 8, page=8)
        inputs[-1] = np.asarray([0, 5, 0], np.int32)
        j = _run(op, "pallas", inputs, {}, jax_side=True)[0]
        t = _run(op, "cuda", inputs, {}, jax_side=False)[0]
        assert not t[0].any() and not t[2].any()
        np.testing.assert_allclose(t, j, **TOL)


# --------------------------------------------------------------------------- #
# declarations: shapes, costs and the cuda guards
# --------------------------------------------------------------------------- #

def _specs(op, spec_cls, page=8, d=8, dtype="float32"):
    q = spec_cls((2, 4, d)) if "decode" in op else spec_cls((2, 6, 4, d))
    pages = spec_cls((10, page, 2, d), dtype)
    tb, ln = spec_cls((2, 3), "int32"), spec_cls((2,), "int32")
    if op.endswith("_q"):
        sc = spec_cls((10, 2))
        return [q, pages, sc, pages, sc, tb, ln]
    return [q, pages, pages, tb, ln]


@pytest.mark.parametrize("op", ATTN_OPS)
def test_paged_attention_shapes_and_costs_match(op):
    dt = "int8" if op.endswith("_q") else "float32"
    jspecs, tspecs = _specs(op, JSpec, dtype=dt), _specs(op, TSpec, dtype=dt)
    assert [(s.shape, s.dtype) for s in top(op).shape_fn(tspecs, {})] == \
        [(s.shape, s.dtype) for s in jop(op).shape_fn(jspecs, {})]
    for backend in ("cuda", "ref"):
        jb = "pallas" if backend == "cuda" else "ref"
        jc, tc = jimpl(op, jb).cost(jspecs, {}), timpl(op, backend).cost(tspecs, {})
        assert (tc.flops, tc.bytes) == (jc.flops, jc.bytes), backend


@pytest.mark.parametrize("quant", [False, True])
def test_paged_cache_update_shapes_and_costs_match(quant):
    op = "paged_cache_update_q" if quant else "paged_cache_update"
    shapes = [((10, 8, 2, 8), "int8" if quant else "float32")]
    if quant:
        shapes.append(((10, 2), "float32"))
    shapes += [((2, 4, 2, 8), "float32"), ((2, 3), "int32"), ((2,), "int32"),
               ((2,), "int32")]
    jspecs = [JSpec(*s) for s in shapes]
    tspecs = [TSpec(*s) for s in shapes]
    assert [(s.shape, s.dtype) for s in top(op).shape_fn(tspecs, {})] == \
        [(s.shape, s.dtype) for s in jop(op).shape_fn(jspecs, {})]
    jc, tc = jimpl(op, "ref").cost(jspecs, {}), timpl(op, "ref").cost(tspecs, {})
    assert (tc.flops, tc.bytes) == (jc.flops, jc.bytes)
    if quant:
        with pytest.raises(ValueError, match="int8"):
            top(op).shape_fn([TSpec((10, 8, 2, 8))] + tspecs[1:], {})
        with pytest.raises(ValueError, match="scales"):
            top(op).shape_fn([tspecs[0], TSpec((10, 1))] + tspecs[2:], {})


@pytest.mark.parametrize("op", ATTN_OPS)
def test_cuda_guards_take_any_page_size(op):
    """No TPU page % 8 guard: page 5 and 1 take the kernel; D > 256 and a
    page dtype the op does not read do not."""
    dt = "int8" if op.endswith("_q") else "float32"
    for page in (1, 5, 8, 16):
        assert "cuda" in backends_for(op, _specs(op, TSpec, page=page, dtype=dt), {})
    assert "cuda" not in backends_for(op, _specs(op, TSpec, d=300, dtype=dt), {})
    if dt == "float32":
        assert "cuda" not in backends_for(op, _specs(op, TSpec, dtype="float16"), {})
