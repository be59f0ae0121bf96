"""Tests of the port that need the card (marked ``gpu``): the CUDA kernels
against their plain versions, a small engine on the card against the same
engine on the CPU, weight sharing across Programs, and the wrappers'
refusals.  This file imports neither JAX nor the JAX package, so it runs on
a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py

Each test decides inside itself whether a card exists and skips without one.
"""

import math

import numpy as np
import pytest
import torch

TOL = dict(rtol=2e-5, atol=2e-5)   # fp32 on both sides, another summation order
GQA = [(1, 1), (2, 1), (4, 2), (4, 4)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    from repro_torch.core.device import resolve_device
    return resolve_device("cuda")


def _rn(gen, dev):
    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)
    return rn


@pytest.mark.gpu
def test_kernels_match_their_plain_versions_on_the_card():
    dev = _card()
    from repro_torch.kernels.flash_attention import (flash_chunk_attention,
                                                     flash_chunk_attention_plain)
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain
    from repro_torch.kernels.gemm import gemm, gemm_plain
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rn = _rn(gen, dev)
    before = (gemm.launches, rmsnorm.launches, flash_decode.launches,
              flash_chunk_attention.launches)
    for m, n, k in ((5, 37, 19), (64, 130, 33), (4, 3, 1)):
        x, w = rn(m, k), rn(k, n)
        torch.testing.assert_close(gemm(x, w), gemm_plain(x, w), **TOL)
    x, w, r = rn(7, 96), rn(96), rn(7, 96)
    torch.testing.assert_close(rmsnorm(x, w), rmsnorm_plain(x, w), **TOL)
    torch.testing.assert_close(rmsnorm(x, w, residual=r),
                               rmsnorm_plain(x, w, residual=r), **TOL)
    for hq, hk in GQA:
        for scale in (None, 0.0):
            sc = 1 / math.sqrt(96) if scale is None else scale
            q, k, v = rn(3, hq, 96), rn(3, 70, hk, 96), rn(3, 70, hk, 64)
            lengths = torch.tensor([0, 70, 37], dtype=torch.int32, device=dev)
            out = flash_decode(q, k, v, lengths, scale=scale)
            torch.testing.assert_close(out, flash_decode_plain(q, k, v, lengths, sc), **TOL)
            assert float(out[0].abs().max()) == 0.0      # length 0 gives 0
            q, k, v = rn(3, 16, hq, 8), rn(3, 48, hk, 8), rn(3, 48, hk, 8)
            start = torch.tensor([0, 32, 7], dtype=torch.int32, device=dev)  # 32+16 == cap
            sc = 1 / math.sqrt(8) if scale is None else scale
            torch.testing.assert_close(flash_chunk_attention(q, k, v, start, scale=scale),
                                       flash_chunk_attention_plain(q, k, v, start, sc), **TOL)
    after = (gemm.launches, rmsnorm.launches, flash_decode.launches,
             flash_chunk_attention.launches)
    assert all(a > b for a, b in zip(after, before))


@pytest.mark.gpu
def test_gemm_rows_do_not_depend_on_the_batch():
    """Through the skinny/tiled threshold and across the tiles: every
    element is one FMA chain over k = 0..K-1 in both kernels.  At these N
    the rows of M = 256 take the 128x128 tile and M = 17 and 64 the 32x64
    one; N ragged against both tiles; K 301 (4-byte copies) and 300
    (16-byte copies), a multiple of neither K step."""
    dev = _card()
    from repro_torch.kernels.gemm import (SKINNY_MAX_M, TILES, gemm, gemm_plain, gemm_tile,
                                          gemm_variant)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    rn = _rn(gen, dev)
    ms = (1, 4, SKINNY_MAX_M, SKINNY_MAX_M + 1, 64, 256)
    assert {gemm_variant(m) for m in ms} == {"skinny", "tiled"}
    for k, n in ((301, 8269), (300, 8300)):
        assert {gemm_tile(m, n) for m in ms if gemm_variant(m) == "tiled"} == set(TILES)
        x, w = rn(256, k), rn(k, n) / math.sqrt(k)
        full = gemm(x, w)
        torch.testing.assert_close(full, gemm_plain(x, w), **TOL)
        for m in ms:
            assert torch.equal(gemm(x[:m].contiguous(), w), full[:m]), m


@pytest.mark.gpu
def test_small_engine_on_the_card_matches_the_cpu():
    dev = _card()
    from repro_torch.kernels.gemm import gemm
    from repro_torch.models.graph_lm import GraphLMConfig, init_lm_params
    from repro_torch.runtime.engine import EngineRequest, build_lm_serving
    cfg = GraphLMConfig(vocab=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=96)
    params = init_lm_params(cfg, 0)
    rng = np.random.default_rng(0)
    prompts = [(rng.integers(0, cfg.vocab, int(rng.integers(1, 20))).astype(np.int32),
                int(rng.integers(1, 8))) for _ in range(5)]
    outs = {}
    for device in (dev, "cpu"):
        engine, reference = build_lm_serving(cfg, n_slots=3, chunk=8, cache_cap=32,
                                             params=params, device=device)
        reqs = [EngineRequest(uid=i, prompt=p, max_new_tokens=n)
                for i, (p, n) in enumerate(prompts)]
        for r in reqs:
            assert engine.submit(r)
        launches = gemm.launches
        engine.run()
        if device == dev:
            assert gemm.launches > launches
            for r in reqs:       # batch 3 on the card == batch 1 on the card
                assert r.out_tokens == reference.generate(r.prompt, r.max_new_tokens, chunk=8)
        outs[str(device)] = [r.out_tokens for r in reqs]
    assert outs[str(dev)] == outs["cpu"]


@pytest.mark.gpu
def test_programs_share_weights_on_the_card():
    dev = _card()
    from repro_torch.models.graph_lm import GraphLMConfig, init_lm_params_torch
    from repro_torch.runtime.engine import build_lm_serving
    cfg = GraphLMConfig(vocab=61, d_model=32, n_layers=1, n_heads=4, n_kv_heads=4, d_ff=64)
    params = init_lm_params_torch(cfg, 0, device=dev)
    engine, reference = build_lm_serving(cfg, n_slots=2, chunk=4, cache_cap=16,
                                         params=params, device=dev)
    reference.generate(np.arange(5, dtype=np.int32), 2, chunk=4)
    programs = [engine.stepper.decode_program, engine.stepper.prefill_program]
    for prog in programs:
        stored = prog._stored_params()
        assert all(stored[k].data_ptr() == params[k].data_ptr() for k in stored)


@pytest.mark.gpu
def test_wrappers_refuse_what_the_kernels_do_not_take():
    dev = _card()
    from repro_torch.kernels.gemm import gemm
    from repro_torch.kernels.rmsnorm import rmsnorm
    x = torch.randn(8, 4, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        gemm(x.t(), torch.randn(8, 3, device=dev))
    with pytest.raises(ValueError, match="CUDA device"):
        gemm(x, torch.randn(4, 3))
    with pytest.raises(TypeError, match="float32"):
        rmsnorm(x.double(), torch.ones(4, device=dev, dtype=torch.float64))


def _paged_inputs(gen, dev, *, b, hq, hk, d, dv, page, mp, quant, lengths):
    """A scrambled page pool: every sequence's live pages are distinct
    blocks in random order, table entries past a sequence's live pages
    are junk (any block id, even out of range), and with ``quant`` one
    page is all zeros with scale 0."""
    n = b * mp + 3
    perm = torch.randperm(n, generator=gen, device=dev)
    tables = torch.randint(-2, n + 2, (b, mp), generator=gen, device=dev)
    for bi in range(b):
        live = -(-int(lengths[bi]) // page)
        tables[bi, :live] = perm[bi * mp:bi * mp + live]
    tables = tables.to(torch.int32)
    q_shape = (b, hq, d)
    if quant:
        pk = torch.randint(-127, 128, (n, page, hk, d), generator=gen, device=dev,
                           dtype=torch.int8)
        pv = torch.randint(-127, 128, (n, page, hk, dv), generator=gen, device=dev,
                           dtype=torch.int8)
        ks = torch.rand(n, hk, generator=gen, device=dev) * 0.05
        vs = torch.rand(n, hk, generator=gen, device=dev) * 0.05
        zero = int(perm[0])
        pk[zero], pv[zero], ks[zero], vs[zero] = 0, 0, 0.0, 0.0
        return q_shape, pk, pv, tables, dict(k_scales=ks, v_scales=vs)
    pk = torch.randn(n, page, hk, d, generator=gen, device=dev)
    pv = torch.randn(n, page, hk, dv, generator=gen, device=dev)
    return q_shape, pk, pv, tables, {}


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True])
def test_paged_kernels_match_their_plain_versions_on_the_card(quant):
    dev = _card()
    from repro_torch.kernels.flash_attention import (flash_paged_chunk_attention,
                                                     flash_paged_chunk_attention_plain)
    from repro_torch.kernels.flash_decode import flash_paged_decode, flash_paged_decode_plain
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    before = (flash_paged_decode.launches, flash_paged_chunk_attention.launches)
    for hq, hk in GQA:
        for page, mp in ((1, 70), (5, 14), (16, 5), (64, 2), (128, 1)):
            cap = page * mp
            for scale in (None, 0.0):
                lengths = torch.tensor([0, cap, 37, 1], dtype=torch.int32, device=dev)
                q_shape, pk, pv, tables, sc = _paged_inputs(
                    gen, dev, b=4, hq=hq, hk=hk, d=96, dv=64, page=page, mp=mp,
                    quant=quant, lengths=lengths)
                q = torch.randn(*q_shape, generator=gen, device=dev)
                s = 1 / math.sqrt(96) if scale is None else scale
                out = flash_paged_decode(q, pk, pv, tables, lengths, scale=scale, **sc)
                torch.testing.assert_close(out, flash_paged_decode_plain(
                    q, pk, pv, tables, lengths, s, sc.get("k_scales"), sc.get("v_scales")),
                    **TOL)
                assert float(out[0].abs().max()) == 0.0      # length 0 gives 0
                t = 16
                start = torch.tensor([0, cap - t, 5, cap // 2], dtype=torch.int32, device=dev)
                filled = torch.full((4,), cap, dtype=torch.int32, device=dev)
                q_shape, pk, pv, tables, sc = _paged_inputs(
                    gen, dev, b=4, hq=hq, hk=hk, d=32, dv=32, page=page, mp=mp,
                    quant=quant, lengths=filled)
                q = torch.randn(4, t, hq, 32, generator=gen, device=dev)
                s = 1 / math.sqrt(32) if scale is None else scale
                torch.testing.assert_close(
                    flash_paged_chunk_attention(q, pk, pv, tables, start, scale=scale, **sc),
                    flash_paged_chunk_attention_plain(q, pk, pv, tables, start, s,
                                                      sc.get("k_scales"),
                                                      sc.get("v_scales")), **TOL)
    after = (flash_paged_decode.launches, flash_paged_chunk_attention.launches)
    assert all(a > b for a, b in zip(after, before))


@pytest.mark.gpu
@pytest.mark.parametrize("page", [1, 5, 16, 64])
def test_fp32_paged_kernels_equal_the_dense_kernels_bitwise(page):
    """Same 64-row logical tiles and arithmetic: a paged row is bit for bit
    the dense kernel's row on the gathered cache, junk entries included."""
    dev = _card()
    from repro_torch.kernels.flash_attention import (flash_chunk_attention,
                                                     flash_paged_chunk_attention)
    from repro_torch.kernels.flash_decode import (flash_decode, flash_paged_decode,
                                                  gather_pages)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    mp = -(-300 // page)
    lengths = torch.tensor([290, 0, 64, 1], dtype=torch.int32, device=dev)
    q_shape, pk, pv, tables, _ = _paged_inputs(gen, dev, b=4, hq=8, hk=4, d=96, dv=96,
                                               page=page, mp=mp, quant=False,
                                               lengths=lengths)
    k, v = gather_pages(pk, tables), gather_pages(pv, tables)
    q = torch.randn(*q_shape, generator=gen, device=dev)
    assert torch.equal(flash_paged_decode(q, pk, pv, tables, lengths),
                       flash_decode(q, k, v, lengths))
    start = torch.tensor([200, 0, 63, 5], dtype=torch.int32, device=dev)
    filled = torch.full((4,), page * mp, dtype=torch.int32, device=dev)
    _, pk, pv, tables, _ = _paged_inputs(gen, dev, b=4, hq=8, hk=4, d=96, dv=96,
                                         page=page, mp=mp, quant=False, lengths=filled)
    q = torch.randn(4, 64, 8, 96, generator=gen, device=dev)
    assert torch.equal(flash_paged_chunk_attention(q, pk, pv, tables, start),
                       flash_chunk_attention(q, gather_pages(pk, tables),
                                             gather_pages(pv, tables), start))


@pytest.mark.gpu
def test_paged_wrappers_refuse_what_the_kernels_do_not_take():
    dev = _card()
    from repro_torch.kernels.flash_attention import flash_paged_chunk_attention
    from repro_torch.kernels.flash_decode import flash_paged_decode
    pk = torch.zeros(4, 8, 2, 300, device=dev)
    tables = torch.zeros(1, 2, dtype=torch.int32, device=dev)
    lengths = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="unsupported"):          # D > 256
        flash_paged_decode(torch.zeros(1, 2, 300, device=dev), pk, pk, tables, lengths)
    pk8 = torch.zeros(4, 8, 2, 16, dtype=torch.int8, device=dev)
    sc = torch.zeros(4, 2, device=dev)
    with pytest.raises(ValueError, match="both"):
        flash_paged_decode(torch.zeros(1, 2, 16, device=dev), pk8, pk8, tables, lengths,
                           k_scales=sc)
    with pytest.raises(TypeError, match="int8"):
        flash_paged_chunk_attention(torch.zeros(1, 3, 2, 16, device=dev), pk8.float(),
                                    pk8.float(), tables, lengths, k_scales=sc, v_scales=sc)
    with pytest.raises(ValueError, match="CUDA device"):
        flash_paged_decode(torch.zeros(1, 2, 16, device=dev), pk8, pk8, tables.cpu(),
                           lengths, k_scales=sc, v_scales=sc)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_small_paged_engine_on_the_card_matches_the_cpu(kv_dtype):
    dev = _card()
    from repro_torch.kernels.flash_decode import flash_paged_decode
    from repro_torch.models.graph_lm import GraphLMConfig, init_lm_params
    from repro_torch.runtime.engine import EngineRequest, build_lm_serving
    cfg = GraphLMConfig(vocab=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=96)
    params = init_lm_params(cfg, 0)
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, cfg.vocab, 21).astype(np.int32)
    prompts = [(np.concatenate([prefix, rng.integers(0, cfg.vocab, i).astype(np.int32)]), 4)
               for i in range(1, 5)]
    outs = {}
    for device in (dev, "cpu"):
        engine, reference = build_lm_serving(cfg, n_slots=3, chunk=8, cache_cap=48,
                                             paged=True, page_size=5, kv_dtype=kv_dtype,
                                             params=params, device=device)
        launches = flash_paged_decode.launches
        for p, n in prompts:       # one at a time: each later one hits the prefix
            r = EngineRequest(uid=len(outs), prompt=p, max_new_tokens=n)
            assert engine.submit(r)
            engine.run()
            outs.setdefault(str(device), []).append(r.out_tokens)
            if kv_dtype == "float32":
                assert r.out_tokens == reference.generate(p, n, chunk=8)
        engine.stepper.pool.check_integrity()
        assert engine.stepper.pool.hit_tokens > 0
        if device == dev:
            assert flash_paged_decode.launches > launches
    assert outs[str(dev)] == outs["cpu"]


# (B, Sq, Skv, Hq, Hk, D, Dv): Sq < Skv, GQA 1/2/4, lengths off the 32/64
# tiles, D 16 to 256, Dv != D
ATTENTION_SHAPES = [(2, 37, 37, 4, 4, 16, 16), (1, 70, 100, 4, 2, 96, 96),
                    (2, 45, 45, 4, 1, 128, 128), (1, 130, 130, 4, 1, 256, 256),
                    (1, 33, 50, 2, 1, 24, 16)]
ATTENTION_MASKS = [(True, None), (False, None), (True, 1), (True, 16), (False, 16),
                   (True, 200)]


@pytest.mark.gpu
def test_flash_attention_matches_its_plain_version_on_the_card():
    dev = _card()
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    rn = _rn(gen, dev)
    before = flash_attention.launches
    for b, sq, skv, hq, hk, d, dv in ATTENTION_SHAPES:
        q, k, v = rn(b, sq, hq, d), rn(b, skv, hk, d), rn(b, skv, hk, dv)
        for causal, window in ATTENTION_MASKS:
            out = flash_attention(q, k, v, causal=causal, window=window)
            want = flash_attention_plain(q, k, v, causal=causal, window=window,
                                         scale=1 / math.sqrt(d))
            torch.testing.assert_close(out, want, **TOL)
    q, k, v = rn(1, 12, 2, 16), rn(1, 8, 1, 16), rn(1, 8, 1, 16)   # Sq > Skv
    assert float(flash_attention(q, k, v)[:, :4].abs().max()) == 0.0
    assert flash_attention.launches > before
    # the layer-stack decode: D = 256, a group of 4 query heads on one kv head
    q, k, v = rn(4, 4, 256), rn(4, 512, 1, 256), rn(4, 512, 1, 256)
    lengths = torch.tensor([512, 300, 1, 0], dtype=torch.int32, device=dev)
    torch.testing.assert_close(flash_decode(q, k, v, lengths),
                               flash_decode_plain(q, k, v, lengths, 1 / 16), **TOL)


@pytest.mark.gpu
def test_flash_attention_refuses_what_the_kernel_does_not_take():
    dev = _card()
    from repro_torch.kernels.flash_attention import flash_attention
    x = torch.zeros(1, 8, 2, 300, device=dev)
    with pytest.raises(ValueError, match="unsupported"):            # D > 256
        flash_attention(x, x, x)
    q = torch.zeros(1, 8, 2, 16, device=dev)
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, q, q, window=0)
    with pytest.raises(TypeError, match="float32"):
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention(q, q.cpu(), q)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), q, q)


@pytest.mark.gpu
def test_layerstack_batcher_on_the_card_matches_its_reference_and_the_cpu():
    dev = _card()
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import serving_config
    from repro_torch.models.lm import LM
    from repro_torch.runtime.batching import ContinuousBatcher, Request
    outs = {}
    for device in (dev, "cpu"):
        cfg = serving_config("gemma3-1b", device=device)
        model = LM(cfg)
        params = model.init_params(0, device="cpu")       # the same weights on both sides
        if device == dev:
            params = _to(params, dev)
        rng = np.random.default_rng(2)
        reqs = [Request(uid=i, prompt=rng.integers(2, cfg.vocab, int(rng.integers(3, 40)))
                        .astype(np.int32), max_new_tokens=int(rng.integers(2, 9)))
                for i in range(7)]
        batcher = ContinuousBatcher(model, params, n_slots=3, cache_cap=64, eos_id=-1)
        for r in reqs:
            batcher.submit(r)
        launches = flash_attention.launches
        batcher.run()
        outs[str(device)] = [r.out_tokens for r in reqs]
        if device == dev:
            assert flash_attention.launches > launches
            for r in reqs:       # batch 3 on the card == batch 1 on the card
                lg, caches, lengths = model.prefill(
                    params, {"tokens": torch.as_tensor(r.prompt, device=dev)[None]},
                    cache_cap=64)
                want = [int(lg[0].argmax())]
                while len(want) < r.max_new_tokens:
                    lg, caches = model.decode_step(
                        params, torch.tensor([want[-1]], dtype=torch.int32, device=dev),
                        caches, lengths)
                    lengths = lengths + 1
                    want.append(int(lg[0].argmax()))
                assert r.out_tokens == want, r.uid
    assert outs[str(dev)] == outs["cpu"]


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


@pytest.mark.gpu
def test_batched_gemm_matches_bmm_and_its_rows_do_not_depend_on_m():
    dev = _card()
    from repro_torch.kernels.gemm import batched_gemm, batched_gemm_plain, gemm
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    rn = _rn(gen, dev)
    launches = batched_gemm.launches
    for e, m, n, k in ((3, 5, 37, 19), (2, 70, 65, 200), (4, 1, 3, 1), (64, 32, 96, 130)):
        x, w = rn(e, m, k), rn(e, k, n)
        torch.testing.assert_close(batched_gemm(x, w), batched_gemm_plain(x, w), **TOL)
    assert batched_gemm.launches == launches + 4
    x, w = rn(8, 96, 150), rn(8, 150, 70)
    full = batched_gemm(x, w)
    for m in (1, 3, 64, 65):             # a row's bits do not depend on M or its block
        assert torch.equal(batched_gemm(x[:, -m:].contiguous(), w), full[:, -m:])
    assert torch.equal(full[2], gemm(x[2].contiguous(), w[2].contiguous()))


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [(2, 64, 4, 16, 1, 16, 16), (1, 50, 4, 24, 2, 32, 16),
                                               (2, 37, 6, 8, 3, 128, 128), (1, 256, 2, 64, 1, 128, 128)])
def test_ssd_matches_its_plain_version_on_the_card(b, s, h, p, g, n, chunk):
    dev = _card()
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ssd_ref
    from repro_torch.kernels.ssd import ssd_scan
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    rn = _rn(gen, dev)
    x, B, C = rn(b, s, h, p), rn(b, s, g, n) * 0.3, rn(b, s, g, n) * 0.3
    dt = torch.nn.functional.softplus(rn(b, s, h) - 2.0)
    A, D = -torch.linspace(0.5, 4.0, h, device=dev), rn(h)
    launches = ssd_scan.launches
    for with_d in (None, D):             # S off the chunk: the op pads with dt = 0 steps
        y, st = ops.ssd(x, dt, A, B, C, with_d, chunk=chunk, backend="cuda")
        y_ref, st_ref = ssd_ref(x, dt, A, B, C, with_d)
        yc, stc = ops.ssd(x, dt, A, B, C, with_d, chunk=chunk, backend="chunked")
        for got, want in ((y, yc), (st, stc), (y, y_ref), (st, st_ref)):
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert ssd_scan.launches == launches + 2


@pytest.mark.gpu
def test_mamba_decode_step_is_bitwise_across_the_batch():
    dev = _card()
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    rn = _rn(gen, dev)
    b, h, p, g, n = 4, 32, 64, 1, 128               # mamba2-370m's step
    x, dt, B, C = rn(b, h, p), torch.rand(b, h, device=dev) * 0.1, rn(b, g, n), rn(b, g, n)
    A, D, state = -torch.linspace(1.0, 16.0, h, device=dev), torch.ones(h, device=dev), \
        rn(b, h, p, n)
    y, st = ops.ssd_step(x, dt, A, B, C, D, state)
    for i in range(b):
        y1, st1 = ops.ssd_step(x[i:i + 1], dt[i:i + 1], A, B[i:i + 1], C[i:i + 1], D,
                               state[i:i + 1])
        assert torch.equal(y1, y[i:i + 1]) and torch.equal(st1, st[i:i + 1])


@pytest.mark.gpu
def test_ssd_and_batched_gemm_refuse_what_the_kernels_do_not_take():
    dev = _card()
    from repro_torch.kernels.gemm import batched_gemm
    from repro_torch.kernels.ssd import ssd_scan
    x = torch.zeros(2, 4, 8, device=dev)
    with pytest.raises(ValueError, match="needs"):
        batched_gemm(x, torch.zeros(3, 8, 4, device=dev))
    with pytest.raises(TypeError, match="float32"):
        batched_gemm(x.half(), x.transpose(1, 2).contiguous().half())
    with pytest.raises(ValueError, match="contiguous"):
        batched_gemm(x, torch.zeros(2, 4, 8, device=dev).transpose(1, 2))
    xs, dt, A = torch.zeros(1, 256, 2, 8, device=dev), torch.zeros(1, 256, 2, device=dev), \
        torch.zeros(2, device=dev)
    bc = torch.zeros(1, 256, 1, 16, device=dev)
    with pytest.raises(ValueError, match="unsupported"):             # chunk > 128
        ssd_scan(xs, dt, A, bc, bc, chunk=256)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_scan(xs[:, :100], dt[:, :100], A, bc[:, :100], bc[:, :100], chunk=64)
    with pytest.raises(ValueError, match="CUDA device"):
        ssd_scan(xs, dt.cpu(), A, bc, bc)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mamba2-370m"])
def test_moe_and_mamba_batchers_on_the_card_match_batch_one(arch):
    dev = _card()
    from repro_torch.kernels.gemm import batched_gemm
    from repro_torch.kernels.ssd import ssd_scan
    from repro_torch.launch.serve import serving_config
    from repro_torch.models.lm import LM
    from repro_torch.runtime.batching import ContinuousBatcher, Request
    cfg = serving_config(arch, device=dev)
    model = LM(cfg)
    params = model.init_params(0, device=dev)
    rng = np.random.default_rng(3)
    reqs = [Request(uid=i, prompt=rng.integers(2, cfg.vocab, int(rng.integers(3, 40)))
                    .astype(np.int32), max_new_tokens=int(rng.integers(2, 9))) for i in range(7)]
    kern = batched_gemm if arch.startswith("qwen2") else ssd_scan
    launches = kern.launches
    batcher = ContinuousBatcher(model, params, n_slots=3, cache_cap=64, eos_id=-1)
    for r in reqs:
        batcher.submit(r)
    batcher.run()
    assert kern.launches > launches
    for r in reqs:                       # batch 3 on the card == batch 1 on the card
        lg, caches, lengths = model.prefill(
            params, {"tokens": torch.as_tensor(r.prompt, device=dev)[None]}, cache_cap=64)
        want = [int(lg[0].argmax())]
        while len(want) < r.max_new_tokens:
            lg, caches = model.decode_step(
                params, torch.tensor([want[-1]], dtype=torch.int32, device=dev), caches,
                lengths)
            lengths = lengths + 1
            want.append(int(lg[0].argmax()))
        assert r.out_tokens == want, r.uid


@pytest.mark.gpu
@pytest.mark.parametrize("n_splits", [2, 4, 8])
def test_partial_kernel_matches_its_plain_version_on_the_card(n_splits):
    """Lengths 0, shards wholly empty, lengths on and across shard edges;
    GQA groups 1-8; D 64-256 with Dv != D."""
    dev = _card()
    from repro_torch.kernels.flash_decode import (flash_decode_partial,
                                                  flash_decode_partial_plain)
    gen = torch.Generator(device=dev)
    gen.manual_seed(n_splits)
    rn = _rn(gen, dev)
    before = flash_decode_partial.launches
    s = 64 * n_splits + 32 * n_splits          # shards of 96 rows: a ragged second tile
    part = s // n_splits
    lens = [0, 1, part - 1, part, part + 1, s // 2 + 5, s - 1, s]
    for hq, hk in ((1, 1), (2, 1), (4, 2), (8, 1), (8, 8)):
        for d, dv in ((64, 64), (96, 96), (128, 64), (256, 256), (96, 128)):
            b = len(lens)
            q, k, v = rn(b, hq, d), rn(b, s, hk, d), rn(b, s, hk, dv)
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            sc = 1 / math.sqrt(d)
            acc, m, l = flash_decode_partial(q, k, v, lengths, n_splits=n_splits)
            pa, pm, pl = flash_decode_partial_plain(q, k, v, lengths, sc, n_splits)
            torch.testing.assert_close(acc, pa, **TOL)
            torch.testing.assert_close(m, pm, **TOL)
            torch.testing.assert_close(l, pl, **TOL)
            empty = (lengths[None, :] - part * torch.arange(n_splits, device=dev)[:, None]) <= 0
            assert bool((m[empty] == -1e30).all()) and bool((l[empty] == 0).all())
            assert float(acc[empty].abs().max()) == 0.0
    assert flash_decode_partial.launches == before + 25


@pytest.mark.gpu
def test_split_decode_rows_do_not_depend_on_the_batch():
    dev = _card()
    from repro_torch.kernels.flash_decode import combine_partials, flash_decode_partial
    from repro_torch.kernels.ops import decode_attention
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    rn = _rn(gen, dev)
    q, k, v = rn(8, 4, 256), rn(8, 1024, 1, 256), rn(8, 1024, 1, 256)
    lengths = torch.tensor([1000, 0, 511, 512, 513, 1, 1024, 300], dtype=torch.int32,
                           device=dev)
    before = flash_decode_partial.launches
    before_combine = combine_partials.launches
    for n_splits in (2, 4, 8):
        full = decode_attention(q, k, v, lengths, backend="cuda_split", n_splits=n_splits)
        for lo, hi in ((0, 1), (3, 4), (2, 6), (5, 8)):
            part = decode_attention(q[lo:hi].contiguous(), k[lo:hi].contiguous(),
                                    v[lo:hi].contiguous(), lengths[lo:hi].contiguous(),
                                    backend="cuda_split", n_splits=n_splits)
            assert torch.equal(part, full[lo:hi])
        ref = decode_attention(q, k, v, lengths, backend="cuda")
        torch.testing.assert_close(full, ref, **TOL)
    assert flash_decode_partial.launches == before + 15
    # one combine per cuda_split call and one inside each flash_decode call
    assert combine_partials.launches == before_combine + 15 + 3


@pytest.mark.gpu
def test_decode_rows_do_not_depend_on_the_batch():
    """gemma3-1b's global decode shape (Hq 4, Hk 1, D 256, S 2048), lengths
    on the shard edges, one row off them, and 0: the dense and paged fp32
    kernels give a sequence the same bits at every batch size."""
    dev = _card()
    from repro_torch.kernels.flash_decode import (decode_shard_rows, flash_decode,
                                                  flash_paged_decode)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    rn = _rn(gen, dev)
    s = 2048
    sh = decode_shard_rows(s)
    lens = [0, 1, sh - 1, sh, sh + 1, 3 * sh - 1, 3 * sh + 1, s]
    b = len(lens)
    q, k, v = rn(b, 4, 256), rn(b, s, 1, 256), rn(b, s, 1, 256)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    full = flash_decode(q, k, v, lengths)
    assert float(full[0].abs().max()) == 0.0
    page = 16
    pk, pv = k.reshape(b * s // page, page, 1, 256), v.reshape(b * s // page, page, 1, 256)
    tables = torch.arange(b * s // page, dtype=torch.int32, device=dev).reshape(b, s // page)
    assert torch.equal(flash_paged_decode(q, pk, pv, tables, lengths), full)
    for lo, hi in ((0, 1), (2, 3), (3, 6), (1, 8), (7, 8)):
        part = flash_decode(q[lo:hi].contiguous(), k[lo:hi].contiguous(),
                            v[lo:hi].contiguous(), lengths[lo:hi].contiguous())
        assert torch.equal(part, full[lo:hi]), (lo, hi)


@pytest.mark.gpu
@pytest.mark.parametrize("n_shards", [1, 2, 16, 33])
def test_combine_kernel_matches_combine_partials_ref(n_shards):
    """Real partials with empty shards, and a row whose shards are all
    empty (acc 0, m -1e30, l 0), which gives 0."""
    dev = _card()
    from repro_torch.kernels.flash_decode import combine_partials, flash_decode_partial
    from repro_torch.kernels.ref import combine_partials_ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(n_shards)
    rn = _rn(gen, dev)
    s = 8 * n_shards
    q, k, v = rn(3, 4, 96), rn(3, s, 2, 96), rn(3, s, 2, 72)
    lengths = torch.tensor([0, s // 2 + 1, s], dtype=torch.int32, device=dev)
    parts = flash_decode_partial(q, k, v, lengths, n_splits=n_shards)
    before = combine_partials.launches
    got = combine_partials(*parts)
    assert combine_partials.launches == before + 1
    torch.testing.assert_close(got, combine_partials_ref(*parts), **TOL)
    assert float(got[0].abs().max()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [False, True])
def test_conv2d_cuda_matches_its_plain_version_on_the_card(fused):
    dev = _card()
    from repro_torch.core.registry import get_impl
    from repro_torch.kernels.gemm import gemm
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    rn = _rn(gen, dev)
    op = "conv2d_fused" if fused else "conv2d"
    before = gemm.launches
    cases = (((1, 56, 56, 64), (3, 3, 64, 64), {"stride": 1, "padding": "SAME"}),
             ((1, 224, 224, 3), (7, 7, 3, 64), {"stride": 2, "padding": "SAME"}),
             ((1, 7, 7, 2048), (1, 1, 2048, 512), {"stride": 1, "padding": "SAME"}),
             ((2, 17, 13, 5), (3, 3, 5, 7), {"stride": 2, "padding": "VALID", "dilation": 1}),
             ((1, 9, 9, 4), (3, 3, 4, 6), {"stride": 1, "padding": ((1, 2), (0, 1)),
                                           "dilation": 2}))
    for xs, ws, attrs in cases:
        x, w = rn(*xs), rn(*ws) / math.sqrt(ws[0] * ws[1] * ws[2])
        args = [x, w] + ([rn(ws[-1])] if fused else [])
        attrs = {**attrs, "act": "relu"} if fused else attrs
        (got,) = get_impl(op, "cuda")(args, attrs)
        (want,) = get_impl(op, "ref")(args, attrs)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert gemm.launches == before + len(cases)


# ---- the sharded attention kernel and the per-expert GEMM (csrc/flash_attention.cu,
# csrc/gemm.cu batched_gemm_f32): rows bitwise across the batch, the chunk
# split, shard and tile edges and M

def _dense_to_pages(k, page):
    """A dense cache (B, S, Hk, D) as pages (B*S/page, page, Hk, D) and the
    identity block tables (B, S/page)."""
    b, s = k.shape[:2]
    tables = torch.arange(b * s // page, dtype=torch.int32, device=k.device).reshape(b, -1)
    return k.reshape(b * s // page, page, *k.shape[2:]), tables


@pytest.mark.gpu
@pytest.mark.parametrize("hq,hk,d", [(8, 8, 96), (8, 2, 128), (4, 1, 256)])
def test_chunk_attention_rows_do_not_depend_on_the_batch_or_the_chunk(hq, hk, d):
    """phi3's engine chunk shape and two GQA ones at S = 1024 (four shards):
    a row has the same bits at B = 1 and B = 4, computed in one T = 64 chunk
    or in two (T = 17 then 47) at the same positions, and through fp32
    pages; starts put rows on both sides of the shard and tile edges."""
    dev = _card()
    from repro_torch.kernels.flash_attention import (attention_shard_cols,
                                                     flash_chunk_attention,
                                                     flash_chunk_attention_plain,
                                                     flash_paged_chunk_attention)
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    rn = _rn(gen, dev)
    s, t = 1024, 64
    sh = attention_shard_cols(s)
    assert sh < s
    starts = [sh - 1 - 17, sh - 40, 2 * sh - 1, 0]
    q, k, v = rn(4, t, hq, d), rn(4, s, hk, d), rn(4, s, hk, d)
    start = torch.tensor(starts, dtype=torch.int32, device=dev)
    full = flash_chunk_attention(q, k, v, start)
    torch.testing.assert_close(full, flash_chunk_attention_plain(q, k, v, start,
                                                                 1 / math.sqrt(d)), **TOL)
    for i in range(4):
        one = flash_chunk_attention(q[i:i + 1].contiguous(), k[i:i + 1].contiguous(),
                                    v[i:i + 1].contiguous(), start[i:i + 1].contiguous())
        assert torch.equal(one, full[i:i + 1]), i
    head = flash_chunk_attention(q[:, :17].contiguous(), k, v, start)
    tail = flash_chunk_attention(q[:, 17:].contiguous(), k, v, start + 17)
    assert torch.equal(torch.cat([head, tail], dim=1), full)
    pk, tables = _dense_to_pages(k, 16)
    pv, _ = _dense_to_pages(v, 16)
    assert torch.equal(flash_paged_chunk_attention(q, pk, pv, tables, start), full)


@pytest.mark.gpu
def test_chunk_attention_rows_at_shard_and_tile_edges():
    """Every position within one row of a 64-column tile edge or a shard
    edge, and position 0 (one column): its row computed inside a T = 1024
    chunk from 0 and inside T = 64 chunks starting at, before and after the
    edge has the same bits."""
    dev = _card()
    from repro_torch.kernels.flash_attention import attention_shard_cols, flash_chunk_attention
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    rn = _rn(gen, dev)
    s, hq, hk, d = 1024, 4, 1, 96
    qall, k, v = rn(1, s, hq, d), rn(1, s, hk, d), rn(1, s, hk, d)
    ref = flash_chunk_attention(qall, k, v, torch.zeros(1, dtype=torch.int32, device=dev))
    sh = attention_shard_cols(s)
    edges = sorted({e for e in range(0, s + 1, 64)} | {e for e in range(0, s + 1, sh)})
    starts = sorted({min(max(e + off, 0), s - 64) for e in edges for off in (-64, -63, -1, 0, 1)})
    for s0 in starts:
        got = flash_chunk_attention(qall[:, s0:s0 + 64].contiguous(), k, v,
                                    torch.tensor([s0], dtype=torch.int32, device=dev))
        assert torch.equal(got, ref[:, s0:s0 + 64]), s0


@pytest.mark.gpu
@pytest.mark.parametrize("d,dv", [(96, 96), (128, 128), (256, 256), (192, 128), (96, 64)])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 512), (False, None),
                                           (False, 300)])
def test_flash_attention_widths_against_the_plain_version(d, dv, causal, window):
    """Several shards (Skv = 700 and 1024), GQA 4 and 1, Dv != D, Sq < Skv."""
    dev = _card()
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    gen = torch.Generator(device=dev)
    gen.manual_seed(d + dv)
    rn = _rn(gen, dev)
    for b, sq, skv, hq, hk in ((1, 1024, 1024, 4, 1), (2, 300, 700, 2, 2)):
        q, k, v = rn(b, sq, hq, d), rn(b, skv, hk, d), rn(b, skv, hk, dv)
        torch.testing.assert_close(
            flash_attention(q, k, v, causal=causal, window=window),
            flash_attention_plain(q, k, v, causal=causal, window=window, scale=1 / math.sqrt(d)),
            **TOL)


@pytest.mark.gpu
def test_flash_attention_rows_do_not_depend_on_the_batch_or_the_query_count():
    """gemma3-1b's prefill heads (4 on 1, D = 256) over 1024 keys, causal
    and with its 512 window: a row has the same bits at B = 1 and B = 3,
    and with fewer query rows (the last m, at the same positions), m
    putting the first row on both sides of tile and shard edges."""
    dev = _card()
    from repro_torch.kernels.flash_attention import attention_shard_cols, flash_attention
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    rn = _rn(gen, dev)
    s = 1024
    sh = attention_shard_cols(s)
    q, k, v = rn(3, s, 4, 256), rn(3, s, 1, 256), rn(3, s, 1, 256)
    for window in (None, 512):
        full = flash_attention(q, k, v, window=window)
        for i in range(3):
            one = flash_attention(q[i:i + 1].contiguous(), k[i:i + 1].contiguous(),
                                  v[i:i + 1].contiguous(), window=window)
            assert torch.equal(one, full[i:i + 1]), (window, i)
        for first in (0, 1, 63, 64, 65, sh - 1, sh, sh + 1, 3 * sh + 1, s - 1):
            part = flash_attention(q[:, first:].contiguous(), k, v, window=window)
            assert torch.equal(part, full[:, first:]), (window, first)


@pytest.mark.gpu
def test_paged_chunk_attention_over_shards_matches_its_plain_version():
    """int8 pages (scrambled tables, junk entries, an all-zero page) over
    four shards, against the plain version; fp32 pages bitwise equal to the
    dense kernel."""
    dev = _card()
    from repro_torch.kernels.flash_attention import (flash_chunk_attention,
                                                     flash_paged_chunk_attention,
                                                     flash_paged_chunk_attention_plain)
    from repro_torch.kernels.flash_decode import gather_pages
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    page, mp = 16, 64
    start = torch.tensor([640, 320, 64, 0], dtype=torch.int32, device=dev)
    filled = start + 64
    for quant in (False, True):
        _, pk, pv, tables, sc = _paged_inputs(gen, dev, b=4, hq=8, hk=8, d=96, dv=96,
                                              page=page, mp=mp, quant=quant, lengths=filled)
        q = torch.randn(4, 64, 8, 96, generator=gen, device=dev)
        got = flash_paged_chunk_attention(q, pk, pv, tables, start, **sc)
        torch.testing.assert_close(got, flash_paged_chunk_attention_plain(
            q, pk, pv, tables, start, 1 / math.sqrt(96), sc.get("k_scales"),
            sc.get("v_scales")), **TOL)
        if not quant:
            assert torch.equal(got, flash_chunk_attention(
                q, gather_pages(pk, tables), gather_pages(pv, tables), start))


@pytest.mark.gpu
def test_batched_gemm_rows_across_m_variant_and_tile_equal_gemm():
    """qwen2's expert shapes: a row of expert e has the same bits at every M
    (skinny at 1, 8, 16; tiled 32x64 at 17, 32, 80; 128x128 at 128 with 64
    experts) and equals gemm's row of x[e] @ w[e]."""
    dev = _card()
    from repro_torch.kernels.gemm import (batched_gemm, batched_gemm_plain, gemm, gemm_tile,
                                          gemm_variant)
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    rn = _rn(gen, dev)
    assert gemm_tile(128, 1408, 64) == (128, 128) and gemm_tile(80, 1408, 64) == (32, 64)
    for kk, nn in ((2048, 1408), (1408, 2048)):
        x, w = rn(64, 128, kk), rn(64, kk, nn) / math.sqrt(kk)
        full = batched_gemm(x, w)
        torch.testing.assert_close(full, batched_gemm_plain(x, w), rtol=1e-4, atol=1e-4)
        for e in (0, 37, 63):
            assert torch.equal(full[e], gemm(x[e].contiguous(), w[e].contiguous()))
        for m in (1, 8, 16, 17, 32, 80):
            assert gemm_variant(m) == ("skinny" if m <= 16 else "tiled")
            assert torch.equal(batched_gemm(x[:, :m].contiguous(), w), full[:, :m]), (kk, m)


@pytest.mark.gpu
def test_every_launch_counter_moves_once_per_launch():
    dev = _card()
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ssd
    from repro_torch.kernels.gemm import batched_gemm, gemm
    from repro_torch.kernels.rmsnorm import rmsnorm
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    rn = _rn(gen, dev)
    lengths = torch.tensor([300, 0], dtype=torch.int32, device=dev)
    start = torch.tensor([250, 0], dtype=torch.int32, device=dev)
    q1, q8 = rn(2, 4, 64), rn(2, 8, 4, 64)
    k, v = rn(2, 512, 2, 64), rn(2, 512, 2, 64)
    pk, tables = _dense_to_pages(k, 16)
    pv, _ = _dense_to_pages(v, 16)
    _, qk, qv, qtables, sc = _paged_inputs(gen, dev, b=2, hq=4, hk=2, d=64, dv=64, page=16,
                                           mp=32, quant=True, lengths=start + 8)
    calls = [
        (gemm, lambda: gemm(rn(4, 64), rn(64, 32))),
        (rmsnorm, lambda: rmsnorm(rn(4, 64), rn(64))),
        (fd.flash_decode, lambda: fd.flash_decode(q1, k, v, lengths)),
        (fd.flash_paged_decode, lambda: fd.flash_paged_decode(q1, pk, pv, tables, lengths)),
        (fd.flash_decode_partial,
         lambda: fd.flash_decode_partial(q1, k, v, lengths, n_splits=2)),
        (fd.combine_partials,
         lambda: fd.combine_partials(*fd.flash_decode_partial(q1, k, v, lengths, n_splits=2))),
        (fa.flash_chunk_attention, lambda: fa.flash_chunk_attention(q8, k, v, start)),
        (fa.flash_paged_chunk_attention,
         lambda: fa.flash_paged_chunk_attention(q8, pk, pv, tables, start)),
        (fa.flash_paged_chunk_attention,
         lambda: fa.flash_paged_chunk_attention(q8, qk, qv, qtables, start, **sc)),
        (fa.flash_attention, lambda: fa.flash_attention(rn(1, 300, 4, 64), rn(1, 300, 2, 64),
                                                        rn(1, 300, 2, 64), window=100)),
        (batched_gemm, lambda: batched_gemm(rn(4, 5, 64), rn(4, 64, 32))),
        (batched_gemm, lambda: batched_gemm(rn(4, 40, 64), rn(4, 64, 32))),
        (ssd.ssd_scan, lambda: ssd.ssd_scan(rn(1, 32, 2, 16),
                                            torch.nn.functional.softplus(rn(1, 32, 2)),
                                            -torch.ones(2, device=dev), rn(1, 32, 1, 8),
                                            rn(1, 32, 1, 8), chunk=16)),
    ]
    for kern, call in calls:
        before = kern.launches
        call()
        assert kern.launches == before + 1, kern.__name__
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_attention_kernels_at_widths_off_the_float4_groups():
    """D = 6 and Dv = 10 take the 4-byte copies (and int8 pages the
    element-by-element loads) over two shards: each kernel against its plain
    version, fp32 pages bitwise equal to the dense kernel."""
    dev = _card()
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.flash_decode import gather_pages
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    rn = _rn(gen, dev)
    d, dv, page, mp = 6, 10, 16, 20
    q, k, v = rn(2, 300, 4, d), rn(2, 300, 2, d), rn(2, 300, 2, dv)
    for causal, window in ((True, None), (False, 70)):
        torch.testing.assert_close(
            fa.flash_attention(q, k, v, causal=causal, window=window),
            fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=1 / math.sqrt(d)), **TOL)
    start = torch.tensor([250, 0], dtype=torch.int32, device=dev)
    qc = rn(2, 16, 4, d)
    for quant in (False, True):
        _, pk, pv, tables, sc = _paged_inputs(gen, dev, b=2, hq=4, hk=2, d=d, dv=dv,
                                              page=page, mp=mp, quant=quant, lengths=start + 16)
        got = fa.flash_paged_chunk_attention(qc, pk, pv, tables, start, **sc)
        torch.testing.assert_close(got, fa.flash_paged_chunk_attention_plain(
            qc, pk, pv, tables, start, 1 / math.sqrt(d), sc.get("k_scales"),
            sc.get("v_scales")), **TOL)
        if not quant:
            kd, vd = gather_pages(pk, tables), gather_pages(pv, tables)
            dense = fa.flash_chunk_attention(qc, kd, vd, start)
            assert torch.equal(got, dense)
            torch.testing.assert_close(dense, fa.flash_chunk_attention_plain(
                qc, kd, vd, start, 1 / math.sqrt(d)), **TOL)


def _ssd_inputs(rn, dev, b, s, h, p, g, n):
    """mamba2-like inputs: dt ~ softplus(N(0,1) - 3), A in [-16, -1]."""
    return (rn(b, s, h, p), torch.nn.functional.softplus(rn(b, s, h) - 3.0),
            -torch.linspace(1.0, 16.0, h, device=dev), 0.3 * rn(b, s, g, n),
            0.3 * rn(b, s, g, n), rn(h))


@pytest.mark.gpu
@pytest.mark.parametrize("n_chunks", [1, 2, 5, 8])
def test_ssd_sequences_are_bitwise_alone_at_mamba2_width(n_chunks):
    """mamba2-370m's widths (H = 32, P = 64, G = 1, N = 128, Q = 128): each
    sequence of a B = 3 call is the same bits as that sequence alone (the
    others hold other data); y and the final state within 1e-4 of the plain
    version."""
    dev = _card()
    from repro_torch.kernels.ssd import ssd_scan, ssd_scan_plain
    gen = torch.Generator(device=dev)
    gen.manual_seed(18 + n_chunks)
    x, dt, A, B, C, D = _ssd_inputs(_rn(gen, dev), dev, 3, 128 * n_chunks, 32, 64, 1, 128)
    y, st = ssd_scan(x, dt, A, B, C, D)
    yp, stp = ssd_scan_plain(x, dt, A, B, C, D)
    torch.testing.assert_close(y, yp, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(st, stp, rtol=1e-4, atol=1e-4)
    for i in range(3):
        sl = slice(i, i + 1)
        y1, st1 = ssd_scan(x[sl], dt[sl], A, B[sl].contiguous(), C[sl].contiguous(), D)
        assert torch.equal(y1, y[sl]) and torch.equal(st1, st[sl]), i


@pytest.mark.gpu
def test_ssd_widths_off_the_tiles_and_the_float4_groups():
    """P = 72 and N = 70 (two tiles each, the second ragged), P = 6 and N =
    5 (4-byte copies), Q = 37 (off the 32-step contraction and the 64-row
    tile), G = 3: against the plain version, with and without D."""
    dev = _card()
    from repro_torch.kernels.ssd import ssd_scan, ssd_scan_plain
    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    rn = _rn(gen, dev)
    for b, s, h, p, g, n, q in ((2, 256, 2, 72, 1, 70, 128), (1, 60, 2, 6, 1, 5, 20),
                                (2, 111, 6, 16, 3, 32, 37)):
        x, dt, A, B, C, D = _ssd_inputs(rn, dev, b, s, h, p, g, n)
        for d in (None, D):
            for got, want in zip(ssd_scan(x, dt, A, B, C, d, chunk=q),
                                 ssd_scan_plain(x, dt, A, B, C, d, chunk=q)):
                torch.testing.assert_close(got, want, **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 3, 1152, 2048, 3072, 7168])
@pytest.mark.parametrize("residual", [False, True])
def test_rmsnorm_rows_do_not_depend_on_the_row_count(d, residual):
    """A row is the same bits in a 1-row and a 1024-row call (the layout is a
    function of D alone), and within 1e-5 of the plain version."""
    dev = _card()
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain
    gen = torch.Generator(device=dev)
    gen.manual_seed(d)
    rn = _rn(gen, dev)
    x, w = rn(1024, d), 1.0 + 0.1 * rn(d)
    r = rn(1024, d) if residual else None
    full = rmsnorm(x, w, residual=r)
    torch.testing.assert_close(full, rmsnorm_plain(x, w, residual=r), rtol=1e-5, atol=1e-5)
    for i in (0, 517, 1023):
        one = rmsnorm(x[i:i + 1], w, residual=None if r is None else r[i:i + 1])
        assert torch.equal(one, full[i:i + 1]), i


@pytest.mark.gpu
def test_ssd_and_rmsnorm_count_one_launch_per_call():
    """ssd_scan's three kernels are one launch of its counter; rmsnorm's
    counter moves once per call whatever path (float4 or element by element,
    registers or the second read past D = 8192) the kernel takes; an empty
    call launches nothing."""
    dev = _card()
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.ssd import ssd_scan
    gen = torch.Generator(device=dev)
    gen.manual_seed(20)
    rn = _rn(gen, dev)
    x, dt, A, B, C, D = _ssd_inputs(rn, dev, 2, 256, 4, 64, 1, 128)
    before = ssd_scan.launches
    ssd_scan(x, dt, A, B, C, D)
    ssd_scan(x, dt, A, B, C)
    assert ssd_scan.launches == before + 2
    before = rmsnorm.launches
    for d in (3, 64, 9000):
        rmsnorm(rn(5, d), rn(d), residual=rn(5, d))
    rmsnorm(rn(0, 64), rn(64))
    assert rmsnorm.launches == before + 3
    _cuda.empty_launch(x)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_refused_launches_and_inputs_raise():
    """A launch the runtime refuses (65536 sequences: past the grid's z limit)
    raises, with nothing counted; so do inputs the kernels do not take."""
    dev = _card()
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.ssd import ssd_scan
    x, dt, A = torch.zeros(65536, 1, 1, 4, device=dev), torch.zeros(65536, 1, 1, device=dev), \
        torch.zeros(1, device=dev)
    bc = torch.zeros(65536, 1, 1, 4, device=dev)
    before = ssd_scan.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        ssd_scan(x, dt, A, bc, bc)
    assert ssd_scan.launches == before
    with pytest.raises(TypeError, match="float32"):
        ssd_scan(x[:2], dt[:2], A, bc[:2], bc[:2], torch.zeros(1, device=dev, dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        rmsnorm(torch.zeros(8, 6, device=dev).t(), torch.ones(8, device=dev))
    with pytest.raises(ValueError, match="CUDA device"):
        rmsnorm(torch.zeros(2, 8, device=dev), torch.ones(8, device=dev),
                residual=torch.zeros(2, 8))
    torch.cuda.synchronize()


# --------------------------------------------------------------------------- #
# speculative verify and int8 weights on the card
# --------------------------------------------------------------------------- #

def _verify_case(rn, dev, op, b, t, d=96, hq=8, hk=4, n=40, p=16, mp=8):
    """One verify op's inputs at T = t: starts 0, mid-page and reaching past
    the last page (the patched rows beyond the cache are dropped)."""
    start = torch.tensor([0, 37, mp * p - t + 1, 5][:b], dtype=torch.int32, device=dev)
    q = rn(b, t, hq, d)
    if op == "verify_attention":
        return [q, rn(b, mp * p, hk, d), rn(b, mp * p, hk, d), start]
    tables = torch.stack([torch.randperm(n, device=dev)[:mp] for _ in range(b)]).int()
    if op == "paged_verify_attention":
        return [q, rn(n, p, hk, d), rn(n, p, hk, d), tables, start]
    pk = torch.randint(-127, 128, (n, p, hk, d), device=dev, dtype=torch.int8)
    pv = torch.randint(-127, 128, (n, p, hk, d), device=dev, dtype=torch.int8)
    return [q, pk, rn(n, hk).abs() * 0.02, pv, rn(n, hk).abs() * 0.02, tables, start,
            rn(b, t, hk, d), rn(b, t, hk, d)]


VERIFY_OPS = ["verify_attention", "paged_verify_attention", "paged_verify_attention_q"]


@pytest.mark.gpu
@pytest.mark.parametrize("op", VERIFY_OPS)
@pytest.mark.parametrize("t", [2, 3, 4, 5])
def test_verify_ops_cuda_match_their_plain_versions(op, t):
    """The verify ops' ``cuda`` backends (the chunk and paged chunk kernels
    at T = spec_k + 1) against their ``ref`` backends on the card."""
    dev = _card()
    import repro_torch  # noqa: F401
    from repro_torch.core.registry import get_impl
    from repro_torch.kernels.flash_attention import (flash_chunk_attention,
                                                     flash_paged_chunk_attention)
    gen = torch.Generator(device=dev)
    gen.manual_seed(30 + t)
    torch.manual_seed(t)
    inputs = _verify_case(_rn(gen, dev), dev, op, 4, t)
    kern = flash_paged_chunk_attention if op == "paged_verify_attention" \
        else flash_chunk_attention
    before = kern.launches
    for scale in (None, 0.0):
        (got,) = get_impl(op, "cuda")(inputs, {"scale": scale})
        (want,) = get_impl(op, "ref")(inputs, {"scale": scale})
        torch.testing.assert_close(got, want, **TOL)
    assert kern.launches == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("op", VERIFY_OPS)
def test_verify_rows_are_bitwise_the_same_at_b1_and_b4(op):
    dev = _card()
    import repro_torch  # noqa: F401
    from repro_torch.core.registry import get_impl
    gen = torch.Generator(device=dev)
    gen.manual_seed(40)
    torch.manual_seed(40)
    inputs = _verify_case(_rn(gen, dev), dev, op, 4, 4)
    (full,) = get_impl(op, "cuda")(inputs, {})
    batch_args = {0, 5, 6, 7, 8} if op == "paged_verify_attention_q" else \
        ({0, 3, 4} if op == "paged_verify_attention" else {0, 1, 2, 3})
    for b in range(4):
        one = [x[b:b + 1].contiguous() if i in batch_args else x for i, x in enumerate(inputs)]
        (row,) = get_impl(op, "cuda")(one, {})
        assert torch.equal(row[0], full[b]), b


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["dense_q", "dense_fused_q", "conv2d_q", "conv2d_fused_q"])
@pytest.mark.parametrize("static", [True, False])
def test_quantized_ref_on_the_card_equals_the_cpu_bitwise(op, static):
    """The integer oracle accumulates in float64 on the card (no tensor
    leaves it): exact, so its output equals the CPU's bit for bit, at
    phi3-mini's widest K (8192) for dense."""
    dev = _card()
    import repro_torch  # noqa: F401
    from repro_torch.core.quant import quantize_weight
    from repro_torch.core.registry import get_impl
    g = torch.Generator().manual_seed(50)
    dense = op.startswith("dense")
    x = torch.randn((4, 8192) if dense else (2, 14, 14, 64), generator=g)
    w = torch.randn((8192, 96) if dense else (3, 3, 64, 32), generator=g) * 0.02
    w_q, w_s = quantize_weight(w, 1 if dense else 3)
    attrs = {"w_scale": w_s, "zero_point": 0, "act": "relu"}
    if not dense:
        attrs["padding"] = "SAME"
    if static:
        attrs["x_scale"] = float(x.abs().max()) * 0.8 / 127
    cpu_in = [x, w_q] + ([torch.randn(w_q.shape[-1], generator=g)] if "fused" in op else [])
    attrs_dev = dict(attrs, w_scale=w_s.to(dev))
    (want,) = get_impl(op, "ref")(cpu_in, attrs)
    (got,) = get_impl(op, "ref")([t.to(dev) for t in cpu_in], attrs_dev)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_weight_quantization_on_the_card_equals_numpy_bitwise():
    """quantize_weight of a tensor on the card: the same int8 weights and
    scales as the numpy path (true divisions, round half to even)."""
    dev = _card()
    from repro_torch.core.quant import quantize_weight
    w = np.random.default_rng(51).standard_normal((3072, 8192)).astype(np.float32)
    w[:, 7] = 0.0
    q_np, s_np = quantize_weight(w, 1)
    q_t, s_t = quantize_weight(torch.from_numpy(w).to(dev), 1)
    assert np.array_equal(q_t.cpu().numpy(), q_np)
    assert s_t.cpu().numpy().tobytes() == s_np.tobytes()


# --------------------------------------------------------------------------- #
# self-healing on the card
# --------------------------------------------------------------------------- #

def _tiny_serving(dev, **kw):
    from repro_torch.models.graph_lm import GraphLMConfig
    from repro_torch.runtime.engine import build_lm_serving
    cfg = GraphLMConfig(vocab=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=96)
    return build_lm_serving(cfg, **{"n_slots": 3, "chunk": 8, "cache_cap": 48, **kw},
                            device=dev)


def _tiny_requests(n=5):
    from repro_torch.runtime.engine import EngineRequest
    rng = np.random.default_rng(3)
    return [EngineRequest(uid=i, prompt=rng.integers(0, 97, int(rng.integers(3, 20)))
                          .astype(np.int32), max_new_tokens=6) for i in range(n)]


@pytest.mark.gpu
def test_relocate_slots_on_the_card_is_bitwise():
    """A swapped pair and a chain of per-slot cache rows on CUDA tensors:
    every source is gathered before any destination is written."""
    dev = _card()
    engine, _ = _tiny_serving(dev, n_slots=4)
    st = engine.stepper
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    for name in st.caches:
        st.caches[name] = torch.randn(st.caches[name].shape, generator=gen, device=dev)
    before = {k: v.clone() for k, v in st.caches.items()}
    st.relocate_slots([(0, 1), (1, 0)])
    st.relocate_slots([(1, 2), (2, 3), (3, 1)])
    for k, v in st.caches.items():
        b = before[k]
        # after the swap slot 0 holds 1's rows and 1 holds 0's; the chain
        # then moves 1 -> 2, 2 -> 3, 3 -> 1
        for slot, src in ((0, 1), (2, 0), (3, 2), (1, 3)):
            assert torch.equal(v[slot], b[src]), (k, slot)


@pytest.mark.gpu
def test_a_device_overrun_in_draft_prefill_is_charged_to_its_own_call():
    """draft_prefill reads nothing back, so its device work is still queued
    when it returns.  A device spin queued inside it overruns the hang
    deadline; the guard waits for the card, so the overrun is caught in
    draft_prefill's own guarded call and tick, not in the next call's host
    read — and the run heals token-exact."""
    dev = _card()
    want = {}
    engine, _ = _tiny_serving(dev, spec_k=3)
    for r in _tiny_requests():
        assert engine.submit(r)
        want[r.uid] = r
    engine.run()
    engine, _ = _tiny_serving(dev, spec_k=3, self_heal=True, hang_timeout=0.5)
    st = engine.stepper
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    cycles = int(10_000_000 * 1.0e3 / start.elapsed_time(end))   # ~1 s of spinning
    calls, spun, charged = [0], [], []
    draft_prefill = st.draft_prefill

    def spinning(*args):
        calls[0] += 1
        if calls[0] == 2:
            spun.append(engine.tick)
            out = draft_prefill(*args)
            torch.cuda._sleep(cycles)
            return out
        return draft_prefill(*args)

    st.draft_prefill = spinning
    guarded = engine._guarded_call

    def tracked(fn, *args):
        try:
            return guarded(fn, *args)
        except Exception:
            charged.append((engine.tick, fn.__name__))
            raise

    engine._guarded_call = tracked
    reqs = _tiny_requests()
    for r in reqs:
        assert engine.submit(r)
    engine.run()
    assert charged == [(spun[0], "spinning")]
    assert engine.metrics.n_hang_failures == 1 and engine.metrics.n_crash_failures == 0
    for r in reqs:
        assert r.done and r.out_tokens == want[r.uid].out_tokens


@pytest.mark.gpu
def test_small_paged_engine_heals_from_a_real_out_of_memory_error():
    """An allocation larger than the card's free memory inside a decode call
    raises torch.cuda.OutOfMemoryError, which leaves the context usable: the
    tick is discarded and the paged engine resumes from its pages with the
    uninterrupted run's tokens."""
    dev = _card()
    want = {}
    engine, _ = _tiny_serving(dev, paged=True, page_size=8)
    for r in _tiny_requests():
        assert engine.submit(r)
        want[r.uid] = r
    engine.run()
    engine, _ = _tiny_serving(dev, paged=True, page_size=8, self_heal=True)
    st = engine.stepper
    calls, decode = [0], st.decode

    def oom(*args):
        calls[0] += 1
        out = decode(*args)
        if calls[0] == 3:
            free, total = torch.cuda.mem_get_info(dev)
            torch.empty(total, dtype=torch.uint8, device=dev)
        return out

    st.decode = oom
    reqs = _tiny_requests()
    for r in reqs:
        assert engine.submit(r)
    engine.run()
    assert engine.metrics.n_crash_failures == 1 and engine.metrics.recovered_rows > 0
    st.pool.check_integrity()
    assert st.pool.live_sequences == 0
    for r in reqs:
        assert r.done and r.out_tokens == want[r.uid].out_tokens


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["decode", "prefill"])
@pytest.mark.parametrize("quantize", [None, "int8"], ids=["fp32", "int8"])
def test_bundle_round_trip_on_the_card_is_bitwise(kind, quantize, tmp_path):
    """A Program on the card saved to an OXF bundle and loaded back on the
    card: ``pallas`` pinned where it ran ``cuda``, the same assignment, and
    every output equal bit for bit on the same inputs."""
    dev = _card()
    import json
    from repro_torch.core import compile, load_program
    from repro_torch.models import graph_lm as glm
    cfg = glm.GraphLMConfig(vocab=61, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
                            d_ff=64)
    params = glm.params_from_numpy(glm.init_lm_params(cfg, 0), dev)
    if kind == "decode":
        g, t = glm.build_decode_graph(cfg, params, batch=2, cache_cap=16), 1
    else:
        g, t = glm.build_prefill_graph(cfg, params, batch=2, chunk=4, cache_cap=16), 4
    prog = compile(g, quantize=quantize, device=dev)
    prog.save(str(tmp_path))
    with open(tmp_path / "model.json") as f:
        pins = {nd["name"]: nd["backend"] for nd in json.load(f)["nodes"]}
    assert pins == {n: {"cuda": "pallas"}.get(b, b) for n, b in prog.assignment.items()}
    loaded = load_program(str(tmp_path))
    assert loaded.device.type == "cuda" and loaded.assignment == prog.assignment
    rng = np.random.default_rng(5)
    feed = {"tokens": rng.integers(0, 61, (2, t)).astype(np.int32),
            "start": np.asarray([3, 0], np.int32), "n_new": np.asarray([t, 1], np.int32)}
    for i in range(cfg.n_layers):
        for kv in "kv":
            feed[f"cache_{kv}{i}"] = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    for a, b in zip(prog(**feed), loaded(**feed)):
        assert a.is_cuda and torch.equal(a, b)


@pytest.mark.gpu
def test_golden_bundle_on_the_card_gives_expected_y(tmp_path):
    """tests/golden/tiny_int8 (pinned ``xla``: ``torch`` in the port) on the
    card reproduces ``expected_y`` (rtol 1e-5, atol 1e-6, as the JAX
    package's golden test) and re-saves byte-identically."""
    import os
    from repro_torch.core import load_program
    _card()
    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "tiny_int8")
    prog = load_program(golden)
    assert set(prog.assignment.values()) == {"torch"}
    x = np.load(os.path.join(golden, "input_x.npy"))
    y = prog(x=x)[0]
    assert y.is_cuda
    np.testing.assert_allclose(y.cpu().numpy(), np.load(os.path.join(golden, "expected_y.npy")),
                               rtol=1e-5, atol=1e-6)
    prog.save(str(tmp_path))
    for name in ("model.json", "program.json"):
        with open(os.path.join(golden, name), "rb") as a, open(tmp_path / name, "rb") as b:
            assert a.read() == b.read(), name


# --------------------------------------------------------------------------- #
# tensor-parallel serving: two ranks on cuda:0 over gloo (one spawn)
# --------------------------------------------------------------------------- #

# phi3-mini's attention at the engine's shapes: (op, B, T, S or pool, lengths or starts)
TP_CARD_OPS = ("decode_attention", "chunk_attention", "paged_decode_attention",
               "paged_chunk_attention", "paged_decode_attention_q",
               "paged_chunk_attention_q", "paged_verify_attention_q")


def _tp_card_inputs(op, dev, gen):
    b, hq, hk, d, s, page, t = 4, 32, 32, 96, 1024, 16, 64
    rn = _rn(gen, dev)
    decode = "decode" in op
    q = rn(b, hq, d) if decode else rn(b, 4 if "verify" in op else t, hq, d)
    pos = torch.tensor([731, 400, 129, 1] if decode else [640, 320, 64, 0], dtype=torch.int32,
                       device=dev)
    if not op.startswith("paged"):
        return [q, rn(b, s, hk, d), rn(b, s, hk, d), pos]
    n, mp = b * (s // page), s // page
    tables = torch.randperm(n, generator=gen, device=dev)[:b * mp].view(b, mp).int()
    if not op.endswith("_q"):
        return [q, rn(n, page, hk, d), rn(n, page, hk, d), tables, pos]
    pk = torch.randint(-127, 128, (n, page, hk, d), generator=gen, device=dev).to(torch.int8)
    pv = torch.randint(-127, 128, (n, page, hk, d), generator=gen, device=dev).to(torch.int8)
    ks, vs = rn(n, hk).abs() * 0.01, rn(n, hk).abs() * 0.01
    ins = [q, pk, ks, pv, vs, tables, pos]
    if "verify" in op:
        ins += [rn(b, 4, hk, d), rn(b, 4, hk, d)]
    return ins


def _tp_card_rank():
    """A rank of the card TP checks: each tp backend against the single-rank
    kernels bitwise, tree decode against flash_decode, the ring matmul (its
    chunks staged through the host over gloo) against the whole product."""
    from repro_torch.core.registry import get_impl
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_partial
    from repro_torch.kernels.gemm import gemm, gemm_plain
    from repro_torch.kernels.serving_ops import _TP_LAYOUT, serving_mesh, tp_slice
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.sharding.collectives import ring_allgather_matmul, tree_decode_attention
    mesh = make_serving_mesh(2, device="cuda:0")
    dev = mesh.device
    out = {"backend": mesh.backend, "device": str(dev), "ops": {}, "tree": []}
    gen = torch.Generator(device=dev)
    for i, op in enumerate(TP_CARD_OPS):
        gen.manual_seed(i)
        full = _tp_card_inputs(op, dev, gen)
        single = get_impl(op, "cuda")(full, {"scale": None})[0]
        local = list(full)
        for idx, dim in _TP_LAYOUT[op][1]:
            local[idx] = tp_slice(full[idx], dim, mesh)
        with serving_mesh(mesh):
            got = get_impl(op, "tp")(local, {"scale": None})[0]
        out["ops"][op] = (got.is_cuda, bool(torch.equal(got, single)),
                          float((got - single).abs().max()))
    for b, hq, hk, d, s, lens in ((4, 32, 32, 96, 1024, (731, 400, 129, 0)),
                                  (4, 4, 1, 256, 2048, (1400, 1000, 600, 250))):
        gen.manual_seed(s)
        rn = _rn(gen, dev)
        q, k, v = rn(b, hq, d), rn(b, s, hk, d), rn(b, s, hk, d)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        rows = slice(mesh.rank * s // 2, (mesh.rank + 1) * s // 2)
        before = flash_decode_partial.launches
        k_loc, v_loc = k[:, rows].contiguous(), v[:, rows].contiguous()
        got = tree_decode_attention(mesh, q, k_loc, v_loc, lengths)
        out["tree"].append((float((got - flash_decode(q, k, v, lengths)).abs().max()),
                            flash_decode_partial.launches - before))
        plain = tree_decode_attention(mesh, q, k_loc, v_loc, lengths, backend="ref")
        out.setdefault("tree_vs_ref", []).append((hk, float((got - plain).abs().max())))
    # phi3-mini's decode gate/up product, 4 rows a rank
    gen.manual_seed(7)
    rn = _rn(gen, dev)
    x, w = rn(8, 3072), rn(3072, 8192) / 3072 ** 0.5
    before = gemm.launches
    got = ring_allgather_matmul(mesh, x[mesh.rank * 4:(mesh.rank + 1) * 4].contiguous(), w)
    want = gemm_plain(x, w)
    out["ring"] = (str(got.device), gemm.launches - before,
                   bool(((got - want).abs() <= 1e-4 + 1e-4 * want.abs()).all()),
                   float((got - want).abs().max()))
    return out


@pytest.fixture(scope="module")
def tp_card_run():
    _card()
    from repro_torch.launch.mesh import spawn_ranks
    return spawn_ranks(_tp_card_rank, 2, timeout=300)


@pytest.mark.gpu
@pytest.mark.parametrize("op", TP_CARD_OPS)
def test_tp_backends_on_the_card_equal_the_single_rank_kernels(op, tp_card_run):
    """Two ranks on cuda:0 over gloo, 16 of phi3-mini's 32 heads each: the
    tp backend's gathered output is bitwise the single-rank kernels'."""
    for r in tp_card_run:
        assert (r["backend"], r["device"]) == ("gloo", "cuda:0")
        on_card, equal, err = r["ops"][op]
        assert on_card and equal, (op, err)


@pytest.mark.gpu
def test_tree_decode_on_the_card_is_within_1e4_of_flash_decode(tp_card_run):
    for r in tp_card_run:
        for err, launched in r["tree"]:
            assert err <= 1e-4 and launched == 1, (err, launched)


@pytest.mark.gpu
def test_tree_decode_cuda_is_within_1e5_of_ref_at_gemma3_global(tp_card_run):
    """Two ranks, each on its half of gemma3-1b's global-layer cache (Hq 4,
    Hk 1, D 256, S 2048, lengths 1400 / 1000 / 600 / 250): the merge of the
    partial kernel's shards against the merge of their plain versions —
    the sharded decode of the mesh serve step."""
    for r in tp_card_run:
        errs = dict(r["tree_vs_ref"])
        assert errs[1] <= 1e-5, errs


@pytest.mark.gpu
def test_ring_allgather_matmul_on_the_card_equals_the_whole_product(tp_card_run):
    """gloo takes no point-to-point op on CUDA tensors: the ring's chunks
    travel through host memory, and each rank's two products run the gemm
    kernel on the card."""
    for r in tp_card_run:
        device, launched, close, err = r["ring"]
        assert device == "cuda:0" and launched == 2 and close, r["ring"]


# --------------------------------------------------------------------------- #
# the three config families of the last serving slice: MLA's wide decode,
# the encoder-decoder's attention shapes, zamba2's scan
# --------------------------------------------------------------------------- #

@pytest.mark.gpu
def test_wide_decode_matches_plain_and_rows_do_not_depend_on_the_batch():
    """deepseek-v2-lite's absorbed decode: 16 query heads on 1 KV head, D 576
    (latent + rope), Dv 512 (the latent, a view of the same cache rows in the
    model; a copy here), S 2048, scale 1 / sqrt(192): the dense kernel's wide
    layout within 1e-4 of the plain version, lengths on and off the shard
    edges and 0, and each sequence of batch 4 bitwise the same alone; the
    partial kernel at the same shape; the paged kernel refuses it."""
    dev = _card()
    from repro_torch.kernels.flash_decode import (decode_shard_rows, flash_decode,
                                                  flash_decode_partial,
                                                  flash_decode_partial_plain,
                                                  flash_decode_plain, flash_paged_decode)
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    rn = _rn(gen, dev)
    s, sc = 2048, 1 / math.sqrt(192)
    sh = decode_shard_rows(s)
    for lens in ([1400, 1000, 600, 250], [0, 1, sh + 1, s]):
        b = len(lens)
        q, ckv, kpe = rn(b, 16, 576), rn(b, s, 512), rn(b, s, 64)
        k = torch.cat([ckv, kpe], -1)[:, :, None, :]
        v = ckv[:, :, None, :]
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        launches = flash_decode.launches
        full = flash_decode(q, k, v, lengths, scale=sc)
        assert flash_decode.launches == launches + 1
        torch.testing.assert_close(full, flash_decode_plain(q, k, v, lengths, sc),
                                   rtol=1e-4, atol=1e-4)
        if 0 in lens:
            assert float(full[lens.index(0)].abs().max()) == 0.0
        for i in range(b):
            sl = slice(i, i + 1)
            one = flash_decode(q[sl].contiguous(), k[sl].contiguous(), v[sl].contiguous(),
                               lengths[sl].contiguous(), scale=sc)
            assert torch.equal(one, full[sl]), (lens, i)
    acc, m, l = flash_decode_partial(q, k, v, lengths, scale=sc, n_splits=4)
    for got, want in zip((acc, m, l), flash_decode_partial_plain(q, k, v, lengths, sc, 4)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    page = 16
    pk = k.reshape(b * s // page, page, 1, 576)
    pv = v.reshape(b * s // page, page, 1, 512)
    tables = torch.arange(b * s // page, dtype=torch.int32, device=dev).reshape(b, s // page)
    with pytest.raises(ValueError, match="unsupported"):
        flash_paged_decode(q, pk, pv, tables, lengths)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [
    (2, 64, 1024, 16, 16, 64, 64, False),    # seamless cross: 64 decoder rows over 1024 frames
    (1, 1024, 1024, 16, 16, 64, 64, False),  # seamless encoder
    (1, 512, 512, 16, 16, 192, 128, True),   # deepseek MLA prefill (D != Dv)
    (1, 512, 512, 32, 32, 112, 112, True),   # zamba2 shared attention
], ids=["cross", "encoder", "mla-prefill", "zamba2"])
def test_attention_shapes_of_the_new_families(shape):
    """Non-causal with Sq != Skv and the MLA / zamba2 widths: within 1e-4 of
    the plain version, and each sequence of a batch bitwise the same alone."""
    dev = _card()
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    b, sq, skv, hq, hk, d, dv, causal = shape
    gen = torch.Generator(device=dev)
    gen.manual_seed(sum(shape))
    rn = _rn(gen, dev)
    q, k, v = rn(b, sq, hq, d), rn(b, skv, hk, d), rn(b, skv, hk, dv)
    sc = 1 / math.sqrt(192) if d == 192 else None
    got = flash_attention(q, k, v, causal=causal, scale=sc)
    torch.testing.assert_close(got, flash_attention_plain(
        q, k, v, causal=causal, window=None, scale=sc or 1 / math.sqrt(d)),
        rtol=1e-4, atol=1e-4)
    if b > 1:
        one = flash_attention(q[:1].contiguous(), k[:1].contiguous(), v[:1].contiguous(),
                              causal=causal, scale=sc)
        assert torch.equal(one, got[:1])


@pytest.mark.gpu
def test_ssd_at_zamba2_width():
    """zamba2-7b's scan (H 112, P 64, G 1, N 64, chunk 128) over 1024 rows:
    within 1e-4 of the plain version, each sequence bitwise alone."""
    dev = _card()
    from repro_torch.kernels.ssd import ssd_scan, ssd_scan_plain
    gen = torch.Generator(device=dev)
    gen.manual_seed(112)
    x, dt, A, B, C, D = _ssd_inputs(_rn(gen, dev), dev, 2, 1024, 112, 64, 1, 64)
    y, st = ssd_scan(x, dt, A, B, C, D)
    yp, stp = ssd_scan_plain(x, dt, A, B, C, D)
    torch.testing.assert_close(y, yp, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(st, stp, rtol=1e-4, atol=1e-4)
    y1, st1 = ssd_scan(x[:1], dt[:1], A, B[:1].contiguous(), C[:1].contiguous(), D)
    assert torch.equal(y1, y[:1]) and torch.equal(st1, st[:1])


@pytest.mark.gpu
def test_mla_absorbed_products_through_batched_gemm():
    """MLA decode's per-head products, heads as experts and the batch as
    rows: E 16, M 4, 128 -> 512 (W_uk absorbed into q) and 512 -> 128
    (W_uv): within 1e-4 of bmm's plain version, and M 1 bitwise a row of
    M 4."""
    dev = _card()
    from repro_torch.kernels.gemm import batched_gemm, batched_gemm_plain
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    rn = _rn(gen, dev)
    for kk, nn in ((128, 512), (512, 128)):
        x, w = rn(16, 4, kk), rn(16, kk, nn) / math.sqrt(kk)
        got = batched_gemm(x, w)
        torch.testing.assert_close(got, batched_gemm_plain(x, w), rtol=1e-4, atol=1e-4)
        for i in range(4):
            assert torch.equal(batched_gemm(x[:, i:i + 1].contiguous(), w), got[:, i:i + 1])


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "zamba2-7b"])
def test_mla_and_hybrid_batchers_on_the_card_match_batch_one(arch):
    """Reduced deepseek-v2-lite (MLA + MoE) and zamba2 (Mamba2 + shared
    attention) under the batcher on the card: every request equals batch-1
    greedy on the card (card against CPU: chip_smoke.py phase 4)."""
    dev = _card()
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.ssd import ssd_scan
    from repro_torch.launch.serve import serving_config
    from repro_torch.models.lm import LM
    from repro_torch.runtime.batching import ContinuousBatcher, Request
    model = LM(serving_config(arch, device=dev))
    params = model.init_params(0, device=dev)
    rng = np.random.default_rng(4)
    reqs = [Request(uid=i, prompt=rng.integers(2, model.cfg.vocab, int(rng.integers(3, 40)))
                    .astype(np.int32), max_new_tokens=int(rng.integers(2, 9))) for i in range(7)]
    kern = flash_decode if arch.startswith("deepseek") else ssd_scan
    launches = kern.launches
    batcher = ContinuousBatcher(model, params, n_slots=3, cache_cap=64, eos_id=-1)
    for r in reqs:
        batcher.submit(r)
    batcher.run()
    assert kern.launches > launches
    for r in reqs:
        lg, caches, lengths = model.prefill(
            params, {"tokens": torch.as_tensor(r.prompt, device=dev)[None]}, cache_cap=64)
        want = [int(lg[0].argmax())]
        while len(want) < r.max_new_tokens:
            lg, caches = model.decode_step(
                params, torch.tensor([want[-1]], dtype=torch.int32, device=dev), caches,
                lengths)
            lengths = lengths + 1
            want.append(int(lg[0].argmax()))
        assert r.out_tokens == want, r.uid


@pytest.mark.gpu
def test_encdec_on_the_card_matches_batch_one_and_the_cpu():
    """Reduced seamless-m4t: a batch of two sources decoded greedily on the
    card equals each source alone, and the CPU's tokens (logits within
    1e-4)."""
    dev = _card()
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import serving_config
    from repro_torch.models.encdec import EncDec
    gen = np.random.default_rng(5)
    toks = torch.from_numpy(gen.integers(0, 500, (2, 7)).astype(np.int32))
    runs = {}
    for device in (dev, "cpu"):
        model = EncDec(serving_config("seamless-m4t-medium", device=device))
        params = model.init_params(0, device="cpu")
        if device == dev:
            params = _to(params, dev)
        src = torch.from_numpy(np.random.default_rng(6).standard_normal(
            (2, 30, model.cfg.d_model)).astype(np.float32)).to(device)

        def greedy(s, t, n=6):
            lg, caches, lengths = model.prefill(params, {"src_embeds": s, "tokens": t},
                                                cache_cap=16)
            enc_lengths = torch.full((s.shape[0],), s.shape[1], dtype=torch.int32,
                                     device=s.device)
            logits, out = [lg], [lg.argmax(-1)]
            for _ in range(n - 1):
                lg, caches = model.decode_step(params, out[-1].to(torch.int32), caches,
                                               lengths, enc_lengths)
                lengths = lengths + 1
                logits.append(lg)
                out.append(lg.argmax(-1))
            return torch.stack(out, 1), torch.stack(logits, 1)

        launches = flash_attention.launches
        runs[str(device)] = greedy(src, toks.to(device))
        if device == dev:
            assert flash_attention.launches > launches
            for i in range(2):
                one, _ = greedy(src[i:i + 1], toks[i:i + 1].to(dev))
                assert torch.equal(one[0], runs[str(dev)][0][i])
    assert torch.equal(runs[str(dev)][0].cpu(), runs["cpu"][0])
    torch.testing.assert_close(runs[str(dev)][1].cpu(), runs["cpu"][1], rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------- #
# training (the config's differentiable backends on the card)
# --------------------------------------------------------------------------- #

def _train_case(arch, dev):
    """A reduced config's model, its trainable params drawn on the CPU and
    moved to ``dev`` (the same values on both sides), and a SyntheticLM
    batch as launch/train.py builds it."""
    from repro_torch.configs import get_reduced
    from repro_torch.core.tree import tree_map
    from repro_torch.data import SyntheticLM
    from repro_torch.models.encdec import EncDec
    from repro_torch.models.lm import LM, strip_derived
    cfg = get_reduced(arch)
    model = EncDec(cfg) if cfg.n_encoder_layers else LM(cfg)
    params = strip_derived(model.init_params(0, device="cpu"))
    batch = dict(SyntheticLM(vocab=cfg.vocab, seq_len=32, batch=2, seed=0).batch_at(0))
    rng = np.random.default_rng(0)
    if cfg.n_encoder_layers:
        batch["src_embeds"] = rng.standard_normal((2, 16, cfg.d_model), np.float32)
        batch["tokens"], batch["labels"] = batch["tokens"][:, :16], batch["labels"][:, :16]
    elif cfg.frontend == "embeds":
        batch["embeds"] = rng.standard_normal((2, 32, cfg.d_model), np.float32)
    return cfg, model, params, tree_map(lambda t: t.to(dev), params), batch


TRAIN_ARCHS = ["gemma3-1b", "phi3-mini-3.8b", "stablelm-12b", "minitron-4b", "pixtral-12b",
               "qwen2-moe-a2.7b", "deepseek-v2-lite-16b", "mamba2-370m", "zamba2-7b",
               "seamless-m4t-medium"]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_on_the_card_matches_the_cpu(arch):
    """Loss and every gradient leaf on the card within 1e-4 of the CPU's
    (relative to the leaf's largest magnitude), then one make_train_step
    step's loss and grad norm; no kernel launches."""
    dev = _card()
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.gemm import gemm
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.train import make_train_step, value_and_grad
    cfg, model, p_cpu, p_dev, batch = _train_case(arch, dev)
    before = (gemm.launches, flash_attention.launches)
    loss_c, _, g_cpu = value_and_grad(model, p_cpu, batch)
    loss_d, _, g_dev = value_and_grad(model, p_dev, batch)
    assert abs(float(loss_d) - float(loss_c)) <= 1e-5 * abs(float(loss_c))
    for a, b in zip(tree_leaves(g_dev), tree_leaves(g_cpu)):
        scale = float(b.abs().max())
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * scale
    opt_cfg = AdamWConfig(lr=1e-3)
    _, _, m_c = make_train_step(model, cfg, opt_cfg, donate=False)(
        p_cpu, adamw.init(p_cpu, opt_cfg), batch)
    _, _, m_d = make_train_step(model, cfg, opt_cfg)(p_dev, adamw.init(p_dev, opt_cfg), batch)
    for k in ("loss", "grad_norm"):
        assert abs(float(m_d[k]) - float(m_c[k])) <= 1e-4 * abs(float(m_c[k])), k
    assert (gemm.launches, flash_attention.launches) == before


@pytest.mark.gpu
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_on_the_card_is_deterministic_and_remat_free(arch):
    """The same step twice gives bitwise-equal gradients on the card, and
    remat on and off give the same bits."""
    dev = _card()
    from repro_torch.core.tree import tree_leaves
    from repro_torch.runtime.train import value_and_grad
    cfg, model, _, p_dev, batch = _train_case(arch, dev)
    runs = [value_and_grad(model, p_dev, batch, remat=r) for r in (True, True, False)]
    for _, _, g in runs[1:]:
        for a, b in zip(tree_leaves(runs[0][2]), tree_leaves(g)):
            assert torch.equal(a, b)
    assert len({float(r[0]) for r in runs}) == 1


# --------------------------------------------------------------------------- #
# sharded training and the pipeline: four ranks on cuda:0 over gloo
# --------------------------------------------------------------------------- #

MESH_ARCHS = (("gemma3-1b", None), ("qwen2-moe-a2.7b", 1.0))


def _mesh_case(arch, capacity_factor):
    """A reduced config (the MoE one with global dispatch at
    ``capacity_factor``: tokens drop), its model, its trainable params drawn
    on the CPU and a SyntheticLM batch of 4 rows."""
    import dataclasses
    from repro_torch.configs import get_reduced
    from repro_torch.data import SyntheticLM
    from repro_torch.models.lm import LM, strip_derived
    cfg = get_reduced(arch)
    if capacity_factor is not None:
        cfg = cfg.with_overrides(moe=dataclasses.replace(cfg.moe, dispatch="global",
                                                         capacity_factor=capacity_factor))
    model = LM(cfg)
    params = strip_derived(model.init_params(0, device="cpu"))
    return cfg, model, params, SyntheticLM(vocab=cfg.vocab, seq_len=32, batch=4,
                                           seed=0).batch_at(0)


def _mesh_card_rank():
    """A rank of the card's mesh checks: each case's (data 2, model 2) step
    twice from the same shards (gathered params and metrics), then
    pipeline_apply over a ("pod",) mesh of the four ranks."""
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.pipeline import pipeline_apply
    from repro_torch.runtime.train import make_train_step, train_state_shardings
    from repro_torch.sharding.specs import gather_tree, shard_tree
    mesh = make_mesh((2, 2), ("data", "model"), device="cuda:0")
    dev = mesh.device
    out = {"backend": mesh.backend, "device": str(dev), "cases": []}
    for arch, cf in MESH_ARCHS:
        cfg, model, params, batch = _mesh_case(arch, cf)
        params = tree_map(lambda t: t.to(dev), params)
        opt_cfg = AdamWConfig(lr=1e-3)
        p_spec, o_spec, _ = train_state_shardings(model, cfg, mesh, batch, opt_cfg)
        step = make_train_step(model, cfg, opt_cfg, mesh=mesh, batch_example=batch,
                               donate=False)
        p, s = shard_tree(params, p_spec, mesh), shard_tree(adamw.init(params, opt_cfg),
                                                            o_spec, mesh)
        runs = [step(p, s, batch) for _ in range(2)]
        twice = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(runs[0][:2]), tree_leaves(runs[1][:2])))
        out["cases"].append((
            [x.cpu().numpy() for x in tree_leaves(gather_tree(runs[0][0], p_spec, mesh))],
            {k: float(v) for k, v in runs[0][2].items()}, twice,
            all(x.is_cuda for x in tree_leaves(runs[0][:2]))))
    pod = make_mesh((4,), ("pod",), device="cuda:0")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    w = torch.randn(4, 64, 64, generator=gen, device=dev) * 0.3
    x = torch.randn(6, 8, 64, generator=gen, device=dev)
    calls = []

    def stage(w_, h):
        calls.append(1)
        return torch.tanh(h @ w_)

    y = pipeline_apply(pod, stage, w, x)
    n_calls = len(calls)
    ref = x
    for i in range(4):
        ref = stage(w[i], ref)
    out["pipe"] = (str(y.device), float((y - ref).abs().max()), n_calls)
    # the backward pass: every rank the same replicated loss, against
    # autograd through the sequential blocks in this process
    g = torch.randn(y.shape, generator=gen, device=dev)
    wg, xg = w.clone().requires_grad_(), x.clone().requires_grad_()
    (pipeline_apply(pod, stage, wg, xg) * g).sum().backward()
    ws, xs = w.clone().requires_grad_(), x.clone().requires_grad_()
    h = xs
    for i in range(4):
        h = stage(ws[i], h)
    (h * g).sum().backward()
    s_ = pod.axis_index("pod")
    out["pipe_grads"] = (str(wg.grad.device), float((wg.grad[s_] - ws.grad[s_]).abs().max()),
                         float(ws.grad[s_].abs().max()), float((xg.grad - xs.grad).abs().max()),
                         float(xs.grad.abs().max()))
    return out


@pytest.fixture(scope="module")
def mesh_card_run():
    _card()
    from repro_torch.launch.mesh import spawn_ranks
    return spawn_ranks(_mesh_card_rank, 4, timeout=300)


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(MESH_ARCHS)), ids=[a for a, _ in MESH_ARCHS])
def test_mesh_train_step_on_the_card_matches_the_cpu(case, mesh_card_run):
    """Four ranks on cuda:0 over gloo: the (data 2, model 2) step's gathered
    params and its loss and grad norm within 1e-4 of the single-device step
    on the CPU."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.train import make_train_step
    cfg, model, params, batch = _mesh_case(*MESH_ARCHS[case])
    opt_cfg = AdamWConfig(lr=1e-3)
    p_c, _, m_c = make_train_step(model, cfg, opt_cfg, donate=False)(
        params, adamw.init(params, opt_cfg), batch)
    for r in mesh_card_run:
        assert (r["backend"], r["device"]) == ("gloo", "cuda:0")
        got, metrics, _, on_card = r["cases"][case]
        assert on_card
        for k in ("loss", "grad_norm"):
            assert abs(metrics[k] - float(m_c[k])) <= 1e-4 * abs(float(m_c[k])), k
        for a, b in zip(got, tree_leaves(p_c)):
            assert float(np.abs(a - b.numpy()).max()) < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(MESH_ARCHS)), ids=[a for a, _ in MESH_ARCHS])
def test_mesh_train_step_on_the_card_is_bitwise_twice(case, mesh_card_run):
    for r in mesh_card_run:
        assert r["cases"][case][2]


@pytest.mark.gpu
def test_pipeline_on_the_card_matches_the_sequential_run(mesh_card_run):
    for r in mesh_card_run:
        device, err, calls = r["pipe"]
        assert device == "cuda:0" and err <= 1e-5, (device, err)
        assert calls == 6


@pytest.mark.gpu
def test_pipeline_grads_on_the_card_match_the_sequential_run(mesh_card_run):
    """Each stage's gradient of its weights and every rank's gradient of the
    input within 1e-5 of their largest |value| in the sequential run."""
    for r in mesh_card_run:
        device, w_err, w_max, x_err, x_max = r["pipe_grads"]
        assert device == "cuda:0"
        assert w_err <= 1e-5 * w_max and x_err <= 1e-5 * x_max, r["pipe_grads"]


# --------------------------------------------------------------------------- #
# the bf16 entries of gemm, rmsnorm, flash_attention and flash_decode
# --------------------------------------------------------------------------- #

def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each |x| (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(x.abs().float().clamp(min=2.0 ** -126))) - 7)


def _within_bf16_ulp(got, plain):
    """bf16, and within one bf16 ulp (+ the fp32 tolerance) of the plain
    version."""
    assert got.dtype == torch.bfloat16
    diff = (got.float() - plain.float()).abs()
    assert bool((diff <= _bf16_ulp(torch.maximum(got.float().abs(), plain.float().abs()))
                 + TOL["atol"]).all()), float(diff.max())


def _check_bf16(got, fp32_kernel_out, plain):
    """A bf16 entry's output: bf16, bitwise the fp32 entry's output on the
    upcast inputs rounded once (the same fp32 arithmetic), and within one
    bf16 ulp (+ the fp32 tolerance) of the plain version."""
    assert torch.equal(got, fp32_kernel_out.to(torch.bfloat16))
    _within_bf16_ulp(got, plain)


# the M of the bf16 GEMM's row gates: both sides of every plan's 64-row
# warpgroup and 128-row tile (csrc/gemm.cu gemm_bf16)
BF16_GEMM_MS = (1, 4, 16, 17, 32, 63, 64, 65, 127, 128, 256)


@pytest.mark.gpu
def test_bf16_kernels_match_their_plain_versions_on_the_card():
    dev = _card()
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    from repro_torch.kernels.flash_decode import combine_partials, flash_decode, flash_decode_plain
    from repro_torch.kernels.gemm import gemm, gemm_plain
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)

    def rb(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    counts = [f.bf16.launches for f in (gemm, rmsnorm, flash_attention, flash_decode,
                                        combine_partials)]
    # gemm (the tensor-core body, not the fp32 entry's arithmetic): both
    # plans, TMA staging and element loads (widths off 8), K off the 64-deep
    # stages and the 16-deep instructions
    for m, k, n in ((1, 64, 96), (4, 1152, 1000), (5, 37, 19), (16, 300, 264), (17, 64, 130),
                    (64, 1152, 6912), (256, 301, 250), (1024, 1152, 6912), (1030, 301, 2050)):
        x, w = rb(m, k), rb(k, n, scale=k ** -0.5)
        _within_bf16_ulp(gemm(x, w), gemm_plain(x, w))
    # rmsnorm (its own bf16 body, not the fp32 entry's arithmetic): the
    # registers layouts and the two-pass one, with and without the residual,
    # widths off 8; each row bitwise in a call of 1, 4, 17 and 256 rows
    for rows, d in ((256, 1152), (256, 96), (256, 30), (256, 1027), (17, 9000)):
        x, r, w = rb(rows, d), rb(rows, d), 1.0 + rb(d, scale=0.1)
        for res in (None, r):
            got = rmsnorm(x, w, eps=1e-6, residual=res)
            _within_bf16_ulp(got, rmsnorm_plain(x, w, eps=1e-6, residual=res))
            for n in (1, 4, 17, 256):
                part = rmsnorm(x[-n:].contiguous(), w, eps=1e-6,
                               residual=None if res is None else res[-n:].contiguous())
                assert torch.equal(part, got[-n:]), (d, n, res is None)
    # flash_attention (the tensor-core body, not the fp32 entry's
    # arithmetic): gemma3's MQA at D 256 with and without the window,
    # several shards, a query offset, D off 8 (element loads), non-causal
    for b, sq, skv, hq, hk, d, causal, window in (
            (1, 1024, 1024, 4, 1, 256, True, 512), (1, 1024, 1024, 4, 1, 256, True, None),
            (2, 64, 700, 4, 2, 96, True, None), (1, 50, 50, 2, 2, 30, False, None),
            (2, 80, 80, 8, 1, 128, True, 17)):
        q, k, v = rb(b, sq, hq, d), rb(b, skv, hk, d), rb(b, skv, hk, d)
        sc = 1.0 / math.sqrt(d)
        _within_bf16_ulp(flash_attention(q, k, v, causal=causal, window=window),
                         flash_attention_plain(q, k, v, causal=causal, window=window, scale=sc))
    # flash_decode (the narrow tensor-core body, not the fp32 entry's
    # arithmetic): gemma3's global and rolling caches, empty and full rows,
    # D off 8 (element loads), Dv != D, G 8 and 12 (two head groups)
    for b, s, hq, hk, d, dv, lens in ((4, 2048, 4, 1, 256, 256, (1400, 1000, 600, 250)),
                                      (4, 512, 4, 1, 256, 256, (512, 512, 512, 250)),
                                      (3, 70, 8, 2, 30, 30, (0, 70, 37)),
                                      (2, 200, 4, 4, 128, 64, (199, 1)),
                                      (2, 90, 8, 1, 64, 40, (90, 33)),
                                      (2, 300, 12, 1, 112, 112, (300, 17))):
        q, k, v = rb(b, hq, d), rb(b, s, hk, d), rb(b, s, hk, dv)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        got = flash_decode(q, k, v, lengths)
        _within_bf16_ulp(got, flash_decode_plain(q, k, v, lengths, 1.0 / math.sqrt(d)))
        assert all(float(got[i].float().abs().max()) == 0.0 for i, n in enumerate(lens) if n == 0)
    acc, m, l = (torch.randn(5, 3, 4, 16, device=dev), torch.randn(5, 3, 4, device=dev),
                 torch.rand(5, 3, 4, device=dev))
    _check_bf16(combine_partials(acc, m, l, dtype=torch.bfloat16), combine_partials(acc, m, l),
                combine_partials(acc.cpu(), m.cpu(), l.cpu()).to(dev))
    after = [f.bf16.launches for f in (gemm, rmsnorm, flash_attention, flash_decode,
                                       combine_partials)]
    assert all(a > b for a, b in zip(after, counts))


@pytest.mark.gpu
def test_bf16_gemm_rows_do_not_depend_on_the_batch():
    """gemm_bf16: a row's bits are those of one M = 1024 call at every M of
    BF16_GEMM_MS, whichever rows of the 1024 it is given (so at other
    places in the 64-row tile) and whichever plan runs either call, at
    gemma3-1b's projection and head widths, qwen2's expert width and a
    ragged one (element loads, both plans)."""
    dev = _card()
    from repro_torch.kernels.gemm import BF16_TILES, gemm, gemm_bf16_plan
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    plans = set()
    for k, n in ((1152, 1024), (1152, 6912), (6912, 1152), (1152, 262144), (2048, 1408),
                 (301, 2050)):
        w = (torch.randn(k, n, generator=gen, device=dev) * k ** -0.5).to(torch.bfloat16)
        x = torch.randn(1024, k, generator=gen, device=dev).to(torch.bfloat16)
        full = gemm(x, w)
        plans.add(gemm_bf16_plan(1024, n))
        for m in BF16_GEMM_MS:
            plans.add(gemm_bf16_plan(m, n))
            assert torch.equal(gemm(x[:m].contiguous(), w), full[:m]), (k, n, m)
            assert torch.equal(gemm(x[-m:].contiguous(), w), full[-m:]), (k, n, m)
    assert plans == set(BF16_TILES)


# the bf16 attention body's row gate (chip_smoke.py BF16_ATTN_WIDTHS /
# BF16_ATTN_FIRSTS): every panel count of Dv, D off 16 and off 8; rows from
# both sides of a 64-row tile's edge and of the 256-column shards
BF16_ATTN_WIDTHS = ((64, 64), (112, 112), (128, 128), (192, 128), (256, 256), (30, 30))
BF16_ATTN_FIRSTS = (1, 63, 64, 65, 255, 257, 511)


@pytest.mark.gpu
@pytest.mark.parametrize("d,dv", BF16_ATTN_WIDTHS)
def test_bf16_flash_attention_rows_do_not_depend_on_the_batch_or_the_offset(d, dv):
    """flash_attention_bf16: the rows of a B = 1 call from each first of
    BF16_ATTN_FIRSTS on are bitwise those of a B = 2 call over all 700
    rows, causal, windowed (512) and not, at G = 1 (16 heads: one shard)
    and G = 4 (one kv head: 256-column shards), and within one bf16 ulp of
    the plain version."""
    dev = _card()
    from repro_torch.kernels.flash_attention import (attention_shard_cols_bf16, flash_attention,
                                                     flash_attention_plain)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    rb = _rb(gen, dev)
    assert attention_shard_cols_bf16(700, 16, 16) != attention_shard_cols_bf16(700, 4, 1)
    for hq, hk in ((16, 16), (4, 1)):
        q, k, v = rb(2, 700, hq, d), rb(2, 700, hk, d), rb(2, 700, hk, dv)
        for causal, window in ((True, None), (True, 512), (False, None)):
            full = flash_attention(q, k, v, causal=causal, window=window)
            _within_bf16_ulp(full, flash_attention_plain(q, k, v, causal=causal, window=window,
                                                         scale=1 / math.sqrt(d)))
            for first in BF16_ATTN_FIRSTS:
                part = flash_attention(q[:1, first:].contiguous(), k[:1].contiguous(),
                                       v[:1].contiguous(), causal=causal, window=window)
                assert torch.equal(part, full[:1, first:]), (hq, hk, causal, window, first)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 112, 128, 256])
@pytest.mark.parametrize("hq,hk", [(4, 4), (4, 1)])
def test_bf16_flash_decode_rows_do_not_depend_on_the_batch(d, hq, hk):
    """flash_decode_bf16 (the narrow tensor-core body) at every served narrow
    width, G 1 and 4: row b of a B = 4 call is bitwise the B = 1 call on
    sequence b (the shard plan reads the cache's rows and the head counts
    alone), at lengths 0, 1, 63, 64, 65 and S, and within one bf16 ulp of
    the plain version."""
    dev = _card()
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain
    gen = torch.Generator(device=dev)
    gen.manual_seed(5 + d)
    rb = _rb(gen, dev)
    for s, lens in ((2048, (1400, 1000, 600, 250)), (512, (512, 300, 1, 0)),
                    (96, (63, 64, 65, 96))):
        q, k, v = rb(4, hq, d), rb(4, s, hk, d), rb(4, s, hk, d)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        full = flash_decode(q, k, v, lengths)
        _within_bf16_ulp(full, flash_decode_plain(q, k, v, lengths, 1.0 / math.sqrt(d)))
        assert all(float(full[i].float().abs().max()) == 0.0 for i, n in enumerate(lens) if n == 0)
        for i in range(4):
            one = flash_decode(q[i:i + 1].contiguous(), k[i:i + 1].contiguous(),
                               v[i:i + 1].contiguous(), lengths[i:i + 1].contiguous())
            assert torch.equal(one[0], full[i]), (s, i)


@pytest.mark.gpu
def test_bf16_batcher_on_the_card_matches_batch_one():
    """Reduced gemma3-1b at bfloat16 on the card's bf16 kernels: the
    batcher's tokens equal the unbatched greedy run's, and every kernel
    launch is on a bf16 entry."""
    dev = _card()
    from repro_torch.configs import get_reduced
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.gemm import gemm
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.models.lm import CUDA_BACKENDS, LM
    from repro_torch.runtime.batching import ContinuousBatcher, Request
    cfg = get_reduced("gemma3-1b").with_overrides(dtype="bfloat16", param_dtype="bfloat16",
                                                  backends=CUDA_BACKENDS)
    model = LM(cfg)
    params = model.init_params(0, device=dev)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(2, cfg.vocab, n).astype(np.int32),
                    max_new_tokens=m)
            for i, (n, m) in enumerate(zip((6, 21, 30, 6, 21), (5, 3, 7, 4, 6)))]
    kernels = (gemm, rmsnorm, flash_attention, flash_decode)
    before = [(f.launches, f.bf16.launches) for f in kernels]
    batcher = ContinuousBatcher(model, params, n_slots=3, cache_cap=40, eos_id=-1)
    for r in reqs:
        batcher.submit(r)
    batcher.run()
    for f, (n32, n16) in zip(kernels, before):
        assert f.launches == n32 and f.bf16.launches > n16, f.__name__
    for r in reqs:
        lg, caches, lengths = model.prefill(
            params, {"tokens": torch.from_numpy(r.prompt)[None].to(dev)}, cache_cap=40)
        out = [int(lg[0].argmax())]
        while len(out) < r.max_new_tokens:
            lg, caches = model.decode_step(
                params, torch.tensor([out[-1]], dtype=torch.int32, device=dev), caches, lengths)
            lengths = lengths + 1
            out.append(int(lg[0].argmax()))
        assert r.done and r.out_tokens == out, r.uid


# --------------------------------------------------------------------------- #
# the bf16 entries of batched_gemm, the wide flash_decode and ssd_scan
# --------------------------------------------------------------------------- #

def _rb(gen, dev):
    def rb(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(torch.bfloat16)
    return rb


@pytest.mark.gpu
def test_bf16_family_kernels_match_their_plain_versions_on_the_card():
    """batched_gemm_bf16 (both plans, ragged widths) within one bf16 ulp of
    its plain version; the wide flash_decode_bf16 (MLA's D 576 / Dv 512, D
    592, Dv off 8) and ssd_scan_bf16 (with and without D, widths off 4):
    each bitwise the fp32 entry on the upcast inputs rounded once, within
    one bf16 ulp of its plain version; the scan's state bitwise the fp32
    entry's."""
    dev = _card()
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain
    from repro_torch.kernels.gemm import batched_gemm, batched_gemm_plain
    from repro_torch.kernels.ssd import ssd_scan, ssd_scan_plain
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    rb = _rb(gen, dev)
    counts = [f.bf16.launches for f in (batched_gemm, flash_decode, ssd_scan)]
    for e, m, k, n in ((64, 32, 2048, 1408), (64, 80, 1408, 2048), (16, 4, 128, 512),
                       (16, 4, 512, 128), (3, 17, 37, 19), (2, 130, 300, 264),
                       (64, 130, 300, 264)):
        x, w = rb(e, m, k), rb(e, k, n, scale=k ** -0.5)
        _within_bf16_ulp(batched_gemm(x, w), batched_gemm_plain(x, w))
    for b, s, hq, hk, d, dv, lens in ((4, 2048, 16, 1, 576, 512, (1400, 1000, 600, 250)),
                                      (3, 300, 8, 2, 592, 512, (0, 300, 77)),
                                      (2, 100, 4, 1, 576, 260, (99, 3))):
        q, k, v = rb(b, hq, d), rb(b, s, hk, d), rb(b, s, hk, dv)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        got = flash_decode(q, k, v, lengths)
        _check_bf16(got, flash_decode(q.float(), k.float(), v.float(), lengths),
                    flash_decode_plain(q, k, v, lengths, 1.0 / math.sqrt(d)))
        assert all(float(got[i].float().abs().max()) == 0.0 for i, n in enumerate(lens) if n == 0)
    fn = torch.nn.functional
    for b, sl, h, p, g, n, q in ((1, 1024, 32, 64, 1, 128, 128), (1, 256, 112, 64, 1, 64, 128),
                                 (2, 111, 4, 6, 2, 10, 37)):
        x, bm, cm = rb(b, sl, h, p), rb(b, sl, g, n, scale=0.3), rb(b, sl, g, n, scale=0.3)
        dt = fn.softplus(torch.randn(b, sl, h, generator=gen, device=dev) - 3.0)
        a = -torch.linspace(1.0, 16.0, h, device=dev)
        for d_skip in (None, torch.randn(h, generator=gen, device=dev)):
            y, st = ssd_scan(x, dt, a, bm, cm, d_skip, chunk=q)
            y32, st32 = ssd_scan(x.float(), dt, a, bm.float(), cm.float(), d_skip, chunk=q)
            yp, stp = ssd_scan_plain(x, dt, a, bm, cm, d_skip, chunk=q)
            _check_bf16(y, y32, yp)
            assert st.dtype == torch.float32 and torch.equal(st, st32)
            torch.testing.assert_close(st, stp, rtol=1e-4, atol=1e-4)
    after = [f.bf16.launches for f in (batched_gemm, flash_decode, ssd_scan)]
    assert all(a > b for a, b in zip(after, counts))


@pytest.mark.gpu
def test_bf16_expert_rows_do_not_depend_on_m():
    """batched_gemm_bf16: expert e's rows have the bits of one M = 256
    call's at every M of BF16_GEMM_MS, from the first rows and the last,
    at qwen2's expert widths and MLA's absorbed ones, and equal gemm_bf16's
    product x[e] @ w[e] at M = 1, 32 and 256."""
    dev = _card()
    from repro_torch.kernels.gemm import batched_gemm, gemm
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    rb = _rb(gen, dev)
    for k, n in ((2048, 1408), (1408, 2048), (128, 512)):
        x, w = rb(8, 256, k), rb(8, k, n, scale=k ** -0.5)
        full = batched_gemm(x, w)
        for m in BF16_GEMM_MS:
            assert torch.equal(batched_gemm(x[:, :m].contiguous(), w), full[:, :m]), (k, n, m)
            assert torch.equal(batched_gemm(x[:, -m:].contiguous(), w), full[:, -m:]), (k, n, m)
        for m in (1, 32, 256):
            part = batched_gemm(x[:, :m].contiguous(), w)
            for e in (0, 7):
                assert torch.equal(gemm(x[e, :m].contiguous(), w[e]), part[e]), (k, n, m, e)


@pytest.mark.gpu
def test_bf16_ssd_scan_does_not_depend_on_the_batch():
    """ssd_scan_bf16: sequence i of a batch of 4 has the bits of the scan of
    it alone, y and state, at mamba2-370m's widths."""
    dev = _card()
    from repro_torch.kernels.ssd import ssd_scan
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    rb = _rb(gen, dev)
    b, sl, h, p, g, n = 4, 256, 32, 64, 1, 128
    x, bm, cm = rb(b, sl, h, p), rb(b, sl, g, n, scale=0.3), rb(b, sl, g, n, scale=0.3)
    dt = torch.nn.functional.softplus(torch.randn(b, sl, h, generator=gen, device=dev) - 3.0)
    a, d_skip = -torch.linspace(1.0, 16.0, h, device=dev), torch.ones(h, device=dev)
    y, st = ssd_scan(x, dt, a, bm, cm, d_skip)
    for i in (0, 3):
        one = [t[i:i + 1].contiguous() for t in (x, dt, bm, cm)]
        y1, st1 = ssd_scan(one[0], one[1], a, one[2], one[3], d_skip)
        assert torch.equal(y1[0], y[i]) and torch.equal(st1[0], st[i]), i


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mamba2-370m", "zamba2-7b",
                                  "deepseek-v2-lite-16b"])
def test_bf16_family_batcher_on_the_card_matches_batch_one(arch):
    """The reduced MoE, Mamba2, hybrid and MLA configs at bfloat16 on the
    card's bf16 kernels: the batcher's tokens equal the unbatched greedy
    run's, and batched_gemm and ssd_scan launch only on their bf16
    entries."""
    dev = _card()
    from repro_torch.configs import get_reduced
    from repro_torch.kernels.gemm import batched_gemm
    from repro_torch.kernels.ssd import ssd_scan
    from repro_torch.models.lm import CUDA_BACKENDS, LM
    from repro_torch.runtime.batching import ContinuousBatcher, Request
    cfg = get_reduced(arch).with_overrides(dtype="bfloat16", param_dtype="bfloat16",
                                           backends=CUDA_BACKENDS)
    model = LM(cfg)
    params = model.init_params(0, device=dev)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(2, cfg.vocab, n).astype(np.int32),
                    max_new_tokens=m)
            for i, (n, m) in enumerate(zip((6, 21, 30, 6, 21), (5, 3, 7, 4, 6)))]
    before = [(f.launches, f.bf16.launches) for f in (batched_gemm, ssd_scan)]
    batcher = ContinuousBatcher(model, params, n_slots=3, cache_cap=40, eos_id=-1)
    for r in reqs:
        batcher.submit(r)
    batcher.run()
    uses = {"batched_gemm": cfg.moe is not None or cfg.mla is not None,
            "ssd_scan": cfg.ssm is not None}
    for f, (n32, n16) in zip((batched_gemm, ssd_scan), before):
        assert f.launches == n32 and (f.bf16.launches > n16) == uses[f.__name__], f.__name__
    for r in reqs:
        lg, caches, lengths = model.prefill(
            params, {"tokens": torch.from_numpy(r.prompt)[None].to(dev)}, cache_cap=40)
        out = [int(lg[0].argmax())]
        while len(out) < r.max_new_tokens:
            lg, caches = model.decode_step(
                params, torch.tensor([out[-1]], dtype=torch.int32, device=dev), caches, lengths)
            lengths = lengths + 1
            out.append(int(lg[0].argmax()))
        assert r.done and r.out_tokens == out, r.uid


# --------------------------------------------------------------------------- #
# the bf16 partial decode (flash_decode_partial_bf16) and bf16 training
# --------------------------------------------------------------------------- #

@pytest.mark.gpu
@pytest.mark.parametrize("n_splits", [1, 2, 4, 8, 16])
def test_bf16_partial_kernel_matches_its_plain_version_on_the_card(n_splits):
    """flash_decode_partial_bf16: acc bitwise the fp32 entry's on the
    upcast inputs rounded once, m and l bitwise the fp32 entry's, within
    one bf16 ulp (acc) and the fp32 tolerance (m, l) of the plain version;
    lengths 0 and across the shard edges, GQA groups 1-8, both layouts."""
    dev = _card()
    from repro_torch.kernels.flash_decode import (flash_decode_partial,
                                                  flash_decode_partial_plain)
    gen = torch.Generator(device=dev)
    gen.manual_seed(20 + n_splits)

    def rb(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    before = (flash_decode_partial.launches, flash_decode_partial.bf16.launches)
    part = 40                                   # a ragged last tile in every shard
    s = part * n_splits
    lens = sorted({0, 1, part - 1, part, part + 1, s // 2 + 3, s - 1, s})
    cases = [(hq, hk, d, dv) for hq, hk in ((1, 1), (2, 1), (4, 1), (8, 2), (8, 1))
             for d, dv in ((64, 64), (256, 256), (96, 128), (30, 30))]
    cases += [(4, 1, 576, 512), (16, 1, 576, 512)]          # MLA's wide layout
    for hq, hk, d, dv in cases:
        b = len(lens)
        q, k, v = rb(b, hq, d), rb(b, s, hk, d), rb(b, s, hk, dv)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        acc, m, l = flash_decode_partial(q, k, v, lengths, n_splits=n_splits)
        assert (acc.dtype, m.dtype, l.dtype) == (torch.bfloat16, torch.float32, torch.float32)
        fa, fm, fl = flash_decode_partial(q.float(), k.float(), v.float(), lengths,
                                          n_splits=n_splits)
        pa, pm, pl = flash_decode_partial_plain(q, k, v, lengths, 1 / math.sqrt(d), n_splits)
        _check_bf16(acc, fa, pa)
        assert torch.equal(m, fm) and torch.equal(l, fl), (hq, hk, d, dv)
        torch.testing.assert_close(m, pm, **TOL)
        torch.testing.assert_close(l, pl, **TOL)
        empty = (lengths[None, :] - part * torch.arange(n_splits, device=dev)[:, None]) <= 0
        assert bool((m[empty] == -1e30).all()) and bool((l[empty] == 0).all())
        assert float(acc[empty].float().abs().max()) == 0.0
    assert flash_decode_partial.bf16.launches == before[1] + len(cases)
    assert flash_decode_partial.launches == before[0] + len(cases)     # the fp32 comparisons


@pytest.mark.gpu
def test_bf16_split_decode_rows_do_not_depend_on_the_batch():
    """cuda_split at bf16 (the bf16 partials, upcast, merged by the combine
    kernel with a bf16 out): a sequence's bits are the same at B = 1 and
    B = 4, and the plain route's within the roundings both make: each
    rounds every shard's acc (half an ulp, at most 2^-8 of |acc|) and the
    merged output, so they differ by at most 2^-7 of the merge of the
    shards' |acc| plus 2^-7 of |out| (the shards' acc may cancel, so a
    bound in ulps of the output does not hold)."""
    dev = _card()
    from repro_torch.kernels.flash_decode import (combine_partials, flash_decode_partial,
                                                  flash_decode_partial_plain)
    from repro_torch.kernels.ops import decode_attention
    from repro_torch.kernels.ref import combine_partials_ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)

    def rb(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    before = (flash_decode_partial.bf16.launches, combine_partials.bf16.launches)
    calls = 0
    for hq, d, dv in ((4, 256, 256), (16, 576, 512)):
        q, k, v = rb(4, hq, d), rb(4, 2048, 1, d), rb(4, 2048, 1, dv)
        lengths = torch.tensor([1400, 0, 1024, 1025], dtype=torch.int32, device=dev)
        for n_splits in (2, 4, 8, 16):
            full = decode_attention(q, k, v, lengths, backend="cuda_split", n_splits=n_splits)
            assert full.dtype == torch.bfloat16
            for i in range(4):
                one = decode_attention(q[i:i + 1].contiguous(), k[i:i + 1].contiguous(),
                                       v[i:i + 1].contiguous(), lengths[i:i + 1].contiguous(),
                                       backend="cuda_split", n_splits=n_splits)
                assert torch.equal(one, full[i:i + 1]), (hq, n_splits, i)
            cpu = [x.cpu() for x in (q, k, v, lengths)]
            plain = decode_attention(*cpu, backend="cuda_split", n_splits=n_splits).float()
            pa, pm, pl = flash_decode_partial_plain(*cpu, 1 / math.sqrt(d), n_splits)
            mag = combine_partials_ref(pa.float().abs(), pm, pl)
            diff = (full.float().cpu() - plain).abs()
            assert bool((diff <= 2.0 ** -7 * (mag + plain.abs()) + TOL["atol"]).all()), \
                float(diff.max())
            calls += 5
    assert flash_decode_partial.bf16.launches == before[0] + calls
    assert combine_partials.bf16.launches == before[1] + calls


@pytest.mark.gpu
def test_bf16_train_step_on_the_card_repeats_bitwise():
    """Reduced gemma3-1b at the published bfloat16 (bf16 params, f32
    masters and moments): one make_train_step step on the card, run twice
    from copies of the same state, gives the same bits; the params stay
    bf16, each its master rounded once; no kernel launches."""
    dev = _card()
    from repro_torch.configs import get_reduced
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.gemm import gemm
    from repro_torch.models.lm import LM, strip_derived
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.train import make_train_step
    cfg = get_reduced("gemma3-1b").with_overrides(dtype="bfloat16", param_dtype="bfloat16")
    model, opt_cfg = LM(cfg), AdamWConfig(lr=1e-3)
    params = strip_derived(model.init_params(0, device=dev))
    state = adamw.init(params, opt_cfg)
    batch = SyntheticLM(vocab=cfg.vocab, seq_len=32, batch=4, seed=0).batch_at(0)
    step = make_train_step(model, cfg, opt_cfg, donate=True)
    before = (gemm.launches, gemm.bf16.launches, flash_attention.bf16.launches)
    runs = []
    for _ in range(2):
        p, s = tree_map(torch.clone, params), tree_map(torch.clone, state)
        runs.append(step(p, s, batch))
    (p1, s1, m1), (p2, s2, m2) = runs
    for a, b in zip(tree_leaves({"p": p1, "s": s1}), tree_leaves({"p": p2, "s": s2})):
        assert torch.equal(a, b)
    assert float(m1["loss"]) == float(m2["loss"]) and math.isfinite(float(m1["loss"]))
    for p, master in zip(tree_leaves(p1), tree_leaves(s1["master"])):
        assert p.dtype == torch.bfloat16 and master.dtype == torch.float32
        assert torch.equal(p, master.to(torch.bfloat16))
    assert (gemm.launches, gemm.bf16.launches, flash_attention.bf16.launches) == before
