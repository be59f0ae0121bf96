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
    dev = _card()
    from repro_torch.kernels.gemm import gemm
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    rn = _rn(gen, dev)
    x, w = rn(256, 300), rn(300, 70)
    full = gemm(x, w)
    for m in (1, 4, 64):
        assert torch.equal(gemm(x[:m].contiguous(), w), full[:m])


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
