"""The redesigned attention and batched GEMM kernels' algorithms and
constants, held on the CPU (the kernels themselves run only on the card,
tests/test_torch_gpu.py):

- the sharded formulation of ``csrc/flash_attention.cu`` — each shard of
  ``attention_shard_cols(S)`` columns gives its unnormalised partials (acc,
  m, l) over the columns a row may see, merged in shard order
  (``combine_partials_ref``) — against JAX's Pallas ``flash_attention`` and
  ``flash_chunk_attention`` in interpret mode and the port's plain versions,
  at lengths and positions on and around the shard and tile edges;
- the shard size depends on the column count alone (no batch, no chunk);
- ``chunk_fits``, ``attention_fits`` and ``paged_chunk_fits`` under the new
  layout admit every attention shape of the configs;
- the Python layout constants and rules agree with the CUDA sources, and
  ``batched_gemm`` takes the variant and tile of ``gemm``'s kernels.

Tolerance 1e-5: fp32 on both sides, summed in another order."""

import inspect
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jflash_attention
from repro.kernels.flash_attention import flash_chunk_attention as jflash_chunk_attention
from repro.kernels.gemm import batched_gemm as jbatched_gemm
from repro_torch.configs import get_config, list_configs
from repro_torch.kernels import _cuda
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gemm as gm
from repro_torch.kernels.ref import attention_mask, combine_partials_ref

TOL = dict(rtol=1e-5, atol=1e-5)
CSRC = Path(_cuda.__file__).resolve().parent.parent / "csrc"


def _sharded(q, k, v, allowed, scale):
    """What the card computes: q (B, T, Hq, D), k (B, S, Hk, D), v (B, S,
    Hk, Dv), allowed (B or 1, T, S).  Each shard's partials over the
    columns it holds (masked columns weigh 0; a shard a row sees nothing of
    gives acc 0, m -1e30, l 0), merged in shard order."""
    b, t, hq, d = q.shape
    s_len, hk = k.shape[1], k.shape[2]
    g = hq // hk
    shard = fa.attention_shard_cols(s_len)
    qg = (q * scale).reshape(b, t, hk, g, d)
    accs, ms, ls = [], [], []
    for c0 in range(0, s_len, shard):
        cols = slice(c0, min(s_len, c0 + shard))
        ok = allowed[:, None, None, :, cols]                         # (B,1,1,T,c)
        s = torch.einsum("btkgd,bskd->bkgts", qg, k[:, cols])
        s = torch.where(ok, s, torch.full_like(s, -1e30))
        m = s.amax(dim=-1)
        p = torch.where(ok, torch.exp(s - m[..., None]), torch.zeros_like(s))
        accs.append(torch.einsum("bkgts,bskd->bkgtd", p, v[:, cols]))
        ms.append(m)
        ls.append(p.sum(dim=-1))
    o = combine_partials_ref(torch.stack(accs), torch.stack(ms), torch.stack(ls))
    return o.permute(0, 3, 1, 2, 4).reshape(b, t, hq, v.shape[3])


def _qkv(b, t, s, hq, hk, d, dv, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, hq, d)).astype(np.float32),
            rng.standard_normal((b, s, hk, d)).astype(np.float32),
            rng.standard_normal((b, s, hk, dv)).astype(np.float32))


@pytest.mark.parametrize("s_len", [255, 256, 257, 513])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 64), (False, None),
                                           (False, 100)])
def test_sharded_attention_matches_pallas_and_plain(s_len, causal, window):
    """Whole-sequence attention over 1-3 shards, GQA 2, lengths on and
    around the shard edge."""
    q, k, v = _qkv(2, s_len, s_len, 4, 2, 16, 16, seed=s_len)
    scale = 1.0 / math.sqrt(16)
    allowed = attention_mask(s_len, s_len, causal=causal, window=window, offset=0)[None]
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = _sharded(tq, tk, tv, allowed, scale)
    plain = fa.flash_attention_plain(tq, tk, tv, causal=causal, window=window, scale=scale)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    want = np.asarray(jflash_attention(q, k, v, causal=causal, window=window, scale=scale,
                                       block_q=s_len, block_kv=s_len, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("starts", [(240, 0), (255, 1), (256, 63), (497, 64)])
def test_sharded_chunk_attention_matches_pallas_and_plain(starts):
    """Chunks of 16 rows over a 600-column cache (three shards) whose rows
    sit before, on and after the shard and tile edges."""
    t, s_len = 16, 600
    q, k, v = _qkv(2, t, s_len, 4, 1, 32, 32, seed=sum(starts))
    start = np.asarray(starts, np.int32)
    scale = 1.0 / math.sqrt(32)
    tq, tk, tv, ts = (torch.from_numpy(a) for a in (q, k, v, start))
    qpos = ts.long()[:, None] + torch.arange(t)[None, :]
    allowed = torch.arange(s_len)[None, None, :] <= qpos[:, :, None]
    got = _sharded(tq, tk, tv, allowed, scale)
    plain = fa.flash_chunk_attention_plain(tq, tk, tv, ts, scale)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    want = np.asarray(jflash_chunk_attention(q, k, v, start, scale=scale, block_q=t,
                                             block_kv=s_len, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_shard_size_takes_no_batch():
    """A function of the column count alone: neither the batch nor the
    chunk (start, T) can change a row's shards."""
    assert list(inspect.signature(fa.attention_shard_cols).parameters) == ["s_len"]


@pytest.mark.parametrize("s_len", [1, 64, 256, 257, 1024, 2048, 2049, 8192, 1 << 20])
def test_attention_shard_cols(s_len):
    shard = fa.attention_shard_cols(s_len)
    assert shard % fa.SHARD_COLS == 0 and shard & (shard - 1) == 0
    assert shard % fa.BLOCK_KV == 0                         # whole KV tiles
    assert -(-s_len // shard) <= fa.MAX_SHARDS
    assert shard == fa.SHARD_COLS or -(-s_len // (shard // 2)) > fa.MAX_SHARDS


@pytest.mark.parametrize("arch", list_configs())
def test_attention_fits_every_config(arch):
    """Every attention shape of the configs (MLA: D = nope + rope, Dv = v)."""
    cfg = get_config(arch)
    hq, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    mla = getattr(cfg, "mla", None)
    d, dv = (mla.nope_dim + mla.rope_dim, mla.v_dim) if mla else (dh, dh)
    assert fa.chunk_fits(hq, hk, d, dv) and fa.attention_fits(hq, hk, d, dv)
    assert fa.paged_chunk_fits(hq, hk, d, dv)


@pytest.mark.parametrize("d,dv,blocks", [(96, 96, 2), (128, 128, 2), (64, 64, 3),
                                         (160, 160, 1), (256, 256, 1), (192, 128, 1)])
def test_attention_blocks_per_sm(d, dv, blocks):
    """228 KB of shared memory per SM, 1 KB of it reserved per block: the
    engine's and qwen2's widths fit two blocks, D = 256 one."""
    per_block = fa.attention_smem_bytes(d, dv) + 1024
    assert (228 * 1024) // per_block == blocks
    assert fa.attention_smem_bytes(d, dv) <= _cuda.MAX_SMEM_BYTES


@pytest.mark.parametrize("hq,hk,ok", [(64, 1, True), (65, 1, False), (8, 3, False),
                                      (4, 0, False)])
def test_chunk_fits_group_limit(hq, hk, ok):
    """A block holds the whole GQA group in its 64 query rows."""
    assert fa.chunk_fits(hq, hk, 64, 64) is ok


def test_attention_layout_constants_are_the_cuda_source():
    src = (CSRC / "flash_attention.cu").read_text()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+)", src).group(1))

    assert const("THREADS") == 256 and const("BR") == fa.BLOCK_ROWS
    assert const("BKV") == fa.BLOCK_KV and const("MAX_SHARDS") == fa.MAX_SHARDS
    flat = " ".join(src.split())
    assert ("(size_t)BR * pad4(D) + (size_t)BKV * (pad4(D) + 4) + (size_t)BKV * pad4(Dv) + "
            "(size_t)BR * BKV") in flat
    assert "shard < 64 || shard % 64" in flat and "Hq / Hk > BR" in flat


def test_batched_gemm_runs_gemms_kernels_per_expert():
    """The C entry point takes the tile the wrapper picks (gemm_tile over
    all experts' blocks), runs the skinny kernel at M <= 16 and the tiled
    one above, and only its instances offset by the expert."""
    flat = " ".join((CSRC / "gemm.cu").read_text().split())
    t = gm.SKINNY_MAX_M
    assert (f"return M <= {t} ? skinny<true>(a, b, c, E, M, N, K, st) "
            f": tiled<true>(a, b, c, E, M, N, K, bm, bn, st);") in flat
    assert "skinny<false>(a, b, c, 1, M, N, K" in flat
    assert "tiled<false>(a, b, c, 1, M, N, K" in flat
    assert "batched_gemm_kernel" not in flat
    assert gm.gemm_tile(128, 1408) == (32, 64) and gm.gemm_tile(128, 1408, 64) == (128, 128)
    assert gm.gemm_tile(80, 1408, 64) == (32, 64)           # M short of a 128-row tile
    assert gm.gemm_tile(256, 8192) == gm.gemm_tile(256, 8192, 1) == (128, 128)


@pytest.mark.parametrize("m", [1, 8, 16, 17, 32, 80])
def test_batched_gemm_plain_matches_pallas_at_every_variant(m):
    """qwen2-like expert shapes, scaled down, at the M of each variant and
    tile: the port's plain version against Pallas batched_gemm in
    interpret mode, and against gemm's plain version per expert."""
    rng = np.random.default_rng(m)
    x = rng.standard_normal((4, m, 64)).astype(np.float32)
    w = (rng.standard_normal((4, 64, 48)) / 8).astype(np.float32)
    got = gm.batched_gemm(torch.from_numpy(x), torch.from_numpy(w))
    want = np.asarray(jbatched_gemm(x, w, block_m=32, block_n=48, block_k=64, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    for e in range(4):
        np.testing.assert_allclose(got[e].numpy(), gm.gemm(torch.from_numpy(x[e]),
                                                           torch.from_numpy(w[e])).numpy(), **TOL)
