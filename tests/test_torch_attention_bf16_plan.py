"""The bf16 attention body's plan and constants, held on the CPU (the
tensor-core kernel itself runs only on the card, tests/test_torch_gpu.py):

- ``attention_shard_cols_bf16`` reads the key count and the head counts and
  nothing else (no batch, no query count), keeps whole 64-column tiles and
  at most MAX_SHARDS shards, takes one shard where one sequence's query
  tiles fill the SMs and the fp32 plan elsewhere;
- its tile constants, its instruction shapes, each instance's shared
  memory and the C entry's ctypes signature agree with
  ``csrc/flash_attention.cu``, and the fp32 body carries no bf16 path;
- the plain version the kernel is held to on the card
  (``flash_attention_plain`` at bf16: fp32 on the upcast inputs, rounded
  once) against JAX's Pallas ``flash_attention`` in interpret mode at the
  served widths the body adds (D 112; D 192 / Dv 128; G = 8) and a window,
  within one bf16 ulp + 2e-5.
"""

import inspect
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jflash_attention
from repro_torch.configs import get_config, list_configs
from repro_torch.kernels import _cuda
from repro_torch.kernels import flash_attention as fa

CSRC = Path(_cuda.__file__).resolve().parent.parent / "csrc"
F32_TOL = 2e-5


def _src() -> str:
    return (CSRC / "flash_attention.cu").read_text()


def _body() -> str:
    """The bf16 body's part of the source: from its constants to the C entries."""
    src = _src()
    return src[src.index("constexpr int TC_THREADS"):src.index('extern "C"')]


def _bf16(rng, *shape):
    """(a JAX bf16 array, a torch bf16 tensor with the same bits)."""
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


# --------------------------------------------------------------------------- #
# the shard plan
# --------------------------------------------------------------------------- #

def test_plan_reads_the_key_count_and_the_heads_alone():
    """No batch and no query count: a row's shards are the same in every
    call, so its bits are."""
    assert list(inspect.signature(fa.attention_shard_cols_bf16).parameters) == [
        "s_len", "hq", "hk"]


@pytest.mark.parametrize("s_len", [1, 63, 64, 65, 700, 1024, 1030, 2100, 4096, 32768])
@pytest.mark.parametrize("hq,hk", [(1, 1), (4, 1), (16, 16), (32, 32), (8, 2), (64, 1),
                                   (12, 4)])
def test_plan_keeps_whole_tiles_and_at_most_max_shards(s_len, hq, hk):
    shard = fa.attention_shard_cols_bf16(s_len, hq, hk)
    assert shard % fa.BLOCK_KV == 0 and shard >= fa.BLOCK_KV
    assert -(-s_len // shard) <= fa.MAX_SHARDS
    gp = 1 << (hq // hk - 1).bit_length()                      # G rounded up to 2^k
    blocks = -(-s_len // (fa.BLOCK_ROWS // gp)) * hk
    if blocks >= fa.SMS:
        assert shard >= s_len and shard - s_len < fa.BLOCK_KV   # one shard
    else:
        assert shard == fa.attention_shard_cols(s_len)          # the fp32 plan


@pytest.mark.parametrize("s_len,hq,hk,shard", [
    (1024, 16, 16, 1024),     # qwen2 and deepseek MLA prefill, seamless encoder and cross
    (1024, 32, 32, 1024),     # zamba2's shared attention
    (1024, 4, 1, 256),        # gemma3-1b: 64 query tiles on one kv head
    (64, 16, 16, 256),        # seamless decoder self attention: one fp32 shard
    (700, 16, 16, 704),       # the row gate's one-shard case
    (700, 4, 1, 256),         # ... and its sharded one
])
def test_plan_at_the_served_shapes(s_len, hq, hk, shard):
    assert fa.attention_shard_cols_bf16(s_len, hq, hk) == shard


def test_fp32_plan_is_unchanged():
    assert fa.SHARD_COLS == 256 and fa.MAX_SHARDS == 8
    assert [fa.attention_shard_cols(s) for s in (64, 1024, 2048, 2049)] == [256, 256, 256, 512]


# --------------------------------------------------------------------------- #
# the constants, the instructions and the C interface
# --------------------------------------------------------------------------- #

def test_tile_constants_are_the_cuda_source():
    src = _src()

    def const(name):  # a constexpr int: a number or a product of numbers
        expr = re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)
        return int(np.prod([int(x) for x in expr.split("*")]))

    assert const("TC_THREADS") == fa.BF16_THREADS == 128
    assert const("TC_PANEL") == fa.BF16_PANEL_BYTES == 64 * 64 * 2
    assert const("BR") == fa.BLOCK_ROWS and const("BKV") == fa.BLOCK_KV
    assert "1024 + (size_t)TC_PANEL * (2 * panels64(D) + panels64(Dv))" in src
    flat = " ".join(src.split())
    assert "return BR / gp;" in flat                # the fp32 body's GQA packing
    assert flat.count("tile_positions(B, T, Hq, Hk, S, D, Dv, shard, acc && m && l)") == 2


def test_one_instruction_shape_for_both_products():
    """Q K^T on m64n64k16 with B K-major (trans-b 0) over D's 16-deep
    chunks; P V on the register-A form with V N-major (trans-b 1), hi then
    lo for each chunk; nothing else multiplies."""
    body = _body()
    calls = re.findall(r"\bwgmma_m\w+<\d+>", body)
    assert set(calls) == {"wgmma_m64n64k16<0>", "wgmma_m64n64k16_rs<1>"}
    assert calls.count("wgmma_m64n64k16_rs<1>") == 2           # P_hi V, then P_lo V
    header = (CSRC / "wgmma.cuh").read_text()
    shapes = set(re.findall(r"wgmma\.mma_async\.sync\.aligned\.(m\d+n\d+k\d+)\.(\S+)", header))
    assert shapes == {("m64n64k16", "f32.bf16.bf16")}
    flat = " ".join(body.split())
    assert "const int n_k16 = (D + 15) / 16;" in flat
    assert "for (int kd = 0; kd < n_k16; ++kd)" in flat
    assert "fmaf" not in body                                   # no FFMA product


@pytest.mark.parametrize("nv", [1, 2, 3, 4])
def test_each_instance_fits_the_card(nv):
    """The dispatch runs one instance per panel count of Dv; at the widest D
    each takes at most the H100's shared memory per block."""
    flat = " ".join(_body().split())
    assert f"return run_bf16<{nv}>(" in flat
    assert fa.attention_smem_bytes(256, 64 * nv, bf16=True) <= _cuda.MAX_SMEM_BYTES
    assert "switch (panels64(Dv))" in flat and "run_bf16<5>" not in flat


@pytest.mark.parametrize("d,dv,blocks", [(64, 64, 8), (112, 112, 4), (128, 128, 4),
                                         (192, 128, 3), (256, 256, 2)])
def test_blocks_per_sm_by_shared_memory(d, dv, blocks):
    """228 KB a SM, 1 KB of it reserved a block."""
    assert (228 * 1024) // (fa.attention_smem_bytes(d, dv, bf16=True) + 1024) == blocks


@pytest.mark.parametrize("arch", list_configs())
def test_attention_fits_every_config_at_bf16(arch):
    cfg = get_config(arch)
    mla = getattr(cfg, "mla", None)
    d, dv = (mla.nope_dim + mla.rope_dim, mla.v_dim) if mla else (cfg.head_dim, cfg.head_dim)
    assert fa.attention_fits(cfg.n_heads, cfg.n_kv_heads, d, dv)
    assert fa.attention_smem_bytes(d, dv, bf16=True) <= _cuda.MAX_SMEM_BYTES


def test_fp32_body_carries_no_bf16_path():
    """attention_kernel is the fp32 body alone (fp32 and int8 sources)."""
    src = _src()
    fp32 = src[src.index("template <class Src, class Mask, int NV>"):
               src.index("// One warp per row of the R = B * T * Hq rows")]
    assert "bf16" not in fp32 and "typename TQ" not in src and "Bf16Source" not in src


def test_bf16_entry_ctypes_signature():
    """q, k, v (bf16), acc, m, l (fp32 partials), o (bf16); B, T, Hq, Hk,
    Skv, D, Dv, causal, window, shard; the scale; the stream."""
    m = re.search(r'extern "C" int flash_attention_bf16\(([^)]*)\)', _src())
    params = [p.strip().rsplit(" ", 1)[0] for p in m.group(1).split(",")]
    assert params[:3] == ["const __nv_bfloat16*"] * 3 and params[3:6] == ["float*"] * 3
    assert params[6] == "__nv_bfloat16*" and params[7:17] == ["int"] * 10
    assert params[17:] == ["float", "void*"]
    sig = _cuda._SIGNATURES["flash_attention_bf16"]
    assert sig == (*[_cuda._P] * 7, *[_cuda._I] * 10, _cuda._F, _cuda._P)
    assert "wgmma.cuh" in _cuda.HEADERS


# --------------------------------------------------------------------------- #
# the plain version at bf16 against Pallas
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("b,sq,skv,hq,hk,d,dv,causal,window", [
    (1, 64, 64, 2, 2, 112, 112, True, None),       # zamba2's head width
    (1, 64, 128, 2, 2, 192, 128, True, None),      # MLA's prefill: D 192, Dv 128, an offset
    (1, 64, 64, 8, 1, 64, 64, True, 24),           # G = 8 and a window
    (2, 32, 64, 4, 4, 128, 128, False, None),      # non-causal, Sq != Skv
])
def test_flash_attention_plain_bf16_against_pallas(b, sq, skv, hq, hk, d, dv, causal, window):
    rng = np.random.default_rng(sq + skv + d + dv + hq)
    jq, q = _bf16(rng, b, sq, hq, d)
    jk, k = _bf16(rng, b, skv, hk, d)
    jv, v = _bf16(rng, b, skv, hk, dv)
    want = jflash_attention(jq, jk, jv, causal=causal, window=window, block_q=32, block_kv=32,
                            interpret=True)
    launches = fa.flash_attention.bf16.launches
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert fa.flash_attention.bf16.launches == launches         # CPU tensors: the plain version
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert torch.equal(got, fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                                     scale=d ** -0.5))
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    mag = np.maximum(np.maximum(np.abs(g), np.abs(w)), np.float32(2.0 ** -126))
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    assert np.all(np.abs(g - w) <= ulp + F32_TOL), float(np.max(np.abs(g - w) - ulp))
