"""The plans and constants of the bf16 bodies of rmsnorm and of the narrow
flash_decode, held on the CPU (the kernels themselves run only on the card,
tests/test_torch_gpu.py):

- ``row_layout_bf16`` reads the row width alone and ``decode_plan_bf16`` the
  cache's rows and the head counts alone (no batch, no row count), so a
  row's order, and its bits, are the same in every call;
- rmsnorm's bf16 layout holds every served width in registers in 16-byte
  pieces, with the fewest threads; the decode plan keeps whole 16-row
  tiles, at most one cluster of shards, no empty trailing shard, and fewer
  shards where a sequence has many kv heads;
- their constants, each decode instance's shared memory, its blocks per SM
  at the served widths and both C entries' ctypes signatures agree with
  ``csrc/rmsnorm.cu`` and ``csrc/flash_decode.cu``; the decode body
  multiplies with one tensor-core instruction shape;
- the fp32 plans (``row_layout``, ``decode_shard_rows``) are unchanged.
"""

import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, list_configs
from repro_torch.kernels import _cuda
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import rmsnorm as rn

CSRC = Path(_cuda.__file__).resolve().parent.parent / "csrc"


def _src(name: str) -> str:
    return (CSRC / name).read_text()


def _const(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int [^;]*\b{name} = (\d+)", src).group(1))


def _tc_body() -> str:
    """The narrow bf16 decode body's part of the source."""
    src = _src("flash_decode.cu")
    return src[src.index("constexpr int TC_THREADS"):src.index('extern "C"')]


# --------------------------------------------------------------------------- #
# the plans read what they should and nothing else
# --------------------------------------------------------------------------- #

def test_plans_take_the_width_or_the_cache_and_heads_alone():
    assert list(inspect.signature(rn.row_layout_bf16).parameters) == ["d"]
    assert list(inspect.signature(fd.decode_plan_bf16).parameters) == ["s_len", "hq", "hk"]


def test_fp32_plans_are_unchanged():
    assert (rn.THREADS, rn.MAX_VPT) == (256, 8)
    assert [rn.row_layout(d) for d in (1, 1024, 1152, 3072, 7168, 8192, 9000)] == [
        (32, 1), (32, 8), (64, 5), (128, 6), (256, 7), (256, 8), (256, 9)]
    assert (fd.SHARD_ROWS, fd.MAX_SHARDS) == (64, 128)
    assert [fd.decode_shard_rows(s) for s in (1, 512, 2048, 8192, 8193)] == [64, 64, 64, 64, 128]


# --------------------------------------------------------------------------- #
# rmsnorm's bf16 layout
# --------------------------------------------------------------------------- #

def test_bf16_layout_holds_every_row_to_8192_in_registers():
    for d in range(1, 8193):
        tpr, ppt = rn.row_layout_bf16(d)
        assert tpr in (32, 64, 128, 256) and rn.BF16_THREADS % tpr == 0
        assert 1 <= ppt <= rn.MAX_PPT and tpr * ppt * rn.PIECE >= d
        assert tpr == 32 or (tpr // 2) * rn.MAX_PPT * rn.PIECE < d      # the fewest threads
    assert rn.row_layout_bf16(8193) == (256, 5)                         # the two-pass path


@pytest.mark.parametrize("d,layout", [(1024, (32, 4)), (1152, (64, 3)), (2048, (64, 4)),
                                      (3584, (128, 4)), (7168, (256, 4))])
def test_bf16_layout_at_the_served_widths(d, layout):
    """A warp a row at D 1024 (8 rows a block), one block a row at 7168."""
    assert rn.row_layout_bf16(d) == layout


def test_bf16_layout_constants_are_the_cuda_source():
    src = _src("rmsnorm.cu")
    assert (_const(src, "BF16_THREADS"), _const(src, "PIECE"), _const(src, "MAX_PPT")) == (
        rn.BF16_THREADS, rn.PIECE, rn.MAX_PPT)
    assert "while (t < BF16_THREADS && t * MAX_PPT < np) t <<= 1;" in src
    # w staged once a block: its pieces' bytes of dynamic shared memory
    assert "const size_t smem = static_cast<size_t>(np) * 16;" in src
    # the fp32 body keeps its own layout
    assert "while (t < THREADS && t * MAX_VPT < g4) t <<= 1;" in src
    assert "return run_bf16(x, residual, w, y, rows, D, eps, stream);" in src


# --------------------------------------------------------------------------- #
# the narrow decode's shard plan
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("s_len", [1, 15, 16, 17, 63, 64, 65, 96, 130, 512, 1024, 2048, 4096,
                                   32768])
@pytest.mark.parametrize("hq,hk", [(4, 1), (1, 1), (16, 16), (32, 32), (12, 1), (24, 8)])
def test_plan_keeps_whole_tiles_and_one_cluster(s_len, hq, hk):
    shard, shards, groups = fd.decode_plan_bf16(s_len, hq, hk)
    assert shard % fd.TC_ROWS == 0 and 1 <= shards <= fd.TC_CLUSTER
    assert shards * shard >= s_len and (shards - 1) * shard < max(s_len, 1)   # none empty
    assert groups == -(-(hq // hk) // fd.TC_HEADS)
    assert shards == 1 or hk * groups * shards <= fd.TC_FILL
    # cut into the most of 1, 2, 4 and 8 pieces that the fill allows and that
    # each hold a tile of the cache, then rounded up to whole tiles
    cut = max(c for c in (1, 2, 4, fd.TC_CLUSTER)
              if c == 1 or (hk * groups * c <= fd.TC_FILL and c * fd.TC_ROWS < s_len + fd.TC_ROWS))
    per = -(-max(s_len, 1) // cut)
    assert shard == -(-per // fd.TC_ROWS) * fd.TC_ROWS


@pytest.mark.parametrize("s_len,hq,hk,plan", [
    (2048, 4, 1, (256, 8, 1)),      # gemma3-1b global
    (512, 4, 1, (64, 8, 1)),        # gemma3-1b rolling
    (2048, 16, 16, (512, 4, 1)),    # qwen2-moe
    (2048, 32, 32, (1024, 2, 1)),   # zamba2's shared attention
    (1024, 16, 16, (256, 4, 1)),    # seamless cross
    (96, 16, 16, (32, 3, 1)),       # seamless self
])
def test_plan_at_the_served_shapes(s_len, hq, hk, plan):
    assert fd.decode_plan_bf16(s_len, hq, hk) == plan


def test_decode_constants_are_the_cuda_source():
    src = _src("flash_decode.cu")
    assert _const(src, "TC_THREADS") // 32 == fd.TC_WARPS
    assert (_const(src, "TC_ROWS"), _const(src, "TC_NST"), _const(src, "TC_HEADS"),
            _const(src, "TC_CLUSTER")) == (fd.TC_ROWS, fd.TC_NST, fd.TC_HEADS, fd.TC_CLUSTER)
    flat = " ".join(src.split())
    # the C side takes the plan's shard and checks it against the cluster
    assert "shard % TC_ROWS || (S + shard - 1) / shard > TC_CLUSTER" in flat
    assert "if (D <= 32 * 4 * NCH && Dv <= 32 * 4 * NCH) return decode_tc(" in flat
    assert "attr[0].val.clusterDim.x = cluster;" in flat
    # the fp32 body's constants, which the wide layout and the partial keep
    assert (_const(src, "ROWS"), _const(src, "NST"), _const(src, "GMAX"), _const(src, "NCH")) == (
        fd.BLOCK_KV, fd.RING, fd.GROUP_HEADS, 2)


def test_one_tensor_core_shape_for_both_products():
    """q K^T and (transposed) P V on mma.sync.m16n8k16 (bf16 in, fp32
    accumulate), P as hi then lo; no fp32 FMA product in the tile loop."""
    body = _tc_body()
    shapes = set(re.findall(r"mma\.sync\.aligned\.(m\d+n\d+k\d+)\.(\S+)", body))
    assert shapes == {("m16n8k16", "row.col.f32.bf16.bf16.f32")}
    loop = body[body.index("for (int i = 0; i < my_tiles; ++i)"):body.index("cp_async_wait<0>")]
    # q K^T: even and odd chunks for two 8-key halves; then V^T P_hi^T, V^T P_lo^T
    assert loop.count("mma16816(") == 6
    assert loop.index("hi0, hi1);") < loop.index("lo0, lo1);")
    assert "ldsm_x4_trans(va" in loop and "fmaf" not in loop
    assert "cluster.map_shared_rank(bm, r)" in body and body.count("cluster.sync();") == 2


def _smem_formula(d: int, dv: int) -> int:
    """decode_tc_smem_bytes, from the source's constants."""
    src = _src("flash_decode.cu")
    w, rows, nst, heads, cl = (_const(src, "TC_THREADS") // 32, _const(src, "TC_ROWS"),
                               _const(src, "TC_NST"), _const(src, "TC_HEADS"),
                               _const(src, "TC_CLUSTER"))
    ks, vs, dv16 = -(-d // 16) * 16 + 8, -(-dv // 16) * 16 + 8, -(-dv // 16) * 16
    ring = 2 * w * nst * rows * (ks + vs)
    merge = 4 * ((w + 1) * heads * (2 + dv16) + (w + cl + 1) * heads)
    return 2 * heads * ks + max(ring, merge)


@pytest.mark.parametrize("d,dv", [(64, 64), (112, 112), (128, 128), (256, 256), (30, 30), (40, 24),
                                  (1, 1), (160, 160), (96, 96)])
def test_smem_is_the_cuda_formula_and_fits(d, dv):
    text = " ".join(_src("flash_decode.cu").split())
    assert "const size_t ring = 2 * (size_t)TC_WARPS * TC_NST * TC_ROWS * (KS + VS);" in text
    assert ("const size_t merge = 4 * ((size_t)(TC_WARPS + 1) * TC_HEADS * (2 + Dv16) + "
            "(size_t)(TC_WARPS + TC_CLUSTER + 1) * TC_HEADS);") in text
    assert "return (W + 15) / 16 * 16 + 8;" in text
    assert fd.decode_tc_smem_bytes(d, dv) == _smem_formula(d, dv) <= _cuda.MAX_SMEM_BYTES


@pytest.mark.parametrize("d,blocks", [(64, 4), (112, 2), (128, 2), (256, 1)])
def test_blocks_per_sm_at_the_served_widths(d, blocks):
    """228 KB of shared memory a SM, 1 KB of it reserved a block."""
    assert (228 * 1024) // (fd.decode_tc_smem_bytes(d, d) + 1024) == blocks


@pytest.mark.parametrize("arch", list_configs())
def test_every_narrow_served_head_takes_the_tensor_core_body(arch):
    """Every config's attention head up to 256 wide fits the body; G <= 8
    at every config (one head group a block)."""
    cfg = get_config(arch)
    if getattr(cfg, "mla", None) or cfg.n_heads < 2 or cfg.head_dim > _cuda.MAX_HEAD_DIM:
        return
    assert fd.decode_tc_smem_bytes(cfg.head_dim, cfg.head_dim) <= _cuda.MAX_SMEM_BYTES
    assert fd.decode_plan_bf16(2048, cfg.n_heads, cfg.n_kv_heads)[2] == 1


# --------------------------------------------------------------------------- #
# the C interface and the CPU path
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("name,src,sig", [
    ("rmsnorm_bf16", "rmsnorm.cu", (_cuda._P,) * 4 + (_cuda._I,) * 2 + (_cuda._F, _cuda._P)),
    ("flash_decode_bf16", "flash_decode.cu",
     (_cuda._P,) * 8 + (_cuda._I,) * 7 + (_cuda._F, _cuda._P)),
])
def test_bf16_entries_ctypes_signatures(name, src, sig):
    m = re.search(rf'extern "C" int {name}\(([^)]*)\)', _src(src))
    params = [p.strip().rsplit(" ", 1)[0] for p in m.group(1).split(",")]
    want = [{"int": _cuda._I, "float": _cuda._F}.get(p, _cuda._P) for p in params]
    assert tuple(want) == sig == _cuda._SIGNATURES[name]


def test_cpu_tensors_take_the_plain_versions():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3, 40)).astype(np.float32)).bfloat16()
    w = torch.ones(40, dtype=torch.bfloat16)
    before = (rn.rmsnorm.bf16.launches, fd.flash_decode.bf16.launches,
              fd.combine_partials.bf16.launches)
    assert torch.equal(rn.rmsnorm(x, w), rn.rmsnorm_plain(x, w))
    q = torch.from_numpy(rng.standard_normal((2, 4, 64)).astype(np.float32)).bfloat16()
    k = torch.from_numpy(rng.standard_normal((2, 20, 1, 64)).astype(np.float32)).bfloat16()
    lengths = torch.tensor([20, 0], dtype=torch.int32)
    got = fd.flash_decode(q, k, k, lengths)
    assert torch.equal(got, fd.flash_decode_plain(q, k, k, lengths, 64 ** -0.5))
    assert float(got[1].float().abs().max()) == 0.0
    assert (rn.rmsnorm.bf16.launches, fd.flash_decode.bf16.launches,
            fd.combine_partials.bf16.launches) == before
