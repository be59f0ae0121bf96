"""The plans and constants of the tensor-core bf16 bodies of ssd_scan and of
the wide (MLA) flash_decode, held on the CPU (the kernels themselves run
only on the card, tests/test_torch_gpu.py):

- ``decode_plan_wide_bf16`` reads the cache's rows and the head counts
  alone (no batch), keeps whole 16-row tiles that cover the cache, and
  spreads a sequence over about WD_FILL blocks; the scan's scratch takes no
  batch either;
- the wide body's shared memory and register arrays, and the scan's, are
  the CUDA sources' formulas and fit the H100;
- bf16 at D or Dv past 256 dispatches to the new body, while the fp32 wide
  layout and ``flash_decode_partial_bf16_ffma`` (the former bf16 partial,
  a yardstick) keep the fp32 body, and ``ssd_scan_bf16`` runs the
  tensor-core kernels while ``ssd_scan_f32`` keeps the FFMA ones; every
  product of the new bodies is one mma.sync shape;
- on CPU tensors the wrappers run their plain versions and count no
  launch; the former FFMA bodies, kept as yardsticks, refuse CPU tensors.
"""

import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ssd

CSRC = Path(_cuda.__file__).resolve().parent.parent / "csrc"


def _src(name: str) -> str:
    return (CSRC / name).read_text()


def _const(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int [^;]*\b{name} = (\d+)", src).group(1))


def _body(src: str, start: str, end: str) -> str:
    """From ``start`` up to the first ``end`` after it."""
    i = src.index(start)
    return src[i:src.index(end, i)]


# --------------------------------------------------------------------------- #
# the wide decode's plan
# --------------------------------------------------------------------------- #

def test_plans_take_no_batch():
    assert list(inspect.signature(fd.decode_plan_wide_bf16).parameters) == ["s_len", "hq", "hk"]
    for fn in (ssd.scan_scratch, ssd.scan_fits):
        assert not {"b", "batch", "B"} & set(inspect.signature(fn).parameters)


@pytest.mark.parametrize("s_len", [1, 15, 16, 17, 63, 64, 65, 100, 300, 1400, 2048, 4096, 32768])
@pytest.mark.parametrize("hq,hk", [(16, 1), (8, 2), (4, 1), (32, 2), (48, 1), (128, 128)])
def test_wide_plan_keeps_whole_tiles_that_cover_the_cache(s_len, hq, hk):
    shard, shards, groups = fd.decode_plan_wide_bf16(s_len, hq, hk)
    assert shard % fd.WD_ROWS == 0 and shard >= fd.WD_MIN_SHARD
    assert shards * shard >= s_len and (shards - 1) * shard < max(s_len, 1)   # none empty
    assert groups == -(-(hq // hk) // fd.WD_HEADS)
    assert shards <= fd.MAX_COMBINE_SHARDS
    # about WD_FILL blocks a sequence, where the cache is long enough
    want = max(1, fd.WD_FILL // (hk * groups))
    assert shards <= want or shard == fd.WD_MIN_SHARD


def test_wide_plan_at_mla_decode():
    """deepseek-v2-lite's absorbed decode at the batcher's 2048-row cache:
    32 shards of 64 rows, one head group of all 16 heads."""
    assert fd.decode_plan_wide_bf16(2048, 16, 1) == (64, 32, 1)


# --------------------------------------------------------------------------- #
# shared memory and registers against the CUDA sources
# --------------------------------------------------------------------------- #

def test_wide_constants_are_the_cuda_source():
    src = _src("flash_decode.cu")
    assert _const(src, "WD_THREADS") // 32 == fd.WD_WARPS
    assert (_const(src, "WD_ROWS"), _const(src, "WD_NST"), _const(src, "WD_HEADS")) == (
        fd.WD_ROWS, fd.WD_NST, fd.WD_HEADS)
    # a warp's chunks of D and Dv hold every width the wide layout takes
    nq, nv = _const(src, "WD_NQ"), _const(src, "WD_NV")
    assert 16 * fd.WD_WARPS * nq >= fd.MAX_WIDE_D and 16 * fd.WD_WARPS * nv >= fd.MAX_WIDE_DV
    assert 16 * fd.WD_WARPS * (nq - 1) < fd.MAX_WIDE_D
    assert 16 * fd.WD_WARPS * (nv - 1) < fd.MAX_WIDE_DV
    # the register arrays: q's A fragments and the accumulator, sized by them
    body = _body(src, "decode_wide_kernel(const bf16*", "int decode_wide(")
    assert "unsigned qf[WD_NQ][4];" in body and "float acc[2 * WD_NV][4];" in body


def _wide_smem(d: int, dv: int) -> int:
    """decode_wide_smem_bytes, from the source's constants."""
    src = _src("flash_decode.cu")
    w, rows, nst, heads = (_const(src, "WD_THREADS") // 32, _const(src, "WD_ROWS"),
                           _const(src, "WD_NST"), _const(src, "WD_HEADS"))
    chunks = lambda x: -(-(-(-x // 16)) // w)                           # noqa: E731
    kq, vq = 16 * chunks(d) + 8, 16 * chunks(dv) + 8
    return (2 * heads * (-(-d // 16) * 16 + 8) + 4 * 2 * w * heads * rows
            + 2 * 2 * 2 * heads * (rows + 8) + 4 * 2 * heads + 2 * w * nst * rows * (kq + vq))


@pytest.mark.parametrize("d,dv", [(576, 512), (640, 512), (592, 512), (576, 260), (600, 300),
                                  (40, 300), (257, 1)])
def test_wide_smem_is_the_cuda_formula_and_fits(d, dv):
    text = " ".join(_src("flash_decode.cu").split())
    assert "return ((W + 15) / 16 + WD_WARPS - 1) / WD_WARPS;" in text
    assert ("2 * (size_t)WD_WARPS * WD_NST * WD_ROWS * (kq + vq);") in text
    assert fd.decode_wide_smem_bytes(d, dv) == _wide_smem(d, dv) <= _cuda.MAX_SMEM_BYTES
    assert fd.decode_fits(16, 1, d, dv, bf16=True)


def test_scan_constants_and_shared_memory():
    """state_tc_kernel's static tiles (x and B, MAX_Q rows of 64 values + 8)
    and output_tc_kernel's ring of STAGES steps (a piece of C and the start
    state's hi and lo rows of it, or a key tile's x rows and fp32 scores),
    within the H100's 227 KB, leaving room for more than one block an
    SM."""
    src = _src("ssd.cu")
    tile, max_q, stages = _const(src, "TILE"), _const(src, "MAX_Q"), _const(src, "STAGES")
    nk = _const(src, "TC_NK")
    row, krow, srow, frow = tile + 8, nk + 8, 2 * tile + 8, tile + 8
    assert "constexpr int TC_ROW = TILE + 8;" in src and "constexpr int TC_KROW = TC_NK + 8;" in src
    assert "constexpr int TC_SROW = 2 * TILE + 8;" in src
    assert "constexpr int TC_FROW = TILE + 8;" in src
    state_bytes = 2 * 2 * max_q * row + 3 * 4 * max_q
    stage = max(tile * krow + nk * srow, tile * row + 2 * tile * frow)
    out_bytes = stages * stage * 2
    assert (state_bytes, out_bytes) == (38400, 55296)
    for nbytes in (state_bytes, out_bytes + 2 * 4 * max_q):
        assert 2 * (nbytes + 1024) <= 228 * 1024
    assert state_bytes <= 48 * 1024                                     # static
    assert "constexpr int TC_OUT_BYTES = STAGES * TC_STAGE * 2;" in src
    # the register arrays: the score tile's, the state tile's and the
    # output's accumulators
    for start, end in (("score_tile(const bf16*", "// Phase 1 at bf16"),
                       ("state_tc_kernel(const bf16*", "// Phase 3 at bf16"),
                       ("output_tc_kernel(const bf16*", "int scan_tc(")):
        assert "float acc[8][4] = {};" in _body(src, start, end)


# --------------------------------------------------------------------------- #
# which body each entry runs, and the tensor-core products
# --------------------------------------------------------------------------- #

def test_bf16_wide_dispatches_to_the_new_body():
    flat = " ".join(_src("flash_decode.cu").split())
    entry = _body(flat, 'extern "C" int flash_decode_bf16(', 'extern "C" int flash_decode_bf16_ffma(')
    assert "if (D <= 32 * 4 * NCH && Dv <= 32 * 4 * NCH) return decode_tc(" in entry
    assert "return decode_wide(q, k, v, lengths, acc, m, l, o," in entry
    # the fp32 wide layout and the former bf16 partial (the yardstick, on its
    # bf16 rings) keep the fp32 body; the bf16 partial takes the wide body
    # past 256 too
    f32 = _body(flat, 'extern "C" int flash_decode_f32(', 'extern "C" int flash_paged_decode_f32(')
    assert "return decode(q, k, v, nullptr, nullptr, DenseRows{S, Hk}," in f32
    part = flat[flat.index('extern "C" int flash_decode_partial_bf16_ffma('):]
    assert "return launch_shards(q, k, v, nullptr, nullptr, DenseRows{S, Hk}," in part
    assert "return decode_wide(q, k, v, lengths, ws_acc, ws_m, ws_l, acc, m, l," in _body(
        flat, 'extern "C" int flash_decode_partial_bf16(',
        'extern "C" int flash_decode_partial_bf16_ffma(')
    assert "const bool wide = D > 32 * 4 * NCH || Dv > 32 * 4 * NCH;" in flat
    # the wrapper: the wide plan's shard for bf16, decode_shard_rows for fp32
    wrapper = inspect.getsource(fd.flash_decode)
    assert ("shard = decode_plan_wide_bf16(s_len, hq, hk)[0] if bf16 else "
            "decode_shard_rows(s_len)") in wrapper


def test_bf16_scan_runs_the_tensor_core_kernels():
    flat = " ".join(_src("ssd.cu").split())
    bf16 = _body(flat, 'extern "C" int ssd_scan_bf16(', 'extern "C" int ssd_scan_bf16_ffma(')
    assert "return scan_tc(" in bf16
    f32 = _body(flat, 'extern "C" int ssd_scan_f32(', 'extern "C" int ssd_scan_bf16(')
    assert "return scan(x, dt, A, D, Bm, Cm, y, state, st, sc, cs," in f32
    body = _body(flat, "int scan_tc(", "bool aligned(")
    assert ("state_tc_kernel<true>" in body and "pass_kernel<true>" in body
            and "output_tc_kernel<true>" in body)
    # the score blocks once per group, beside the state blocks, as chunk_kernel's
    assert "g.H * g.ntp * g.ntn + g.G * g.nrt * (g.nrt + 1) / 2" in body
    ffma = _body(flat, "int scan(const T* x", 'extern "C" int ssd_scan_f32(')
    assert "pass_kernel<false>" in ffma and "chunk_kernel<true, T>" in ffma


@pytest.mark.parametrize("src,start,end,count", [
    ("ssd.cu", "score_tile(const bf16*", "// Phase 1 at bf16", 2),
    ("ssd.cu", "state_tc_kernel(const bf16*", "// Phase 3 at bf16", 4),
    ("ssd.cu", "output_tc_kernel(const bf16*", "const float dh = D", 6),     # then y + D x
    ("flash_decode.cu", "decode_wide_kernel(const bf16*", "int decode_wide(", 4),
])
def test_products_are_one_tensor_core_shape(src, start, end, count):
    """Every product of the new bodies goes through common.cuh's one
    mma.sync helper (bf16 in, fp32 accumulate): hi and lo halves of each
    fp32 factor in a fixed order; no FMA product."""
    shapes = set(re.findall(r"mma\.sync\.aligned\.(m\d+n\d+k\d+)\.(\S+)", _src("common.cuh")))
    assert shapes == {("m16n8k16", "row.col.f32.bf16.bf16.f32")}
    body = _body(_src(src), start, end)
    assert body.count("mma16816(") == count and "fmaf" not in body


# --------------------------------------------------------------------------- #
# the CPU path
# --------------------------------------------------------------------------- #

def test_cpu_tensors_take_the_plain_versions():
    rng = np.random.default_rng(0)

    def t(*shape, dtype=torch.bfloat16):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)

    before = (ssd.ssd_scan.bf16.launches, fd.flash_decode.bf16.launches,
              fd.combine_partials.bf16.launches)
    x, b, c = t(1, 32, 4, 8), t(1, 32, 1, 16), t(1, 32, 1, 16)
    dt = torch.nn.functional.softplus(t(1, 32, 4, dtype=torch.float32) - 3.0)
    a = -torch.linspace(1.0, 4.0, 4)
    got = ssd.ssd_scan(x, dt, a, b, c, chunk=16)
    want = ssd.ssd_scan_plain(x, dt, a, b, c, chunk=16)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    q, k, v = t(2, 16, 576), t(2, 20, 1, 576), t(2, 20, 1, 512)
    lengths = torch.tensor([20, 0], dtype=torch.int32)
    out = fd.flash_decode(q, k, v, lengths)
    assert torch.equal(out, fd.flash_decode_plain(q, k, v, lengths, 576 ** -0.5))
    assert float(out[1].float().abs().max()) == 0.0
    assert (ssd.ssd_scan.bf16.launches, fd.flash_decode.bf16.launches,
            fd.combine_partials.bf16.launches) == before
    with pytest.raises(ValueError):
        ssd.ssd_scan_bf16_ffma(x, dt, a, b, c, chunk=16)
    with pytest.raises(ValueError):
        fd.flash_decode_bf16_ffma(q, k, v, lengths)
