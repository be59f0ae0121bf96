"""The plan, constants and dispatch of the tensor-core bf16 partial decode
(``flash_decode_partial_bf16``), held on the CPU (the kernels themselves run
only on the card, tests/test_torch_gpu.py):

- ``decode_plan_partial_bf16`` reads the caller shard's rows, the head
  counts, n_splits and the layout, never the batch; its sub-shards are whole
  16-row tiles that cover each caller shard and, cut by the kernels' row
  formula, never reach into the next one;
- the Python constants and shared-memory formulas are the CUDA source's and
  fit the H100's 227 KB; ``decode_fits(bf16=True)`` is derived from the
  tensor-core bodies' blocks;
- bf16 partials dispatch to the tensor-core bodies (the narrow one's
  partial mode, the wide one and the combine's grouped mode), fp32 partials
  stay on ``flash_decode_partial_f32`` and the former body is the
  yardstick ``flash_decode_partial_bf16_ffma``;
- the combine's grouped merge, in plain PyTorch, applied to plain partials
  of n_splits * c shards is the plain partial over n_splits shards, empty
  shards exactly (0, -1e30, 0);
- on CPU tensors the wrapper runs its plain version and counts no launch;
  the yardstick refuses CPU tensors.
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

CSRC = Path(_cuda.__file__).resolve().parent.parent / "csrc"
F32_TOL = dict(rtol=2e-5, atol=2e-5)   # fp32 on both sides, another summation order


def _src() -> str:
    return (CSRC / "flash_decode.cu").read_text()


def _flat() -> str:
    return " ".join(_src().split())


def _const(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int [^;]*\b{name} = (\d+)", src).group(1))


def _body(src: str, start: str, end: str) -> str:
    """From ``start`` up to the first ``end`` after it."""
    i = src.index(start)
    return src[i:src.index(end, i)]


def _heads():
    """The (Hq, Hk) of every served attention config, and MLA's absorbed
    decode (16 heads on one latent kv head)."""
    out = {(16, 1)}
    for arch in list_configs():
        cfg = get_config(arch)
        if cfg.n_heads >= 1 and getattr(cfg, "n_kv_heads", 0):
            out.add((cfg.n_heads, cfg.n_kv_heads))
    return sorted(out)


# --------------------------------------------------------------------------- #
# the plan
# --------------------------------------------------------------------------- #

def test_plan_takes_no_batch():
    assert list(inspect.signature(fd.decode_plan_partial_bf16).parameters) == [
        "part", "hq", "hk", "n_splits", "wide"]


def _kernel_rows(part: int, sub: int, nsub: int, split: int, j: int):
    """A block's rows, as decode_tc_kernel and decode_wide_kernel cut them:
    [row0, row0 + rows) with rows = max(min(sub, (split + 1) * part - row0), 0)."""
    row0 = split * part + j * sub
    return row0, max(min(sub, (split + 1) * part - row0), 0)


@pytest.mark.parametrize("s_len", [1, 15, 16, 17, 48, 64, 100, 256, 500, 1000, 1024, 2048, 4096,
                                   32768])
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_plan_keeps_whole_tiles_inside_each_caller_shard(s_len, wide):
    for hq, hk in _heads():
        for ns in range(1, 17):
            if s_len % ns:
                continue
            part = s_len // ns
            sub, nsub, groups = fd.decode_plan_partial_bf16(part, hq, hk, ns, wide)
            tile, heads = (fd.WD_ROWS, fd.WD_HEADS) if wide else (fd.TC_ROWS, fd.TC_HEADS)
            assert groups == -(-(hq // hk) // heads)
            assert sub % tile == 0 and sub >= tile
            assert nsub * sub >= part and (nsub - 1) * sub < part            # none empty
            if wide:
                assert sub >= fd.WD_MIN_SHARD and ns * nsub <= 65535
                assert nsub <= fd.MAX_COMBINE_SHARDS
            else:
                assert 1 <= nsub <= fd.TC_CLUSTER
                assert nsub == 1 or ns * hk * groups * nsub <= fd.TC_FILL
            # the kernels' rows of each caller shard: disjoint, in order, the
            # whole caller shard and nothing past it
            for split in {0, ns - 1}:
                covered = []
                for j in range(nsub):
                    row0, rows = _kernel_rows(part, sub, nsub, split, j)
                    assert rows > 0 and row0 + rows <= (split + 1) * part
                    covered.extend(range(row0, row0 + rows))
                assert covered == list(range(split * part, (split + 1) * part))


@pytest.mark.parametrize("part,hq,hk,ns,wide,plan", [
    (1024, 4, 1, 1, False, (128, 8, 1)),     # gemma3-1b's tree decode, one rank's global rows
    (256, 4, 1, 1, False, (64, 4, 1)),       # and its rolling window's
    (1024, 4, 1, 2, False, (128, 8, 1)),     # gemma3-1b global, S 2048, n_splits 2
    (512, 4, 1, 4, False, (64, 8, 1)),
    (256, 4, 1, 8, False, (64, 4, 1)),
    (128, 4, 1, 16, False, (64, 2, 1)),
    (512, 32, 32, 2, False, (512, 1, 1)),    # phi3-mini's engine decode
    (500, 4, 1, 2, False, (64, 8, 1)),       # S 1000: a caller shard off 16 rows
    (1024, 16, 1, 2, True, (64, 16, 1)),     # MLA's absorbed decode
    (500, 16, 1, 2, True, (64, 8, 1)),
])
def test_plan_at_the_served_shapes(part, hq, hk, ns, wide, plan):
    assert fd.decode_plan_partial_bf16(part, hq, hk, ns, wide) == plan


def test_plan_is_the_decode_plans_rule():
    """The tree decode's n_splits 1 at many caller-shard rows is the decode's
    own plan on those rows (the wide body's in full; the narrow body's where
    its sub-shards take TC_MIN_SUB rows or more)."""
    for s_len in (64, 128, 512, 1024, 2048, 8192):
        for hq, hk in ((4, 1), (16, 16), (32, 32)):
            assert (fd.decode_plan_partial_bf16(s_len, hq, hk, 1, False)
                    == fd.decode_plan_bf16(s_len, hq, hk)
                    or fd.decode_plan_bf16(s_len, hq, hk)[0] < fd.TC_MIN_SUB)
        assert (fd.decode_plan_partial_bf16(s_len, 16, 1, 1, True)
                == fd.decode_plan_wide_bf16(s_len, 16, 1))


# --------------------------------------------------------------------------- #
# constants, shared memory and the C interface against the source
# --------------------------------------------------------------------------- #

def test_constants_are_the_cuda_source():
    src = _src()
    assert fd.TC_MIN_SUB == fd.TC_WARPS * fd.TC_ROWS == 64
    assert (_const(src, "TC_ROWS"), _const(src, "TC_CLUSTER"), _const(src, "WD_ROWS")) == (
        fd.TC_ROWS, fd.TC_CLUSTER, fd.WD_ROWS)
    flat = _flat()
    # the C side checks the plan's sub-shards against the cluster and the tiles
    narrow = _body(flat, "int decode_tc(", "// -----")
    assert "shard % TC_ROWS || (part + shard - 1) / shard > TC_CLUSTER" in narrow
    wide = _body(flat, "int decode_wide(", "} // namespace")
    assert "shard % WD_ROWS" in wide
    assert "nsub = shard > 0 ? (part + shard - 1) / shard : 0" in wide
    # one row formula in both kernels: a block never reads past its caller shard
    rows = "const int rows = max(min(shard, (split + 1) * part - row0), 0);"
    assert flat.count(rows) == 2
    assert flat.count("const int len = min(max(min(max(lengths[b], 0), S) - row0, 0), rows);") == 2


@pytest.mark.parametrize("d,dv", [(64, 64), (96, 96), (112, 112), (128, 128), (256, 256),
                                  (30, 30), (1, 1), (576, 512), (640, 512), (584, 500),
                                  (257, 1), (40, 300)])
def test_bf16_fits_is_the_tensor_core_bodies_shared_memory(d, dv):
    narrow = max(d, dv) <= _cuda.MAX_HEAD_DIM
    smem = fd.decode_tc_smem_bytes(d, dv) if narrow else fd.decode_wide_smem_bytes(d, dv)
    assert smem <= _cuda.MAX_SMEM_BYTES
    assert fd.decode_fits(4, 1, d, dv, bf16=True) and fd.decode_fits(16, 1, d, dv, bf16=True)
    assert fd.decode_tc_smem_bytes(256, 256) == 206976
    assert fd.decode_wide_smem_bytes(576, 512) == 202112
    text = " ".join(inspect.getsource(fd.decode_fits).split())
    assert ("smem = decode_tc_smem_bytes(d, dv) if narrow else decode_wide_smem_bytes(d, dv)"
            in text)


def test_bf16_fits_refuses_what_the_bodies_do_not_take():
    assert not fd.decode_fits(4, 1, fd.MAX_WIDE_D + 1, 64, bf16=True)
    assert not fd.decode_fits(4, 1, 64, fd.MAX_WIDE_DV + 1, bf16=True)
    assert not fd.decode_fits(4, 3, 64, 64, bf16=True)


def _c_signature(name: str):
    m = re.search(rf'extern "C" int {name}\(([^)]*)\)', _src())
    params = [p.strip().rsplit(" ", 1)[0] for p in m.group(1).split(",")]
    return tuple({"int": _cuda._I, "float": _cuda._F}.get(p, _cuda._P) for p in params)


@pytest.mark.parametrize("name,sig", [
    ("flash_decode_partial_bf16", (_cuda._P,) * 10 + (_cuda._I,) * 8 + (_cuda._F, _cuda._P)),
    ("flash_decode_partial_bf16_ffma", (_cuda._P,) * 7 + (_cuda._I,) * 7 + (_cuda._F, _cuda._P)),
    ("flash_decode_partial_f32", (_cuda._P,) * 7 + (_cuda._I,) * 7 + (_cuda._F, _cuda._P)),
])
def test_ctypes_signatures(name, sig):
    assert _c_signature(name) == sig == _cuda._SIGNATURES[name]


# --------------------------------------------------------------------------- #
# which body each entry runs
# --------------------------------------------------------------------------- #

def test_bf16_partials_run_the_tensor_core_bodies():
    flat = _flat()
    entry = _body(flat, 'extern "C" int flash_decode_partial_bf16(',
                  'extern "C" int flash_decode_partial_bf16_ffma(')
    assert ("if (D <= 32 * 4 * NCH && Dv <= 32 * 4 * NCH) return decode_tc(q, k, v, lengths, "
            "acc, m, l, B, Hq, Hk, S, D, Dv, n_splits, sub, scale, true, stream);") in entry
    assert ("return decode_wide(q, k, v, lengths, ws_acc, ws_m, ws_l, acc, m, l, B, Hq, Hk, S, D, "
            "Dv, n_splits, sub, scale, stream);") in entry
    assert "launch_shards" not in entry
    # the narrow partial is decode_tc_kernel's partial mode; the wide one the
    # wide body, then the combine merging each caller shard's sub-shards
    assert "template <int NV, bool PARTIAL> __global__" in flat
    assert "(partial ? launch_tc<NV, true>(q, k, v, lengths, o, m, l," in flat
    assert "if (m_out != nullptr) return combine_groups(acc, m, l, o, m_out, l_out, nsub," in flat
    # the decode: the same launchers with one caller shard, no partial outputs
    decode = _body(flat, 'extern "C" int flash_decode_bf16(',
                   'extern "C" int flash_decode_bf16_ffma(')
    assert ("return decode_tc(q, k, v, lengths, o, nullptr, nullptr, B, Hq, Hk, S, D, Dv, 1, "
            "shard, scale, false, stream);") in decode
    assert ("return decode_wide(q, k, v, lengths, acc, m, l, o, nullptr, nullptr, B, Hq, Hk, S, "
            "D, Dv, 1, shard, scale, stream);") in decode
    assert "combine_kernel<repro_torch::bf16, true><<<" in flat
    # the former body is the yardstick; the fp32 partial keeps the fp32 body
    ffma = flat[flat.index('extern "C" int flash_decode_partial_bf16_ffma('):]
    assert "return launch_shards(q, k, v, nullptr, nullptr, DenseRows{S, Hk}," in ffma
    f32 = _body(flat, 'extern "C" int flash_decode_partial_f32(',
                'extern "C" int combine_partials_f32(')
    assert "return launch_shards(q, k, v, nullptr, nullptr, DenseRows{S, Hk}," in f32
    # the wrapper: the plan's sub-shard rows for bf16, a workspace for the wide body only
    wrapper = " ".join(inspect.getsource(fd.flash_decode_partial).split())
    assert ("sub, nsub, _ = decode_plan_partial_bf16(s_len // n_splits, hq, hk, n_splits, wide)"
            in wrapper)
    assert "lib.flash_decode_partial_f32(" in wrapper
    assert "lib.flash_decode_partial_bf16(" in wrapper
    assert "combine_partials.bf16.launches += 1" in wrapper


def test_partial_mode_writes_unnormalised_natural_partials():
    """The narrow partial mode writes acc undivided, l raw and m from log2
    units to natural ones, an empty shard's m kept at -1e30; the combine's
    grouped mode writes m and l and acc undivided."""
    flat = _flat()
    tc = _body(flat, "decode_tc_kernel(const bf16*", "int launch_tc(")
    assert "m_out[row] = mm == repro_torch::kNegInf ? mm : mm * 0.6931471805599453f;" in tc
    assert "l_out[row] = ls;" in tc
    assert "__float2bfloat16_rn(PARTIAL ? a : a / wsum[g]);" in tc
    # no other cluster barrier than the decode's two
    assert tc.count("cluster.sync();") == 2
    comb = _body(flat, "combine_kernel(const float*", "int combine(")
    assert "out[(grp * R + row) * Dv + d] = repro_torch::from_f32<TO>(o);" in comb
    assert "m_out[grp * R + row] = m_max;" in comb and "l_out[grp * R + row] = ls;" in comb


# --------------------------------------------------------------------------- #
# the grouped merge, and the CPU path
# --------------------------------------------------------------------------- #

def _inputs(b, s, hq, hk, d, dv, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)

    return t(b, hq, d), t(b, s, hk, d), t(b, s, hk, dv)


@pytest.mark.parametrize("ns,c", [(1, 8), (2, 4), (2, 8), (4, 2), (3, 5), (16, 2)])
def test_grouped_merge_of_plain_partials_is_the_plain_partial(ns, c):
    s = 480
    q, k, v = _inputs(5, s, 4, 1, 32, 24, ns * 10 + c)
    lengths = torch.tensor([0, 1, s // ns, s // ns + 7, s], dtype=torch.int32)
    fine = fd.flash_decode_partial_plain(q, k, v, lengths, 32 ** -0.5, ns * c)
    acc, m, l = fd.merge_partial_groups_plain(*fine, c)
    want = fd.flash_decode_partial_plain(q, k, v, lengths, 32 ** -0.5, ns)
    for got, w in zip((acc, m, l), want):
        assert got.shape == w.shape and got.dtype == torch.float32
        torch.testing.assert_close(got, w, **F32_TOL)
    empty = want[2] == 0
    assert bool(empty.any())
    assert bool((m[empty] == -1e30).all()) and bool((l[empty] == 0).all())
    assert bool((acc[empty] == 0).all())


def test_cpu_tensors_take_the_plain_version():
    q, k, v = _inputs(2, 64, 4, 1, 64, 64, 3, torch.bfloat16)
    lengths = torch.tensor([40, 0], dtype=torch.int32)
    before = (fd.flash_decode_partial.launches, fd.flash_decode_partial.bf16.launches,
              fd.combine_partials.bf16.launches)
    for ns in (1, 2, 4):
        got = fd.flash_decode_partial(q, k, v, lengths, n_splits=ns)
        want = fd.flash_decode_partial_plain(q, k, v, lengths, 64 ** -0.5, ns)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert (got[0].dtype, got[1].dtype, got[2].dtype) == (torch.bfloat16, torch.float32,
                                                               torch.float32)
    assert (fd.flash_decode_partial.launches, fd.flash_decode_partial.bf16.launches,
            fd.combine_partials.bf16.launches) == before


def test_yardstick_refuses_cpu_tensors():
    q, k, v = _inputs(2, 64, 4, 1, 64, 64, 4, torch.bfloat16)
    lengths = torch.tensor([40, 0], dtype=torch.int32)
    with pytest.raises(ValueError, match="on the card"):
        fd.flash_decode_partial_bf16_ffma(q, k, v, lengths, n_splits=2)
