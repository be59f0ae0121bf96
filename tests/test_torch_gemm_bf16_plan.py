"""The bf16 GEMM body's plan and constants, held on the CPU (the tensor-core
kernel itself runs only on the card, tests/test_torch_gpu.py):

- ``gemm_bf16_plan`` reads M, N and the expert count and nothing else (no
  batch), returns one of the body's two tiles and never splits K; decode
  shapes take the narrow tile and spread the weights over the SMs;
- its tiles, its K depth, its one instruction shape and the C entries'
  ctypes signatures agree with ``csrc/gemm.cu``;
- the plain versions the kernel is held to on the card (``gemm_plain`` /
  ``batched_gemm_plain`` at bf16: fp32 on the upcast operands, rounded
  once) against JAX's Pallas ``gemm`` / ``batched_gemm`` in interpret mode
  at the plan's edges (M 63/64/65/127/128/129, K 15/16/17/301, N off 8),
  within one bf16 ulp + 2e-5.
"""

import inspect
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gemm import batched_gemm as jbatched_gemm
from repro.kernels.gemm import gemm as jgemm
from repro_torch.kernels import _cuda
from repro_torch.kernels import gemm as gm

CSRC = Path(_cuda.__file__).resolve().parent.parent / "csrc"
F32_TOL = 2e-5
SMS = 132   # an H100 SXM's streaming multiprocessors


def _src() -> str:
    return (CSRC / "gemm.cu").read_text()


def _bf16(rng, *shape, scale=1.0):
    """(a JAX bf16 array, a torch bf16 tensor with the same bits)."""
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def _within_one_ulp(got: torch.Tensor, want) -> None:
    """Both bf16: |got - want| <= one bf16 ulp of the larger + F32_TOL."""
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    assert g.shape == w.shape
    mag = np.maximum(np.maximum(np.abs(g), np.abs(w)), np.float32(2.0 ** -126))
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    diff = np.abs(g - w)
    assert np.all(diff <= ulp + F32_TOL), float(np.max(diff - ulp))


# --------------------------------------------------------------------------- #
# the plan
# --------------------------------------------------------------------------- #

def test_plan_reads_m_n_and_the_expert_count_alone():
    """No batch, no K: the plan's arguments are the output's shape and the
    number of products in the launch."""
    assert list(inspect.signature(gm.gemm_bf16_plan).parameters) == ["m", "n", "count"]


@pytest.mark.parametrize("m", [1, 4, 16, 17, 32, 63, 64, 65, 127, 128, 129, 256, 1024, 4096])
@pytest.mark.parametrize("n,count", [(9, 1), (1152, 1), (6912, 1), (262144, 1), (1408, 64),
                                     (512, 16)])
def test_plan_is_a_tile_of_the_body_and_never_splits_k(m, n, count):
    """The plan is (BM, BN), one of the two instances gemm_bf16 takes: no K
    split, no third number; the wide tile only past one 64-row warpgroup,
    and only where the launch keeps MIN_BIG_TILE_BLOCKS blocks."""
    plan = gm.gemm_bf16_plan(m, n, count)
    assert plan in gm.BF16_TILES and len(plan) == 2
    assert gm.gemm_bf16_plan(m, n, count) == plan            # no state
    if m <= gm.BF16_TILES[0][0]:
        assert plan == gm.BF16_TILES[0]
    if plan == gm.BF16_TILES[1]:
        assert count * -(-m // 128) * -(-n // 128) >= gm.MIN_BIG_TILE_BLOCKS


@pytest.mark.parametrize("m,n,count,plan", [
    (4, 262144, 1, (64, 64)),      # gemma3-1b's head at the batcher's decode
    (1, 262144, 1, (64, 64)),      # ... and at its batch-1 reference
    (1024, 6912, 1, (128, 128)),   # gemma3-1b's prefill gate/up
    (1024, 1152, 1, (64, 64)),     # its down projection: 72 wide blocks would idle SMs
    (32, 1408, 64, (64, 64)),      # qwen2's expert decode (batch 4 x capacity 8)
    (80, 1408, 64, (128, 128)),    # qwen2's expert prefill
    (120, 1408, 64, (128, 128)),   # deepseek's expert prefill
    (4, 512, 16, (64, 64)),        # MLA's absorbed products
])
def test_plan_at_the_served_shapes(m, n, count, plan):
    assert gm.gemm_bf16_plan(m, n, count) == plan


@pytest.mark.parametrize("m,n,count", [(4, 262144, 1), (32, 1408, 64), (4, 2048, 64),
                                       (1, 32000, 1), (4, 256256, 1)])
def test_decode_blocks_cover_the_sms(m, n, count):
    """Decode's narrow 64-column strips: each weight is read by one block
    and the launch has at least one block per SM."""
    bm, bn = gm.gemm_bf16_plan(m, n, count)
    assert bm == 64 and count * -(-n // bn) >= SMS


def test_fp32_plan_is_unchanged():
    """The fp32 entries keep their own variant and tiles."""
    assert gm.TILES == ((128, 128), (32, 64)) and gm.SKINNY_MAX_M == 16
    assert gm.gemm_tile(1024, 6912) == (128, 128) and gm.gemm_variant(4) == "skinny"


# --------------------------------------------------------------------------- #
# the constants and the C interface
# --------------------------------------------------------------------------- #

def test_tiles_and_depth_are_the_cuda_sources():
    src = _src()
    assert int(re.search(r"\bWG_BK = (\d+)", src).group(1)) == gm.BF16_BK == 64
    for bm, bn in gm.BF16_TILES:
        assert re.search(rf"bm == {bm} && bn == {bn}\) return launch_wgmma<{bm // 64}, {bn}>",
                         src), (bm, bn)
    assert "struct Wg" in src and "BM = 64 * NWG" in src


def test_one_instruction_shape_and_no_split_k():
    """Every plan issues the same wgmma instruction shape (the shared
    header's m64n64k16 with B N-major, the weights as stored), and every
    block walks the whole of K from 0 (no K offset from the grid)."""
    src = _src()
    header = (CSRC / "wgmma.cuh").read_text()
    assert '#include "wgmma.cuh"' in src and "wgmma.mma_async" not in src
    shapes = set(re.findall(r"wgmma\.mma_async\.sync\.aligned\.(m\d+n\d+k\d+)\.(\S+)", header))
    assert shapes == {("m64n64k16", "f32.bf16.bf16")}
    assert set(re.findall(r"\bwgmma_m\w+<\d+>", src)) == {"wgmma_m64n64k16<1>"}
    flat = " ".join(src.split())
    assert "const int n_steps = (K + WG_BK - 1) / WG_BK;" in flat
    assert "for (int t = 0; t < n_steps; ++t)" in flat
    assert "blockIdx.z" in flat and "k_split" not in flat and "splitk" not in flat.lower()


def test_fp32_entries_are_ffma_only():
    """The FFMA kernels carry no element type and no bf16 branch."""
    src = _src()
    assert "gemm_bf16_skinny" not in src and "gemm_bf16_tiled" not in src
    assert "typename T" not in src and "kF32" not in src


def _c_params(name):
    m = re.search(rf'extern "C" int {name}\(([^)]*)\)', _src())
    return [p.strip().rsplit(" ", 1)[0] for p in m.group(1).split(",")]


@pytest.mark.parametrize("name,n_ints", [("gemm_bf16", 5), ("batched_gemm_bf16", 6)])
def test_bf16_entries_ctypes_signatures(name, n_ints):
    """a, b, c as pointers, then the ints (E,) M, N, K, bm, bn, the stream."""
    params = _c_params(name)
    sig = _cuda._SIGNATURES[name]
    assert len(params) == len(sig) == 3 + n_ints + 1
    assert params[:3] == ["const __nv_bfloat16*", "const __nv_bfloat16*", "__nv_bfloat16*"]
    assert params[3:-1] == ["int"] * n_ints and params[-1] == "void*"
    assert sig[:3] == (_cuda._P,) * 3 and sig[3:-1] == (_cuda._I,) * n_ints
    assert sig[-1] is _cuda._P
    assert "gemm_bf16_skinny" not in _cuda._SIGNATURES


# --------------------------------------------------------------------------- #
# the plain versions at bf16 against Pallas at the plan's edges
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("m,k,n", [(63, 15, 37), (64, 16, 40), (65, 17, 33), (127, 301, 19),
                                   (128, 16, 130), (129, 301, 70), (1, 17, 9), (64, 301, 250)])
def test_gemm_plain_bf16_against_pallas(m, k, n):
    rng = np.random.default_rng(m * 1000 + k + n)
    jx, x = _bf16(rng, m, k)
    jw, w = _bf16(rng, k, n, scale=k ** -0.5)
    launches = gm.gemm.bf16.launches
    got = gm.gemm(x, w)
    assert gm.gemm.bf16.launches == launches               # CPU tensors: the plain version
    assert torch.equal(got, gm.gemm_plain(x, w))
    assert torch.equal(got, (x.float() @ w.float()).to(torch.bfloat16))
    _within_one_ulp(got, jgemm(jx, jw, interpret=True))


@pytest.mark.parametrize("e,m,k,n", [(3, 63, 15, 37), (2, 65, 301, 19), (2, 128, 17, 70),
                                     (4, 129, 16, 9)])
def test_batched_gemm_plain_bf16_against_pallas(e, m, k, n):
    rng = np.random.default_rng(e * 1000 + m + k + n)
    jx, x = _bf16(rng, e, m, k)
    jw, w = _bf16(rng, e, k, n, scale=k ** -0.5)
    got = gm.batched_gemm(x, w)
    assert torch.equal(got, gm.batched_gemm_plain(x, w))
    for i in range(e):                   # expert i is the plain product x[i] @ w[i]
        assert torch.equal(got[i], gm.gemm_plain(x[i], w[i]))
    _within_one_ulp(got, jbatched_gemm(jx, jw, interpret=True))
