"""The redesigned decode and GEMM kernels' algorithms and constants, held on
the CPU (the kernels themselves run only on the card, tests/test_torch_gpu.py):

- the fixed-shard formulation of ``csrc/flash_decode.cu`` — the partials of
  shards of ``decode_shard_rows(S)`` rows (``flash_decode_partial_plain``)
  merged in shard order (``combine_partials_ref``) — against JAX's Pallas
  ``flash_decode`` in interpret mode and the port's ``flash_decode_plain``,
  at lengths on and around the shard edges;
- the shard size and the GEMM variant threshold depend on no batch size;
- ``decode_fits`` under the new shared-memory layout admits every attention
  shape of the configs the port serves;
- the Python constants and ctypes signatures agree with the CUDA sources.

Tolerance 1e-5: fp32 on both sides, summed in another order."""

import inspect
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels.flash_decode import flash_decode as jflash_decode
from repro_torch.configs import get_config
from repro_torch.kernels import _cuda
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import gemm as gm
from repro_torch.kernels.ops import decode_attention
from repro_torch.kernels.ref import combine_partials_ref

TOL = dict(rtol=1e-5, atol=1e-5)
CSRC = Path(_cuda.__file__).resolve().parent.parent / "csrc"
SERVED = ("gemma3-1b", "phi3-mini-3.8b", "stablelm-12b", "minitron-4b", "qwen2-moe-a2.7b")


def _qkv(b, s, hq, hk, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, d)).astype(np.float32),
            rng.standard_normal((b, s, hk, d)).astype(np.float32),
            rng.standard_normal((b, s, hk, d)).astype(np.float32))


def _fixed_shards(q, k, v, lengths, scale):
    """What the card computes: each shard's partials, merged in shard order."""
    s_len = k.shape[1]
    shard = fd.decode_shard_rows(s_len)
    assert s_len % shard == 0
    acc, m, l = fd.flash_decode_partial_plain(q, k, v, lengths, scale, s_len // shard)
    return combine_partials_ref(acc, m, l)


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("d", [96, 256])
def test_fixed_shard_formulation_matches_pallas_and_plain(g, d):
    shard = fd.decode_shard_rows(256)
    s_len = 4 * shard
    lens = [0, 1, shard - 1, shard, shard + 1, s_len]
    hk = 2 if g == 1 else 1
    q, k, v = _qkv(len(lens), s_len, g * hk, hk, d, seed=g + d)
    lengths = np.asarray(lens, np.int32)
    scale = 1.0 / math.sqrt(d)
    got = _fixed_shards(*(torch.from_numpy(a) for a in (q, k, v, lengths)), scale)
    want = np.asarray(jflash_decode(q, k, v, lengths, block_kv=64, interpret=True))
    plain = fd.flash_decode_plain(*(torch.from_numpy(a) for a in (q, k, v, lengths)), scale)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    # the Pallas kernel and the port agree but at length 0, where Pallas
    # gives 0 (finite -1e30 mask, acc / max(l, 1e-30)) as the kernel does
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert float(got[0].abs().max()) == 0.0


@pytest.mark.parametrize("n_splits", [1, 2, 8])
def test_combine_kernel_plain_version_is_combine_partials_ref(n_splits):
    """``combine_partials`` on CPU tensors, the ``cuda_split`` backend's
    merge; an all-empty row (every shard acc 0, m -1e30, l 0) gives 0."""
    q, k, v = _qkv(4, 64, 4, 1, 32, seed=n_splits)
    lengths = torch.tensor([0, 5, 33, 64], dtype=torch.int32)
    parts = fd.flash_decode_partial(*(torch.from_numpy(a) for a in (q, k, v)), lengths,
                                    n_splits=n_splits)
    got = fd.combine_partials(*parts)
    assert torch.equal(got, combine_partials_ref(*parts))
    assert float(got[0].abs().max()) == 0.0
    split = decode_attention(*(torch.from_numpy(a) for a in (q, k, v)), lengths,
                             backend="cuda_split", n_splits=max(n_splits, 2))
    np.testing.assert_allclose(split.numpy(), fd.flash_decode_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), lengths, 1 / math.sqrt(32)).numpy(), **TOL)


@pytest.mark.parametrize("n_shards,b,hq,dv", [(1, 1, 1, 1), (32, 4, 4, 256), (3, 2, 5, 72)])
def test_decode_workspace_is_three_views_of_one_allocation(n_shards, b, hq, dv):
    """acc, m and l as the C entries take them (contiguous, float32), in one
    buffer without overlap: one allocation per decode call, not three."""
    acc, m, l = fd._workspace(n_shards, b, hq, dv, "cpu")
    assert acc.shape == (n_shards, b, hq, dv) and m.shape == l.shape == (n_shards, b, hq)
    assert all(t.is_contiguous() and t.dtype == torch.float32 for t in (acc, m, l))
    base = acc.untyped_storage().data_ptr()
    assert m.untyped_storage().data_ptr() == l.untyped_storage().data_ptr() == base
    rows = n_shards * b * hq
    assert (m.data_ptr() - base, l.data_ptr() - base) == (4 * rows * dv, 4 * rows * (dv + 1))
    assert acc.untyped_storage().nbytes() == 4 * rows * (dv + 2)


@pytest.mark.parametrize("bad", ["shape", "dtype"])
def test_combine_partials_refuses_what_the_kernel_does_not_take(bad):
    acc, m, l = torch.zeros(2, 3, 8), torch.zeros(2, 3), torch.zeros(2, 3)
    if bad == "shape":
        with pytest.raises(ValueError):
            fd.combine_partials(acc, m[:, :2], l)
    else:
        with pytest.raises(TypeError):
            fd.combine_partials(acc.double(), m, l)


@pytest.mark.parametrize("fn", [fd.decode_shard_rows, gm.gemm_variant])
def test_shard_size_and_gemm_variant_take_no_batch(fn):
    """The shard size is a function of the cache's row count alone; the
    GEMM variant of M alone, and only the speed depends on it."""
    params = list(inspect.signature(fn).parameters)
    assert params == (["s_len"] if fn is fd.decode_shard_rows else ["m"])


@pytest.mark.parametrize("s_len", [1, 63, 64, 512, 1024, 2048, 8192, 8193, 32768, 1 << 20])
def test_decode_shard_rows(s_len):
    shard = fd.decode_shard_rows(s_len)
    assert shard % fd.SHARD_ROWS == 0 and shard & (shard - 1) == 0
    assert -(-s_len // shard) <= fd.MAX_SHARDS <= fd.MAX_COMBINE_SHARDS
    assert shard == fd.SHARD_ROWS or -(-s_len // (shard // 2)) > fd.MAX_SHARDS
    assert fd.decode_shard_rows(s_len) == shard        # no state, no batch


def test_gemm_variant_threshold():
    t = gm.SKINNY_MAX_M
    assert [gm.gemm_variant(m) for m in (1, 4, t, t + 1, 64, 256)] == \
        ["skinny"] * 3 + ["tiled"] * 3
    src = (CSRC / "gemm.cu").read_text()
    assert f"M > {t}" in src and f"M <= {t}" in src


@pytest.mark.parametrize("m,n,tile", [(256, 8192, (128, 128)), (256, 3072, (32, 64)),
                                      (1024, 2048, (128, 128)), (64, 8192, (32, 64)),
                                      (3136, 64, (32, 64)), (17, 300, (32, 64)),
                                      (64, 32064, (32, 64))])
def test_gemm_tile(m, n, tile):
    """128x128 only where M fills its rows and it gives about one block per
    SM; the rule reads M and N, and every tile is an instance the C entry
    point takes."""
    assert gm.gemm_tile(m, n) == tile and tile in gm.TILES
    src = (CSRC / "gemm.cu").read_text()
    assert all(f"bm == {bm} && bn == {bn}" in src for bm, bn in gm.TILES)


@pytest.mark.parametrize("arch", SERVED)
def test_decode_fits_admits_every_served_attention_shape(arch):
    cfg = get_config(arch)
    hq, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    assert fd.decode_fits(hq, hk, dh, dh) and fd.paged_decode_fits(hq, hk, dh, dh)


@pytest.mark.parametrize("d,dv", [(256, 256), (160, 160), (128, 128), (96, 96), (6, 10)])
def test_two_decode_blocks_fit_on_an_sm(d, dv):
    """228 KB of shared memory per SM, 1 KB of it reserved per block."""
    assert 2 * (fd.decode_smem_bytes(d, dv) + 1024) <= 228 * 1024
    assert fd.decode_fits(4, 1, d, dv)


def test_python_layout_constants_are_the_cuda_sources():
    src = (CSRC / "flash_decode.cu").read_text()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+)", src).group(1))

    assert const("THREADS") // 32 == fd.WARPS
    assert (const("ROWS"), const("NST"), const("GMAX")) == \
        (fd.BLOCK_KV, fd.RING, fd.GROUP_HEADS)
    assert 32 * 4 * const("NCH") == _cuda.MAX_HEAD_DIM
    assert f"smem > 48 * 1024" in src and fd.MAX_COMBINE_SHARDS == 48 * 1024 // 4


def _c_entries():
    out = {}
    for src in _cuda.SOURCES:
        text = (CSRC / src).read_text()
        for name, params in re.findall(r'extern "C" (?:int|const char\*) (\w+)\(([^)]*)\)', text):
            out[name] = [p.strip() for p in params.split(",") if p.strip()]
    return out


@pytest.mark.parametrize("name", sorted(_cuda._SIGNATURES))
def test_ctypes_signatures_match_the_c_entry_points(name):
    params = _c_entries()[name]
    sig = _cuda._SIGNATURES[name]
    assert len(params) == len(sig)
    for p, t in zip(params, sig):
        ctype = p.rsplit(" ", 1)[0]
        want = {"int": _cuda._I, "float": _cuda._F}.get(ctype, _cuda._P)
        assert t is want, (name, p)
