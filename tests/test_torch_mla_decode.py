"""The decode kernel's wide layout and the attention shapes of the three new
config families, held against the JAX package on the CPU.

- ``decode_attention`` ``cuda`` (the kernel's plain version on CPU
  tensors) against JAX's ``pallas`` flash-decode in interpret mode at
  deepseek-v2-lite's absorbed MLA decode: 16 query heads on 1 KV head,
  D 576 (latent 512 + rope 64), Dv 512 (the latent), lengths 0 / 1 / 37 /
  64 of 64 rows, the explicit scale 1 / sqrt(192) (the qk width, not
  576).  fp32 on both sides, summed in other orders: 2e-5.  Length 0 is
  compared with the kernels' 0, which JAX's Pallas kernel gives too.
- ``decode_fits`` admits that shape on the dense kernel, not on the paged
  one, and ``decode_smem_bytes`` is the ``.cu`` formula, its constants
  read from ``csrc/flash_decode.cu``; a wide head fits under the H100's
  shared memory only as one block an SM.
- ``attention`` ``cuda`` non-causal with fewer query rows than keys (the
  cross-attention's and the encoder's shapes) against JAX's Pallas
  ``flash_attention`` in interpret mode, and at MLA's prefill widths (D
  192, Dv 128) and zamba2's head (D 112).
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
import repro_torch  # noqa: F401
from repro.core.registry import get_impl as jimpl
from repro.kernels.flash_attention import flash_attention as jflash_attention
from repro_torch.kernels import _cuda, ops
from repro_torch.kernels import flash_decode as fd

TOL = dict(rtol=2e-5, atol=2e-5)
CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
# deepseek-v2-lite's absorbed decode: kv_lora_rank 512, rope 64, nope 128
HQ, HK, RANK, ROPE, NOPE = 16, 1, 512, 64, 128
D, DV = RANK + ROPE, RANK
SCALE = 1.0 / math.sqrt(NOPE + ROPE)


def _mla_inputs(seed, b, s):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, HQ, D)).astype(np.float32)
    ckv = rng.standard_normal((b, s, RANK)).astype(np.float32)
    kpe = rng.standard_normal((b, s, ROPE)).astype(np.float32)
    k = np.concatenate([ckv, kpe], -1)[:, :, None, :]
    return q, k, ckv[:, :, None, :].copy()


@pytest.mark.parametrize("lengths", [(0, 1, 37, 64), (64, 63, 2, 17)])
def test_wide_decode_matches_pallas(lengths):
    b, s = len(lengths), 64
    q, k, v = _mla_inputs(sum(lengths), b, s)
    lens = np.asarray(lengths, np.int32)
    want = np.asarray(jimpl("decode_attention", "pallas")(
        [jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens)],
        {"scale": SCALE, "interpret": True})[0])
    got = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               torch.from_numpy(lens), scale=SCALE, backend="cuda")
    assert got.shape == (b, HQ, DV)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if 0 in lengths:
        assert not got[lengths.index(0)].any()


def test_wide_decode_scale_is_the_one_passed():
    """1 / sqrt(192) explicitly, not the default 1 / sqrt(576), and an
    explicit 0 is kept (the falsy-scale trap): every valid row weighs the
    same."""
    q, k, v = (torch.from_numpy(x) for x in _mla_inputs(3, 2, 64))
    lens = torch.tensor([40, 64], dtype=torch.int32)
    explicit = ops.decode_attention(q, k, v, lens, scale=SCALE, backend="cuda")
    default = ops.decode_attention(q, k, v, lens, backend="cuda")
    assert not torch.allclose(explicit, default, atol=1e-3)
    flat = ops.decode_attention(q, k, v, lens, scale=0.0, backend="cuda")
    for i, n in enumerate((40, 64)):
        want = v[i, :n, 0].mean(0).expand(HQ, DV)
        torch.testing.assert_close(flat[i], want, rtol=1e-5, atol=1e-5)


def _cu_const(name):
    src = (CSRC / "flash_decode.cu").read_text()
    return int(re.search(rf"constexpr int [^;]*\b{name} = (\d+)", src).group(1))


def test_decode_fits_takes_mla_on_the_dense_kernel_only():
    assert fd.decode_fits(HQ, HK, D, DV)
    assert ops.get_impl("decode_attention", "cuda").supports(
        [ops.TensorSpec((4, HQ, D), "float32"), ops.TensorSpec((4, 2048, HK, D), "float32"),
         ops.TensorSpec((4, 2048, HK, DV), "float32"), ops.TensorSpec((4,), "int32")], {})
    assert not fd.paged_decode_fits(HQ, HK, D, DV)
    assert fd.decode_fits(4, 4, 256, 256) and fd.paged_decode_fits(4, 4, 256, 256)
    assert not fd.decode_fits(HQ, HK, fd.MAX_WIDE_D + 4, 8)
    assert not fd.decode_fits(HQ, HK, 8, fd.MAX_WIDE_DV + 4)
    # at Dv 512 the shared memory, not the register layout, caps D
    assert fd.decode_fits(HQ, HK, 596, DV) and not fd.decode_fits(HQ, HK, 600, DV)


@pytest.mark.parametrize("d,dv", [(D, DV), (256, 256), (112, 112), (6, 10), (640, 4)])
def test_decode_smem_bytes_is_the_cuda_formula(d, dv):
    """decode_smem_floats: GMAX query rows, then each warp's ring of NST
    slots of ROWS K and V rows, widths padded to 4."""
    pad4 = lambda x: -(-x // 4) * 4                                   # noqa: E731
    floats = (_cu_const("GMAX") * pad4(d) + (_cu_const("THREADS") // 32) * _cu_const("NST")
              * _cu_const("ROWS") * (pad4(d) + pad4(dv)))
    assert fd.decode_smem_bytes(d, dv) == 4 * floats
    assert fd.decode_smem_bytes(D, DV) == 227328 <= _cuda.MAX_SMEM_BYTES
    assert (fd.MAX_WIDE_D, fd.MAX_WIDE_DV) == (32 * 4 * _cu_const("WIDE_NCK"),
                                              32 * 4 * _cu_const("WIDE_NCV"))
    # one wide block an SM (228 KB, 1 KB reserved a block), two narrow ones
    assert 2 * (fd.decode_smem_bytes(D, DV) + 1024) > 228 * 1024
    assert 2 * (fd.decode_smem_bytes(256, 256) + 1024) <= 228 * 1024


def test_wide_layout_is_chosen_from_the_widths_alone():
    """The C launcher picks the layout from D and Dv (never B) and takes the
    wide one only for dense fp32 rows; WIDE_GMAX query heads a block."""
    src = (CSRC / "flash_decode.cu").read_text()
    assert "const bool wide = D > 32 * 4 * NCH || Dv > 32 * 4 * NCH;" in src
    assert "(wide && !kWideOk)" in src
    assert _cu_const("WIDE_GMAX") == 4 and _cu_const("NCH") == 2


# (B, Sq, Skv, Hq, Hk, D, Dv, causal)
ATTN_SHAPES = [(2, 8, 24, 4, 4, 16, 16, False),     # cross: decoder rows over encoder rows
               (1, 24, 24, 4, 4, 16, 16, False),    # the encoder
               (1, 8, 24, 4, 2, 32, 32, False),
               (2, 20, 20, 2, 2, 48, 32, True),     # MLA prefill's D != Dv (192 / 128 cut down)
               (1, 20, 20, 2, 2, 112, 112, True)]   # zamba2's head width


@pytest.mark.parametrize("shape", ATTN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_attention_shapes_match_pallas(shape):
    b, sq, skv, hq, hk, d, dv, causal = shape
    rng = np.random.default_rng(sum(shape))
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, hk, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, hk, dv)).astype(np.float32)
    scale = 1.0 / math.sqrt(d + 8) if dv != d else None
    want = np.asarray(jflash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       causal=causal, scale=scale, interpret=True))
    got = ops.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                        causal=causal, scale=scale, backend="cuda")
    np.testing.assert_allclose(got.numpy(), want, **TOL)
