"""The redesigned SSD-scan and RMSNorm kernels' algorithms and constants,
held on the CPU (the kernels themselves run only on the card,
tests/test_torch_gpu.py):

- the three-phase formulation of ``csrc/ssd.cu`` — every chunk's cumsum,
  state contribution dS_c and C.B scores (once per group) into the
  scratch layout of ``scan_scratch``; the start states passed in chunk
  order; every chunk's output from the decayed, masked scores and its
  start state, with the D term — against JAX's Pallas ``ssd_scan`` in
  interpret mode and ``ssd_scan_plain``, at 1-4 chunks, G = 1 and 2, Q in
  {16, 37, 64}, a sequence padded to the chunk, with and without D;
- the scratch sizes and ``scan_fits`` take no batch, and ``scan_fits``
  admits every config that has an SSM;
- the Python layout constants and the ctypes signatures agree with the
  CUDA sources;
- ``rmsnorm``'s row layout is a function of D alone and holds every row
  up to D = 7168 in registers; ``rmsnorm_plain`` against JAX's Pallas
  ``rmsnorm`` in interpret mode.

Tolerance 1e-5: fp32 on both sides, summed in another order."""

import inspect
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm import rmsnorm as jrmsnorm
from repro.kernels.ssd import ssd_scan as jssd_scan
from repro_torch.configs import get_config, list_configs
from repro_torch.kernels import _cuda
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import ssd

TOL = dict(rtol=1e-5, atol=1e-5)
CSRC = Path(_cuda.__file__).resolve().parent.parent / "csrc"


def _up(n):
    return -(-n // ssd.TILE) * ssd.TILE


def _three_phase(x, dt, A, B, C, D, q):
    """What the card computes, phase by phase, through the scratch layout
    of ``scan_scratch``: (B, nc, H, N, PP) states, (B, nc, G, QR, QR)
    scores, (B, H, S) cumsum."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    nc, hpg = s // q, h // g
    n_st, n_sc, n_cs = ssd.scan_scratch(s, h, p, g, n, q)
    pp, qr = _up(p), _up(q)
    st = torch.zeros(b, n_st).reshape(b, nc, h, n, pp)
    sc = torch.zeros(b, n_sc).reshape(b, nc, g, qr, qr)
    cs = torch.zeros(b, n_cs).reshape(b, h, s)
    xc = x.reshape(b, nc, q, h, p)
    dtc = dt.reshape(b, nc, q, h)
    Bc, Cc = B.reshape(b, nc, q, g, n), C.reshape(b, nc, q, g, n)
    # phase 1: cumsum, dS_c (as [n][p]) and the scores, every chunk at once
    la = dtc * A[None, None, None, :]
    csc = torch.cumsum(la, dim=2)                                         # (b, nc, q, h)
    cs[:] = csc.permute(0, 3, 1, 2).reshape(b, h, s)
    w = torch.exp(csc[:, :, -1:, :] - csc)                                 # j <= last
    xw = xc * dtc[..., None] * w[..., None]                                # (b, nc, q, h, p)
    Bh = Bc.repeat_interleave(hpg, dim=3)
    st[..., :p] = torch.einsum("bcjhp,bcjhn->bchnp", xw, Bh)
    sc[:, :, :, :q, :q] = torch.einsum("bcign,bcjgn->bcgij", Cc, Bc)
    # phase 2: start states in chunk order (the last chunk's slot gets S_{nc-1})
    S = torch.zeros(b, h, n, pp)
    for c in range(nc):
        dS = st[:, c].clone()
        st[:, c] = S
        S = S * torch.exp(cs[:, :, c * q + q - 1])[..., None, None] + dS
    final = S[..., :p].transpose(-1, -2)                                   # (b, h, p, n)
    # phase 3: every chunk's output
    ci = cs.reshape(b, h, nc, q).permute(0, 2, 3, 1)                       # (b, nc, q, h)
    allowed = torch.tril(torch.ones(q, q, dtype=torch.bool))
    diff = ci[:, :, :, None, :] - ci[:, :, None, :, :]                     # (b, nc, i, j, h)
    decay = torch.where(allowed[None, None, :, :, None],
                        torch.exp(torch.where(allowed[None, None, :, :, None], diff,
                                              torch.zeros_like(diff))),
                        torch.zeros_like(diff))
    scores = sc[:, :, :, :q, :q].repeat_interleave(hpg, dim=2)            # (b, nc, h, i, j)
    m = scores * decay.permute(0, 1, 4, 2, 3)
    y_in = torch.einsum("bchij,bcjhp->bcihp", m, xc * dtc[..., None])
    y_out = torch.einsum("bcihn,bchnp->bcihp", Cc.repeat_interleave(hpg, dim=3),
                         st[..., :p]) * torch.exp(ci)[..., None]
    y = (y_in + y_out).reshape(b, s, h, p)
    if D is not None:
        y = y + x * D[None, None, :, None]
    return y, final


def _inputs(seed, b, s, h, p, g, n, q):
    """Inputs of s steps, padded to a multiple of q with dt = 0 steps (as the
    ``ssd`` op pads them)."""
    rng = np.random.default_rng(seed)
    sp = -(-s // q) * q
    x = np.zeros((b, sp, h, p), np.float32)
    dt = np.zeros((b, sp, h), np.float32)
    B = np.zeros((b, sp, g, n), np.float32)
    C = np.zeros((b, sp, g, n), np.float32)
    x[:, :s] = rng.standard_normal((b, s, h, p))
    dt[:, :s] = np.log1p(np.exp(rng.standard_normal((b, s, h)) - 2.0))
    B[:, :s] = 0.3 * rng.standard_normal((b, s, g, n))
    C[:, :s] = 0.3 * rng.standard_normal((b, s, g, n))
    A = -np.linspace(0.5, 4.0, h).astype(np.float32)
    D = rng.standard_normal(h).astype(np.float32)
    return x, dt, A, B, C, D


@pytest.mark.parametrize("q", [16, 37, 64])
@pytest.mark.parametrize("n_chunks", [1, 2, 4])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("with_d", [True, False])
def test_three_phase_formulation_matches_pallas_and_plain(q, n_chunks, g, with_d):
    """S = n_chunks * q - 3 steps, padded to the chunk; H = 4, P = 8, N = 16."""
    b, h, p, n = 2, 4, 8, 16
    x, dt, A, B, C, D = _inputs(q * 10 + n_chunks + g, b, n_chunks * q - 3, h, p, g, n, q)
    D = D if with_d else None
    t = [None if a is None else torch.from_numpy(a) for a in (x, dt, A, B, C, D)]
    y, st = _three_phase(*t, q)
    yj, stj = jssd_scan(*[None if a is None else jnp.asarray(a) for a in (x, dt, A, B, C, D)],
                        chunk=q, interpret=True)
    torch.testing.assert_close(y, torch.from_numpy(np.array(yj)), **TOL)
    torch.testing.assert_close(st, torch.from_numpy(np.array(stj)), **TOL)
    yp, stp = ssd.ssd_scan_plain(*t, chunk=q)
    torch.testing.assert_close(y, yp, **TOL)
    torch.testing.assert_close(st, stp, **TOL)
    assert torch.equal(ssd.ssd_scan(*t, chunk=q)[0], yp)      # CPU tensors: the plain version


def test_three_phase_matches_plain_at_mamba2_width():
    """P = 64, N = 128, Q = 128, one group: two chunks of mamba2-370m's head."""
    x, dt, A, B, C, D = _inputs(3, 1, 256, 2, 64, 1, 128, 128)
    t = [torch.from_numpy(a) for a in (x, dt, A, B, C, D)]
    y, st = _three_phase(*t, 128)
    yp, stp = ssd.ssd_scan_plain(*t, chunk=128)
    torch.testing.assert_close(y, yp, **TOL)
    torch.testing.assert_close(st, stp, **TOL)


@pytest.mark.parametrize("fn", [ssd.scan_scratch, ssd.scan_fits])
def test_scratch_and_fit_take_no_batch(fn):
    params = inspect.signature(fn).parameters
    assert not {"b", "batch", "B"} & set(params)


def test_scratch_sizes_are_per_sequence():
    """mamba2-370m's 1024-token prefill: 8 chunks of states (8.4 MB), the
    scores once per group (0.5 MB), the cumsum."""
    assert ssd.scan_scratch(1024, 32, 64, 1, 128, 128) == (8 * 32 * 128 * 64, 8 * 128 * 128,
                                                         32 * 1024)
    n_st, n_sc, _ = ssd.scan_scratch(37, 6, 8, 3, 32, 128)
    assert (n_st, n_sc) == (6 * 32 * 64, 3 * 64 * 64)           # q = 37, P and q padded to 64


@pytest.mark.parametrize("arch", [a for a in list_configs() if get_config(a).ssm is not None])
def test_scan_fits_every_ssm_config(arch):
    s = get_config(arch).ssm
    assert ssd.scan_fits(s.chunk, s.state)
    assert ssd.scan_fits(min(s.chunk, 1), s.state)              # a 1-token prompt


@pytest.mark.parametrize("chunk,n,fits", [(0, 16, False), (129, 16, False), (128, 0, False),
                                          (128, 512, True), (1, 1, True)])
def test_scan_fits_bounds(chunk, n, fits):
    assert ssd.scan_fits(chunk, n) is fits


def _consts(src):
    text = (CSRC / src).read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", text)}, text


def _ssd_smem_bytes():
    """Each kernel's static shared memory, from csrc/ssd.cu's constants."""
    c, text = _consts("ssd.cu")
    env = dict(c, KP=c["KT"] + 4)
    return {k: 4 * eval(v, {}, env)
            for k, v in re.findall(r"constexpr int (SMEM_\w+) = ([^;]+);", text)}


def test_ssd_layout_constants_are_the_cuda_source():
    c, _ = _consts("ssd.cu")
    assert (c["TILE"], c["MAX_Q"]) == (ssd.TILE, ssd.MAX_CHUNK)
    assert set(_ssd_smem_bytes()) == {"SMEM_CHUNK", "SMEM_OUT", "SMEM_PASS"}


def test_ssd_shared_memory_is_static_and_shares_an_sm():
    """Each kernel's shared memory is static (under 48 KB) and at least four
    blocks of each fit in an SM's 228 KB (1 KB reserved per block)."""
    for nbytes in _ssd_smem_bytes().values():
        assert nbytes <= 48 * 1024
        assert 4 * (nbytes + 1024) <= 228 * 1024


def test_ssd_grids_fill_the_card_at_mamba2_prefill():
    """Phases 1 and 3 at mamba2-370m's 1024-token prefill: about four blocks
    for each of the H100's 132 SMs."""
    nc, h, p, g, n, q = 8, 32, 64, 1, 128, 128
    tiles = lambda k: -(-k // ssd.TILE)                                 # noqa: E731
    phase1 = nc * (h * tiles(p) * tiles(n) + g * tiles(q) * (tiles(q) + 1) // 2)
    phase3 = nc * tiles(q) * h * tiles(p)
    assert (phase1, phase3) == (536, 512)
    assert min(phase1, phase3) >= 3.8 * 132


def _c_entries():
    out = {}
    for src in _cuda.SOURCES:
        text = (CSRC / src).read_text()
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
            out[name] = [p.strip() for p in params.split(",") if p.strip()]
    return out


@pytest.mark.parametrize("name", ["ssd_scan_f32", "rmsnorm_f32", "empty_launch"])
def test_signatures_match_the_c_entry_points(name):
    params = _c_entries()[name]
    sig = _cuda._SIGNATURES[name]
    assert len(params) == len(sig)
    for p, t in zip(params, sig):
        want = {"int": _cuda._I, "float": _cuda._F}.get(p.rsplit(" ", 1)[0], _cuda._P)
        assert t is want, (name, p)


def test_rmsnorm_layout_constants_are_the_cuda_source():
    c, text = _consts("rmsnorm.cu")
    assert (c["THREADS"], c["MAX_VPT"]) == (rn.THREADS, rn.MAX_VPT)
    assert "while (t < THREADS && t * MAX_VPT < g4) t <<= 1;" in text


def test_rmsnorm_layout_takes_d_alone():
    assert list(inspect.signature(rn.row_layout).parameters) == ["d"]


def test_rmsnorm_layout_holds_every_row_to_7168_in_registers():
    for d in range(1, 7169):
        tpr, vpt = rn.row_layout(d)
        assert tpr in (32, 64, 128, 256) and rn.THREADS % tpr == 0
        assert 1 <= vpt <= rn.MAX_VPT and tpr * vpt * 4 >= d
        assert tpr == 32 or (tpr // 2) * rn.MAX_VPT * 4 < d          # the fewest threads
    assert rn.row_layout(8192) == (256, 8) and rn.row_layout(8193)[1] > rn.MAX_VPT


@pytest.mark.parametrize("d", [1, 3, 1152])
@pytest.mark.parametrize("residual", [False, True])
def test_rmsnorm_plain_matches_pallas(d, residual):
    rng = np.random.default_rng(d)
    x = rng.standard_normal((5, d)).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    r = rng.standard_normal((5, d)).astype(np.float32) if residual else None
    want = jrmsnorm(jnp.asarray(x), jnp.asarray(w), eps=1e-6,
                    residual=None if r is None else jnp.asarray(r), interpret=True)
    got = rn.rmsnorm_plain(torch.from_numpy(x), torch.from_numpy(w), eps=1e-6,
                           residual=None if r is None else torch.from_numpy(r))
    torch.testing.assert_close(got, torch.from_numpy(np.array(want)), **TOL)
    assert torch.equal(rn.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), eps=1e-6,
                                  residual=None if r is None else torch.from_numpy(r)), got)


def test_rmsnorm_wrapper_refuses_mixed_types_and_shapes():
    x = torch.zeros(2, 8)
    with pytest.raises(TypeError, match="float32"):
        rn.rmsnorm(x.double(), torch.ones(8))
    with pytest.raises(TypeError, match="residual"):
        rn.rmsnorm(x, torch.ones(8), residual=x.double())
    with pytest.raises(ValueError, match="w"):
        rn.rmsnorm(x, torch.ones(7))
    assert math.isclose(float(rn.rmsnorm(torch.ones(1, 4), torch.ones(4), eps=0.0)[0, 0]), 1.0)
