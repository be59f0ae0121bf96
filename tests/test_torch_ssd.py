"""The port's Mamba2 pieces on the CPU against the JAX package: the ``ssd``
op's ``ref`` (sequential), ``chunked`` and ``cuda`` backends (the SSD-scan
kernel's plain version on CPU tensors) against ``repro``'s ``ssd_ref`` and
its Pallas ``ssd_scan`` in interpret mode (y and final state within 1e-4:
fp32 recurrences over up to 80 steps, summed in other orders); S a
multiple of the chunk and not (the op pads with dt = 0 steps), G = 1 and
2, D present and absent; the one-step ``ssd_step`` against
``ssd_step_ref``; and ``mamba_apply``'s prefill and decode steps on the
reduced mamba2-370m config, with the JAX init's weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
import repro_torch  # noqa: F401
from repro.configs import get_reduced as jget_reduced
from repro.kernels import ops as jops
from repro.kernels.ref import ssd_ref as jssd_ref
from repro.kernels.ref import ssd_step_ref as jssd_step_ref
from repro.kernels.ssd import ssd_scan as jssd_scan
from repro.layers import ssm as jssm
from repro_torch.configs import get_reduced
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ssd_chunked_ref, ssd_ref, ssd_step_ref
from repro_torch.kernels.ssd import ssd_scan, ssd_scan_plain
from repro_torch.layers import ssm
from repro_torch.models.lm import params_from_numpy

TOL = dict(rtol=1e-4, atol=1e-4)
# (B, S, H, P, G, N, chunk)
CASES = [(2, 32, 4, 8, 1, 16, 16), (1, 40, 4, 8, 2, 16, 16), (2, 7, 6, 4, 3, 8, 16),
         (1, 80, 2, 16, 1, 32, 32)]


def _inputs(seed, b, s, h, p, g, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) - 2.0)).astype(np.float32)
    A = -np.linspace(0.5, 4.0, h).astype(np.float32)
    B = (0.3 * rng.standard_normal((b, s, g, n))).astype(np.float32)
    C = (0.3 * rng.standard_normal((b, s, g, n))).astype(np.float32)
    D = rng.standard_normal(h).astype(np.float32)
    return x, dt, A, B, C, D


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("with_d", [True, False])
@pytest.mark.parametrize("backend", ["ref", "chunked", "cuda"])
def test_ssd_op_backends_match_jax(case, with_d, backend):
    *shape, chunk = case
    x, dt, A, B, C, D = _inputs(sum(case), *shape)
    D = D if with_d else None
    y, st = ops.ssd(*_t(x, dt, A, B, C, D), chunk=chunk, backend=backend)
    jy, jst = jssd_ref(*map(lambda a: None if a is None else jnp.asarray(a), (x, dt, A, B, C, D)))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), **TOL)
    assert st.dtype == torch.float32 and tuple(st.shape) == jst.shape
    if backend == "cuda":        # JAX's op around its Pallas kernel (interpret mode)
        py, pst = jops.ssd(*map(lambda a: None if a is None else jnp.asarray(a),
                                (x, dt, A, B, C, D)), chunk=chunk, backend="pallas")
        np.testing.assert_allclose(y.numpy(), np.asarray(py), **TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(pst), **TOL)


@pytest.mark.parametrize("chunk", [8, 16])
def test_ssd_scan_plain_matches_the_pallas_kernel(chunk):
    x, dt, A, B, C, D = _inputs(3, 2, 32, 4, 8, 2, 16)
    y, st = ssd_scan(*_t(x, dt, A, B, C, D), chunk=chunk)          # CPU tensors: plain
    jy, jst = jssd_scan(*map(jnp.asarray, (x, dt, A, B, C, D)), chunk=chunk, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), **TOL)
    launches = ssd_scan.launches
    y2, st2 = ssd_scan_plain(*_t(x, dt, A, B, C, D), chunk=chunk)
    assert torch.equal(y, y2) and torch.equal(st, st2) and ssd_scan.launches == launches


def test_chunked_and_sequential_oracles_agree_with_an_initial_state():
    x, dt, A, B, C, D = _inputs(4, 1, 48, 4, 8, 1, 16)
    s0 = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 4, 8, 16))
                          .astype(np.float32))
    y, st = ssd_ref(*_t(x, dt, A, B, C, D), init_state=s0)
    yc, stc = ssd_chunked_ref(*_t(x, dt, A, B, C, D), init_state=s0, chunk=16)
    torch.testing.assert_close(yc, y, **TOL)
    torch.testing.assert_close(stc, st, **TOL)


def test_large_decay_stays_finite():
    """A chunk whose log decay spans hundreds: exp(cs_i - cs_j) for j > i
    would overflow, so the plain path never forms it."""
    x, dt, A, B, C, D = _inputs(6, 1, 32, 2, 4, 1, 8)
    dt = np.full_like(dt, 8.0)
    y, st = ops.ssd(*_t(x, dt, A, B, C, D), chunk=32, backend="cuda")
    jy, jst = jssd_ref(*map(jnp.asarray, (x, dt, A, B, C, D)))
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_step_matches_jax(g):
    rng = np.random.default_rng(7 + g)
    b, h, p, n = 3, 4, 8, 16
    x = rng.standard_normal((b, h, p)).astype(np.float32)
    dt = (0.1 * rng.random((b, h))).astype(np.float32)
    A = -np.linspace(1.0, 16.0, h).astype(np.float32)
    B, C = (rng.standard_normal((b, g, n)).astype(np.float32) for _ in range(2))
    D = np.ones(h, np.float32)
    state = rng.standard_normal((b, h, p, n)).astype(np.float32)
    jy, jst = jssd_step_ref(*map(jnp.asarray, (x, dt, A, B, C, D, state)))
    for fn in (ops.ssd_step, ssd_step_ref):
        y, st = fn(*_t(x, dt, A, B, C, D, state))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(jst), **TOL)


@pytest.mark.parametrize("n", [1, 7, 16, 100])
def test_sum_last_is_a_sum(n):
    t = torch.from_numpy(np.random.default_rng(n).standard_normal((3, 5, n)).astype(np.float32))
    torch.testing.assert_close(ops._sum_last(t), t.sum(-1), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_mamba_apply_prefill_then_decode_matches_jax(backend):
    jcfg, cfg = jget_reduced("mamba2-370m"), get_reduced("mamba2-370m")
    if backend == "cuda":
        cfg = cfg.with_overrides(backends={**cfg.backends, "ssd": "cuda", "dense": "cuda"})
    jp = jssm.mamba_init(jax.random.PRNGKey(0), jcfg)
    p = params_from_numpy({"embed": np.zeros((1, 1), np.float32),
                           "m": jax.tree.map(np.asarray, jp)}, "cpu")["m"]
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 21, cfg.d_model)).astype(np.float32)     # 21: off the chunk
    jy, jc = jssm.mamba_apply(jp, jnp.asarray(x[:, :17]), cfg=jcfg, mode="prefill")
    y, c = ssm.mamba_apply(p, torch.from_numpy(x[:, :17]), cfg=cfg, mode="prefill")
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    assert list(c) == list(jc) == ["conv_x", "conv_B", "conv_C", "ssm"]
    for t in range(17, 21):
        jy, jc = jssm.mamba_apply(jp, jnp.asarray(x[:, t:t + 1]), cfg=jcfg, mode="decode",
                                  cache=jc)
        y, c = ssm.mamba_apply(p, torch.from_numpy(x[:, t:t + 1]), cfg=cfg, mode="decode",
                               cache=c)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    for k in jc:
        assert tuple(c[k].shape) == jc[k].shape and c[k].dtype == torch.float32, k
        np.testing.assert_allclose(c[k].numpy(), np.asarray(jc[k]), **TOL)
