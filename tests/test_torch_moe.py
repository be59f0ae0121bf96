"""The port's MoE layer and ``moe_gemm`` op on the CPU against the JAX
package: the op's ``ref`` and ``cuda`` backends (the batched-GEMM kernel's
plain version on CPU tensors) against ``repro``'s Pallas ``batched_gemm`` in
interpret mode and its ``batched_gemm_ref``, ragged M/N/K included (2e-5:
fp32 on both sides, summed in other orders); ``_capacity``, ``route``
(routing indices equal) and ``moe_apply`` with global and local dispatch on
the reduced qwen2-moe-a2.7b config, with and without dropped tokens
(outputs and aux within 1e-4: a router, three expert GEMMs and a shared
expert, summed in other orders).  Inputs from numpy with a seed; the JAX
init's weights go through ``params_from_numpy``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
import repro_torch  # noqa: F401
from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.kernels.gemm import batched_gemm as jbatched_gemm
from repro.kernels.ref import batched_gemm_ref as jbatched_gemm_ref
from repro.layers import moe as jmoe
from repro_torch.configs import get_config, get_reduced
from repro_torch.kernels import ops
from repro_torch.kernels.gemm import batched_gemm, batched_gemm_plain
from repro_torch.layers import moe
from repro_torch.models.lm import params_from_numpy

ARCH = "qwen2-moe-a2.7b"
GEMM_TOL = dict(rtol=2e-5, atol=2e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
# (E, M, N, K): ragged against the GEMM tiles and K steps, M on both sides
# of the skinny/tiled threshold, and against the small Pallas blocks below
SHAPES = [(3, 5, 37, 19), (2, 13, 70, 33), (4, 1, 3, 1), (8, 24, 32, 64)]


def _gemm_inputs(seed, e, m, n, k):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((e, m, k)).astype(np.float32),
            rng.standard_normal((e, k, n)).astype(np.float32))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_moe_gemm_backends_match_pallas_and_ref(shape, backend):
    x, w = _gemm_inputs(sum(shape), *shape)
    got = ops.moe_gemm(torch.from_numpy(x), torch.from_numpy(w), backend=backend).numpy()
    want_ref = np.asarray(jbatched_gemm_ref(jnp.asarray(x), jnp.asarray(w)))
    want = np.asarray(jbatched_gemm(jnp.asarray(x), jnp.asarray(w), block_m=8, block_n=16,
                                    block_k=8, interpret=True))
    np.testing.assert_allclose(got, want_ref, **GEMM_TOL)
    np.testing.assert_allclose(got, want, **GEMM_TOL)


def test_batched_gemm_wrapper_on_the_cpu_is_its_plain_version():
    x, w = (torch.from_numpy(a) for a in _gemm_inputs(0, 3, 5, 37, 19))
    launches = batched_gemm.launches
    assert torch.equal(batched_gemm(x, w), batched_gemm_plain(x, w))
    assert batched_gemm.launches == launches               # no kernel on the CPU
    with pytest.raises(ValueError, match="needs"):
        batched_gemm(x, w[:2])
    with pytest.raises(TypeError, match="float32"):
        batched_gemm(x.double(), w.double())


def test_moe_gemm_declares_jax_shape_and_cost():
    from repro.core.ir import TensorSpec as JSpec
    from repro.core.registry import get_op as jget_op
    from repro_torch.core.ir import TensorSpec
    from repro_torch.core.registry import get_op
    specs = [(8, 24, 64), (8, 64, 32)]
    port = get_op("moe_gemm")
    jax_op = jget_op("moe_gemm")
    assert port.shape_fn([TensorSpec(s) for s in specs], {})[0].shape == \
        jax_op.shape_fn([JSpec(s) for s in specs], {})[0].shape
    c, jc = (op.cost_fn([spec(s) for s in specs], {})
             for op, spec in ((port, TensorSpec), (jax_op, JSpec)))
    assert (c.flops, c.bytes) == (jc.flops, jc.bytes)


@pytest.mark.parametrize("arch_full", [False, True])
def test_capacity_matches_jax(arch_full):
    cfg = get_config(ARCH) if arch_full else get_reduced(ARCH)
    jcfg = jget_config(ARCH) if arch_full else jget_reduced(ARCH)
    for n in (1, 4, 7, 200, 1024, 1400, 5000):
        assert moe._capacity(n, cfg) == jmoe._capacity(n, jcfg), n
    if arch_full:       # qwen2 at 1024 prompt tokens: 80 slots (rounded up to 8)
        assert moe._capacity(1024, cfg) == 80 and moe._capacity(1, cfg) == 8


def test_route_matches_jax_with_padded_experts():
    cfg, jcfg = get_reduced(ARCH), jget_reduced(ARCH)
    assert cfg.moe.n_routed_padded > cfg.moe.n_routed     # 6 routed of 8
    logits = np.random.default_rng(1).standard_normal((64, cfg.moe.n_experts)).astype(np.float32)
    logits[:, cfg.moe.n_routed:] += 5.0                    # padding experts would win unmasked
    topw, topi = moe.route(torch.from_numpy(logits), cfg)
    jw, ji = jmoe.route(jnp.asarray(logits), jcfg)
    assert topi.tolist() == np.asarray(ji).tolist()
    assert int(topi.max()) < cfg.moe.n_routed
    np.testing.assert_allclose(topw.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-6)


def _moe_setup(dispatch, capacity_factor, seed):
    cfg, jcfg = get_reduced(ARCH), jget_reduced(ARCH)
    mo = dataclasses.replace(cfg.moe, dispatch=dispatch, capacity_factor=capacity_factor)
    jmo = dataclasses.replace(jcfg.moe, dispatch=dispatch, capacity_factor=capacity_factor)
    cfg, jcfg = cfg.with_overrides(moe=mo), jcfg.with_overrides(moe=jmo)
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg)
    p = params_from_numpy({"embed": np.zeros((1, 1), np.float32), "moe": jax.tree.map(
        np.asarray, jp)}, "cpu")["moe"]
    x = np.random.default_rng(seed).standard_normal((3, 20, cfg.d_model)).astype(np.float32)
    return cfg, jcfg, p, jp, x


def _drops(cfg, x, p, jp, jcfg):
    """Number of (token, k) entries over capacity, by the port's ranks, once
    the port's routing indices are checked equal to JAX's."""
    b, s, d = x.shape
    logits = torch.from_numpy(x).reshape(b * s, d) @ p["router"]
    _, topi = moe.route(logits, cfg)
    _, jtopi = jmoe.route(jnp.asarray(x).reshape(b * s, d) @ jp["router"], jcfg)
    assert topi.tolist() == np.asarray(jtopi).tolist()
    if cfg.moe.dispatch == "local":
        fi, cap = topi.reshape(b, -1), moe._capacity(s, cfg)
    else:
        fi, cap = topi.reshape(1, -1), moe._capacity(b * s, cfg)
    return int((moe._positions(fi, cfg.moe.n_experts) >= cap).sum())


@pytest.mark.parametrize("dispatch", ["global", "local"])
@pytest.mark.parametrize("capacity_factor", [8.0, 0.5])
@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_moe_apply_matches_jax(dispatch, capacity_factor, backend):
    cfg, jcfg, p, jp, x = _moe_setup(dispatch, capacity_factor, seed=2)
    if backend == "cuda":
        cfg = cfg.with_overrides(backends={"moe_gemm": "cuda", "dense": "cuda"})
    y, aux = moe.moe_apply(p, torch.from_numpy(x), cfg=cfg)
    jy, jaux = jmoe.moe_apply(jp, jnp.asarray(x), cfg=jcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    assert aux.dtype == torch.float32 and aux.dim() == 0
    drops = _drops(cfg, x, p, jp, jcfg)
    assert (drops > 0) == (capacity_factor < 1), "the low factor must drop tokens"


def test_moe_apply_local_matches_jax_pallas_interpret():
    """The ``cuda`` backend's plain path against JAX's Pallas batched GEMM
    (interpret mode), local dispatch with drops."""
    cfg, jcfg, p, jp, x = _moe_setup("local", 0.5, seed=3)
    cfg = cfg.with_overrides(backends={"moe_gemm": "cuda", "dense": "cuda"})
    jcfg = jcfg.with_overrides(backends={"moe_gemm": "pallas"})
    y, aux = moe.moe_apply(p, torch.from_numpy(x), cfg=cfg)
    jy, jaux = jmoe.moe_apply(jp, jnp.asarray(x), cfg=jcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)


def test_local_dispatch_rows_do_not_see_each_other():
    """Folding the batch into the GEMM rows keeps per-row pools: a row's
    output is its output alone (here bitwise, on the CPU's plain path)."""
    cfg, _, p, _, x = _moe_setup("local", 0.5, seed=4)
    xt = torch.from_numpy(x)
    y, _ = moe.moe_apply(p, xt, cfg=cfg)
    for i in range(x.shape[0]):
        y1, _ = moe.moe_apply(p, xt[i:i + 1], cfg=cfg)
        np.testing.assert_allclose(y1[0].numpy(), y[i].numpy(), rtol=1e-6, atol=1e-6)
