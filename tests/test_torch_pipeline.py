"""``repro_torch.runtime.pipeline.pipeline_apply`` on four gloo ranks
(``spawn_ranks``) on the CPU — the counterpart of
tests/test_pipeline_moe.py::TestPipeline::test_pipeline_matches_sequential.

JAX's data (seed 0, 4 stages, 6 microbatches of 2 rows, d 16, ``W * 0.3``,
``tanh(h @ w)``) on a ``("pod",)`` mesh of 4: every rank's result within
1e-5 of the sequential composition and of JAX's ``pipeline_apply`` on its
(4, 2) mesh (run through ``conftest.run_sub``, 8 forced host devices),
each stage calling its function once a microbatch (6 times) over the
M + S - 1 = 9 ticks of the schedule.  The backward pass: every rank
backpropagates the same replicated loss ``sum(y * G)`` (``G`` seeded), and
each stage's gradient of ``W[s]`` and every rank's gradient of ``x`` must
lie within 1e-5 of ``jax.grad`` of the same loss through JAX's
``pipeline_apply`` (the same subprocess), and of autograd through the
sequential composition in one process.  A ``(pod 2, model
2)`` mesh of the same ranks runs two 2-stage pipelines, one a "model"
coordinate, each in its own "pod" group: each must give the 2-stage
composition of the stage weights its model coordinate picks.

The ranks import this module to find their function: it imports no JAX at
module level.
"""

import concurrent.futures

import numpy as np
import pytest
import torch

N_STAGES, N_MICRO, MB, D = 4, 6, 2, 16
SPAWN_TIMEOUT = 120.0


def _data():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((N_STAGES, D, D)) * 0.3).astype(np.float32)
    x = rng.standard_normal((N_MICRO, MB, D)).astype(np.float32)
    return w, x


def _cotangent():
    return np.random.default_rng(1).standard_normal((N_MICRO, MB, D)).astype(np.float32)


def _stage(w, h):
    return torch.tanh(h @ w)


def _rank():
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.pipeline import pipeline_apply
    w, x = (torch.from_numpy(a) for a in _data())
    out, calls = {}, []

    def counted(p, h):
        calls.append(1)
        return _stage(p, h)

    mesh = make_mesh((N_STAGES,), ("pod",), device="cpu")
    out["pod4"] = (pipeline_apply(mesh, counted, w, x, axis="pod").numpy(), len(calls))
    wg, xg = w.clone().requires_grad_(), x.clone().requires_grad_()
    y = pipeline_apply(mesh, _stage, wg, xg, axis="pod")
    (y * torch.from_numpy(_cotangent())).sum().backward()
    s = mesh.axis_index("pod")
    others = torch.cat([wg.grad[:s], wg.grad[s + 1:]])
    out["grad"] = (s, wg.grad[s].numpy(), xg.grad.numpy(), float(others.abs().max()))
    mesh2 = make_mesh((2, 2), ("pod", "model"), device="cpu")
    # model coordinate c runs stages w[2c], w[2c + 1]
    c = mesh2.coords["model"]
    calls.clear()
    y = pipeline_apply(mesh2, lambda p, h: counted(p["w"], h), {"w": w[2 * c:2 * c + 2]}, x)
    out["pod2"] = (dict(mesh2.coords), y.numpy(), len(calls))
    return out


def _sequential(w, x, stages):
    ref = x
    for s in stages:
        ref = np.tanh(ref @ w[s])
    return ref


def _jax_pipeline(out_file):
    from conftest import run_sub
    run_sub(f"""
import numpy as np, jax, jax.numpy as jnp
from repro.runtime.pipeline import pipeline_apply
mesh = jax.make_mesh((4, 2), ("pod", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
rng = np.random.default_rng(0)
W = jnp.asarray(rng.standard_normal(({N_STAGES}, {D}, {D})) * 0.3, jnp.float32)
x = jnp.asarray(rng.standard_normal(({N_MICRO}, {MB}, {D})), jnp.float32)
G = jnp.asarray(np.random.default_rng(1).standard_normal(({N_MICRO}, {MB}, {D})), jnp.float32)
stage = lambda w, h: jnp.tanh(h @ w)
with mesh:
    y = pipeline_apply(mesh, stage, W, x, axis="pod")
    gw, gx = jax.grad(lambda W, x: jnp.sum(pipeline_apply(mesh, stage, W, x, axis="pod") * G),
                      argnums=(0, 1))(W, x)
np.savez({str(out_file)!r}, y=np.asarray(y), gw=np.asarray(gw), gx=np.asarray(gx))
""")
    return dict(np.load(out_file))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results, and JAX's pipeline run meanwhile."""
    from repro_torch.launch.mesh import spawn_ranks
    pool = concurrent.futures.ThreadPoolExecutor(2)
    try:
        ranks = pool.submit(spawn_ranks, _rank, N_STAGES, timeout=SPAWN_TIMEOUT)
        jax_y = pool.submit(_jax_pipeline, tmp_path_factory.mktemp("pipe") / "y.npz")
        yield {"ranks": ranks.result(), "jax": jax_y}
    finally:
        pool.shutdown(wait=True)


def test_pipeline_matches_sequential(runs):
    w, x = _data()
    ref = _sequential(w, x, range(N_STAGES))
    for r in runs["ranks"]:
        y, calls = r["pod4"]
        assert y.shape == (N_MICRO, MB, D)
        assert float(np.abs(y - ref).max()) < 1e-5
        assert calls == N_MICRO


def test_pipeline_matches_jax(runs):
    import jax
    if not hasattr(jax.sharding, "AxisType"):
        pytest.skip("JAX's pipeline test needs jax.sharding.AxisType (conftest.multidev)")
    jax_y = runs["jax"].result()["y"]
    for r in runs["ranks"]:
        assert float(np.abs(r["pod4"][0] - jax_y).max()) < 1e-5


def _sequential_grads():
    """Autograd through the sequential composition, in one process."""
    w, x = (torch.from_numpy(a).requires_grad_() for a in _data())
    h = x
    for s in range(N_STAGES):
        h = _stage(w[s], h)
    (h * torch.from_numpy(_cotangent())).sum().backward()
    return w.grad.numpy(), x.grad.numpy()


def test_pipeline_grads_match_sequential(runs):
    gw, gx = _sequential_grads()
    stages = sorted(r["grad"][0] for r in runs["ranks"])
    assert stages == list(range(N_STAGES))
    for r in runs["ranks"]:
        s, gw_s, gx_r, others = r["grad"]
        assert float(np.abs(gw_s - gw[s]).max()) < 1e-5
        assert float(np.abs(gx_r - gx).max()) < 1e-5
        assert others == 0.0          # a stage's gradient reaches only its own slice
        assert float(np.abs(gw_s).max()) > 1e-3


def test_pipeline_grads_match_jax(runs):
    import jax
    if not hasattr(jax.sharding, "AxisType"):
        pytest.skip("JAX's pipeline test needs jax.sharding.AxisType (conftest.multidev)")
    jax_out = runs["jax"].result()
    for r in runs["ranks"]:
        s, gw_s, gx_r, _ = r["grad"]
        assert float(np.abs(gw_s - jax_out["gw"][s]).max()) < 1e-5
        assert float(np.abs(gx_r - jax_out["gx"]).max()) < 1e-5


def test_pipeline_stage_groups_are_the_axis(runs):
    w, x = _data()
    for r in runs["ranks"]:
        coords, y, calls = r["pod2"]
        c = coords["model"]
        ref = _sequential(w, x, (2 * c, 2 * c + 1))
        assert float(np.abs(y - ref).max()) < 1e-5
        assert calls == N_MICRO
