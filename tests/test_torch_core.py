"""The port's core (repro_torch.core) held against repro.core on the CPU:
one Graph through both compile()s, the pass pipeline, Program weight
sharing, bind() validation, device resolution, and the port's isolation
from JAX and from the JAX package."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro  # noqa: F401  (registers repro's ops)
import repro_torch  # noqa: F401  (registers the port's ops)
from repro.core import ir as jir
from repro.core.program import compile as jcompile
from repro.core.registry import backends_for as jbackends_for
from repro_torch.core import ir as tir
from repro_torch.core.device import resolve_device
from repro_torch.core.pipeline import DEFAULT_PASSES, PipelineError, default_pipeline
from repro_torch.core.program import compile as tcompile
from repro_torch.core.registry import backends_for as tbackends_for
from repro_torch.core.selector import FixedPolicy

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-5, atol=2e-5)   # fp32, summed in another order


def _graph(ir, params):
    """x (3, 5) -> dense -> rmsnorm -> dense(gate), dense(up) -> swiglu
    -> add(residual) -> reshape; plus a dead branch and a duplicate node
    for the passes to remove."""
    N = ir.Node
    nodes = [
        N("proj", "dense", ["x", "w1"], ["h"]),
        N("norm", "rmsnorm", ["h", "g"], ["hn"], {"eps": 1e-6}),
        N("gate", "dense", ["hn", "wg"], ["ga"]),
        N("up", "dense", ["hn", "wu"], ["u"]),
        N("up_dup", "dense", ["hn", "wu"], ["u2"]),
        N("act", "swiglu", ["ga", "u"], ["a"]),
        N("res", "add", ["a", "u2"], ["r"]),
        N("dead", "dense", ["hn", "wg"], ["unused"]),
        N("flat", "reshape", ["r"], ["y"], {"shape": (3, 2, 4)}),
    ]
    return ir.Graph(name="mini", inputs={"x": ir.TensorSpec((3, 5))},
                    outputs=["y"], nodes=nodes, params=dict(params))


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w1": rng.standard_normal((5, 8)).astype(np.float32),
            "g": (1.0 + 0.1 * rng.standard_normal(8)).astype(np.float32),
            "wg": rng.standard_normal((8, 8)).astype(np.float32),
            "wu": rng.standard_normal((8, 8)).astype(np.float32)}


def _node_view(graph):
    return [(n.name, n.op, list(n.inputs), list(n.outputs), dict(n.attrs))
            for n in graph.nodes]


@pytest.mark.parametrize("policy", ["default", "ref"])
def test_one_graph_through_both_compiles(policy):
    from repro.core.selector import FixedPolicy as JFixed
    params = _params()
    x = np.random.default_rng(1).standard_normal((3, 5)).astype(np.float32)
    jpol = None if policy == "default" else JFixed(prefer=("ref",))
    tpol = None if policy == "default" else FixedPolicy(prefer=("ref",))
    jprog = jcompile(_graph(jir, params), policy=jpol)
    tprog = tcompile(_graph(tir, params), policy=tpol, device="cpu")
    assert _node_view(tprog.graph) == _node_view(jprog.graph)
    (jy,) = jprog(x=x)
    (ty,) = tprog(x=x)
    assert ty.shape == (3, 2, 4) and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)


def test_pipeline_removes_dead_and_duplicate_nodes():
    pm = default_pipeline(validate=True)
    g = pm.run(_graph(tir, _params()))
    names = [n.name for n in g.nodes]
    assert "dead" not in names and "up_dup" not in names
    assert [s.name for s in pm.stats] == list(DEFAULT_PASSES)
    assert g.value_info["y"].shape == (3, 2, 4)


def test_pipeline_unknown_pass_raises():
    from repro_torch.core.pipeline import PassManager
    with pytest.raises(PipelineError):
        PassManager(["no_such_pass"]).run(_graph(tir, _params()))


def test_fold_constants_on_tensor_params():
    N = tir.Node
    g = tir.Graph(name="fold", inputs={"x": tir.TensorSpec((2, 3))}, outputs=["y"],
                  nodes=[N("c", "add", ["a", "b"], ["ab"]),
                         N("y", "add", ["x", "ab"], ["y"])],
                  params={"a": torch.ones(2, 3), "b": np.full((2, 3), 2.0, np.float32)})
    prog = tcompile(g, device="cpu")
    assert [n.name for n in prog.graph.nodes] == ["y"]
    (y,) = prog(x=np.zeros((2, 3), np.float32))
    assert torch.equal(y, torch.full((2, 3), 3.0))


def test_spec_of_reads_shape_and_dtype_from_the_tensor():
    g = tir.Graph(name="s", inputs={}, outputs=[], nodes=[],
                  params={"w": torch.zeros(4, 3), "i": torch.zeros(5, dtype=torch.int32),
                          "n": np.zeros((2,), np.int8)})
    assert g.spec_of("w") == tir.TensorSpec((4, 3), "float32")
    assert g.spec_of("i") == tir.TensorSpec((5,), "int32")
    assert g.spec_of("n") == tir.TensorSpec((2,), "int8")


def test_programs_share_params_already_on_the_device():
    params = {k: torch.from_numpy(v) for k, v in _params().items()}
    progs = [tcompile(_graph(tir, params), device="cpu") for _ in range(3)]
    for prog in progs:
        stored = prog._stored_params()
        for k, v in params.items():
            assert stored[k].data_ptr() == v.data_ptr(), k


def test_bind_validates_names_once():
    prog = tcompile(_graph(tir, _params()), device="cpu")
    with pytest.raises(ValueError, match="not graph inputs"):
        prog.bind("x", "nope")
    with pytest.raises(ValueError, match="donate"):
        prog.bind("x", donate=["w1"])
    with pytest.raises(ValueError, match="missing graph inputs"):
        prog()
    x = np.ones((3, 5), np.float32)
    (a,) = prog.bind("x", donate=["x"])(x)
    (b,) = prog(x=x)
    assert torch.equal(a, b)


def test_fixed_policy_prefers_the_kernel_slot():
    prog = tcompile(_graph(tir, _params()), device="cpu")
    a = prog.assignment
    assert a["proj"] == "cuda" and a["norm"] == "cuda"
    assert a["act"] == "ref" and a["flat"] == "ref"


def test_registries_are_separate():
    assert "cuda" in tbackends_for("dense")
    assert "cuda" not in jbackends_for("dense")
    assert "pallas" not in tbackends_for("dense")


def test_entry_points_need_a_card(monkeypatch):
    from repro_torch.models.graph_lm import (GraphLMConfig, init_lm_params,
                                             init_lm_params_torch, params_from_numpy)
    from repro_torch.runtime.engine import build_lm_serving
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GraphLMConfig(vocab=11, d_model=8, n_layers=1, n_heads=2, n_kv_heads=1, d_ff=8)
    for call in (lambda: resolve_device(None),
                 lambda: resolve_device("cuda"),
                 lambda: tcompile(_graph(tir, _params())),
                 lambda: params_from_numpy(init_lm_params(cfg)),
                 lambda: init_lm_params_torch(cfg),
                 lambda: build_lm_serving(cfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    engine, _ = build_lm_serving(cfg, n_slots=1, chunk=2, cache_cap=4, device="cpu")
    assert engine.stepper.device == torch.device("cpu")


def test_import_leaves_jax_out():
    code = ("import sys, repro_torch, repro_torch.runtime.engine, "
            "repro_torch.kernels._cuda, repro_torch.optim, repro_torch.data, "
            "repro_torch.checkpoint, repro_torch.runtime.train, repro_torch.launch.train, "
            "repro_torch.runtime.pipeline, repro_torch.launch.mesh; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'repro' or m.startswith('repro.')]; "
            "assert not bad, bad; print('clean')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(ROOT), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_jax_or_repro_import_in_the_port():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"
