"""The port's CNN path held against the JAX package on the CPU: every new
graph op and conv backend against JAX's ``ref``, the BN-folding and
bias/activation-fusion passes, the five builders (graphs node for node,
params bitwise), WRN-40-2 and ResNet-18 end to end, and the graph LM's
compile left unchanged by the new default pipeline.

Tolerances: single ops 2e-5 (fp32 on both sides, summed in another order;
the Winograd transforms 1e-4, their fp32 rounding grows with CI); whole
networks as max |a - b| / max |b|: 1e-4 for the GEMM, cuda (plain on the
CPU) and direct convolutions, 1e-3 for Winograd."""

import numpy as np
import pytest
import torch

import repro  # noqa: F401  (registers repro's ops)
import repro_torch  # noqa: F401  (registers the port's ops)
from repro.core import ir as jir
from repro.core import passes as jpasses
from repro.core.pipeline import default_pipeline as jdefault_pipeline
from repro.core.program import compile as jcompile
from repro.core.registry import backends_for as jbackends_for
from repro.core.registry import get_impl as jget_impl
from repro.core.registry import get_op as jget_op
from repro.core.selector import FixedPolicy as JFixed
from repro.models import cnn as jcnn
from repro_torch.core import ir as tir
from repro_torch.core import passes as tpasses
from repro_torch.core.pipeline import DEFAULT_PASSES, PassManager, default_pipeline
from repro_torch.core.program import compile as tcompile
from repro_torch.core.registry import backends_for, get_impl, get_op
from repro_torch.core.selector import FixedPolicy
from repro_torch.launch import cnn_eval
from repro_torch.models import cnn as tcnn

TOL = dict(rtol=2e-5, atol=2e-5)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _jax(op, inputs, attrs, backend="ref"):
    return [np.asarray(o) for o in jget_impl(op, backend)(list(inputs), attrs)]


def _port(op, inputs, attrs, backend):
    with torch.no_grad():
        outs = get_impl(op, backend)([torch.from_numpy(np.ascontiguousarray(a))
                                      for a in inputs], attrs)
    return [o.numpy() for o in outs]


# --------------------------------------------------------------------------- #
# conv2d and conv2d_fused, every backend, against JAX's ref
# --------------------------------------------------------------------------- #

CONV_CASES = [
    # (x shape NHWC, w shape HWIO, attrs)
    ((2, 9, 9, 4), (3, 3, 4, 6), {"stride": 1, "padding": "SAME"}),
    ((1, 10, 7, 3), (3, 3, 3, 5), {"stride": 1, "padding": "VALID"}),
    ((2, 11, 11, 4), (3, 3, 4, 8), {"stride": 2, "padding": "SAME"}),
    ((1, 12, 12, 3), (7, 7, 3, 8), {"stride": 2, "padding": "SAME"}),
    ((1, 9, 9, 4), (3, 3, 4, 4), {"stride": 1, "padding": "SAME", "dilation": 2}),
    ((1, 8, 8, 6), (1, 1, 6, 5), {"stride": 1, "padding": "SAME"}),
    ((1, 8, 8, 8), (1, 1, 8, 12), {"stride": 2, "padding": "SAME"}),
    ((1, 9, 9, 8), (3, 3, 2, 8), {"stride": 1, "padding": "SAME", "groups": 4}),
    ((2, 10, 10, 6), (3, 3, 1, 6), {"stride": 2, "padding": "SAME", "groups": 6}),
    ((1, 8, 9, 4), (3, 3, 4, 4), {"stride": 1, "padding": ((1, 2), (0, 1))}),
]


def _conv_inputs(xs, ws, seed=0):
    rng = _rng(seed)
    return (rng.standard_normal(xs).astype(np.float32),
            (rng.standard_normal(ws) / np.sqrt(np.prod(ws[:3]))).astype(np.float32))


@pytest.mark.parametrize("backend", ["ref", "cuda", "torch", "winograd"])
@pytest.mark.parametrize("case", range(len(CONV_CASES)))
def test_conv2d_backend_matches_jax_ref(case, backend):
    xs, ws, attrs = CONV_CASES[case]
    x, w = _conv_inputs(xs, ws, case)
    specs = [tir.TensorSpec(xs), tir.TensorSpec(ws)]
    if backend not in backends_for("conv2d", specs, attrs):
        # the guards: winograd is 3x3 stride-1 ungrouped, cuda ungrouped
        assert (backend == "cuda" and attrs.get("groups", 1) > 1) or backend == "winograd"
        assert backend not in _jax_backends("conv2d", specs, attrs)
        return
    (want,) = _jax("conv2d", [x, w], attrs)
    (got,) = _port("conv2d", [x, w], attrs, backend)
    tol = dict(rtol=1e-4, atol=1e-4) if backend == "winograd" else TOL
    np.testing.assert_allclose(got, want, **tol)


def _jax_backends(op, specs, attrs):
    """JAX's supported set for the same node, in the port's names."""
    names = {"pallas": "cuda", "xla": "torch"}
    jspecs = [jir.TensorSpec(s.shape, s.dtype) for s in specs]
    return [names.get(b, b) for b in jbackends_for(op, jspecs, attrs)]


@pytest.mark.parametrize("act", ["none", "relu", "relu6", "gelu", "silu", "sigmoid", "tanh"])
@pytest.mark.parametrize("backend", ["ref", "cuda", "torch", "winograd"])
def test_conv2d_fused_matches_jax_ref(backend, act):
    xs, ws, attrs = CONV_CASES[0]
    x, w = _conv_inputs(xs, ws, 7)
    b = _rng(8).standard_normal(ws[-1]).astype(np.float32)
    attrs = {**attrs, "act": act}
    (want,) = _jax("conv2d_fused", [x, w, b], attrs)
    (got,) = _port("conv2d_fused", [x, w, b], attrs, backend)
    tol = dict(rtol=1e-4, atol=1e-4) if backend == "winograd" else TOL
    np.testing.assert_allclose(got, want, **tol)


# --------------------------------------------------------------------------- #
# the other graph ops
# --------------------------------------------------------------------------- #

def _op_cases():
    rng = _rng(3)
    x4 = rng.standard_normal((2, 9, 9, 5)).astype(np.float32)
    x2 = rng.standard_normal((3, 7)).astype(np.float32)
    c5 = rng.standard_normal(5).astype(np.float32)
    var = (np.abs(rng.standard_normal(5)) + 0.5).astype(np.float32)
    w = rng.standard_normal((7, 4)).astype(np.float32)
    b4 = rng.standard_normal(4).astype(np.float32)
    cases = [("mul", [x2, x2[:1]], {}), ("bias_add", [x4, c5], {}), ("add", [x4, x4], {}),
             ("softmax", [x2], {}), ("softmax", [x4], {"axis": 1}),
             ("global_avgpool", [x4], {}), ("flatten", [x4], {}),
             ("transpose", [x4], {"perm": (0, 3, 1, 2)}),
             ("concat", [x4, x4[..., :2]], {"axis": -1}),
             ("concat", [x2, x2], {"axis": 0}),
             ("batchnorm", [x4, c5, c5[::-1].copy(), c5 * 0.5, var], {"eps": 1e-5}),
             ("fused_elementwise", [x2], {"ops": ("relu", "tanh", "gelu")}),
             ("fused_elementwise", [x2], {"ops": ("silu", "identity", "sigmoid", "relu6")}),
             ("reshape", [x2], {"shape": (7, 3)})]
    for act in ("none", "relu", "relu6", "gelu", "silu", "sigmoid", "tanh"):
        cases.append(("dense_fused", [x2, w, b4], {"act": act}))
    for name in ("relu", "relu6", "gelu", "silu", "sigmoid", "tanh", "identity"):
        cases.append((name, [x4 * 3.0], {}))
    for op in ("maxpool2d", "avgpool2d"):
        for attrs in ({"window": 3, "stride": 2, "padding": "SAME"},
                      {"window": 3, "stride": 1, "padding": "SAME"},
                      {"window": 3, "stride": 2, "padding": "VALID"},
                      {"window": 2}, {"window": (2, 3), "stride": (1, 2)}):
            cases.append((op, [x4], attrs))
    return cases


OP_CASES = _op_cases()


@pytest.mark.parametrize("i", range(len(OP_CASES)),
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(OP_CASES)])
def test_graph_op_matches_jax_ref(i):
    op, inputs, attrs = OP_CASES[i]
    want = _jax(op, inputs, attrs)
    got = _port(op, inputs, attrs, "ref")
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)
    specs = [tir.TensorSpec(a.shape, str(a.dtype)) for a in inputs]
    jspecs = [jir.TensorSpec(a.shape, str(a.dtype)) for a in inputs]
    assert [s.shape for s in get_op(op).shape_fn(specs, attrs)] == \
        [s.shape for s in jget_op(op).shape_fn(jspecs, attrs)]
    tc, jc = get_op(op).cost_fn(specs, attrs), jget_op(op).cost_fn(jspecs, attrs)
    assert (tc.flops, tc.bytes) == (jc.flops, jc.bytes)


@pytest.mark.parametrize("op", ["conv2d", "conv2d_fused"])
@pytest.mark.parametrize("backend", ["ref", "cuda", "torch", "winograd"])
def test_conv_costs_match_jax(op, backend):
    names = {"cuda": "pallas", "torch": "xla"}
    specs = [tir.TensorSpec((1, 9, 9, 4)), tir.TensorSpec((3, 3, 4, 6))]
    jspecs = [jir.TensorSpec((1, 9, 9, 4)), jir.TensorSpec((3, 3, 4, 6))]
    if op == "conv2d_fused":
        specs.append(tir.TensorSpec((6,)))
        jspecs.append(jir.TensorSpec((6,)))
    attrs = {"stride": 1, "padding": "SAME"}
    tc = get_impl(op, backend).cost(specs, attrs)
    jc = jget_impl(op, names.get(backend, backend)).cost(jspecs, attrs)
    assert (tc.flops, tc.bytes) == (jc.flops, jc.bytes)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    (got,) = _port("gelu", [x], {}, "ref")
    (want,) = _jax("gelu", [x], {})
    np.testing.assert_allclose(got, want, **TOL)
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - want).max() > 1e-5      # the approximation differs from erf


# --------------------------------------------------------------------------- #
# passes
# --------------------------------------------------------------------------- #

def _node_view(graph):
    return [(n.name, n.op, list(n.inputs), list(n.outputs), dict(n.attrs), n.backend)
            for n in graph.nodes]


def _same_params(tg, jg):
    assert sorted(tg.params) == sorted(jg.params)
    for k in jg.params:
        t = tg.params[k]
        t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        j = np.asarray(jg.params[k])
        assert t.dtype == j.dtype and t.shape == j.shape, k
        assert np.array_equal(t, j), k


def _bn_graph(ir, seed=0):
    """conv -> bn -> relu, conv -> bias_add -> relu6, a BN whose conv output
    has two consumers (not folded), dense -> bias_add -> tanh, a BN on a
    param-less path, and a conv output that is a graph output."""
    rng = _rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)        # noqa: E731
    pos = lambda *s: (np.abs(rng.standard_normal(s)) + 0.5).astype(np.float32)  # noqa: E731
    N = ir.Node
    params = {"w1": f(3, 3, 3, 4), "s1": f(4), "b1": f(4), "m1": f(4), "v1": pos(4),
              "w2": f(3, 3, 4, 4), "bias2": f(4),
              "w3": f(1, 1, 4, 4), "s3": f(4), "b3": f(4), "m3": f(4), "v3": pos(4),
              "wd": f(4, 5), "bd": f(5)}
    nodes = [
        N("c1", "conv2d", ["x", "w1"], ["h1"], {"stride": 1, "padding": "SAME"}),
        N("bn1", "batchnorm", ["h1", "s1", "b1", "m1", "v1"], ["h1n"], {"eps": 1e-5}),
        N("r1", "relu", ["h1n"], ["a1"]),
        N("c2", "conv2d", ["a1", "w2"], ["h2"], {"stride": 2, "padding": "SAME"}),
        N("ba2", "bias_add", ["h2", "bias2"], ["h2b"]),
        N("r2", "relu6", ["h2b"], ["a2"]),
        N("c3", "conv2d", ["a2", "w3"], ["h3"], {}),
        N("bn3", "batchnorm", ["h3", "s3", "b3", "m3", "v3"], ["h3n"], {"eps": 1e-3}),
        N("side", "add", ["h3", "h3n"], ["h3s"]),
        N("gap", "global_avgpool", ["h3s"], ["g"]),
        N("d", "dense", ["g", "wd"], ["y0"]),
        N("bd_", "bias_add", ["y0", "bd"], ["y1"]),
        N("t", "tanh", ["y1"], ["y"]),
    ]
    return ir.Graph(name="bn", inputs={"x": ir.TensorSpec((1, 8, 8, 3))},
                    outputs=["y", "a2"], nodes=nodes, params=params)


@pytest.mark.parametrize("name", ["fold_batchnorm", "fuse_bias_act", "simplify"])
def test_pass_graphs_equal_jax(name):
    tg = getattr(tpasses, name)(_bn_graph(tir))
    jg = getattr(jpasses, name)(_bn_graph(jir))
    assert _node_view(tg) == _node_view(jg)
    _same_params(tg, jg)
    assert {k: v.shape for k, v in tg.value_info.items()} == \
        {k: v.shape for k, v in jg.value_info.items()}
    if name == "simplify":
        ops = [n.op for n in tg.nodes]
        assert "batchnorm" in ops          # bn3's conv output feeds `side` too
        assert ops.count("conv2d_fused") == 2 and "dense_fused" in ops


def test_simplified_bn_graph_runs_like_jax():
    x = _rng(9).standard_normal((1, 8, 8, 3)).astype(np.float32)
    raw = tcompile(_bn_graph(tir), FixedPolicy(prefer=("ref",)), pipeline=(), device="cpu")
    simp = tcompile(_bn_graph(tir), FixedPolicy(prefer=("ref",)), device="cpu")
    jprog = jcompile(_bn_graph(jir), JFixed(prefer=("ref",)))
    for got, want in zip(simp(x=x), jprog(x=x)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    for got, want in zip(simp(x=x), raw(x=x)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


def test_default_pipeline_is_jaxs():
    from repro.core.pipeline import DEFAULT_PASSES as JDEFAULT
    assert DEFAULT_PASSES == JDEFAULT
    pm = default_pipeline()
    pm.run(_bn_graph(tir))
    assert [s.name for s in pm.stats] == list(JDEFAULT)


# --------------------------------------------------------------------------- #
# the five builders
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("name", list(jcnn.CNN_MODELS))
def test_builder_graph_and_params_equal_jax(name):
    assert list(tcnn.CNN_MODELS) == list(jcnn.CNN_MODELS)
    tg, jg = tcnn.build_cnn(name), jcnn.build_cnn(name)
    assert tg.name == jg.name and tg.outputs == jg.outputs
    assert {k: (v.shape, v.dtype) for k, v in tg.inputs.items()} == \
        {k: (v.shape, v.dtype) for k, v in jg.inputs.items()}
    assert _node_view(tg) == _node_view(jg)
    _same_params(tg, jg)


@pytest.mark.parametrize("name", ["wrn-40-2", "mobilenet-v1"])
def test_simplified_cnn_equals_jax(name):
    tg = default_pipeline().run(tcnn.build_cnn(name))
    jg = jdefault_pipeline().run(jcnn.build_cnn(name))
    assert _node_view(tg) == _node_view(jg)
    _same_params(tg, jg)
    assert "batchnorm" not in {n.op for n in tg.nodes}


# --------------------------------------------------------------------------- #
# end to end against the JAX Program
# --------------------------------------------------------------------------- #

def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def wrn_jax():
    g = jdefault_pipeline().run(jcnn.build_cnn("wrn-40-2"))
    x = _rng(11).standard_normal(g.inputs["x"].shape).astype(np.float32)
    (y,) = jcompile(g, JFixed(prefer=("ref",)), pipeline=())(x=x)
    return x, np.asarray(y)


@pytest.mark.parametrize("label", ["gemm", "cuda", "direct", "winograd", "cost_model"])
def test_wrn_40_2_end_to_end_against_jax(wrn_jax, label):
    x, want = wrn_jax
    g = default_pipeline().run(tcnn.build_cnn("wrn-40-2"))
    pol = cnn_eval.policies(device="cpu")[label]
    prog = tcompile(g, pol, pipeline=(), device="cpu")
    (y,) = prog(x=x)
    assert y.shape == want.shape == (1, 10) and bool(torch.isfinite(y).all())
    assert _rel(y.numpy(), want) <= (1e-3 if label == "winograd" else 1e-4)
    backends = set(prog.assignment.values())
    if label in ("cuda", "direct", "winograd"):
        assert {"cuda": "cuda", "direct": "torch", "winograd": "winograd"}[label] in backends


def test_resnet18_batch1_end_to_end_against_jax():
    x = _rng(12).standard_normal((1, 224, 224, 3)).astype(np.float32)
    (want,) = jcompile(jdefault_pipeline().run(jcnn.build_cnn("resnet-18")),
                       JFixed(prefer=("ref",)), pipeline=())(x=x)
    prog = tcompile(default_pipeline().run(tcnn.build_cnn("resnet-18")), device="cpu")
    assert "cuda" in set(prog.assignment.values())
    (y,) = prog(x=x)
    assert y.shape == (1, 1000)
    assert _rel(y.numpy(), np.asarray(want)) <= 1e-4


def test_run_instrumented_reports_every_node():
    g = default_pipeline().run(tcnn.build_cnn("wrn-40-2"))
    prog = tcompile(g, device="cpu")
    x = _rng(13).standard_normal(g.inputs["x"].shape).astype(np.float32)
    (y,), reports = prog.run_instrumented(x=x)
    assert [r.name for r in reports] == [n.name for n, *_ in prog.costs()]
    assert all(r.seconds > 0 and r.backend == prog.assignment[r.name] for r in reports)
    assert torch.equal(y, prog(x=x)[0])
    total = prog.total_cost()
    assert total.flops == sum(c.flops for _, _, c in prog.costs()) > 0


def test_cnn_eval_runs_on_the_cpu(tmp_path, capsys):
    rows = cnn_eval.run(models=["wrn-40-2"], reps=1, device="cpu",
                        autotune_cache=str(tmp_path / "tune.json"))
    assert set(rows[0]) == {"model", "winner", *cnn_eval.ASSIGNMENTS}
    assert rows[0]["winner"] in cnn_eval.ASSIGNMENTS
    cnn_eval.main(["--int8", "--fast", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "batch 1, median of 2 runs, on cpu"
    rows = [line.split() for line in out[2:]]
    assert [r[0] for r in rows] == list(cnn_eval.FAST_MODELS)
    assert all(float(r[5].rstrip("x")) >= 3.9 for r in rows)


# --------------------------------------------------------------------------- #
# the serving graphs are untouched by the new default pipeline
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("which", ["decode", "prefill", "paged_decode", "kv8_prefill"])
def test_graph_lm_compile_unchanged_by_the_new_passes(which):
    from repro_torch.models import graph_lm as G
    cfg = G.GraphLMConfig(vocab=31, d_model=16, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=24)
    params = G.init_lm_params(cfg, seed=1)
    paged = dict(n_blocks=9, page_size=4, max_pages=4)
    graph = {"decode": lambda: G.build_decode_graph(cfg, params, batch=2, cache_cap=16),
             "prefill": lambda: G.build_prefill_graph(cfg, params, batch=2, chunk=4,
                                                      cache_cap=16),
             "paged_decode": lambda: G.build_paged_decode_graph(cfg, params, batch=2, **paged),
             "kv8_prefill": lambda: G.build_paged_prefill_graph(
                 cfg, params, batch=2, chunk=4, kv_dtype="int8", **paged)}[which]()
    old = [p for p in DEFAULT_PASSES if p not in ("fold_batchnorm", "fuse_bias_act")]
    new_prog = tcompile(graph, device="cpu")
    old_prog = tcompile(graph, pipeline=PassManager(old), device="cpu")
    assert _node_view(new_prog.graph) == _node_view(old_prog.graph)
    assert new_prog.assignment == old_prog.assignment
    assert sorted(new_prog.graph.params) == sorted(old_prog.graph.params)
