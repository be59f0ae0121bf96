"""int8 weights on the port (``repro_torch.core.quant``) against the JAX
package on the CPU: the unit tests of tests/test_quantize.py on the port;
``quantize_graph`` bitwise against JAX's given the same ranges (numpy and
tensor weights); ``calibrate`` within 1e-6 relative; the four quantized
ops, ``ref`` bitwise against JAX's ``ref`` and ``torch`` within 1e-5 of
``xla``; the float64 accumulation of ``ref`` against an int64 product; the
golden ``tiny_int8`` bundle; the int8-weight serving engine token-exact
against its reference and equal to JAX's under matching backends; and
``cnn_eval --int8`` against the JAX package's ``run_quant``."""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import repro  # noqa: F401  (registers every op and backend of the JAX package)
import repro_torch  # noqa: F401
from repro.core import quant as jq
from repro.core.program import compile as jcompile
from repro.core.selector import FixedPolicy as JFixed
from repro.models import graph_lm as jlm
from repro.runtime import engine as jeng
from repro_torch.core import (FixedPolicy, Graph, Node, PassManager, TensorSpec, calibrate,
                              compile, get_impl, is_quantized, load_graph, quantize_graph,
                              quantize_weight)
from repro_torch.core.quant import QMAX, activation_scale, weight_scales
from repro_torch.models import graph_lm as tlm
from repro_torch.runtime import engine as teng
from repro_torch.tools.report import weight_bytes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "tiny_int8")
TINY_ARGS = dict(vocab=61, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64)
REF = FixedPolicy(prefer=("ref",))


def conv_graph(rng, graph_cls=Graph, node_cls=Node, spec_cls=TensorSpec):
    """conv2d -> bias_add -> relu -> flatten -> dense (tests/test_quantize.py's
    graph), built with either package's IR classes."""
    g = graph_cls(
        name="qconv",
        inputs={"x": spec_cls((2, 8, 8, 3))},
        outputs=["y"],
        nodes=[
            node_cls("c", "conv2d", ["x", "w"], ["h"], {"padding": "SAME"}),
            node_cls("b", "bias_add", ["h", "bias"], ["hb"]),
            node_cls("r", "relu", ["hb"], ["hr"]),
            node_cls("f", "flatten", ["hr"], ["hf"]),
            node_cls("d", "dense", ["hf", "w2"], ["y"]),
        ],
        params={
            "w": (rng.standard_normal((3, 3, 3, 8)) * 0.2).astype(np.float32),
            "bias": (rng.standard_normal((8,)) * 0.1).astype(np.float32),
            "w2": (rng.standard_normal((8 * 8 * 8, 5)) * 0.05).astype(np.float32),
        },
    )
    g.validate()
    return g


def jax_conv_graph(seed):
    from repro.core import Graph as JG, Node as JN, TensorSpec as JS
    return conv_graph(np.random.default_rng(seed), JG, JN, JS)


def run(prog, **inputs):
    return prog(**inputs)[0].numpy()


# --------------------------------------------------------------------------- #
# tests/test_quantize.py on the port
# --------------------------------------------------------------------------- #

class TestWeightQuantization:
    def test_per_channel_scales_shapes(self, rng):
        assert weight_scales(rng.standard_normal((3, 3, 8, 16)).astype(np.float32),
                             3).shape == (16,)
        assert weight_scales(rng.standard_normal((8, 4)).astype(np.float32), 1).shape == (4,)

    def test_roundtrip_error_bounded_by_half_scale(self, rng):
        w = rng.standard_normal((5, 7)).astype(np.float32)
        w_q, s = quantize_weight(w, 1)
        assert w_q.dtype == np.int8 and np.abs(w_q).max() <= QMAX
        err = np.abs(w - w_q.astype(np.float32) * s[None, :])
        assert (err <= s[None, :] / 2 + 1e-7).all()

    def test_channel_with_largest_magnitude_hits_qmax(self, rng):
        w_q, _ = quantize_weight(rng.standard_normal((16, 3)).astype(np.float32), 1)
        assert (np.abs(w_q).max(axis=0) == QMAX).all()

    def test_all_zero_channel_is_safe(self):
        for w in (np.zeros((4, 2), np.float32), torch.zeros(4, 2)):
            w_q, s = quantize_weight(w, 1)
            assert (np.asarray(w_q) == 0).all() and (np.asarray(s) == np.float32(1 / QMAX)).all()

    def test_activation_scale_symmetric(self):
        assert activation_scale(-2.0, 1.0) == pytest.approx(2.0 / QMAX)
        assert activation_scale(0.0, 3.0) == pytest.approx(3.0 / QMAX)


class TestCalibrate:
    def test_observes_every_value(self, rng):
        g = conv_graph(rng)
        ranges = calibrate(g, {"x": rng.standard_normal((2, 8, 8, 3)).astype(np.float32)},
                           device="cpu")
        expected = set(g.inputs) | set(g.params) | {v for n in g.nodes for v in n.outputs}
        assert expected <= set(ranges)
        assert all(lo <= hi for lo, hi in ranges.values())
        assert ranges["hr"][0] >= 0.0

    def test_multiple_batches_widen_ranges(self, rng):
        g = conv_graph(rng)
        small = (rng.standard_normal((2, 8, 8, 3)) * 0.1).astype(np.float32)
        large = (rng.standard_normal((2, 8, 8, 3)) * 10).astype(np.float32)
        r_small = calibrate(g, small, device="cpu")          # bare array: one input
        r_both = calibrate(g, [{"x": small}, {"x": torch.from_numpy(large)}], device="cpu")
        assert r_both["x"][1] > r_small["x"][1] and r_both["x"][0] < r_small["x"][0]

    def test_channel_mean_recorded(self, rng):
        x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
        mu = calibrate(conv_graph(rng), x, device="cpu")["x"].channel_mean
        np.testing.assert_allclose(mu, x.mean(axis=(0, 1, 2)), rtol=1e-5)

    def test_missing_input_raises(self, rng):
        with pytest.raises(ValueError, match="missing inputs"):
            calibrate(conv_graph(rng), {"not_x": np.zeros((2, 8, 8, 3))}, device="cpu")


class TestQuantizeGraphRewrite:
    def test_rewrites_ops_and_params(self, rng):
        gq = quantize_graph(conv_graph(rng))
        ops = {n.op for n in gq.nodes}
        assert "conv2d_q" in ops and "dense_q" in ops
        assert "conv2d" not in ops and "dense" not in ops
        assert gq.params["w.q8"].dtype == np.int8
        assert "w" not in gq.params and "w2" not in gq.params
        qnode = next(n for n in gq.nodes if n.op == "conv2d_q")
        assert qnode.attrs["zero_point"] == 0 and qnode.attrs["w_scale"].shape == (8,)
        assert "x_scale" not in qnode.attrs
        gq.validate()

    def test_calibrated_rewrite_freezes_x_scale(self, rng):
        g = conv_graph(rng)
        x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
        qnode = next(n for n in quantize_graph(g, calibrate(g, x, device="cpu")).nodes
                     if n.op == "conv2d_q")
        assert qnode.attrs["x_scale"] == pytest.approx(np.abs(x).max() / QMAX, rel=1e-5)

    def test_registered_as_pass(self, rng):
        assert is_quantized(PassManager(["infer_shapes", "quantize"]).run(conv_graph(rng)))

    def test_input_graph_untouched(self, rng):
        g = conv_graph(rng)
        quantize_graph(g)
        assert {n.op for n in g.nodes} == {"conv2d", "bias_add", "relu", "flatten", "dense"}
        assert "w.q8" not in g.params

    def test_computed_weight_left_in_fp32(self):
        g = Graph(name="computed_w",
                  inputs={"x": TensorSpec((2, 4)), "wdyn": TensorSpec((4, 4))},
                  outputs=["y"], nodes=[Node("d", "dense", ["x", "wdyn"], ["y"])])
        g.validate()
        assert [n.op for n in quantize_graph(g).nodes] == ["dense"]

    def test_unknown_dtype_rejected(self, rng):
        with pytest.raises(ValueError, match="int8"):
            quantize_graph(conv_graph(rng), dtype="int4")


class TestQuantizedExecution:
    def test_ref_is_true_int8_accumulation(self, rng):
        x = rng.standard_normal((3, 6)).astype(np.float32)
        w_q, w_s = quantize_weight((rng.standard_normal((6, 4)) * 0.3).astype(np.float32), 1)
        x_scale = float(np.abs(x).max() / QMAX)
        attrs = {"w_scale": w_s, "x_scale": x_scale, "zero_point": 0}
        (y,) = get_impl("dense_q", "ref")([torch.from_numpy(x), torch.from_numpy(w_q)], attrs)
        x_q = np.clip(np.round(x / x_scale), -QMAX, QMAX).astype(np.int32)
        expect = (x_q @ w_q.astype(np.int32)).astype(np.float32) * (x_scale * w_s[None, :])
        np.testing.assert_allclose(y.numpy(), expect, rtol=1e-6, atol=1e-6)

    def test_backends_close_to_fp32(self, rng):
        g = conv_graph(rng)
        x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
        y_fp = run(compile(g, REF, device="cpu"), x=x)
        for prefer in (("torch", "ref"), ("ref",)):
            prog = compile(g, FixedPolicy(prefer=prefer), quantize="int8", calib_data=x,
                           device="cpu")
            np.testing.assert_allclose(run(prog, x=x), y_fp, atol=0.05)

    def test_dynamic_weight_only_still_runs(self, rng):
        g = conv_graph(rng)
        x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
        y_fp = run(compile(g, REF, device="cpu"), x=x)
        np.testing.assert_allclose(run(compile(g, REF, quantize="int8", device="cpu"), x=x),
                                   y_fp, atol=0.1)

    def test_bad_mode_rejected(self, rng):
        with pytest.raises(ValueError, match="quantize mode"):
            compile(conv_graph(rng), quantize="fp8", device="cpu")
        with pytest.raises(ValueError, match="not both"):
            compile(conv_graph(rng), quantize="int8", calib_data=np.zeros((2, 8, 8, 3)),
                    calib_ranges={}, device="cpu")


class TestExampleCNNAcceptance:
    """JAX's test compiles under its default policy, which runs the *_q
    nodes on ``xla``; the port's counterpart is ``torch`` (its default
    picks the integer ``ref``, as JAX's ``("ref",)``: 0.176 on both)."""

    @pytest.fixture(scope="class")
    def built(self):
        from repro_torch.models.cnn import build_cnn
        g = build_cnn("wrn-40-2", batch=1)
        x = np.random.default_rng(7).standard_normal(g.inputs["x"].shape).astype(np.float32)
        pol = FixedPolicy(prefer=("torch", "ref"))
        return (x, compile(g, pol, device="cpu"),
                compile(g, pol, quantize="int8", calib_data=x, device="cpu"))

    def test_matches_fp32_within_atol(self, built):
        x, prog_fp, prog_q = built
        np.testing.assert_allclose(run(prog_q, x=x), run(prog_fp, x=x), atol=0.1)

    def test_weight_bytes_at_least_3x_smaller(self, built):
        _, prog_fp, prog_q = built
        assert weight_bytes(prog_fp) >= 3 * weight_bytes(prog_q)
        assert is_quantized(prog_q.graph) and not is_quantized(prog_fp.graph)


def test_weight_bytes_counts_tensors_and_arrays(rng):
    g = conv_graph(rng)
    want = sum(v.nbytes for v in g.params.values())
    assert weight_bytes(g) == want
    g.params = {k: torch.from_numpy(v) for k, v in g.params.items()}
    assert weight_bytes(g) == want
    prog_q = compile(conv_graph(rng), REF, quantize="int8", device="cpu")
    assert weight_bytes(compile(conv_graph(rng), REF, device="cpu")) > 3 * weight_bytes(prog_q)


# --------------------------------------------------------------------------- #
# parity with the JAX package
# --------------------------------------------------------------------------- #

def _lm_graph(pkg, mode):
    cfg = pkg.GraphLMConfig(**TINY_ARGS)
    params = jlm.init_lm_params(jlm.GraphLMConfig(**TINY_ARGS), 0)
    if mode == "decode":
        return pkg.build_decode_graph(cfg, params, batch=2, cache_cap=16)
    return pkg.build_prefill_graph(cfg, params, batch=2, chunk=4, cache_cap=16)


def _lm_batch(seed, mode):
    rng = np.random.default_rng(seed)
    t = 1 if mode == "decode" else 4
    batch = {"tokens": rng.integers(0, 61, (2, t)).astype(np.int32),
             "start": np.asarray([3, 0], np.int32), "n_new": np.asarray([t, t - 1], np.int32)}
    for i in range(TINY_ARGS["n_layers"]):
        for kv in "kv":
            batch[f"cache_{kv}{i}"] = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    return batch


def _assert_same_rewrite(gt, gj):
    assert [(n.name, n.op, n.inputs) for n in gt.nodes] == \
        [(n.name, n.op, n.inputs) for n in gj.nodes]
    assert sorted(gt.params) == sorted(gj.params)
    for k in gj.params:
        a, b = np.asarray(gt.params[k]) if not isinstance(gt.params[k], torch.Tensor) \
            else gt.params[k].numpy(), np.asarray(gj.params[k])
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    for nt, nj in zip(gt.nodes, gj.nodes):
        for key in ("w_scale", "x_scale", "zero_point"):
            if key in nj.attrs:
                a = nt.attrs[key]
                a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
                assert a.tobytes() == np.asarray(nj.attrs[key]).tobytes(), (nt.name, key)
            else:
                assert key not in nt.attrs


@pytest.mark.parametrize("weights", ["numpy", "tensor"])
def test_quantize_graph_bitwise_equal_to_jax_conv(weights):
    """The same simplified graph and JAX's calibration ranges: int8 weights,
    w_scale, x_scale and the bias-corrected qbias equal JAX's bit for bit,
    whether the port's weights are numpy arrays or tensors."""
    from repro.core.pipeline import default_pipeline as jpipe
    from repro_torch.core.pipeline import default_pipeline as tpipe
    gj = jpipe().run(jax_conv_graph(3))
    gt = tpipe().run(conv_graph(np.random.default_rng(3)))
    x = np.random.default_rng(4).standard_normal((2, 8, 8, 3)).astype(np.float32)
    ranges = jq.calibrate(gj, x)
    if weights == "tensor":
        gt.params = {k: torch.from_numpy(np.array(v)) for k, v in gt.params.items()}
    qj, qt = jq.quantize_graph(gj, ranges), quantize_graph(gt, ranges)
    assert any(k.endswith(".qbias") for k in qj.params)
    _assert_same_rewrite(qt, qj)


@pytest.mark.parametrize("mode", ["decode", "prefill"])
@pytest.mark.parametrize("weights", ["numpy", "tensor"])
def test_quantize_graph_bitwise_equal_to_jax_lm(mode, weights):
    gj, gt = _lm_graph(jlm, mode), _lm_graph(tlm, mode)
    ranges = jq.calibrate(gj, _lm_batch(5, mode))
    if weights == "tensor":
        gt.params = {k: torch.from_numpy(v) for k, v in gt.params.items()}
    _assert_same_rewrite(quantize_graph(gt, ranges), jq.quantize_graph(gj, ranges))


@pytest.mark.parametrize("mode", ["decode", "prefill"])
def test_calibrate_ranges_match_jax(mode):
    """Ranges and channel means within 1e-6 relative (the two packages'
    fp32 arithmetic differs in summation order only)."""
    batches = [_lm_batch(6, mode), _lm_batch(7, mode)]
    rj = jq.calibrate(_lm_graph(jlm, mode), batches)
    rt = calibrate(_lm_graph(tlm, mode), batches, device="cpu")
    assert set(rt) == set(rj)
    for name, vr in rj.items():
        _assert_range_close(rt[name], vr, name)
        np.testing.assert_allclose(rt[name].channel_mean, vr.channel_mean, rtol=0,
                                   atol=1e-6 * max(abs(vr[0]), abs(vr[1]), 1e-30),
                                   err_msg=name)


def _assert_range_close(got, want, name):
    """Within 1e-6 of the value's magnitude max(|lo|, |hi|)."""
    atol = 1e-6 * max(abs(want[0]), abs(want[1]))
    np.testing.assert_allclose(got[:2], want[:2], rtol=0, atol=atol, err_msg=name)


def test_calibrate_conv_ranges_match_jax():
    gj, gt = jax_conv_graph(8), conv_graph(np.random.default_rng(8))
    x = np.random.default_rng(9).standard_normal((2, 8, 8, 3)).astype(np.float32)
    rj, rt = jq.calibrate(gj, x), calibrate(gt, x, device="cpu")
    for name, vr in rj.items():
        _assert_range_close(rt[name], vr, name)


def _q_case(op, static, seed):
    """Inputs and attrs of one quantized op: x, int8 w, and a bias for the
    fused forms; ``static`` freezes an x_scale."""
    rng = np.random.default_rng(seed)
    dense = op.startswith("dense")
    groups = 1 if static else 2
    x = rng.standard_normal((3, 5, 24) if dense else (2, 9, 9, 6)).astype(np.float32)
    w = rng.standard_normal((24, 7) if dense else (3, 3, 6 // groups, 8)).astype(np.float32)
    w_q, w_s = quantize_weight(w, 1 if dense else 3)
    attrs = {"w_scale": w_s, "zero_point": 0}
    if not dense:
        attrs.update(padding="SAME", stride=2 if static else 1, groups=groups)
    if static:
        attrs["x_scale"] = float(np.abs(x).max() * 0.9 / QMAX)   # clips a little
    inputs = [x, w_q]
    if op.endswith("fused_q"):
        inputs.append(rng.standard_normal((w_q.shape[-1],)).astype(np.float32))
        attrs["act"] = "relu"
    return inputs, attrs


@pytest.mark.parametrize("static", [True, False])
@pytest.mark.parametrize("op", ["dense_q", "dense_fused_q", "conv2d_q", "conv2d_fused_q"])
def test_quantized_ops_match_jax(op, static):
    """``ref`` bitwise against JAX's ``ref`` (the integer oracle both
    sides); ``torch`` within 1e-5 of ``xla`` (float32 products in another
    order)."""
    inputs, attrs = _q_case(op, static, seed=len(op) + static)
    t_in = [torch.from_numpy(a) for a in inputs]
    (yj,) = get_impl_j(op, "ref")(inputs, attrs)
    (yt,) = get_impl(op, "ref")(t_in, attrs)
    assert yt.numpy().tobytes() == np.asarray(yj).tobytes()
    (yj,) = get_impl_j(op, "xla")(inputs, attrs)
    (yt,) = get_impl(op, "torch")(t_in, attrs)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5, atol=1e-5)


def get_impl_j(op, backend):
    from repro.core.registry import get_impl as jget
    return jget(op, backend)


def test_float64_accumulation_is_the_int64_product_at_k8192():
    """The ``ref`` backends accumulate int8 x int8 products in float64: at
    K = 8192 every partial sum is an integer below 8192 * 127**2 < 2**53,
    so the result equals an int64 product bitwise, including the
    all-extreme worst case."""
    rng = np.random.default_rng(0)
    k = 8192
    x = torch.from_numpy(rng.integers(-127, 128, (5, k)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (k, 9)).astype(np.int8))
    x[0] = 127
    w[:, 0] = 127
    x[1] = -127
    exact = torch.matmul(x.long(), w.long())
    got = torch.matmul(x.double(), w.double())
    assert torch.equal(got, exact.double())
    assert int(exact[0, 0]) == k * 127 * 127
    assert torch.equal(got.long(), exact)


# --------------------------------------------------------------------------- #
# the golden int8 bundle
# --------------------------------------------------------------------------- #

def _read_golden():
    """tests/golden/tiny_int8 as a port Graph (the importer), its pins
    cleared so that each test's policy chooses."""
    g = load_graph(GOLDEN)
    for n in g.nodes:
        n.backend = None
    return g


def test_golden_tiny_int8_torch_reproduces_expected_y():
    """The bundle was saved pinned to JAX's ``xla`` backend: the port's
    counterpart ``torch`` reproduces its ``expected_y`` to float32
    rounding."""
    g = _read_golden()
    x = np.load(os.path.join(GOLDEN, "input_x.npy"))
    prog = compile(g, FixedPolicy(prefer=("torch",)), pipeline=(), device="cpu")
    assert set(prog.assignment.values()) == {"torch"}
    np.testing.assert_allclose(run(prog, x=x), np.load(os.path.join(GOLDEN, "expected_y.npy")),
                               rtol=1e-5, atol=1e-6)


def test_golden_tiny_int8_ref_equals_jax_ref():
    """The integer oracle also quantizes the activations, so it lies
    5.74e-3 from ``expected_y`` — in the JAX package too (its ``ref`` on
    the same bundle).  The port's ``ref`` equals JAX's bit for bit."""
    from repro.core.program import Program as JProgram
    g = _read_golden()
    x = np.load(os.path.join(GOLDEN, "input_x.npy"))
    jg = JProgram.load(GOLDEN).graph.clone()
    for n in jg.nodes:
        n.backend = None
    yj = np.asarray(jcompile(jg, JFixed(prefer=("ref",)), pipeline=())(x=x)[0])
    yt = run(compile(g, REF, pipeline=(), device="cpu"), x=x)
    assert yt.tobytes() == yj.tobytes()
    assert np.abs(yt - np.load(os.path.join(GOLDEN, "expected_y.npy"))).max() < 6e-3


# --------------------------------------------------------------------------- #
# the int8-weight serving engine
# --------------------------------------------------------------------------- #

def _requests(cls, seed, n=4, phi=11, mhi=5):
    """tests/test_speculative.py's request draw."""
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=rng.integers(0, 61, int(rng.integers(1, phi))).astype(np.int32),
                max_new_tokens=int(rng.integers(1, mhi))) for i in range(n)]


def _serve(engine, reqs):
    for r in reqs:
        assert engine.submit(r), r.dropped
    engine.run(max_ticks=engine.tick + 4000)
    assert all(r.done for r in reqs)
    engine.sched.check_conservation()
    return [list(r.out_tokens) for r in reqs]


@pytest.mark.parametrize("variant", [{}, {"paged": True, "page_size": 8},
                                     {"paged": True, "page_size": 8, "kv_dtype": "int8"}],
                         ids=["dense", "paged-fp32", "paged-int8"])
def test_int8_engine_token_exact_against_its_reference(variant):
    engine, ref = teng.build_lm_serving(tlm.GraphLMConfig(**TINY_ARGS), n_slots=2, chunk=4,
                                        cache_cap=32, quantize="int8", device="cpu", **variant)
    summary = engine.stepper.backend_summary()
    for phase in ("prefill", "decode"):
        assert summary[phase]["dense_q"] == {"ref": 7 * 2 + 1}
        assert "dense" not in summary[phase]
    reqs = _requests(teng.EngineRequest, 24)
    got = _serve(engine, reqs)
    assert got == [ref.generate(r.prompt, r.max_new_tokens) for r in reqs]
    if engine.paged:
        engine.stepper.pool.check_integrity()


def test_shared_calibration_matches_jax():
    """The same traffic (the same prompts from the same seed) through
    either package's fp32 reference: every merged range within 1e-6."""
    params = jlm.init_lm_params(jlm.GraphLMConfig(**TINY_ARGS), 0)
    rj = jeng.shared_calibration(jlm.GraphLMConfig(**TINY_ARGS), params, chunk=4,
                                 cache_cap=48)
    rt = teng.shared_calibration(tlm.GraphLMConfig(**TINY_ARGS), params, chunk=4,
                                 cache_cap=48, device="cpu")
    assert set(rt) == set(rj)
    for name, vr in rj.items():
        _assert_range_close(rt[name], vr, name)


@pytest.mark.parametrize("backends", [("ref", "ref"), ("torch", "xla")],
                         ids=["ref-ref", "torch-xla"])
def test_int8_engine_equals_jax_int8_engine(backends):
    """Each package's own build_lm_serving(quantize="int8") at TINY_LM with
    the quantized ops pinned to matching backends (never the defaults: JAX
    prefers ``xla`` for ``dense_q``, the port ``ref``): the same tokens."""
    tb, jb = backends
    cfg_t, cfg_j = tlm.GraphLMConfig(**TINY_ARGS), jlm.GraphLMConfig(**TINY_ARGS)
    kw = dict(n_slots=3, chunk=4, cache_cap=48, quantize="int8")
    et, _ = teng.build_lm_serving(cfg_t, policy=FixedPolicy(per_op={"dense_q": (tb,)}),
                                  device="cpu", **kw)
    ej, _ = jeng.build_lm_serving(cfg_j, policy=JFixed(per_op={"dense_q": (jb,)}), **kw)
    assert et.stepper.backend_summary()["decode"]["dense_q"] == {tb: 15}
    assert ej.stepper.backend_summary()["decode"]["dense_q"] == {jb: 15}
    assert _serve(et, _requests(teng.EngineRequest, 32, n=6)) == \
        _serve(ej, _requests(jeng.EngineRequest, 32, n=6))


def test_reference_records_calibration_batches():
    params = tlm.init_lm_params(tlm.GraphLMConfig(**TINY_ARGS), 0)
    ref = teng.UnbatchedReference(tlm.GraphLMConfig(**TINY_ARGS), params, cache_cap=16,
                                  device="cpu")
    record = []
    out = ref.generate(np.arange(1, 7, dtype=np.int32), 3, chunk=4, record=record)
    assert [kind for kind, _ in record] == ["prefill", "prefill", "decode", "decode"]
    assert len(out) == 3
    first = record[0][1]
    assert set(first) == {"tokens", "start", "n_new", "cache_k0", "cache_v0",
                          "cache_k1", "cache_v1"}
    assert float(first["cache_k0"].abs().max()) == 0.0        # the cache the call read
    assert float(record[1][1]["cache_k0"].abs().max()) > 0.0


# --------------------------------------------------------------------------- #
# cnn_eval --int8 against the JAX package's run_quant
# --------------------------------------------------------------------------- #

def _smoke_constants():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT,
                                                                             "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.JAX_INT8_MAX_ABS_ERR, mod.INT8_ERR_MARGIN


@pytest.mark.parametrize("model", ["wrn-40-2", "resnet-18"])
def test_cnn_int8_error_matches_jax_run_quant(model):
    """The JAX package's ``run_quant`` (benchmarks/fig2_inference_time.py)
    gives the max abs error chip_smoke.py holds the card's int8 CNNs to
    (JAX_INT8_MAX_ABS_ERR, all five models, seed 0); this recomputes it for
    two models and runs the port's ``run_quant`` on the CPU beside it: the
    port's error is within INT8_ERR_MARGIN of JAX's (its calibration sums
    in another order, so a few activations round the other way) and its
    weights shrink at least 3.9x."""
    sys.path.insert(0, ROOT)
    try:
        from benchmarks.fig2_inference_time import run_quant as jax_run_quant
    finally:
        sys.path.remove(ROOT)
    from repro_torch.launch.cnn_eval import run_quant
    consts, margin = _smoke_constants()
    assert set(consts) == {"wrn-40-2", "mobilenet-v1", "resnet-18", "inception-v3",
                           "resnet-50"}
    (rj,) = jax_run_quant([model], reps=1)
    assert rj["max_abs_err"] == consts[model]
    (rt,) = run_quant([model], reps=1, device="cpu")
    assert rt["bytes_ratio"] >= 3.9 and rt["fp32_weight_bytes"] == rj["fp32_weight_bytes"]
    assert rt["int8_weight_bytes"] == rj["int8_weight_bytes"]
    assert rt["max_abs_err"] <= consts[model] * margin
