"""OXF bundles across the two packages (``repro_torch.core.importer``,
``Program.save`` / ``Program.load``) on the CPU.

A bundle names backends in the format's vocabulary, which is the JAX
package's; the port maps ``pallas`` -> ``cuda``, ``pallas_split`` ->
``cuda_split``, ``xla`` -> ``torch`` (or ``ref`` where the port folded
``xla`` into it) and back, and remembers the names it read.  Checked here:
the golden ``tiny_int8`` bundle through the port (its ``expected_y`` to
rtol 1e-5, atol 1e-6, as tests/test_oxf_golden.py; a byte-identical
re-save); the tiny graph LM's serving graphs saved by either package and
loaded by the other, fp32 and int8 (shared calibration ranges), outputs
within 1e-5; ``model.json`` and ``program.json`` written by the port
byte-identical to JAX's for the same graph and assignment; assignments
surviving JAX -> port -> JAX; the name map against both live registries;
the version errors; partitioned bundles and ``tp`` pins (tensor-parallel
serving) through the port and back, byte for byte.  JAX compiles with
FixedPolicy(("xla", "ref")) or ("ref",): no Pallas interpret run.
"""

import json
import os
import shutil
import types

import numpy as np
import pytest
import torch

import repro  # noqa: F401  (registers every op and backend of the JAX package)
import repro_torch  # noqa: F401
from repro.core import importer as jimp
from repro.core import registry as jreg
from repro.core.program import Program as JProgram
from repro.core.program import compile as jcompile
from repro.core.selector import FixedPolicy as JFixed
from repro.models import graph_lm as jlm
from repro.runtime import engine as jeng
from repro_torch.core import (FixedPolicy, GraphError, Program, compile, is_quantized,
                              load_graph, load_program, save_graph)
from repro_torch.core import registry as treg
from repro_torch.core.importer import bundle_backend, bundle_cost, port_backend
from repro_torch.models import graph_lm as tlm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "tiny_int8")
TINY_ARGS = dict(vocab=61, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64)
PARAMS = jlm.init_lm_params(jlm.GraphLMConfig(**TINY_ARGS), 0)
TOL = dict(rtol=1e-5, atol=1e-5)   # fp32 on both sides, another summation order
J_XLA, J_REF, J_PALLAS = (JFixed(prefer=("xla", "ref")), JFixed(prefer=("ref",)),
                          JFixed(prefer=("pallas", "pallas_split", "ref")))
T_REF, T_CUDA = FixedPolicy(prefer=("ref",)), FixedPolicy(prefer=("cuda", "cuda_split", "ref"))
GRAPHS = ["decode", "prefill", "paged_decode", "paged_prefill", "paged_decode_int8",
          "paged_prefill_int8", "verify", "paged_verify"]


def lm_graph(pkg, kind):
    cfg = pkg.GraphLMConfig(**TINY_ARGS)
    paged = dict(batch=2, page_size=8, n_blocks=6, max_pages=2)
    kv8 = dict(kv_dtype="int8") if kind.endswith("_int8") else {}
    base = kind.replace("_int8", "")
    if base == "decode":
        return pkg.build_decode_graph(cfg, PARAMS, batch=2, cache_cap=16)
    if base == "prefill":
        return pkg.build_prefill_graph(cfg, PARAMS, batch=2, chunk=4, cache_cap=16)
    if base == "paged_decode":
        return pkg.build_paged_decode_graph(cfg, PARAMS, **paged, **kv8)
    if base == "paged_prefill":
        return pkg.build_paged_prefill_graph(cfg, PARAMS, chunk=4, **paged, **kv8)
    if base == "verify":
        return pkg.build_verify_graph(cfg, PARAMS, batch=2, width=4, cache_cap=16)
    return pkg.build_paged_verify_graph(cfg, PARAMS, width=4, **paged)


def lm_inputs(kind, seed=5):
    """Seeded inputs for the dense decode / prefill graphs (no row of
    length 0: there ``ref`` and the kernels differ by design)."""
    rng = np.random.default_rng(seed)
    t = 1 if kind == "decode" else 4
    feed = {"tokens": rng.integers(0, 61, (2, t)).astype(np.int32),
            "start": np.asarray([3, 0], np.int32), "n_new": np.asarray([t, max(t - 1, 1)], np.int32)}
    for i in range(TINY_ARGS["n_layers"]):
        for kv in "kv":
            feed[f"cache_{kv}{i}"] = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    return feed


def outputs(prog, feed):
    return [np.asarray(y) if not isinstance(y, torch.Tensor) else y.numpy()
            for y in prog(**feed)]


def assert_outputs_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


def assert_same_files(a, b, names=("model.json", "program.json")):
    for f in names:
        with open(os.path.join(a, f), "rb") as fa, open(os.path.join(b, f), "rb") as fb:
            assert fa.read() == fb.read(), f"{f} differs"


def assert_same_weights(a, b):
    with np.load(os.path.join(a, "weights.npz")) as za, \
            np.load(os.path.join(b, "weights.npz")) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            assert za[k].dtype == zb[k].dtype, k
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


@pytest.fixture(scope="module")
def ranges():
    """One shared calibration (the JAX package's) for every int8 bundle."""
    return jeng.shared_calibration(jlm.GraphLMConfig(**TINY_ARGS), PARAMS, chunk=4,
                                   cache_cap=16)


# --------------------------------------------------------------------------- #
# the golden bundle
# --------------------------------------------------------------------------- #

def test_golden_bundle_through_the_port(tmp_path):
    """Pinned ``xla`` in the file, ``torch`` in the port; ``expected_y``
    reproduced; the re-save byte-identical and its weights equal."""
    prog = load_program(GOLDEN, device="cpu")
    assert set(prog.assignment.values()) == {"torch"}
    assert set(prog.bundle_assignment().values()) == {"xla"}
    assert is_quantized(prog.graph)
    assert prog.graph.params["w1.q8"].dtype == np.int8
    x = np.load(os.path.join(GOLDEN, "input_x.npy"))
    want = np.load(os.path.join(GOLDEN, "expected_y.npy"))
    np.testing.assert_allclose(prog(x=x)[0].numpy(), want, rtol=1e-5, atol=1e-6)
    out = tmp_path / "resaved"
    prog.save(str(out))
    assert_same_files(GOLDEN, str(out))
    assert_same_weights(GOLDEN, str(out))
    again = tmp_path / "again"
    load_program(str(out), device="cpu").save(str(again))
    assert_same_files(str(out), str(again))


def test_golden_bundle_loads_without_passes():
    """``pipeline=()`` on load: the quantized graph is taken as it is (no
    simplify, no second quantize)."""
    prog = Program.load(GOLDEN, device="cpu")
    assert [n.op for n in prog.graph.nodes] == ["dense_fused_q", "dense_q"]
    assert prog.pass_stats == ()


# --------------------------------------------------------------------------- #
# fp32 bundles, both directions
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_jax_bundle_runs_in_the_port(kind, tmp_path):
    jprog = jcompile(lm_graph(jlm, kind), J_XLA)
    jprog.save(str(tmp_path))
    prog = load_program(str(tmp_path), device="cpu")
    assert prog.bundle_assignment() == jprog.assignment
    assert set(prog.assignment.values()) == {"ref"}      # every xla here is folded
    feed = lm_inputs(kind)
    assert_outputs_close(outputs(prog, feed), outputs(jprog, feed))


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_port_bundle_runs_in_jax(kind, tmp_path):
    """Saved by the port, loaded by JAX: outputs within 1e-5, and
    model.json / program.json byte-identical to JAX's own save of the same
    graph under the same assignment."""
    prog = compile(lm_graph(tlm, kind), T_REF, device="cpu")
    prog.save(str(tmp_path / "port"))
    jcompile(lm_graph(jlm, kind), J_REF).save(str(tmp_path / "jax"))
    assert_same_files(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert_same_weights(str(tmp_path / "port"), str(tmp_path / "jax"))
    jprog = JProgram.load(str(tmp_path / "port"))
    assert jprog.assignment == prog.assignment
    feed = lm_inputs(kind)
    assert_outputs_close(outputs(jprog, feed), outputs(prog, feed))


@pytest.mark.parametrize("kind", GRAPHS)
@pytest.mark.parametrize("policies", [(T_REF, J_REF), (T_CUDA, J_PALLAS)],
                         ids=["ref-ref", "cuda-pallas"])
def test_port_save_is_byte_identical_to_jax(kind, policies, tmp_path):
    """Every serving graph, under ``ref`` on both sides and under the
    kernels (``cuda`` in the port, ``pallas`` in JAX): the same pins and
    the same cost table, byte for byte."""
    tpol, jpol = policies
    prog = compile(lm_graph(tlm, kind), tpol, device="cpu")
    jprog = jcompile(lm_graph(jlm, kind), jpol)
    assert prog.bundle_assignment() == jprog.assignment
    prog.save(str(tmp_path / "port"))
    jprog.save(str(tmp_path / "jax"))
    assert_same_files(str(tmp_path / "port"), str(tmp_path / "jax"))


@pytest.mark.parametrize("kind", GRAPHS)
def test_assignment_survives_jax_port_jax(kind, tmp_path):
    """A JAX bundle under ``xla`` goes through the port (which runs
    ``ref`` where it folded ``xla``) and back: every byte of model.json and
    program.json kept, the cost of each folded ``xla`` node JAX's own, and
    JAX reloads the original assignment."""
    jprog = jcompile(lm_graph(jlm, kind), J_XLA)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    jprog.save(a)
    load_program(a, device="cpu").save(b)
    assert_same_files(a, b)
    assert_same_weights(a, b)
    assert JProgram.load(b).assignment == jprog.assignment


def test_pallas_pins_map_to_cuda(tmp_path):
    """A JAX bundle pinned to ``pallas`` runs the port's ``cuda`` backends
    (on CPU tensors: the kernels' plain versions), never ``ref`` in their
    place, and re-saves its pins unchanged."""
    jprog = jcompile(lm_graph(jlm, "decode"), J_PALLAS)
    jprog.save(str(tmp_path / "a"))
    prog = load_program(str(tmp_path / "a"), device="cpu")
    want = {n: {"pallas": "cuda"}.get(b, b) for n, b in jprog.assignment.items()}
    assert prog.assignment == want
    assert {"dense", "rmsnorm", "decode_attention"} <= {
        n.op for n in prog.graph.nodes if prog.assignment[n.name] == "cuda"}
    feed = lm_inputs("decode")
    ref_prog = compile(lm_graph(tlm, "decode"), T_REF, device="cpu")
    assert_outputs_close(outputs(prog, feed), outputs(ref_prog, feed))
    prog.save(str(tmp_path / "b"))
    assert_same_files(str(tmp_path / "a"), str(tmp_path / "b"))


def test_unpinned_bundle_is_resolved_by_policy(tmp_path):
    """A bundle written by a plain ``save_graph`` carries no pins: the
    policy chooses, as in JAX, and the save pins what it chose."""
    jimp.save_graph(lm_graph(jlm, "decode"), str(tmp_path / "a"))
    prog = load_program(str(tmp_path / "a"), policy=T_REF, device="cpu")
    assert set(prog.assignment.values()) == {"ref"}
    prog = load_program(str(tmp_path / "a"), policy=T_CUDA, device="cpu")
    prog.save(str(tmp_path / "b"))
    with open(tmp_path / "b" / "model.json") as f:
        pins = {nd["op"]: nd["backend"] for nd in json.load(f)["nodes"]}
    assert pins["dense"] == "pallas" and pins["decode_attention"] == "pallas"


def test_save_graph_round_trip_keeps_port_pins(tmp_path):
    """``save_graph`` writes the format's names for a port graph's pins and
    ``load_graph`` reads them back as the port's."""
    g = lm_graph(tlm, "decode")
    for n in g.nodes:
        n.backend = "cuda" if n.op == "dense" else "ref"
    save_graph(g, str(tmp_path))
    with open(tmp_path / "model.json") as f:
        assert {nd["backend"] for nd in json.load(f)["nodes"] if nd["op"] == "dense"} \
            == {"pallas"}
    g2 = load_graph(str(tmp_path))
    assert [(n.name, n.backend) for n in g2.nodes] == [(n.name, n.backend) for n in g.nodes]
    assert all(isinstance(v, np.ndarray) for v in g2.params.values())


def test_tensor_params_are_written_as_numpy(tmp_path):
    """Params held as tensors (the serving engine's) are written as the
    numpy arrays the JAX package writes, in the same dtypes."""
    g = lm_graph(tlm, "decode")
    g.params = tlm.params_from_numpy(g.params, "cpu")
    assert all(isinstance(v, torch.Tensor) for v in g.params.values())
    compile(g, T_REF, device="cpu").save(str(tmp_path / "port"))
    jcompile(lm_graph(jlm, "decode"), J_REF).save(str(tmp_path / "jax"))
    assert_same_weights(str(tmp_path / "port"), str(tmp_path / "jax"))


# --------------------------------------------------------------------------- #
# int8 bundles (shared calibration ranges), both directions
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_int8_jax_bundle_runs_in_the_port(kind, ranges, tmp_path):
    jprog = jcompile(lm_graph(jlm, kind), JFixed(prefer=("ref",)), quantize="int8",
                     calib_ranges=ranges)
    jprog.save(str(tmp_path))
    prog = load_program(str(tmp_path), device="cpu")
    assert is_quantized(prog.graph)
    assert [n.op for n in prog.graph.nodes] == [n.op for n in jprog.graph.nodes]
    with open(tmp_path / "program.json") as f:
        assert json.load(f)["quantized"] is True
    feed = lm_inputs(kind)
    assert_outputs_close(outputs(prog, feed), outputs(jprog, feed))


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_int8_port_bundle_runs_in_jax(kind, ranges, tmp_path):
    """The port's int8 Program (weights as tensors, as the engine holds
    them) saved and loaded by JAX: within 1e-5, and byte-identical to JAX's
    own int8 save; the int8 weights and scales bit for bit."""
    g = lm_graph(tlm, kind)
    g.params = tlm.params_from_numpy(g.params, "cpu")
    prog = compile(g, T_REF, quantize="int8", calib_ranges=ranges, device="cpu")
    prog.save(str(tmp_path / "port"))
    jcompile(lm_graph(jlm, kind), J_REF, quantize="int8",
             calib_ranges=ranges).save(str(tmp_path / "jax"))
    assert_same_files(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert_same_weights(str(tmp_path / "port"), str(tmp_path / "jax"))
    jprog = JProgram.load(str(tmp_path / "port"))
    feed = lm_inputs(kind)
    assert_outputs_close(outputs(jprog, feed), outputs(prog, feed))


def test_int8_xla_bundle_round_trip(ranges, tmp_path):
    """JAX's default int8 assignment (``dense_q`` on ``xla``) through the
    port (``torch``) and back, unchanged."""
    jprog = jcompile(lm_graph(jlm, "decode"), J_XLA, quantize="int8", calib_ranges=ranges)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    jprog.save(a)
    prog = load_program(a, device="cpu")
    assert {prog.assignment[n.name] for n in prog.graph.nodes if n.op == "dense_q"} \
        == {"torch"}
    feed = lm_inputs("decode")
    assert_outputs_close(outputs(prog, feed), outputs(jprog, feed))
    prog.save(b)
    assert_same_files(a, b)


# --------------------------------------------------------------------------- #
# the backend-name map against both live registries
# --------------------------------------------------------------------------- #

def test_every_port_backend_has_a_name_in_the_format():
    assert treg.registered_ops() == jreg.registered_ops()
    for op in treg.registered_ops():
        jax_names = set(jreg.get_op(op).impls)
        for backend in treg.get_op(op).impls:
            name = bundle_backend(backend)
            assert name in jax_names, (op, backend, name)
            assert port_backend(op, name) == backend, (op, backend)


def test_every_format_name_maps_to_a_port_backend():
    for op in jreg.registered_ops():
        port = set(treg.get_op(op).impls)
        for name in jreg.get_op(op).impls:
            backend = port_backend(op, name)
            assert backend in port, (op, name, backend)
            if bundle_backend(backend) != name:
                # folded: JAX's xla run by the port's ref
                assert (name, backend) == ("xla", "ref"), (op, name, backend)
                assert "torch" not in port


def test_folded_xla_costs_are_jax_costs():
    """The cost a bundle records for a folded ``xla`` node is JAX's, node
    for node over every serving graph (the byte tests above see the sum of
    this through program.json)."""
    for kind in GRAPHS:
        jprog = jcompile(lm_graph(jlm, kind), J_XLA)
        g = jprog.graph
        for node in g.nodes:
            name = jprog.assignment[node.name]
            specs = [g.spec_of(v) for v in node.inputs]
            want = jreg.get_impl(node.op, name).cost(specs, node.attrs)
            got = bundle_cost(node.op, name, specs, node.attrs)
            assert (got.flops, got.bytes) == (want.flops, want.bytes), (kind, node.name)


# --------------------------------------------------------------------------- #
# errors
# --------------------------------------------------------------------------- #

def test_unknown_format_version_raises(tmp_path):
    shutil.copytree(GOLDEN, tmp_path / "b")
    path = tmp_path / "b" / "model.json"
    d = json.loads(path.read_text())
    d["format_version"] = 2
    path.write_text(json.dumps(d))
    with pytest.raises(GraphError, match="unsupported OXF version 2"):
        load_graph(str(tmp_path / "b"))
    with pytest.raises(GraphError, match="unsupported OXF version"):
        load_program(str(tmp_path / "b"), device="cpu")


def test_partitioned_bundle_raises(tmp_path):
    """A bundle's partition is restored verbatim (the port's specs' JSON
    form is the bundle's) and written back byte for byte; loading it onto
    another mesh raises JAX's ValueError."""
    shutil.copytree(GOLDEN, tmp_path / "b")
    path = tmp_path / "b" / "program.json"
    meta = json.loads(path.read_text())
    meta["partition"] = {"mesh": {"model": 2},
                         "specs": {"x": [None, "model"], "y": [], "w1.q8": [["data", "model"]]}}
    path.write_text(json.dumps(meta, indent=1, sort_keys=True))
    prog = load_program(str(tmp_path / "b"), device="cpu")
    assert dict(prog.partition["mesh"]) == {"model": 2}
    assert prog.partition["specs"]["x"] == (None, "model")
    assert prog.partition["specs"]["w1.q8"] == (("data", "model"),)
    prog.save(str(tmp_path / "c"))
    assert json.loads((tmp_path / "c" / "program.json").read_text())["partition"] == \
        meta["partition"]
    mesh4 = types.SimpleNamespace(axis_names=("model",), shape={"model": 4})
    with pytest.raises(ValueError, match="mesh axes"):
        load_program(str(tmp_path / "b"), mesh=mesh4, device="cpu")


def test_tp_pin_raises(tmp_path):
    """A ``tp`` pin maps to the port's ``tp``: a bundle JAX compiled for a
    2-way serving mesh (its attention pinned ``tp``, its caches
    head-sharded) loads in the port under a serving mesh of the same axes
    with the same assignment and partition, and re-saves byte for byte
    (the ``tp`` costs carry the all-gather, as JAX's).  Away from a serving
    mesh the pin is never ignored and never swapped for another backend:
    the load raises."""
    from repro.kernels.serving_ops import serving_mesh as jserving_mesh
    from repro.runtime.engine import _TPFirstPolicy as JTPFirst
    from repro_torch.kernels.serving_ops import serving_mesh
    mesh2 = types.SimpleNamespace(axis_names=("model",), shape={"model": 2})
    for kind in ("decode", "paged_prefill_int8"):
        with jserving_mesh(mesh2):
            jprog = jcompile(lm_graph(jlm, kind), JTPFirst(J_REF), mesh=mesh2)
        assert "tp" in jprog.assignment.values()
        a, b = str(tmp_path / kind / "a"), str(tmp_path / kind / "b")
        jprog.save(a)
        with serving_mesh(mesh2):
            prog = load_program(a, mesh=mesh2, device="cpu")
        assert prog.assignment == jprog.assignment
        assert prog.partition["specs"]["cache_k0"] == (None, None, "model", None)
        prog.save(b)
        assert_same_files(a, b)
        with pytest.raises(ValueError, match="pinned backend 'tp' not supported"):
            load_program(a, device="cpu")


def test_pin_the_port_cannot_run_fails_at_compile(tmp_path):
    """No fallback: a pin with no port backend of that name raises."""
    shutil.copytree(GOLDEN, tmp_path / "b")
    path = tmp_path / "b" / "model.json"
    d = json.loads(path.read_text())
    d["nodes"][0]["backend"] = "winograd"      # not a backend of dense_fused_q
    path.write_text(json.dumps(d))
    with pytest.raises(ValueError, match="pinned backend 'winograd'"):
        load_program(str(tmp_path / "b"), device="cpu")
