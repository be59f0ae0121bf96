"""The port's backend policies on the CPU: the fallback behaviour of
tests/test_selector_fallback.py, the autotune cache of
tests/test_pipeline_compile.py (preload, zero re-measurement, candidates
respected and topped up, keyed by fingerprint, corrupt / truncated /
wrong-shaped files, across processes), the no-hidden-kernel rule, and
``CostModelPolicy``'s picks held node for node against the JAX package's
(pallas -> cuda, pallas_split -> cuda_split, xla -> torch) on two CNNs and
the graph LM."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro  # noqa: F401  (registers repro's ops)
import repro_torch  # noqa: F401  (registers the port's ops)
from repro.core.pipeline import default_pipeline as jdefault_pipeline
from repro.core.selector import CostModelPolicy as JCostModel
from repro.core.selector import HardwareProfile as JProfile
from repro.models import cnn as jcnn
from repro.models import graph_lm as jlm
from repro_torch.core import (H100_SXM, AutotunePolicy, CostModelPolicy, FixedPolicy, Graph,
                              Node, TensorSpec, backends_for, compile, default_cache_path,
                              default_pipeline, hardware_fingerprint)
from repro_torch.core import selector as tselector
from repro_torch.core.registry import impl
from repro_torch.kernels import _cuda
from repro_torch.models import cnn as tcnn
from repro_torch.models import graph_lm as tlm

ROOT = Path(__file__).resolve().parents[1]
JNAMES = {"pallas": "cuda", "pallas_split": "cuda_split", "xla": "torch"}


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def chain_graph(rng):
    """dense -> relu -> tanh -> sigmoid (a fusable elementwise chain)."""
    g = Graph(name="chain", inputs={"x": TensorSpec((2, 8))}, outputs=["y"],
              nodes=[Node("d", "dense", ["x", "w"], ["h"]),
                     Node("a1", "relu", ["h"], ["h1"]),
                     Node("a2", "tanh", ["h1"], ["h2"]),
                     Node("a3", "sigmoid", ["h2"], ["y"])],
              params={"w": rng.standard_normal((8, 8)).astype(np.float32)})
    g.validate()
    return g


def _tune(**kw):
    return AutotunePolicy(reps=1, device="cpu", **kw)


def _compile(g, pol):
    return compile(g, policy=pol, device="cpu")


# --------------------------------------------------------------------------- #
# fallback (tests/test_selector_fallback.py)
# --------------------------------------------------------------------------- #

def _attn_node_and_specs():
    # D = 320 > 256: the cuda kernel's shared-memory guard rejects it
    node = Node("attn", "attention", ["q", "k", "v"], ["o"], attrs={"causal": True})
    q = TensorSpec((1, 7, 2, 320), "float32")
    kv = TensorSpec((1, 7, 1, 320), "float32")
    return node, [q, kv, kv]


def _grouped_conv_node_and_specs():
    # groups=2 -> the cuda GEMM conv rejects; ref/torch remain
    node = Node("c", "conv2d", ["x", "w"], ["y"], attrs={"groups": 2})
    return node, [TensorSpec((1, 4, 4, 4), "float32"), TensorSpec((3, 3, 2, 4), "float32")]


def _single_backend_node_and_specs():
    node = Node("sw", "swiglu", ["g", "u"], ["o"])
    return node, [TensorSpec((2, 8), "float32"), TensorSpec((2, 8), "float32")]


@pytest.mark.parametrize("make", [_attn_node_and_specs, _grouped_conv_node_and_specs,
                                  _single_backend_node_and_specs])
def test_costmodel_policy_chooses_supported(make):
    node, specs = make()
    avail = backends_for(node.op, specs, node.attrs)
    assert avail
    assert CostModelPolicy().resolve(node, specs) in avail


def test_cuda_actually_rejected_by_supports():
    for make in (_attn_node_and_specs, _grouped_conv_node_and_specs):
        node, specs = make()
        assert "cuda" in backends_for(node.op)
        assert "cuda" not in backends_for(node.op, specs, node.attrs)


def test_single_backend_op_resolves_to_ref():
    node, specs = _single_backend_node_and_specs()
    assert backends_for(node.op, specs, node.attrs) == ["ref"]
    assert CostModelPolicy().resolve(node, specs) == "ref"
    assert FixedPolicy(prefer=("cuda", "torch")).resolve(node, specs) == "ref"


def test_autotune_policy_degrades_cleanly():
    pol = _tune()
    for make in (_grouped_conv_node_and_specs, _single_backend_node_and_specs):
        node, specs = make()
        assert pol.resolve(node, specs) in backends_for(node.op, specs, node.attrs)
    # grouped conv (ref/torch) was measured; single-backend swiglu was not
    assert pol.n_measured == 1


def test_autotune_skips_single_candidate_measurement():
    node, specs = _single_backend_node_and_specs()
    pol = _tune()
    assert pol.resolve(node, specs) == "ref"
    assert pol.n_measured == 0 and not pol._timings
    conv, conv_specs = _grouped_conv_node_and_specs()
    pol2 = _tune(candidates=("torch",))
    assert pol2.resolve(conv, conv_specs) == "torch"
    assert pol2.n_measured == 0 and not pol2._timings


def test_autotune_multibackend_chunk_attention():
    node = Node("a", "chunk_attention", ["q", "k", "v", "s"], ["o"])
    specs = [TensorSpec((1, 2, 2, 4), "float32"), TensorSpec((1, 8, 1, 4), "float32"),
             TensorSpec((1, 8, 1, 4), "float32"), TensorSpec((1,), "int32")]
    avail = backends_for(node.op, specs, node.attrs)
    assert set(avail) >= {"ref", "cuda"}
    pol = _tune(candidates=("ref", "cuda"))
    assert pol.resolve(node, specs) in avail
    assert pol.n_measured == 1
    times = pol.timings(node, specs)
    assert set(times) == {"ref", "cuda"} and all(0 < t < float("inf") for t in times.values())


def test_pinned_unsupported_backend_raises():
    node, specs = _attn_node_and_specs()
    node.backend = "cuda"
    with pytest.raises(ValueError, match="pinned backend"):
        FixedPolicy().resolve(node, specs)


def test_random_inputs_are_jaxs():
    from repro.core.selector import AutotunePolicy as JAutotune
    specs = [TensorSpec((3, 4), "float32"), TensorSpec((5,), "int32")]
    got = _tune()._random_inputs(specs, torch.device("cpu"))
    want = JAutotune()._random_inputs(specs)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert set(np.unique(got[1].numpy())) <= {0, 1}


def _with_conv_backend(name, fn, run):
    impl("conv2d", name)(fn)
    try:
        run()
    finally:
        from repro_torch.core.registry import get_op
        del get_op("conv2d").impls[name]


def test_backend_that_cannot_run_is_inf_but_a_build_failure_raises():
    node, specs = _grouped_conv_node_and_specs()

    def cannot_run(inputs, attrs):
        raise NotImplementedError("cannot run here")

    def measured():
        pol = _tune()
        assert pol.resolve(node, specs) in ("ref", "torch")
        assert pol.timings(node, specs)["zz_broken"] == float("inf")

    _with_conv_backend("zz_broken", cannot_run, measured)

    def unbuildable(inputs, attrs):
        raise _cuda.KernelBuildError("nvcc failed")

    def raises():
        with pytest.raises(_cuda.KernelBuildError):
            _tune().resolve(node, specs)

    _with_conv_backend("zz_broken", unbuildable, raises)


@pytest.mark.parametrize("exc", [RuntimeError, ValueError, TypeError])
def test_kernel_that_fails_to_launch_propagates_and_is_not_cached(exc, tmp_path):
    """A launch failure (``_cuda.check`` raises RuntimeError) or a wrapper's
    refusal is not recorded as ``inf``: it propagates, and nothing about the
    backend reaches the cache file."""
    node, specs = _grouped_conv_node_and_specs()
    path = str(tmp_path / "at.json")

    def fails(inputs, attrs):
        raise exc("zz_cuda_broken: CUDA error 1 (invalid argument)")

    def raises():
        pol = _tune(cache_path=path)
        with pytest.raises(exc, match="CUDA error 1"):
            pol.resolve(node, specs)
        assert not pol._timings
        assert not os.path.exists(path) or "zz_cuda_broken" not in open(path).read()

    _with_conv_backend("zz_cuda_broken", fails, raises)


# --------------------------------------------------------------------------- #
# the autotune cache (tests/test_pipeline_compile.py)
# --------------------------------------------------------------------------- #

class TestAutotuneCachePersistence:
    def test_second_instance_loads_not_rebuilds(self, rng, tmp_path):
        g = chain_graph(rng)
        cache = str(tmp_path / "tune.json")
        pol1 = _tune(cache_path=cache)
        prog1 = _compile(g, pol1)
        assert pol1.n_measured > 0 and pol1.n_loaded == 0
        assert os.path.exists(cache)
        pol2 = _tune(cache_path=cache)
        assert pol2.n_loaded == len(pol2._timings) > 0
        prog2 = _compile(g, pol2)
        assert pol2.n_measured == 0
        assert prog2.assignment == prog1.assignment

    def test_cached_timings_respect_candidates(self, rng, tmp_path):
        g = chain_graph(rng)
        cache = str(tmp_path / "tune.json")
        _compile(g, _tune(cache_path=cache))
        pol = _tune(cache_path=cache, candidates=("ref",))
        prog = _compile(g, pol)
        assert set(prog.assignment.values()) == {"ref"}
        assert pol.n_measured == 0

    def test_restricted_cache_topped_up_for_wider_candidates(self, rng, tmp_path):
        g = chain_graph(rng)
        cache = str(tmp_path / "tune.json")
        _compile(g, _tune(cache_path=cache, candidates=("ref",)))
        pol = _tune(cache_path=cache)
        _compile(g, pol)
        assert pol.n_measured > 0
        times = next(iter(pol._timings.values()))
        assert len(times) > 1

    def test_cache_keyed_by_hardware_fingerprint(self, rng, tmp_path):
        cache = tmp_path / "tune.json"
        _compile(chain_graph(rng), _tune(cache_path=str(cache)))
        data = json.loads(cache.read_text())
        assert list(data["fingerprints"]) == [hardware_fingerprint("cpu")]
        data["fingerprints"] = {"deadbeefdeadbeef":
                                data["fingerprints"][hardware_fingerprint("cpu")]}
        cache.write_text(json.dumps(data))
        pol2 = _tune(cache_path=str(cache))
        assert pol2.n_loaded == 0 and not pol2._timings

    def test_fingerprint_names_the_device(self):
        assert hardware_fingerprint("cpu") != hardware_fingerprint("cuda")
        assert hardware_fingerprint("cpu") == hardware_fingerprint(torch.device("cpu"))

    def test_corrupt_cache_file_ignored(self, rng, tmp_path):
        cache = tmp_path / "tune.json"
        cache.write_text("not json{{{")
        pol = _tune(cache_path=str(cache))
        assert pol.n_loaded == 0
        _compile(chain_graph(rng), pol)
        assert json.loads(cache.read_text())["version"] == 1

    def test_truncated_cache_degrades_to_in_memory(self, rng, tmp_path):
        g = chain_graph(rng)
        cache = tmp_path / "tune.json"
        _compile(g, _tune(cache_path=str(cache)))
        full = cache.read_text()
        cache.write_text(full[:len(full) // 2])
        pol = _tune(cache_path=str(cache))
        assert pol.n_loaded == 0
        prog = _compile(g, pol)
        assert pol.n_measured > 0 and prog.assignment
        assert json.loads(cache.read_text())["version"] == 1

    @pytest.mark.parametrize("payload", [
        "[1, 2, 3]",
        '{"version": 1, "fingerprints": [1, 2]}',
        '{"version": 1, "fingerprints": {"%s": ["x"]}}',
        '{"version": 99, "fingerprints": {}}',
    ])
    def test_wrong_shaped_cache_degrades(self, rng, tmp_path, payload):
        cache = tmp_path / "tune.json"
        cache.write_text(payload.replace("%s", hardware_fingerprint("cpu")))
        pol = _tune(cache_path=str(cache))
        assert pol.n_loaded == 0 and not pol._timings
        _compile(chain_graph(rng), pol)
        assert pol.n_measured > 0
        assert hardware_fingerprint("cpu") in json.loads(cache.read_text())["fingerprints"]

    def test_default_cache_path_is_the_ports_own(self, monkeypatch):
        monkeypatch.delenv("ORPHEUS_AUTOTUNE_CACHE", raising=False)
        from repro.core.selector import default_cache_path as jdefault_cache_path
        ours = default_cache_path()
        assert ours != jdefault_cache_path()
        assert os.path.dirname(ours) == os.path.dirname(jdefault_cache_path())
        monkeypatch.setenv("ORPHEUS_AUTOTUNE_CACHE", "/some/where.json")
        assert default_cache_path() == "/some/where.json"

    def test_zero_remeasurement_across_processes(self, tmp_path):
        script = (
            "import sys, numpy as np\n"
            "from repro_torch.core import compile, AutotunePolicy, Graph, Node, TensorSpec\n"
            "import repro_torch\n"
            "g = Graph(name='t', inputs={'x': TensorSpec((2, 4))}, outputs=['y'],\n"
            "          nodes=[Node('d', 'dense', ['x', 'w'], ['y'])],\n"
            "          params={'w': np.eye(4, dtype=np.float32)})\n"
            "pol = AutotunePolicy(reps=1, cache_path=sys.argv[1], device='cpu')\n"
            "compile(g, policy=pol, device='cpu')\n"
            "print(f'MEASURED={pol.n_measured} LOADED={pol.n_loaded}')\n")
        cache = str(tmp_path / "tune.json")
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        outs = []
        for _ in range(2):
            res = subprocess.run([sys.executable, "-c", script, cache], capture_output=True,
                                 text=True, env=env, timeout=240)
            assert res.returncode == 0, res.stderr
            outs.append(res.stdout)
        assert "MEASURED=1 LOADED=0" in outs[0]
        assert "MEASURED=0 LOADED=1" in outs[1]


# --------------------------------------------------------------------------- #
# CostModelPolicy against JAX's, node for node
# --------------------------------------------------------------------------- #

def _check_cost_model_picks(tg, jg, full_set_ops):
    """The port's pick for each node equals JAX's argmin (same H100 peaks,
    JAX's efficiency table under its own names) over the backends whose
    counterpart the port supports there; for ``full_set_ops`` the two
    supported sets are the same, so nothing is left out.  Returns the
    port's assignment counts by backend."""
    jpol = JCostModel(JProfile("h100-sxm", peak_flops=67e12, hbm_bw=3.35e12))
    tpol = CostModelPolicy(H100_SXM)
    assert [n.name for n in tg.nodes] == [n.name for n in jg.nodes]
    counts = {}
    for tn, jn in zip(tg.nodes, jg.nodes):
        tspecs = [tg.spec_of(v) for v in tn.inputs]
        jspecs = [jg.spec_of(v) for v in jn.inputs]
        tavail = backends_for(tn.op, tspecs, tn.attrs)
        est = {JNAMES.get(b, b): t for b, t in jpol.estimate(jn, jspecs).items()}
        if tn.op in full_set_ops:
            assert set(est) == set(tavail), (tn.name, est, tavail)
        mine = {b: t for b, t in est.items() if b in tavail}
        want = min(mine, key=mine.get)
        got = tpol.resolve(tn, tspecs)
        assert got == want, (tn.name, tn.op, est, got)
        counts[got] = counts.get(got, 0) + 1
    return counts


@pytest.mark.parametrize("name", ["wrn-40-2", "mobilenet-v1"])
def test_cost_model_picks_equal_jax_on_a_cnn(name):
    tg = default_pipeline().run(tcnn.build_cnn(name))
    jg = jdefault_pipeline().run(jcnn.build_cnn(name))
    counts = _check_cost_model_picks(tg, jg, {"conv2d", "conv2d_fused"})
    assert counts.get("cuda", 0) > 0
    if name == "mobilenet-v1":
        assert counts.get("torch", 0) > 0      # depthwise: cuda does not take groups


@pytest.mark.parametrize("which", ["decode", "prefill"])
def test_cost_model_picks_equal_jax_on_the_graph_lm(which):
    kw = dict(vocab=37, d_model=16, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=32)
    tcfg, jcfg = tlm.GraphLMConfig(**kw), jlm.GraphLMConfig(**kw)
    tp, jp = tlm.init_lm_params(tcfg, 0), jlm.init_lm_params(jcfg, 0)
    if which == "decode":
        tg = tlm.build_decode_graph(tcfg, tp, batch=2, cache_cap=32)
        jg = jlm.build_decode_graph(jcfg, jp, batch=2, cache_cap=32)
    else:
        tg = tlm.build_prefill_graph(tcfg, tp, batch=2, chunk=4, cache_cap=32)
        jg = jlm.build_prefill_graph(jcfg, jp, batch=2, chunk=4, cache_cap=32)
    tg, jg = default_pipeline().run(tg), jdefault_pipeline().run(jg)
    counts = _check_cost_model_picks(tg, jg, {"decode_attention"})
    assert counts.get("cuda", 0) > 0 and "cuda_split" not in counts


def test_cost_model_passes_over_the_split_where_cuda_runs():
    """The split's efficiency is 0.75 against 0.8 and its cost adds the
    partials: wherever cuda is supported, it wins."""
    node = Node("att", "decode_attention", ["q", "k", "v", "l"], ["o"])
    for s in (32, 2048):
        specs = [TensorSpec((4, 4, 256)), TensorSpec((4, s, 1, 256)),
                 TensorSpec((4, s, 1, 256)), TensorSpec((4,), "int32")]
        est = CostModelPolicy().estimate(node, specs)
        assert est["cuda"] < est["cuda_split"] < est["ref"]
        assert CostModelPolicy().resolve(node, specs) == "cuda"


def test_profiles():
    assert H100_SXM.peak_flops == 67e12 and H100_SXM.hbm_bw == 3.35e12
    assert dict(H100_SXM.backend_efficiency) == {"cuda": 0.8, "cuda_split": 0.75,
                                                  "torch": 0.65, "winograd": 0.65, "ref": 0.35}
    assert tselector.HOST_CPU.efficiency("nope") == 0.5
