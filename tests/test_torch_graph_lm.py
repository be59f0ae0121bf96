"""The port's graph LM held against repro.models.graph_lm on the CPU: the
compiled prefill/decode graphs node for node, bit-identical weights, the
weight carry-over, and one prefill + one decode Program call of the whole
slice (port ``cuda`` backends = plain versions here, against ``repro``
under a Pallas-preferring policy in interpret mode)."""

import numpy as np
import pytest
import torch

import repro  # noqa: F401
import repro_torch  # noqa: F401
from repro.core.program import compile as jcompile
from repro.core.selector import FixedPolicy as JFixed
from repro.models import graph_lm as jlm
from repro_torch.core.program import compile as tcompile
from repro_torch.models import graph_lm as tlm

CFG_ARGS = dict(vocab=37, d_model=16, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=32)
JCFG, TCFG = jlm.GraphLMConfig(**CFG_ARGS), tlm.GraphLMConfig(**CFG_ARGS)
PALLAS = JFixed(prefer=("xla", "ref"),
                per_op={"chunk_attention": ("pallas", "xla", "ref"),
                        "decode_attention": ("pallas", "ref"),
                        "dense": ("pallas", "xla", "ref"),
                        "rmsnorm": ("pallas", "ref")})
# a whole two-layer forward in fp32, summed in other orders on the two sides
SLICE_TOL = dict(rtol=1e-4, atol=1e-4)


def _graphs(lm, cfg, params, mode):
    if mode == "decode":
        return lm.build_decode_graph(cfg, params, batch=3, cache_cap=12)
    return lm.build_prefill_graph(cfg, params, batch=3, chunk=4, cache_cap=12)


def test_init_lm_params_is_bitwise_equal():
    for seed in (0, 5):
        jp, tp = jlm.init_lm_params(JCFG, seed), tlm.init_lm_params(TCFG, seed)
        assert list(jp) == list(tp)
        for k in jp:
            assert jp[k].dtype == tp[k].dtype and np.array_equal(jp[k], tp[k]), k


@pytest.mark.parametrize("mode", ["decode", "prefill"])
def test_compiled_graphs_are_equal_node_for_node(mode):
    params = jlm.init_lm_params(JCFG, 0)
    jg = jcompile(_graphs(jlm, JCFG, params, mode)).graph
    tg = tcompile(_graphs(tlm, TCFG, params, mode), device="cpu").graph
    assert tg.name == jg.name
    assert [(n.name, n.op, n.inputs, n.outputs, n.attrs) for n in tg.nodes] == \
        [(n.name, n.op, n.inputs, n.outputs, n.attrs) for n in jg.nodes]
    assert tg.outputs == jg.outputs
    assert {k: (v.shape, v.dtype) for k, v in tg.inputs.items()} == \
        {k: (v.shape, v.dtype) for k, v in jg.inputs.items()}
    assert {k: (v.shape, v.dtype) for k, v in tg.value_info.items()} == \
        {k: (v.shape, v.dtype) for k, v in jg.value_info.items()}
    assert sorted(tg.params) == sorted(jg.params)


def test_params_from_numpy_carries_weights_over():
    params = jlm.init_lm_params(JCFG, 1)
    tp = tlm.params_from_numpy(params, "cpu")
    for k, v in params.items():
        assert tp[k].dtype == torch.float32 and np.array_equal(tp[k].numpy(), v)
    again = tlm.params_from_numpy(tp, "cpu")
    assert all(again[k] is tp[k] for k in tp)


def test_init_lm_params_torch_has_the_same_distributions():
    cfg = tlm.GraphLMConfig(vocab=512, d_model=64, n_layers=1, n_heads=4,
                            n_kv_heads=2, d_ff=128)
    ref = tlm.init_lm_params(cfg, 0)
    tp = tlm.init_lm_params_torch(cfg, 0, device="cpu")
    assert list(tp) == list(ref)
    for k, v in ref.items():
        assert tuple(tp[k].shape) == v.shape and tp[k].dtype == torch.float32, k
    assert torch.equal(tp["final_norm"], torch.ones(64))
    assert abs(float(tp["embed"].std()) - 0.5) < 0.02
    assert abs(float(tp["l0.wd"].std()) * np.sqrt(128) - 1.0) < 0.05
    again = tlm.init_lm_params_torch(cfg, 0, device="cpu")
    assert all(torch.equal(again[k], tp[k]) for k in tp)


def test_init_cache_inputs_match():
    jc, tc = jlm.init_cache_inputs(JCFG, 2, 7), tlm.init_cache_inputs(TCFG, 2, 7)
    assert {k: v.shape for k, v in jc.items()} == {k: v.shape for k, v in tc.items()}


@pytest.mark.parametrize("mode", ["decode", "prefill"])
def test_slice_program_call_matches_pallas(mode):
    params = jlm.init_lm_params(JCFG, 2)
    jprog = jcompile(_graphs(jlm, JCFG, params, mode), policy=PALLAS)
    tprog = tcompile(_graphs(tlm, TCFG, params, mode), device="cpu")
    for node in ("l0.q_proj", "l1.attn", "l0.attn_norm", "lm_head"):
        assert tprog.assignment[node] == "cuda"
        assert jprog.assignment[node] == "pallas"
    rng = np.random.default_rng(4)
    t = 1 if mode == "decode" else 4
    inputs = {"tokens": rng.integers(0, 37, (3, t)).astype(np.int32),
              "start": np.array([0, 5, 12 - t], np.int32),
              "n_new": np.array([t, 0, t], np.int32)}   # slot 1 idle
    for name, spec in tprog.graph.inputs.items():
        if name.startswith("cache_"):
            inputs[name] = rng.standard_normal(spec.shape).astype(np.float32)
    jouts = jprog(**inputs)
    touts = tprog(**inputs)
    for j, tt in zip(jouts, touts):
        np.testing.assert_allclose(tt.numpy(), np.asarray(j), **SLICE_TOL)
