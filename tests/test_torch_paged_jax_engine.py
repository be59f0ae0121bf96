"""The port's paged engine against repro's paged engine on the CPU, fp32
and int8 pages: the same weights and the same three waves of requests
(cold, prefix hit, copy-on-write divergence) give the same tokens and the
same pool counters, and block-gated admission admits in the same order.
repro runs its Pallas kernels in interpret mode for the four paged
attention ops, dense and rmsnorm, so kernel is compared with kernel."""

import numpy as np
import pytest

import repro  # noqa: F401
import repro_torch  # noqa: F401
from repro.core.selector import FixedPolicy as JFixed
from repro.models.graph_lm import GraphLMConfig as JConfig
from repro.models.graph_lm import init_lm_params
from repro.runtime.engine import EngineRequest as JRequest
from repro.runtime.engine import build_lm_serving as jbuild
from repro_torch.runtime.engine import EngineRequest
from test_torch_paged_engine import TINY_ARGS, paged_serving, scenario

KERNEL_OPS = ("paged_chunk_attention", "paged_decode_attention", "paged_chunk_attention_q",
              "paged_decode_attention_q", "dense", "rmsnorm")
PALLAS = JFixed(prefer=("xla", "ref"), per_op={op: ("pallas", "ref") for op in KERNEL_OPS})
COUNTERS = ("hit_tokens", "lookup_tokens", "cow_count", "evictions", "n_admitted",
            "n_admit_deferred", "live_blocks", "cached_blocks", "indexed_full_pages",
            "indexed_partial_pages")


def _jax_serving(kv_dtype, **kw):
    kw = {"n_slots": 3, "chunk": 4, "cache_cap": 48, "page_size": 8, **kw}
    return jbuild(JConfig(**TINY_ARGS), paged=True, kv_dtype=kv_dtype, policy=PALLAS,
                  params=init_lm_params(JConfig(**TINY_ARGS), 0), **kw)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_paged_engine_matches_the_jax_engine(kv_dtype):
    jengine, _ = _jax_serving(kv_dtype)
    q = "_q" if kv_dtype == "int8" else ""
    assert jengine.stepper.backend_summary()["decode"][f"paged_decode_attention{q}"] == \
        {"pallas": 2}
    engine, _ = paged_serving(kv_dtype)
    jwaves = scenario(jengine, JRequest)
    twaves = scenario(engine, EngineRequest)
    for wave in ("cold", "prefix", "cow_seed", "cow"):
        assert [r.out_tokens for r in twaves[wave][0]] == \
            [r.out_tokens for r in jwaves[wave][0]], wave
        assert {k: twaves[wave][1][k] for k in COUNTERS} == \
            {k: jwaves[wave][1][k] for k in COUNTERS}, wave


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_block_gated_admission_matches_the_jax_engine(kv_dtype):
    rng = np.random.default_rng(15)
    prompts = [rng.integers(0, 61, 8).astype(np.int32) for _ in range(6)]
    ticks = {}
    for name, (engine, _), cls in (
            ("jax", _jax_serving(kv_dtype, n_slots=4, cache_cap=32, n_blocks=5), JRequest),
            ("port", paged_serving(kv_dtype, n_slots=4, cache_cap=32, n_blocks=5),
             EngineRequest)):
        reqs = [cls(uid=i, prompt=p, max_new_tokens=9) for i, p in enumerate(prompts)]
        for r in reqs:
            assert engine.submit(r)
        engine.run(max_ticks=4000)
        ticks[name] = [(r.first_token_tick, r.finish_tick, r.out_tokens) for r in reqs]
    assert ticks["port"] == ticks["jax"]
