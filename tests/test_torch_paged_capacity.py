"""Capacity of the port's paged engine at benchmarks/serve_bench.py's smoke
configuration (1-layer model, 2 dense slots, chunk 8, cache 64, page 8,
requests of 12 prompt + 6 new tokens): peak concurrent requests, dense vs
fp32 paged at equal memory and int8 paged vs fp32 paged at equal bytes,
must reproduce BENCH_serve.json's page-count ratios exactly (2.5 and 3.2).
The same arithmetic as serve_bench's _paged_experiment and
_paged_kv8_experiment."""

import json
from pathlib import Path

import numpy as np
import pytest

import repro_torch  # noqa: F401
from repro_torch.models.graph_lm import GraphLMConfig
from repro_torch.runtime.engine import EngineRequest, build_lm_serving
from repro_torch.runtime.kv_cache import kv_page_bytes, pages_needed

SMOKE = GraphLMConfig(vocab=61, d_model=32, n_layers=1, n_heads=4, n_kv_heads=2, d_ff=64)
N_SLOTS, CHUNK, CAP, PAGE = 2, 8, 64, 8
PLEN, MAX_NEW = 12, 6
BENCH = json.loads((Path(__file__).resolve().parents[1] / "BENCH_serve.json").read_text())


def _peak(engine, n_requests, seed=0):
    rng = np.random.default_rng(seed)
    for i in range(n_requests):
        assert engine.submit(EngineRequest(
            uid=i, prompt=rng.integers(0, SMOKE.vocab, PLEN).astype(np.int32),
            max_new_tokens=MAX_NEW))
    peak = 0
    while engine.has_work() and engine.tick < 10_000:
        engine.step()
        peak = max(peak, engine.sched.busy_slots)
    assert engine.metrics.n_finished == n_requests
    return peak


@pytest.fixture(scope="module")
def capacity():
    max_pages = -(-CAP // PAGE)
    n_blocks = N_SLOTS * max_pages                  # the dense cache's memory
    per_req = pages_needed(PLEN, MAX_NEW, PAGE)
    paged_slots = min(n_blocks // per_req + 1, 16)  # blocks, not slots, bind
    dense, _ = build_lm_serving(SMOKE, n_slots=N_SLOTS, chunk=CHUNK, cache_cap=CAP,
                                device="cpu")
    paged, _ = build_lm_serving(SMOKE, n_slots=paged_slots, chunk=CHUNK, cache_cap=CAP,
                                paged=True, page_size=PAGE, n_blocks=n_blocks, device="cpu")
    fp32_bytes = n_blocks * kv_page_bytes(SMOKE.n_layers, SMOKE.n_kv_heads, SMOKE.d_head,
                                          PAGE)
    kv8_blocks = fp32_bytes // kv_page_bytes(SMOKE.n_layers, SMOKE.n_kv_heads,
                                             SMOKE.d_head, PAGE, "int8")
    kv8_slots = min(kv8_blocks // per_req + 1, 16)
    kv8, _ = build_lm_serving(SMOKE, n_slots=kv8_slots, chunk=CHUNK, cache_cap=CAP,
                              paged=True, page_size=PAGE, n_blocks=kv8_blocks,
                              kv_dtype="int8", device="cpu")
    return {"dense": _peak(dense, 2 * paged_slots), "paged": _peak(paged, 2 * paged_slots),
            "kv8": _peak(kv8, 2 * kv8_slots), "kv8_blocks": kv8_blocks,
            "n_blocks": n_blocks}


def test_paged_capacity_ratio_matches_the_bench(capacity):
    rec = BENCH["paged"]
    assert capacity["n_blocks"] == rec["n_blocks"] == 16
    assert (capacity["dense"], capacity["paged"]) == \
        (rec["capacity"]["dense_concurrent"], rec["capacity"]["paged_concurrent"])
    assert capacity["paged"] / capacity["dense"] == rec["capacity"]["ratio"] == 2.5


def test_kv8_equal_memory_capacity_matches_the_bench(capacity):
    rec = BENCH["paged_kv8"]
    assert capacity["kv8_blocks"] == rec["n_blocks"] == 60
    assert capacity["kv8"] == rec["capacity"]["paged_concurrent"]
    assert capacity["kv8"] / capacity["paged"] == \
        rec["capacity"]["equal_memory_vs_fp32_paged"] == 3.2
