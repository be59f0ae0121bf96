"""The port's report tables and introspection calls against the JAX
package's on the CPU: every serving table of ``repro_torch.tools.report``
character for character equal to ``repro.tools.report``'s on
``BENCH_serve.json`` (read, never written), on the record with its
optional sections removed and on one with the edge cases the tables render
specially (a disabled section's reason, an enabled one, null percentiles
and attainment); ``footprint_table`` and ``activation_bytes`` on the same
tiny graphs, fp32 and int8; ``registered_ops``, ``registered_passes``,
``Cost.arithmetic_intensity`` and ``PassManager.summary``."""

import copy
import json
import os
import sys

import numpy as np
import pytest

import repro  # noqa: F401  (registers every op and backend of the JAX package)
import repro_torch  # noqa: F401
from repro.core import pipeline as jpipe
from repro.core import registry as jreg
from repro.core.program import compile as jcompile
from repro.core.selector import FixedPolicy as JFixed
from repro.models import graph_lm as jlm
from repro.runtime import engine as jeng
from repro.tools import report as jrep
from repro_torch.core import FixedPolicy, compile
from repro_torch.core import pipeline as tpipe
from repro_torch.core import registry as treg
from repro_torch.models import graph_lm as tlm
from repro_torch.tools import report as trep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_ARGS = dict(vocab=61, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64)
TABLES = ["serving_table", "spec_table", "sharded_table", "backend_table", "paged_table",
          "load_table", "overload_table"]
OPTIONAL = ("prefill_gap", "speedup", "spec", "sharded", "backend_sweep", "autotune",
            "paged", "paged_kv8", "load", "overload")


def _bench():
    with open(os.path.join(ROOT, "BENCH_serve.json")) as f:
        return json.load(f)


def _stripped():
    rec = _bench()
    for key in OPTIONAL:
        rec.pop(key, None)
    return rec


def _edges():
    """Null percentiles and attainment, an enabled sharded section."""
    rec = _bench()
    rec["engine"]["latency_s"]["p50"] = None
    rec["engine"]["ttft_s"]["p50"] = 0.0
    tier = sorted(rec["load"]["tiers"])[0]
    rec["load"]["tiers"][tier]["slo_attainment"] = None
    rec["load"]["tiers"][tier]["ttft_ticks"]["p99"] = None
    rec["sharded"] = {"enabled": True, "tp": 2, "token_exact": True,
                      "tp1": {"decode_tok_s": 1234.5, "peak_concurrent": 4},
                      "tp2": {"decode_tok_s": 2345.25, "peak_concurrent": 8}}
    rec["paged_kv8"]["token_exact"] = {"all": False}
    return rec


RECORDS = {"bench": _bench, "stripped": _stripped, "edges": _edges}


@pytest.mark.parametrize("records", list(RECORDS))
@pytest.mark.parametrize("table", TABLES)
def test_record_table_equals_jax(table, records):
    recs = [(records, RECORDS[records]()), ("second", _bench())]
    got = getattr(trep, table)(copy.deepcopy(recs))
    assert got == getattr(jrep, table)(recs)
    assert got.count("\n") >= 1


def test_load_records_and_main_serving_sections(tmp_path, capsys, monkeypatch):
    """``main`` prints the serving sections and then the dry-run sections
    (summary, roofline, raw) as JAX's does, character for character."""
    for name, make in RECORDS.items():
        (tmp_path / f"{name}.json").write_text(json.dumps(make()))
    assert trep.load_records(str(tmp_path)) == jrep.load_records(str(tmp_path))
    argv = ["report", "--serve-dir", str(tmp_path), "--dir", str(tmp_path / "none")]
    monkeypatch.setattr(sys, "argv", argv)
    trep.main()
    got = capsys.readouterr().out
    jrep.main()
    want = capsys.readouterr().out
    head = want[:want.index("## Summary")]
    assert "## Tier-aware overload" in head and "## Tensor-parallel serving" in head
    assert "## Dry-run raw" in want
    assert got == want


@pytest.fixture(scope="module")
def ranges():
    return jeng.shared_calibration(jlm.GraphLMConfig(**TINY_ARGS),
                                   jlm.init_lm_params(jlm.GraphLMConfig(**TINY_ARGS), 0),
                                   chunk=4, cache_cap=16)


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["fp32", "int8"])
def test_footprint_equals_jax(quantize, ranges):
    params = jlm.init_lm_params(jlm.GraphLMConfig(**TINY_ARGS), 0)
    kw = dict(quantize=quantize, calib_ranges=ranges if quantize else None)
    entries = {}
    for pkg, comp, pol, extra in ((tlm, compile, FixedPolicy(prefer=("ref",)),
                                   {"device": "cpu"}),
                                  (jlm, jcompile, JFixed(prefer=("ref",)), {})):
        cfg = pkg.GraphLMConfig(**TINY_ARGS)
        graphs = [("decode", pkg.build_decode_graph(cfg, params, batch=2, cache_cap=16)),
                  ("prefill", pkg.build_prefill_graph(cfg, params, batch=2, chunk=4,
                                                      cache_cap=16))]
        entries[pkg] = [(label, comp(g, pol, **kw, **extra)) for label, g in graphs]
    tt, jj = entries[tlm], entries[jlm]
    assert trep.footprint_table(tt) == jrep.footprint_table(jj)
    for (_, pt), (_, pj) in zip(tt, jj):
        assert trep.activation_bytes(pt) == jrep.activation_bytes(pj) > 0
        assert trep.weight_bytes(pt) == jrep.weight_bytes(pj)
    # a graph (no cost table) renders too
    assert trep.footprint_table([("g", tt[0][1].graph)]) == \
        jrep.footprint_table([("g", jj[0][1].graph)])


def test_registered_ops_and_passes():
    """The packages' own passes (a test may register a ``_test_*`` pass
    into either process-wide registry first; those are left out)."""
    assert treg.registered_ops() == jreg.registered_ops()
    assert len(treg.registered_ops()) == 47

    def own(names):
        return [p for p in names if not p.startswith("_")]

    assert own(tpipe.registered_passes()) == own(jpipe.registered_passes())
    assert "quantize" in tpipe.registered_passes()


@pytest.mark.parametrize("flops,nbytes", [(0.0, 0.0), (98.0, 112.0), (3.5e9, 0.5),
                                          (1e12, 7.3e9)])
def test_arithmetic_intensity_equals_jax(flops, nbytes):
    assert treg.Cost(flops, nbytes).arithmetic_intensity() == \
        jreg.Cost(flops, nbytes).arithmetic_intensity()


def test_pass_manager_summary_equals_jax():
    """The same stats render the same table; ``total_seconds`` sums them."""
    stats = [("infer_shapes", 9, 9, 0.00125, 0, False),
             ("fold_constants", 9, 7, 0.0304, 1, True)]
    tm, jm = tpipe.PassManager([]), jpipe.PassManager([])
    tm.stats = [tpipe.PassStats(*s) for s in stats]
    jm.stats = [jpipe.PassStats(*s) for s in stats]
    assert tm.summary() == jm.summary()
    assert tm.total_seconds() == jm.total_seconds() == 0.00125 + 0.0304
    pm = tpipe.default_pipeline()
    pm.run(tlm.build_decode_graph(tlm.GraphLMConfig(**TINY_ARGS),
                                  tlm.init_lm_params(tlm.GraphLMConfig(**TINY_ARGS), 0),
                                  batch=2, cache_cap=16))
    assert pm.total_seconds() == sum(s.seconds for s in pm.stats) > 0
    lines = pm.summary().splitlines()
    assert len(lines) == len(pm.stats) + 2 and lines[-1].startswith("total")
    assert np.all([ln.split()[0] == s.name for ln, s in zip(lines[1:], pm.stats)])
