"""The port's analysis half: ``launch/cells.py`` ``build_cell`` lowered on
fake tensors, ``launch/dryrun.py`` records, ``tools/hillclimb.py``,
``Program.lower`` and the deprecated ``Executor`` shim.

The cells run in a subprocess (:data:`SUB`): a fake mesh makes its process
rank 0 of a ``fake`` default process group, which must not leak into the
other tests of a worker.  There:

* JAX's tests/test_sharding_multidev.py::test_dryrun_cell_machinery_small_mesh
  bar on a (data 2, model 4) fake mesh: reduced stablelm-12b,
  qwen2-moe-a2.7b and mamba2-370m train cells (32 tokens, batch 4) lower
  with FLOPs > 0, wire bytes > 0 and a bottleneck among the three terms;
  their decode cells too;
* ``build_cell`` allocates no real tensor: every argument leaf is a
  ``FakeTensor``;
* one dry-run record (``run_cell``, reduced gemma3-1b's decode on the
  production mesh) and one hillclimb pair (reduced mamba2-370m, SSD chunk
  128 against 64), each written to a file.

Here, the dry-run record renders identically through JAX's and the port's
``dryrun_table``, ``roofline_table`` and ``summary_stats``; ``Program.lower``
of a small ``graph_lm`` decode Program with a ``cuda`` assignment launches
nothing on the CPU and adds the cost table's FLOPs and bytes of exactly the
``cuda`` nodes; the ``Executor`` shim warns and matches
``compile(..., pipeline=())``.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SUB = """
import dataclasses, json, sys
import torch
from torch._subclasses.fake_tensor import FakeTensor
from repro_torch.configs import get_reduced
from repro_torch.configs.base import ShapeCfg
from repro_torch.core.tree import tree_leaves
from repro_torch.launch.cells import build_cell
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import make_fake_mesh
from repro_torch.tools import hillclimb
from repro_torch.tools.roofline import analyze, model_flops_for

out_dir = sys.argv[1]
mesh = make_fake_mesh((2, 4), ("data", "model"))
cells = {}
for name in ["stablelm-12b", "qwen2-moe-a2.7b", "mamba2-370m"]:
    cfg = dataclasses.replace(get_reduced(name), shapes=(ShapeCfg("t", "train", 32, 4),
                                                          ShapeCfg("d", "decode", 32, 4)))
    for shape in ("t", "d"):
        cell = build_cell(name, shape, mesh, cfg=cfg)
        leaves = [x for tree in cell.args.values() for x in tree_leaves(tree)]
        fake = all(isinstance(x, FakeTensor) for x in leaves)
        low = cell.lower()
        rep = analyze(cell.name, "test", 8, low.cost(), "",
                      model_flops=model_flops_for(cfg, cell.kind, 32, 4),
                      collectives=low.collectives, bytes_per_device=low.bytes_per_device)
        cells[f"{name}/{shape}"] = {"fake": fake, "n_leaves": len(leaves),
                                    "flops": rep.hlo_flops, "wire": rep.wire_bytes_per_chip,
                                    "bottleneck": rep.bottleneck, "counts": rep.counts,
                                    "bytes": low.bytes_accessed, "arg_bytes": low.arg_bytes}
rec = run_cell("gemma3-1b", "smoke_decode", "single", out_dir=out_dir,
               cfg=get_reduced("gemma3-1b"))
climb = [hillclimb.run_variant("mamba2-370m", "train_4k", label,
                               *hillclimb.VARIANTS["mamba2-370m/train_4k"][label],
                               out_dir=out_dir, reduced=True)
         for label in ("baseline-chunk128", "chunk-64")]
print(json.dumps({"cells": cells, "record": rec, "climb": climb}))
"""


@pytest.fixture(scope="module")
def sub(tmp_path_factory):
    out = tmp_path_factory.mktemp("cells")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(SUB), str(out)],
                         capture_output=True, text=True, timeout=300, env=env)
    assert res.returncode == 0, f"stdout:\n{res.stdout}\nstderr:\n{res.stderr}"
    return json.loads(res.stdout.strip().splitlines()[-1]), out


CELLS = [f"{a}/{s}" for a in ("stablelm-12b", "qwen2-moe-a2.7b", "mamba2-370m")
         for s in ("t", "d")]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_lowers_on_a_fake_mesh(sub, cell):
    c = sub[0]["cells"][cell]
    assert c["flops"] > 0
    assert c["wire"] > 0, "expected collectives in a sharded step"
    assert c["bytes"] > 0 and c["arg_bytes"]["params"] > 0
    assert c["bottleneck"] in ("compute", "memory", "collective")
    assert set(c["counts"]) <= {"all-gather", "all-reduce"} and c["counts"]


@pytest.mark.parametrize("cell", CELLS)
def test_build_cell_allocates_nothing(sub, cell):
    c = sub[0]["cells"][cell]
    assert c["fake"] and c["n_leaves"] > 0


def test_dryrun_record_renders_as_in_jax(sub):
    import repro.tools.report as jrep
    import repro_torch.tools.report as trep
    rec, out = sub[0]["record"], sub[1]
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["memory_analysis"]["temp_size_in_bytes"] is None
    assert rec["extra"]["peak_measured"] is False
    on_disk = json.loads((out / "gemma3-1b__smoke_decode__single.json").read_text())
    assert on_disk["hlo_flops"] == rec["hlo_flops"] > 0
    skipped = {"arch": "x", "shape": "y", "mesh": "single", "chips": 256, "status": "skipped",
               "reason": "documented skip"}
    for recs in ([on_disk], [on_disk, skipped]):
        assert trep.dryrun_table(recs) == jrep.dryrun_table(recs)
        assert trep.roofline_table(recs) == jrep.roofline_table(recs)
        assert trep.summary_stats(recs) == jrep.summary_stats(recs)
    assert "gemma3-1b | smoke_decode | single | ok" in trep.dryrun_table([on_disk])


def test_hillclimb_pair_writes_two_records(sub):
    base, var = sub[0]["climb"]
    out = sub[1] / "mamba2-370m__smoke_train"
    assert sorted(os.listdir(out)) == ["baseline-chunk128.json", "chunk-64.json"]
    for rec, label in ((base, "baseline-chunk128"), (var, "chunk-64")):
        assert json.loads((out / f"{label}.json").read_text()) == rec
        assert rec["variant"] == label and rec["compute_s"] > 0


def _program(policy):
    from repro_torch.core import compile
    from repro_torch.models.graph_lm import GraphLMConfig, build_decode_graph, init_lm_params
    cfg = GraphLMConfig(vocab=61, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64)
    graph = build_decode_graph(cfg, init_lm_params(cfg, 0), batch=2, cache_cap=16)
    return graph, compile(graph, policy=policy, device="cpu")


def test_program_lower_counts_kernel_routes_from_the_cost_table():
    from repro_torch.core import FixedPolicy
    from repro_torch.kernels import flash_attention as fa, flash_decode as fd, gemm, rmsnorm, ssd
    KERNELS = (gemm.gemm, gemm.batched_gemm, rmsnorm.rmsnorm, fd.flash_decode,
               fd.flash_paged_decode, fd.flash_decode_partial, fd.combine_partials,
               fa.flash_attention, fa.flash_chunk_attention, fa.flash_paged_chunk_attention,
               ssd.ssd_scan)
    before = {k.__name__: k.launches for k in KERNELS}
    _, prog = _program(FixedPolicy(("cuda", "ref")))
    low = prog.lower()
    on_route = [c for b, c in prog.cost_table.values() if b == "cuda"]
    assert on_route and any(b == "ref" for b, _ in prog.cost_table.values())
    assert low.extra_cost == pytest.approx((sum(c.flops for c in on_route),
                                            sum(c.bytes for c in on_route)))
    assert {k.__name__: k.launches for k in KERNELS} == before
    _, ref_prog = _program(FixedPolicy(("ref",)))
    ref_low = ref_prog.lower()
    assert ref_low.extra_cost == (0.0, 0.0) and ref_low.flops > 0
    assert low.flops < ref_low.flops        # the kernel nodes' plain paths are not counted
    assert low.cost()["flops"] == pytest.approx(low.flops + low.extra_cost[0])
    assert low.bytes_per_device == ref_low.bytes_per_device > 0


def test_executor_shim_warns_and_matches_compile():
    from repro_torch.core import Executor, FixedPolicy, compile
    from repro_torch.models.graph_lm import GraphLMConfig, init_cache_inputs
    graph, _ = _program(FixedPolicy(("ref",)))
    policy = FixedPolicy(("cuda", "ref"))
    with pytest.warns(DeprecationWarning, match="Executor is deprecated"):
        ex = Executor(graph, policy, device="cpu")
    prog = compile(graph, policy=policy, pipeline=(), device="cpu")
    assert ex.assignment == prog.assignment
    rng = np.random.default_rng(0)
    cfg = GraphLMConfig(vocab=61, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64)
    feed = {k: v for k, v in init_cache_inputs(cfg, 2, 16).items()}
    feed.update({k: (rng.integers(0, 8, s.shape) if "int" in s.dtype
                     else rng.standard_normal(s.shape)).astype(s.dtype)
                 for k, s in graph.inputs.items() if k not in feed})
    for a, b in zip(ex(**feed), prog(**feed)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert ex.lower().cost() == prog.lower().cost()
    assert [n.name for n, _, _ in ex.costs()] == [n.name for n, _, _ in prog.costs()]
