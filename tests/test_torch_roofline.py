"""``repro_torch.tools.roofline`` and the dry-run tables of
``repro_torch.tools.report`` against the JAX package's.

* Every case of tests/test_roofline_tools.py gives equal numbers from both
  packages, on the same HLO text, costs and ``Hardware`` values (the port's
  ``Hardware`` built from JAX's ``V5E`` fields; the port's default is its
  ``H100``, whose constants are ``chip_smoke.py``'s bounds');
  ``model_flops_for`` matches on both packages' configs.
* The ring costs of the port's collective records
  (``collective_bytes_from_records``, fed by ``sharding/collectives.py``'s
  ``_count``) equal ``collective_bytes`` on the equivalent HLO lines.
* ``roofline_table``, ``dryrun_table`` and ``summary_stats`` equal JAX's
  character for character on hand-built records: ok, skipped and error, on
  the single and the multi-pod meshes.
"""

import copy
import dataclasses
import types

import pytest
import torch

import repro.tools.report as jrep
import repro.tools.roofline as jroof
import repro_torch.tools.report as trep
import repro_torch.tools.roofline as troof
from repro.configs import get_config as jget_config, list_configs as jlist_configs
from repro_torch.configs import get_config as tget_config, list_configs as tlist_configs

HLO = """
HloModule test
%ar = f32[256,128]{1,0} all-reduce(f32[256,128] %x), replica_groups=[16,16]<=[256]
%ag = bf16[64,512]{1,0} all-gather(bf16[64,32] %y), replica_groups={{0,1,2,3}}, dimensions={1}
%rs = f32[32]{0} reduce-scatter(f32[128] %z), replica_groups=[32,8]<=[256]
%cp = bf16[8,8]{1,0} collective-permute(bf16[8,8] %w), source_target_pairs={{0,1}}
%aa = s32[16]{0} all-to-all(s32[16] %v), replica_groups=[64,4]<=[256]
%ars = f32[2,2] all-reduce-start(f32[2,2] %q), replica_groups=[128,2]<=[256]
"""

# the same collectives as the port records them: (op, group size) -> [calls, result bytes]
RECORDS = {("all-reduce", 16): [1, 256 * 128 * 4], ("all-reduce", 2): [1, 2 * 2 * 4],
           ("all-gather", 4): [1, 64 * 512 * 2], ("reduce-scatter", 8): [1, 32 * 4],
           ("collective-permute", 2): [1, 8 * 8 * 2], ("all-to-all", 4): [1, 16 * 4]}

V5E_AS_PORT = troof.Hardware(**dataclasses.asdict(jroof.V5E))


@pytest.mark.parametrize("hlo,devices", [(HLO, 256), ("HloModule empty", 8), (HLO, 8)],
                         ids=["six-ops", "empty", "eight-devices"])
def test_collective_bytes_equal(hlo, devices):
    assert troof.collective_bytes(hlo, devices) == jroof.collective_bytes(hlo, devices)


def test_ring_costs_as_jax_test_states():
    _, per_type, counts = troof.collective_bytes(HLO, 256)
    assert counts == {"all-reduce": 2, "all-gather": 1, "reduce-scatter": 1,
                      "collective-permute": 1, "all-to-all": 1}
    assert per_type["all-reduce"] == pytest.approx(2 * 15 / 16 * 256 * 128 * 4 + 2 * 1 / 2 * 16)
    assert per_type["reduce-scatter"] == pytest.approx(7 / 8 * 32 * 4 * 8)


def test_records_price_as_the_hlo_lines():
    wire, per_type, counts = troof.collective_bytes_from_records(RECORDS)
    want = jroof.collective_bytes(HLO, 256)
    assert counts == want[2]
    assert per_type == pytest.approx(want[1])
    assert wire == pytest.approx(want[0])
    assert troof.collective_bytes_from_records({}) == (0, {}, {})


def test_count_feeds_the_records():
    """``_count`` adds one call and the result bytes under (op, group size),
    beside the ``traffic`` totals, and the records price as the HLO lines."""
    from repro_torch.sharding.collectives import _count
    mesh = types.SimpleNamespace(traffic={"gathered": 0, "reduced": 0}, collectives={})
    _count(mesh, "reduced", torch.zeros((256, 128)), 16)
    _count(mesh, "reduced", torch.zeros((2, 2)), 2)
    _count(mesh, "gathered", torch.zeros((64, 512), dtype=torch.bfloat16), 4)
    _count(mesh, "gathered", torch.zeros((64, 512), dtype=torch.bfloat16), 4)
    assert mesh.traffic == {"gathered": 2 * 64 * 512 * 2, "reduced": 256 * 128 * 4 + 16}
    assert mesh.collectives == {("all-reduce", 16): [1, 256 * 128 * 4],
                                ("all-reduce", 2): [1, 16], ("all-gather", 4): [2, 131072]}
    hlo = "\n".join([
        "%ar = f32[256,128]{1,0} all-reduce(f32[256,128] %x), replica_groups=[16,16]<=[256]",
        "%ars = f32[2,2] all-reduce-start(f32[2,2] %q), replica_groups=[128,2]<=[256]",
        "%ag = bf16[64,512]{1,0} all-gather(bf16[64,128] %y), replica_groups={{0,1,2,3}}",
        "%ag2 = bf16[64,512]{1,0} all-gather(bf16[64,128] %z), replica_groups={{0,1,2,3}}"])
    wire, per_type, counts = troof.collective_bytes_from_records(mesh.collectives)
    want = jroof.collective_bytes(hlo, 256)
    assert counts == want[2] == {"all-reduce": 2, "all-gather": 2}
    assert (wire, per_type) == pytest.approx(want[:2])


@pytest.mark.parametrize("case", ["bottleneck", "extra_cost", "no_extra", "records"])
def test_analyze_equal(case):
    cost = {"flops": 1e12, "bytes accessed": 1e9}
    kw = {"bottleneck": dict(cost=cost, hlo_text=HLO, model_flops=256e12),
          "extra_cost": dict(cost={"flops": 1e12}, hlo_text="", model_flops=1e12,
                             extra_cost=(1e12, 1e9)),
          "no_extra": dict(cost={"flops": 1e12}, hlo_text="", model_flops=1e12),
          "records": dict(cost=cost, hlo_text=HLO, model_flops=256e12)}[case]
    want = jroof.analyze("c", "single", 256, **kw)
    port_kw = dict(kw, collectives=RECORDS, hlo_text="") if case == "records" else kw
    got = troof.analyze("c", "single", 256, hw=V5E_AS_PORT, **port_kw)
    want_d = dataclasses.asdict(want)
    for key, value in dataclasses.asdict(got).items():
        if isinstance(value, (float, dict)) and key != "extra":
            assert value == pytest.approx(want_d[key]), key
        else:
            assert value == want_d[key], key
    if case == "bottleneck":
        assert got.bottleneck == "compute" and got.useful_ratio == pytest.approx(1.0)
        assert got.compute_s == pytest.approx(1e12 / jroof.V5E.peak_flops)


def test_h100_is_the_default_and_chip_smokes_constants():
    import chip_smoke
    assert troof.H100.peak_flops == chip_smoke.PEAK_FP32_FLOPS
    assert troof.H100.hbm_bw == chip_smoke.PEAK_HBM_BYTES
    assert troof.H100.link_bw == 900e9 / 18
    rep = troof.analyze("c", "single", 1, {"flops": 67e12, "bytes accessed": 3.35e12}, "", 1.0)
    assert rep.compute_s == pytest.approx(1.0) and rep.memory_s == pytest.approx(1.0)
    assert not hasattr(troof, "V5E")


@pytest.mark.parametrize("kind,seq,batch", [("train", 4096, 256), ("prefill", 32768, 32),
                                            ("decode", 32768, 128)])
def test_model_flops_equal(kind, seq, batch):
    assert tlist_configs() == jlist_configs()
    for name in jlist_configs():
        assert troof.model_flops_for(tget_config(name), kind, seq, batch) == \
            jroof.model_flops_for(jget_config(name), kind, seq, batch)


def _ok(arch, shape, mesh, bottleneck, **kw):
    rec = {"arch": arch, "shape": shape, "mesh": mesh, "chips": 512 if mesh == "multipod" else 256,
           "status": "ok", "compute_s": 1.234e-3, "memory_s": 5.6e-2, "collective_s": 7e-6,
           "bottleneck": bottleneck, "useful_ratio": 0.4567, "bytes_per_device": 12.3e9,
           "hlo_flops": 3.21e13, "wire_bytes_per_chip": 4.5e8,
           "counts": {"all-reduce": 12, "all-gather": 3}, "compile_s": 12.5}
    rec.update(kw)
    return rec


RECS = [
    _ok("gemma3-1b", "train_4k", "single", "compute"),
    _ok("gemma3-1b", "decode_32k", "single", "memory", counts={}, compute_s=0.0),
    _ok("gemma3-1b", "decode_32k", "multipod", "collective", compute_s=2.0, memory_s=0.3),
    _ok("stablelm-12b", "prefill_32k", "multipod", "memory"),
    {"arch": "stablelm-12b", "shape": "long_500k", "mesh": "single", "chips": 256,
     "status": "skipped", "reason": "documented skip (full attention arch; DESIGN.md §4)"},
    {"arch": "mamba2-370m", "shape": "train_4k", "mesh": "multipod", "chips": 512,
     "status": "error", "error": "RuntimeError: a long message that the table cuts at forty "
                                 "characters"},
    {"arch": "mamba2-370m", "shape": "decode_32k", "mesh": "single", "chips": 256,
     "status": "error", "error": "ValueError: x"},
]


@pytest.mark.parametrize("recs", [RECS, RECS[:1], [], RECS[4:]], ids=["all", "one", "none",
                                                                      "skip-and-errors"])
@pytest.mark.parametrize("table", ["roofline_single", "roofline_multipod", "dryrun",
                                   "summary"])
def test_tables_equal_jax(table, recs):
    def call(mod):
        if table.startswith("roofline"):
            return mod.roofline_table(copy.deepcopy(recs), table.split("_")[1])
        return {"dryrun": mod.dryrun_table, "summary": mod.summary_stats}[table](
            copy.deepcopy(recs))
    got = call(trep)
    assert got == call(jrep)
    assert got.count("\n") >= (0 if table == "summary" else 1)
