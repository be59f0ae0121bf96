"""Roofline analysis of lowered steps — counterpart of
:mod:`repro.tools.roofline`, with the port's hardware and its collective
records.

Three terms per (arch x shape x mesh), all in seconds:

    compute    = FLOPs            / peak_FLOP/s
    memory     = bytes_accessed   / HBM_bw
    collective = wire_bytes       / link_bw

all per device.  JAX's lowering reads FLOPs and bytes from
``compiled.cost_analysis()`` and wire bytes from the post-SPMD HLO text:
for every all-reduce / all-gather / reduce-scatter / all-to-all /
collective-permute the RESULT buffer size, converted to per-chip wire
traffic with the standard ring costs over the collective's participant
count:

    all-reduce      2 (n-1)/n x size     all-gather      (n-1)/n x size
    reduce-scatter  (n-1)/n x size(in)   all-to-all      (n-1)/n x size
    collective-permute   1 x size

:func:`collective_bytes` parses that HLO text, as JAX's does.  The port has
no HLO: its lowering (:mod:`repro_torch.core.lowering`) counts FLOPs with
``FlopCounterMode`` and bytes with a dispatch mode, and its collectives
record (op, group size) -> [calls, result bytes] on the mesh
(``ProcessMesh.collectives``); :func:`collective_bytes_from_records`
prices those records with the same ring costs.

Kernel caveat: a step whose ops run hand-written kernels launches nothing
under fake tensors, so the lowering adds their FLOPs and bytes from the
registry's cost models (``extra_cost``), as JAX's adds its Pallas kernels'.

Hardware constants (:data:`H100`, the default; NVIDIA's H100 SXM
datasheet, not measured): 67 TFLOP/s fp32 outside the tensor cores (the
port runs fp32 with TF32 off), 3.35 TB/s HBM3, and ``link_bw`` 50 GB/s a
NVLink link: NVIDIA's 900 GB/s over 18 links, both directions counted
(25 GB/s each way).  A GPU behind NVSwitch drives all 18 links at once, so
the collective term read against one link is an upper bound.
"""

from __future__ import annotations

import json
import re
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["Hardware", "H100", "RooflineReport", "analyze", "collective_bytes",
           "collective_bytes_from_records", "model_flops_for"]


@dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float      # per device, FLOP/s
    hbm_bw: float          # per device, B/s
    link_bw: float         # per link, B/s


H100 = Hardware("h100-sxm", peak_flops=67e12, hbm_bw=3.35e12, link_bw=900e9 / 18)

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "f8e4m3fn": 1, "f8e5m2": 1,
}

# e.g.  %all-reduce.5 = f32[256,14336]{1,0} all-reduce(...)
#       ROOT %r = (bf16[8,128], bf16[8,128]) all-to-all(...)
_COLL_RE = re.compile(
    r"=\s*(?P<sig>\([^)]*\)|\S+?)\s+"
    r"(?P<op>all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(")
_SHAPE_RE = re.compile(r"(?P<dt>[a-z0-9]+)\[(?P<dims>[\d,]*)\]")
_GROUPS_RE = re.compile(r"replica_groups=\{(.*?)\}")
_GROUPS_ARR_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def _sig_bytes(sig: str) -> float:
    total = 0.0
    for m in _SHAPE_RE.finditer(sig):
        bytes_per = _DTYPE_BYTES.get(m.group("dt"))
        if bytes_per is None:
            continue
        dims = m.group("dims")
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * bytes_per
    return total


def _participants(line: str, total_devices: int) -> int:
    m = _GROUPS_ARR_RE.search(line)       # replica_groups=[16,16] form
    if m:
        return int(m.group(2))
    m = _GROUPS_RE.search(line)
    if m:
        first = m.group(1).split("}")[0].strip("{} ")
        if first:
            return max(1, len(first.split(",")))
    return total_devices


def collective_bytes(hlo_text: str, total_devices: int
                     ) -> Tuple[float, Dict[str, float], Dict[str, int]]:
    """Per-chip wire bytes (ring model), per-op-type breakdown, op counts.

    Result-buffer sizes in the post-SPMD module are PER-SHARD, so the sum
    over ops of ring-model wire traffic is already per-chip."""
    per_type: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    for line in hlo_text.splitlines():
        m = _COLL_RE.search(line)
        if not m:
            continue
        op = m.group("op")
        size = _sig_bytes(m.group("sig"))
        n = max(_participants(line, total_devices), 1)
        per_type[op] = per_type.get(op, 0.0) + _wire(op, size, n)
        counts[op] = counts.get(op, 0) + 1
    return sum(per_type.values()), per_type, counts


def _wire(op: str, size: float, n: int) -> float:
    """Ring-model wire bytes of one ``op`` whose result is ``size`` bytes,
    over ``n`` participants."""
    if op == "all-reduce":
        return 2.0 * (n - 1) / n * size
    if op in ("all-gather", "all-to-all"):
        return (n - 1) / n * size
    if op == "reduce-scatter":
        return (n - 1) / n * size * n     # input = result x n
    return size                         # collective-permute


def collective_bytes_from_records(records: Dict[Tuple[str, int], Any]
                                  ) -> Tuple[float, Dict[str, float], Dict[str, int]]:
    """:func:`collective_bytes`' triple from a mesh's collective records
    (``ProcessMesh.collectives``: (op, group size) -> [calls, result
    bytes], the rank's own, so per-chip): the same ring cost a call, which
    is linear in the result bytes, so a record's summed bytes price all its
    calls at once."""
    per_type: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    for (op, n), (calls, size) in sorted(records.items()):
        per_type[op] = per_type.get(op, 0.0) + _wire(op, float(size), max(int(n), 1))
        counts[op] = counts.get(op, 0) + int(calls)
    return sum(per_type.values()), per_type, counts


@dataclass
class RooflineReport:
    cell: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    wire_bytes_per_chip: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float
    useful_ratio: float            # MODEL_FLOPS / HLO_FLOPs
    roofline_s: float              # max of the three terms
    per_type: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)
    bytes_per_device: float = 0.0
    extra: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=1, sort_keys=True)


def analyze(cell: str, mesh_name: str, chips: int, cost: Dict[str, float],
            hlo_text: str, model_flops: float, hw: Hardware = H100,
            bytes_per_device: float = 0.0,
            extra_cost: Optional[Tuple[float, float]] = None,
            extra: Optional[Dict[str, Any]] = None,
            collectives: Optional[Dict[Tuple[str, int], Any]] = None) -> RooflineReport:
    """``cost`` holds one device's ``"flops"`` and ``"bytes accessed"``, so
    the three terms are per-chip seconds, directly comparable.  The wire
    bytes come from ``collectives`` (a mesh's records) when it is given,
    else from ``hlo_text``."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    if extra_cost:
        flops += extra_cost[0]
        byts += extra_cost[1]
    if collectives is not None:
        wire, per_type, counts = collective_bytes_from_records(collectives)
    else:
        wire, per_type, counts = collective_bytes(hlo_text, chips)
    compute_s = flops / hw.peak_flops
    memory_s = byts / hw.hbm_bw
    collective_s = wire / hw.link_bw
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    model_flops_per_chip = model_flops / chips
    return RooflineReport(
        cell=cell, mesh=mesh_name, chips=chips,
        hlo_flops=flops, hlo_bytes=byts, wire_bytes_per_chip=wire,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bottleneck=bottleneck, model_flops=model_flops,
        useful_ratio=(model_flops_per_chip / flops if flops else 0.0),
        roofline_s=max(terms.values()), per_type=per_type, counts=counts,
        bytes_per_device=bytes_per_device, extra=extra or {})


def model_flops_for(cfg, kind: str, seq_len: int, global_batch: int) -> float:
    """MODEL_FLOPS: 6·N·D train, 2·N·D prefill, 2·N·B decode (per step);
    MoE uses active params."""
    counts = cfg.param_count()
    n_active = counts["active"]
    if kind == "train":
        return 6.0 * n_active * seq_len * global_batch
    if kind == "prefill":
        return 2.0 * n_active * seq_len * global_batch
    return 2.0 * n_active * global_batch
