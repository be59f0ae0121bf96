"""Report tables — counterpart of :mod:`repro.tools.report`: the Program
memory-footprint table and the serving tables of
``benchmarks/serve_bench.py`` JSON records.

    PYTHONPATH=src python -m repro_torch.tools.report [--serve-dir experiments/serve]

Prints markdown to stdout.  The tables are pure functions of Programs and
record dicts, so a record from either package renders the same, character
for character.  The footprint helpers (:func:`weight_bytes`,
:func:`activation_bytes`, :func:`footprint_table`) are how quantization
wins show up: an int8 Program stores 1-byte weight params, so its
weight-bytes column is ~4x smaller than the fp32 build of the same graph.
The roofline and dry-run tables (:func:`roofline_table`,
:func:`dryrun_table`, :func:`summary_stats`) read dry-run records in JAX's
schema, written by either package's ``launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.tools.report --dir experiments/dryrun_torch
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

__all__ = ["load_records", "weight_bytes", "activation_bytes", "footprint_table",
           "serving_table", "backend_table", "paged_table", "load_table",
           "spec_table", "sharded_table", "overload_table", "roofline_table", "dryrun_table",
           "summary_stats"]


def weight_bytes(obj) -> int:
    """Total bytes of stored parameters for a Graph or Program: the
    on-device weight footprint, which int8 quantization shrinks ~4x.
    Parameters may be numpy arrays or tensors (on any device)."""
    graph = getattr(obj, "graph", obj)
    return int(sum(v.element_size() * v.numel() if isinstance(v, torch.Tensor)
                   else np.asarray(v).nbytes for v in graph.params.values()))


def load_records(dirpath: str) -> List[Dict]:
    recs = []
    for f in sorted(glob.glob(os.path.join(dirpath, "*.json"))):
        with open(f) as fh:
            recs.append(json.load(fh))
    return recs


def _fmt_s(x) -> str:
    # None = "no samples" (empty metric windows serialize as null +
    # n_samples=0, never as a perfect-looking 0.0) -> render an em dash
    if x is None:
        return "—"
    if x == 0:
        return "-"
    if x >= 0.1:
        return f"{x:.2f}s"
    if x >= 1e-4:
        return f"{x*1e3:.2f}ms"
    return f"{x*1e6:.0f}us"


def _fmt_count(x, spec: str = ".0f") -> str:
    """Format a percentile value that is ``None`` when the window had no
    samples."""
    return "—" if x is None else f"{x:{spec}}"


# --------------------------------------------------------------------------- #
# Memory footprint — the quantization-visible column
# --------------------------------------------------------------------------- #

def activation_bytes(obj) -> int:
    """Peak-ish activation footprint: sum of all intermediate value sizes
    from ``value_info`` (an upper bound — liveness not modelled)."""
    graph = getattr(obj, "graph", obj)
    inter = set(graph.value_info) - set(graph.inputs) - set(graph.params)
    return int(sum(graph.value_info[v].nbytes for v in inter))


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB"):
        if abs(n) < 1024 or unit == "GB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}GB"


def footprint_table(entries: Sequence[Tuple[str, object]]) -> str:
    """Markdown memory-footprint table for ``(label, Program)`` pairs:
    node count, weight bytes, activation bytes, and analytic cost totals.
    The weight-bytes column is where an int8 Program shows its ~4x win
    over the fp32 compile of the same graph."""
    out = ["| program | nodes | weight bytes | activation bytes | "
           "GFLOPs | GB moved |",
           "|---|---|---|---|---|---|"]
    for label, prog in entries:
        graph = getattr(prog, "graph", prog)
        total = prog.total_cost() if hasattr(prog, "total_cost") else None
        gflops = f"{total.flops/1e9:.2f}" if total else "-"
        gb = f"{total.bytes/1e9:.3f}" if total else "-"
        out.append(f"| {label} | {len(graph.nodes)} | "
                   f"{_fmt_bytes(weight_bytes(graph))} | "
                   f"{_fmt_bytes(activation_bytes(graph))} | {gflops} | {gb} |")
    return "\n".join(out)


# --------------------------------------------------------------------------- #
# Serving metrics — benchmarks/serve_bench.py JSON records
# --------------------------------------------------------------------------- #

def serving_table(records: Sequence[Tuple[str, Dict]]) -> str:
    """Markdown serving-metrics table from ``(label, record)`` pairs, where
    each record is one ``benchmarks/serve_bench.py`` JSON output: engine
    tokens/s vs the unbatched loop, p50/p95 latency, time-to-first-token,
    busy-slot fraction, and the chunked-prefill inter-token gap against
    one full-prompt prefill."""
    out = ["| config | tok/s | vs unbatched | p50 | p95 | ttft p50 | "
           "busy | max gap (chunked) | full prefill |",
           "|---|---|---|---|---|---|---|---|---|"]
    for label, rec in records:
        eng = rec["engine"]
        gap = rec.get("prefill_gap", {})
        out.append(
            f"| {label} | {eng['tokens_per_s']:,.0f} | "
            f"{rec.get('speedup', 0):.2f}x | "
            f"{_fmt_s(eng['latency_s']['p50'])} | "
            f"{_fmt_s(eng['latency_s']['p95'])} | "
            f"{_fmt_s(eng['ttft_s']['p50'])} | "
            f"{eng['busy_slot_fraction']:.0%} | "
            f"{_fmt_s(gap.get('max_gap_chunked_s', 0))} | "
            f"{_fmt_s(gap.get('full_prefill_s', 0))} |")
    return "\n".join(out)


def spec_table(records: Sequence[Tuple[str, Dict]]) -> str:
    """Markdown speculative-decoding table from serve_bench JSON records
    (the ``"spec"`` section): draft depth and width, accept rate, decode
    tokens/s speculative vs baseline with the measured speedup, and the
    token-exactness flag against the unbatched reference."""
    out = ["| config | draft layers | K | accept rate | decode tok/s "
           "(spec) | decode tok/s (base) | speedup | exact |",
           "|---|---|---|---|---|---|---|---|"]
    for label, rec in records:
        sp = rec.get("spec")
        if not sp:
            continue
        out.append(
            f"| {label} | {sp['draft_layers']}/{sp['n_layers']} | "
            f"{sp['spec_k']} | {sp['accept_rate']:.0%} | "
            f"{sp['decode_tok_s_spec']:,.0f} | "
            f"{sp['decode_tok_s_base']:,.0f} | "
            f"{sp['decode_speedup']:.2f}x | "
            f"{'yes' if sp.get('token_exact') else 'NO'} |")
    return "\n".join(out)


def sharded_table(records: Sequence[Tuple[str, Dict]]) -> str:
    """Markdown tensor-parallel serving table from serve_bench JSON
    records (the ``"sharded"`` section, schema v5): decode tokens/s and
    peak concurrent requests at TP=1 vs TP=N, plus the token-identity
    flag (the tp backends promise bitwise-exact serving — ``NO`` here is
    a bug, not a tolerance).  Disabled records render their reason so a
    single-device run is visibly "not measured" rather than silently
    absent."""
    out = ["| config | TP | decode tok/s (TP=1) | decode tok/s (TP=N) | "
           "peak concurrent (TP=1 / TP=N) | exact |",
           "|---|---|---|---|---|---|"]
    for label, rec in records:
        sh = rec.get("sharded")
        if not sh:
            continue
        if not sh.get("enabled"):
            out.append(f"| {label} | — | — | — | — | "
                       f"disabled: {sh.get('reason', '?')} |")
            continue
        tpk = f"tp{sh['tp']}"
        out.append(
            f"| {label} | {sh['tp']} | "
            f"{sh['tp1']['decode_tok_s']:,.0f} | "
            f"{sh[tpk]['decode_tok_s']:,.0f} | "
            f"{sh['tp1']['peak_concurrent']} / "
            f"{sh[tpk]['peak_concurrent']} | "
            f"{'yes' if sh.get('token_exact') else 'NO'} |")
    return "\n".join(out)


def _fmt_assignment(assignment: Dict) -> str:
    """``{phase: {op: {backend: n}}}`` -> ``op=backend`` summary (majority
    backend per op across phases)."""
    merged: Dict[str, Dict[str, int]] = {}
    for per_op in assignment.values():
        for op, counts in per_op.items():
            agg = merged.setdefault(op, {})
            for b, n in counts.items():
                agg[b] = agg.get(b, 0) + n
    return ", ".join(f"{op}={max(c, key=c.get)}"
                     for op, c in sorted(merged.items()))


def backend_table(records: Sequence[Tuple[str, Dict]]) -> str:
    """Markdown per-backend serving throughput table from serve_bench JSON
    records: for each config, one row per swept backend with prefill and
    decode step tokens/s (absolute and vs the ref row), plus what the
    autotuner chose for the serving ops on this machine."""
    out = ["| config | serving backends | prefill tok/s | vs ref | "
           "decode tok/s | vs ref |",
           "|---|---|---|---|---|---|"]
    for label, rec in records:
        for name, row in rec.get("backend_sweep", {}).items():
            out.append(
                f"| {label} | {name} | {row['prefill_tok_s']:,.0f} | "
                f"{row['prefill_vs_ref']:.2f}x | {row['decode_tok_s']:,.0f} | "
                f"{row['decode_vs_ref']:.2f}x |")
        at = rec.get("autotune")
        if at:
            out.append(f"| {label} | autotuned: {_fmt_assignment(at['assignment'])} "
                       f"| - | - | - | - |")
    return "\n".join(out)


def _bytes_per_token(pg: Dict) -> str:
    """KV bytes per cached token for one paged section (page_bytes spread
    over the page_size rows it stores — includes int8 scale sidecars)."""
    pb, ps = pg.get("page_bytes"), pg.get("page_size")
    return f"{pb / ps:.0f}" if pb and ps else "-"


def paged_table(records: Sequence[Tuple[str, Dict]]) -> str:
    """Markdown paged-KV-cache table from serve_bench JSON records (the
    ``"paged"`` and ``"paged_kv8"`` sections): KV dtype and bytes/token,
    concurrent-request capacity at equal memory (dense vs paged for fp32
    rows; fp32-paged vs int8-paged at equal pool bytes for kv8 rows),
    prefix-hit vs cold TTFT with the deterministic prefill-tick counts,
    prefix hit rate, CoW count and internal fragmentation of the pool."""
    out = ["| config | kv dtype | page x blocks | B/token | "
           "concurrent (at equal memory) | ttft cold | ttft hit | "
           "prefill ticks (cold -> hit) | hit rate | CoW | frag | exact |",
           "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for label, rec in records:
        for key in ("paged", "paged_kv8"):
            pg = rec.get(key)
            if not pg:
                continue
            cap, pre = pg["capacity"], pg["prefix"]
            pool = pg.get("pool", {})
            if key == "paged":
                conc = (f"dense {cap['dense_concurrent']} -> "
                        f"paged {cap['paged_concurrent']} "
                        f"({cap['ratio']:.1f}x)")
                ticks = (f"{pre['prefill_ticks_cold']} -> "
                         f"{pre['prefill_ticks_hit']}")
                cold_s = _fmt_s(pre.get("ttft_cold_s") or 0)
                hit_s = _fmt_s(pre.get("ttft_hit_s") or 0)
                exact = bool(pg.get("token_exact"))
            else:
                r = cap.get("equal_memory_vs_fp32_paged", 0.0)
                conc = (f"fp32 {cap['fp32_paged_concurrent']} -> "
                        f"int8 {cap['paged_concurrent']} ({r:.1f}x)")
                ticks = cold_s = hit_s = "-"
                exact = bool(pg.get("token_exact", {}).get("all"))
            out.append(
                f"| {label} | {pg.get('kv_dtype', 'float32')} | "
                f"{pg['page_size']} x {pg['n_blocks']} | "
                f"{_bytes_per_token(pg)} | {conc} | {cold_s} | {hit_s} | "
                f"{ticks} | {pool.get('hit_rate', 0):.0%} | "
                f"{pool.get('cow_count', 0)} | "
                f"{pool.get('fragmentation', 0):.0%} | "
                f"{'yes' if exact else 'NO'} |")
    return "\n".join(out)


def load_table(records: Sequence[Tuple[str, Dict]]) -> str:
    """Markdown SLO-goodput table from serve_bench JSON records (the
    ``"load"`` section): one row per (config, tier) plus an overall row —
    offered/finished/shed/dropped counts, SLO attainment, goodput in
    requests/s, and the deterministic p99 TTFT and inter-token gap in
    engine ticks against the SLO bounds.

    A tier with zero finished requests (everything shed or expired under
    overload) reports ``slo_attainment: null`` — there is nothing to
    attain over — and renders as an em dash, mirroring the empty-window
    percentile contract."""
    out = ["| config | tier | offered | finished | shed | dropped | "
           "SLO met | attainment | goodput req/s | ttft p99 (ticks) | "
           "gap p99 (ticks) |",
           "|---|---|---|---|---|---|---|---|---|---|---|"]
    for label, rec in records:
        ld = rec.get("load")
        if not ld:
            continue
        slo = ld.get("slo", {})
        rows = [("overall", ld["overall"])]
        rows += sorted(ld.get("tiers", {}).items())
        for tier, tr in rows:
            out.append(
                f"| {label} | {tier} | {tr['n_offered']} | "
                f"{tr['n_finished']} | {tr['n_shed']} | {tr['n_dropped']} | "
                f"{tr['n_slo_met']} | {_fmt_count(tr['slo_attainment'], '.0%')} | "
                f"{tr['goodput_requests_per_s']:.1f} | "
                f"{_fmt_count(tr['ttft_ticks']['p99'])} / "
                f"{slo.get('ttft_ticks', '-')} | "
                f"{_fmt_count(tr['gap_ticks']['p99'])} / "
                f"{slo.get('gap_ticks', '-')} |")
    return "\n".join(out)


def overload_table(records: Sequence[Tuple[str, Dict]]) -> str:
    """Markdown overload-scheduling table from serve_bench JSON records
    (the ``"overload"`` section, schema v6): the same 2x-offered-load
    trace replayed under the tier-blind FIFO baseline and under
    tier-aware shedding/preemption, one row per (config, policy, tier).
    The attainment column is **SLO-met over OFFERED** (the section's
    headline metric — a request shed at admission did not meet its SLO;
    met-over-finished would hide exactly the baseline's failure mode).
    The headline claim is the high-tier rows: tier-aware must strictly
    beat tier-blind on attainment (``validate_record`` enforces this
    before artifacts upload).  Zero-offered tiers render an em dash,
    never a fake 0% or 100%."""
    out = ["| config | policy | tier | offered | finished | shed | "
           "dropped | attainment (met/offered) | preempted | tier-shed |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for label, rec in records:
        ov = rec.get("overload")
        if not ov:
            continue
        for policy in ("tier_blind", "tier_aware"):
            pol = ov["policies"][policy]
            rep = pol["report"]
            for tier, tr in sorted(rep.get("tiers", {}).items()):
                mark = " *" if tier == ov.get("high_tier") else ""
                att = (tr["n_slo_met"] / tr["n_offered"]
                       if tr["n_offered"] else None)
                out.append(
                    f"| {label} | {policy} | {tier}{mark} | "
                    f"{tr['n_offered']} | {tr['n_finished']} | "
                    f"{tr['n_shed']} | {tr['n_dropped']} | "
                    f"{_fmt_count(att, '.0%')} | "
                    f"{pol['n_preempted']} | {pol['n_tier_shed']} |")
    return "\n".join(out)


def roofline_table(recs: List[Dict], mesh: str = "single") -> str:
    rows = [r for r in recs if r["mesh"] == mesh]
    out = ["| arch | shape | compute | memory | collective | bottleneck | "
           "useful ratio | GB/dev | note |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        if r["status"] == "skipped":
            out.append(f"| {r['arch']} | {r['shape']} | - | - | - | - | - | - "
                       f"| skipped: {r['reason'][:40]} |")
            continue
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | - | - | - | - | - | - "
                       f"| ERROR {r.get('error','')[:40]} |")
            continue
        note = ""
        out.append(
            f"| {r['arch']} | {r['shape']} | {_fmt_s(r['compute_s'])} | "
            f"{_fmt_s(r['memory_s'])} | {_fmt_s(r['collective_s'])} | "
            f"**{r['bottleneck']}** | {r['useful_ratio']:.2f} | "
            f"{r['bytes_per_device']/1e9:.1f} | {note} |")
    return "\n".join(out)


def dryrun_table(recs: List[Dict]) -> str:
    out = ["| arch | shape | mesh | status | HLO FLOPs/dev | bytes/dev | "
           "wire B/dev | collectives | compile s |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                       f"{r['status']} | - | - | - | - | - |")
            continue
        cols = ", ".join(f"{k}x{v}" for k, v in sorted(
            r.get("counts", {}).items()))
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | "
            f"{r['hlo_flops']:.2e} | {r['bytes_per_device']/1e9:.1f}G | "
            f"{r['wire_bytes_per_chip']:.2e} | {cols} | "
            f"{r.get('compile_s','-')} |")
    return "\n".join(out)


def summary_stats(recs: List[Dict]) -> str:
    ok = [r for r in recs if r["status"] == "ok"]
    skipped = [r for r in recs if r["status"] == "skipped"]
    err = [r for r in recs if r["status"] == "error"]
    lines = [f"- cells: {len(recs)} ({len(ok)} compiled ok, "
             f"{len(skipped)} documented skips, {len(err)} errors)"]
    for mesh in ("single", "multipod"):
        ms = [r for r in ok if r["mesh"] == mesh]
        if ms:
            bn: Dict[str, int] = {}
            for r in ms:
                bn[r["bottleneck"]] = bn.get(r["bottleneck"], 0) + 1
            lines.append(f"- {mesh}: bottleneck distribution {bn}")
    return "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch",
                    help="directory of dry-run JSON records")
    ap.add_argument("--serve-dir", default="experiments/serve",
                    help="directory of serve_bench JSON records")
    args = ap.parse_args()
    files = sorted(glob.glob(os.path.join(args.serve_dir, "*.json")))
    serve = [(os.path.splitext(os.path.basename(f))[0], rec)
             for f, rec in zip(files, load_records(args.serve_dir))]
    if serve:
        print("## Serving (benchmarks/serve_bench.py)\n")
        print(serving_table(serve))
        print()
        if any("backend_sweep" in rec or "autotune" in rec
               for _, rec in serve):
            print("## Serving-op backends (serve_bench backend sweep)\n")
            print(backend_table(serve))
            print()
        if any("paged" in rec or "paged_kv8" in rec for _, rec in serve):
            print("## Paged KV cache (serve_bench paged section)\n")
            print(paged_table(serve))
            print()
        if any("spec" in rec for _, rec in serve):
            print("## Speculative decoding (serve_bench spec section)\n")
            print(spec_table(serve))
            print()
        if any("load" in rec for _, rec in serve):
            print("## SLO goodput (serve_bench load section)\n")
            print(load_table(serve))
            print()
        if any("overload" in rec for _, rec in serve):
            print("## Tier-aware overload (serve_bench overload section)\n")
            print(overload_table(serve))
            print()
        if any("sharded" in rec for _, rec in serve):
            print("## Tensor-parallel serving (serve_bench sharded "
                  "section)\n")
            print(sharded_table(serve))
            print()
    recs = load_records(args.dir)
    print("## Summary\n")
    print(summary_stats(recs))
    print("\n## Roofline (single-pod 16x16, per-chip seconds)\n")
    print(roofline_table(recs, "single"))
    print("\n## Roofline (multi-pod 2x16x16)\n")
    print(roofline_table(recs, "multipod"))
    print("\n## Dry-run raw\n")
    print(dryrun_table(recs))


if __name__ == "__main__":
    main()
