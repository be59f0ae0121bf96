"""Perf hillclimbing harness — counterpart of :mod:`repro.tools.hillclimb`.

Lowers VARIANTS of one (arch x shape) cell on the single-pod mesh (this
process as rank 0 of 256, :func:`repro_torch.launch.mesh.make_production_mesh`)
— config tweaks (MoE dispatch mode, SSD chunk, remat) or sharding tweaks
(cache seq-shard fallback) — and reports the roofline-term deltas against
the variant listed first, the baseline.  Results land in
experiments/perf_torch/<arch>__<shape>/<variant>.json.  The terms are the
H100 datasheet roofline of the port's step as written (launch/dryrun.py),
not measured times.

    PYTHONPATH=src python -m repro_torch.tools.hillclimb --cell stablelm-12b/decode_32k
    PYTHONPATH=src python -m repro_torch.tools.hillclimb --list
    PYTHONPATH=src python -m repro_torch.tools.hillclimb --cell mamba2-370m/train_4k \\
        --reduced --variant chunk-64       # the baseline and one variant, reduced config
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import ShapeCfg
from repro_torch.launch.cells import build_cell
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.tools.roofline import analyze, model_flops_for

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments", "perf_torch")

TERMS = ("compute_s", "memory_s", "collective_s")


def _ssd_chunk(cfg, q):
    return dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, chunk=q))


def _moe_dispatch(cfg, mode):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch=mode))


_KV = {"baseline-replicated-kv": (None, {"seq_shard_fallback": False}),
       "seq-shard-kv": (None, {"seq_shard_fallback": True})}
_DISPATCH = {"baseline-global-dispatch": (lambda c: _moe_dispatch(c, "global"), {}),
             "local-dispatch": (lambda c: _moe_dispatch(c, "local"), {})}

# cell -> variant -> (cfg_transform, build_cell kwargs); the first is the baseline
VARIANTS = {
    "stablelm-12b/decode_32k": dict(_KV),
    "pixtral-12b/decode_32k": dict(_KV),
    "minitron-4b/decode_32k": dict(_KV),
    "gemma3-1b/decode_32k": dict(_KV),
    "deepseek-v2-lite-16b/decode_32k": {
        "baseline-replicated-latent": (None, {"seq_shard_fallback": False}),
        "seq-shard-latent": (None, {"seq_shard_fallback": True}),
    },
    "qwen2-moe-a2.7b/train_4k": dict(_DISPATCH),
    "deepseek-v2-lite-16b/train_4k": dict(_DISPATCH),
    "mamba2-370m/train_4k": {
        "baseline-chunk128": (lambda c: _ssd_chunk(c, 128), {}),
        "chunk-64": (lambda c: _ssd_chunk(c, 64), {}),
        "chunk-32": (lambda c: _ssd_chunk(c, 32), {}),
        "chunk-256": (lambda c: _ssd_chunk(c, 256), {}),
        "no-remat": (lambda c: dataclasses.replace(c, remat=False), {}),
    },
    "zamba2-7b/train_4k": {
        "baseline-chunk128": (lambda c: _ssd_chunk(c, 128), {}),
        "chunk-64": (lambda c: _ssd_chunk(c, 64), {}),
        "chunk-256": (lambda c: _ssd_chunk(c, 256), {}),
    },
}


def run_variant(arch: str, shape: str, label: str, cfg_fn, kwargs, out_dir: str,
                reduced: bool = False) -> dict:
    """Lower one variant and write its record; ``reduced``: the reduced
    config at a smoke shape of the same kind (32 tokens, one row a data
    rank)."""
    cfg = get_config(arch)
    if reduced:
        kind = cfg.shape(shape).kind
        shape = f"smoke_{kind}"
        cfg = dataclasses.replace(get_reduced(arch), shapes=(ShapeCfg(shape, kind, 32, 16),))
    if cfg_fn is not None:
        cfg = cfg_fn(cfg)
    sc = cfg.shape(shape)
    mesh = make_production_mesh(multi_pod=False)
    chips = mesh.axis_size(mesh.axis_names)
    t0 = time.time()
    cell = build_cell(arch, shape, mesh, cfg=cfg, **kwargs)
    low = cell.lower()
    rep = analyze(cell.name, "single", chips, low.cost(), "",
                  model_flops=model_flops_for(cfg, sc.kind, sc.seq_len, sc.global_batch),
                  bytes_per_device=low.bytes_per_device, collectives=low.collectives)
    rec = json.loads(rep.to_json())
    rec.update(arch=arch, shape=shape, variant=label, compile_s=round(time.time() - t0, 1))
    d = os.path.join(out_dir, f"{arch}__{shape}")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, f"{label}.json"), "w") as f:
        json.dump(rec, f, indent=1, sort_keys=True)
    return rec


def _line(label: str, rec: dict, base: dict) -> str:
    deltas = " ".join(f"{t[:-2]}={rec[t]:.3e} ({(rec[t] - base[t]) / base[t]:+.1%})"
                      if base[t] else f"{t[:-2]}={rec[t]:.3e}" for t in TERMS)
    return (f"[{label:28s}] {deltas} bneck={rec['bottleneck']} "
            f"GB/dev={rec['bytes_per_device'] / 1e9:.1f} ({rec['compile_s']}s)")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default=None, help="arch/shape")
    ap.add_argument("--variant", default=None, help="one variant (and the baseline)")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config at its smoke shape of the cell's kind")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args()
    if args.list:
        for cell, vs in VARIANTS.items():
            print(cell, "->", ", ".join(vs))
        return 0
    cells = [args.cell] if args.cell else list(VARIANTS)
    n_fail = 0
    for cell in cells:
        arch, shape = cell.split("/")
        print(f"=== {cell} ===")
        base = None
        for label, (cfg_fn, kwargs) in VARIANTS[cell].items():
            if args.variant and label != args.variant and base is not None:
                continue
            try:
                rec = run_variant(arch, shape, label, cfg_fn, kwargs, args.out,
                                  reduced=args.reduced)
            except Exception as e:  # noqa: BLE001
                n_fail += 1
                print(f"[{label:28s}] FAILED {type(e).__name__}: {e}")
                continue
            base = base or rec
            print(_line(label, rec, base), flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
