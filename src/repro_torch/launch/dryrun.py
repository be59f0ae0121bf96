"""Multi-pod dry-run: lower every (architecture x input shape) cell on the
production meshes, one rank of 256 or 512 — counterpart of
:mod:`repro.launch.dryrun`.

Where JAX compiles each cell for 512 placeholder host devices, this process
joins a ``fake`` process group as rank 0 of the mesh
(:func:`repro_torch.launch.mesh.make_production_mesh`) and runs the cell's
step once on fake tensors (:meth:`repro_torch.launch.cells.Cell.lower`):
nothing is allocated, no kernel launches, and the collectives move nothing
but are recorded with their group sizes.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun                    # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b   # one arch
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b \\
      --shape decode_32k --mesh multipod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --list

Per cell it writes a record in JAX's schema (the same keys, so either
package's ``tools/report.py`` tables read it) to
experiments/dryrun_torch/<arch>__<shape>__<mesh>.json: the roofline
report on the H100's datasheet constants (:data:`repro_torch.tools.roofline.H100`)
from the step's FLOPs (``FlopCounterMode``), its bytes accessed (unfused:
every aten op's inputs and outputs) and the rank's collective records.
``memory_analysis`` holds the argument and output bytes; no temporary
peak is measured (``temp_size_in_bytes`` is null).  ``--save-hlo``: the
port has no HLO; it writes the step's FLOPs by aten op beside the record.

The records count the port's steps as written: the serve steps hold the
params whole on every rank (:mod:`repro_torch.runtime.serve`) and training
gathers them whole over "model" (:mod:`repro_torch.runtime.train`), so
their FLOPs a rank exceed JAX's per-chip FLOPs wherever GSPMD splits a
product over "model".
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.configs import get_config, list_configs
from repro_torch.launch.cells import build_cell
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.tools.roofline import analyze, model_flops_for

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str = OUT_DIR,
             save_hlo: bool = False, cfg=None) -> dict:
    """Lower one cell on the ``mesh_kind`` ("single" or "multipod")
    production mesh and write its record; ``cfg`` (default: the arch's
    published config) goes to :func:`build_cell`."""
    cfg = cfg or get_config(arch)
    sc = cfg.shape(shape_name)
    mesh = make_production_mesh(multi_pod=mesh_kind == "multipod")
    chips = mesh.axis_size(mesh.axis_names)
    t0 = time.time()
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "chips": chips,
           "status": "unknown"}
    try:
        if shape_name in cfg.skip_shapes:
            rec["status"] = "skipped"
            rec["reason"] = "documented skip (full attention arch; DESIGN.md §4)"
            return _save(rec, out_dir)
        cell = build_cell(arch, shape_name, mesh, cfg=cfg)
        t_lower = time.time() - t0
        low = cell.lower()
        t_compile = time.time() - t0 - t_lower
        extra = {"package": "repro_torch", "bytes_note": low.bytes_note,
                 "peak_measured": low.peak_measured, "kernel_extra_cost": low.extra_cost,
                 "aten_ops": low.aten_ops, "arg_bytes": low.arg_bytes}
        report = analyze(cell.name, mesh_kind, chips, low.cost(), "",
                         model_flops=model_flops_for(cfg, sc.kind, sc.seq_len,
                                                     sc.global_batch),
                         bytes_per_device=low.bytes_per_device, extra=extra,
                         collectives=low.collectives)
        rec.update(json.loads(report.to_json()))
        rec["status"] = "ok"
        rec["kind"] = sc.kind
        rec["seq_len"] = sc.seq_len
        rec["global_batch"] = sc.global_batch
        rec["memory_analysis"] = {
            "argument_size_in_bytes": int(low.bytes_per_device),
            "output_size_in_bytes": low.output_bytes,
            "temp_size_in_bytes": None,
            "alias_size_in_bytes": 0,
            "generated_code_size_in_bytes": 0,
        }
        rec["lower_s"] = round(t_lower, 2)
        rec["compile_s"] = round(t_compile, 2)
        if save_hlo:
            rec["hlo_path"] = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_kind}.ops")
            os.makedirs(out_dir, exist_ok=True)
            with open(rec["hlo_path"], "w") as f:
                for op, n in sorted(low.flops_by_op.items(), key=lambda kv: -kv[1]):
                    f.write(f"{n:.6e} {op}\n")
        print(f"[ok]   {arch:24s} {shape_name:12s} {mesh_kind:9s} "
              f"flops={rec['hlo_flops']:.3e} wire={rec['wire_bytes_per_chip']:.3e} "
              f"bottleneck={rec['bottleneck']} ({t_lower:.0f}+{t_compile:.0f}s)", flush=True)
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[FAIL] {arch:24s} {shape_name:12s} {mesh_kind:9s} {rec['error']}", flush=True)
    return _save(rec, out_dir)


def _save(rec: dict, out_dir: str) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, sort_keys=True, default=str)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None, help="one arch (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--mesh", default="both", choices=["single", "multipod", "both"])
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--save-hlo", action="store_true")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args()

    archs = [args.arch] if args.arch else list_configs()
    meshes = (["single", "multipod"] if args.mesh == "both" else [args.mesh])
    if args.list:
        for a in archs:
            cfg = get_config(a)
            for s in cfg.shapes:
                skip = " (skip)" if s.name in cfg.skip_shapes else ""
                print(f"{a:24s} {s.name:12s} {s.kind:8s}{skip}")
        return 0

    n_fail = 0
    for a in archs:
        cfg = get_config(a)
        shapes = [args.shape] if args.shape else [s.name for s in cfg.shapes]
        for s in shapes:
            for m in meshes:
                rec = run_cell(a, s, m, out_dir=args.out, save_hlo=args.save_hlo)
                if rec["status"] == "error":
                    n_fail += 1
    print(f"done; {n_fail} failures")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
