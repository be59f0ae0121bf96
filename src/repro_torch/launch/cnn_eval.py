"""The paper's Figure 2 on the port: inference time of the five evaluation
CNNs under each backend assignment, batch 1 — counterpart of
``benchmarks/fig2_inference_time.py::run`` and
``examples/orpheus_cnn_eval.py``.

The paper's finding was that the best backend is workload-dependent.  Inside
the port the comparison is between backend assignments of one graph, in one
environment:

  gemm        every conv via im2col + matmul in plain PyTorch (``ref``)
  cuda        im2col + the hand-written GEMM kernel (``csrc/gemm.cu``)
  direct      one ``F.conv2d`` call (the third-party library)
  winograd    F(2x2,3x3) where it applies, GEMM elsewhere
  cost_model  the analytic argmin under the H100 profile
  autotune    the per-layer measured best (the paper's runtime selection)

Each model is simplified once through the default pipeline, then compiled
into one Program per assignment.  ``--int8`` instead compares each model's
fp32 Program with its int8 one (``compile(..., quantize="int8",
calib_data=x)``), both under the library assignment (``torch``, then
``ref``): ms per inference, weight bytes and their ratio, and the max abs
error of the int8 output — ``benchmarks/fig2_inference_time.py::run_quant``
on the port.  Autotune measurements persist in the
port's cache file (``--autotune-cache``, default ``default_cache_path()``),
so a second run measures nothing.  Times are the median of ``reps`` runs
after one warm-up, on the host clock with the device synchronised.

    python -m repro_torch.launch.cnn_eval [--fast] [--int8] [--autotune-cache PATH] [--device cpu]

Without ``--device`` it runs on the card and raises where there is none.
"""

from __future__ import annotations

import argparse
import statistics
import time
from typing import Dict, List, Optional

import numpy as np
import torch

import repro_torch  # noqa: F401  (registers every op and backend)
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.pipeline import default_pipeline
from repro_torch.core.program import Program, compile
from repro_torch.core.selector import (H100_SXM, AutotunePolicy, BackendPolicy,
                                       CostModelPolicy, FixedPolicy, default_cache_path)
from repro_torch.models.cnn import CNN_MODELS, build_cnn
from repro_torch.tools.report import weight_bytes

__all__ = ["ASSIGNMENTS", "FAST_MODELS", "policies", "compile_all", "time_program", "run",
           "run_quant"]

ASSIGNMENTS = ("gemm", "cuda", "direct", "winograd", "cost_model", "autotune")
FAST_MODELS = ("wrn-40-2", "mobilenet-v1", "resnet-18")


def policies(*, autotune_cache: Optional[str] = None, device: DeviceLike = None,
             reps: int = 2) -> Dict[str, BackendPolicy]:
    """The six assignments, by label."""
    return {
        "gemm": FixedPolicy(prefer=("ref",)),
        "cuda": FixedPolicy(prefer=("cuda", "ref")),
        "direct": FixedPolicy(prefer=("torch", "ref")),
        "winograd": FixedPolicy(prefer=("winograd", "ref")),
        "cost_model": CostModelPolicy(H100_SXM),
        "autotune": AutotunePolicy(reps=reps, device=device,
                                   cache_path=autotune_cache or default_cache_path()),
    }


def compile_all(graph, pols: Dict[str, BackendPolicy], *,
                device: DeviceLike = None) -> Dict[str, Program]:
    """One Program per assignment of an already simplified graph."""
    return {label: compile(graph, policy=pol, pipeline=(), device=device)
            for label, pol in pols.items()}


def time_program(prog: Program, x, reps: int = 5) -> float:
    """Median seconds of ``prog(x=x)`` over ``reps`` runs after one warm-up,
    the device synchronised after each."""
    sync = torch.cuda.synchronize if prog.device.type == "cuda" else (lambda: None)
    prog(x=x)
    sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        prog(x=x)
        sync()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def run(models: Optional[List[str]] = None, reps: int = 3, include_autotune: bool = True,
        autotune_cache: Optional[str] = None, device: DeviceLike = None) -> List[Dict]:
    """Rows of {model, <assignment>: seconds, ..., winner}."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    pipeline = default_pipeline()
    pols = policies(autotune_cache=autotune_cache, device=dev)
    if not include_autotune:
        del pols["autotune"]
    rows = []
    for name in (models or list(CNN_MODELS)):
        g = pipeline.run(build_cnn(name, batch=1))
        x = torch.from_numpy(rng.standard_normal(g.inputs["x"].shape).astype(np.float32)).to(dev)
        row: Dict = {"model": name}
        for label, prog in compile_all(g, pols, device=dev).items():
            row[label] = time_program(prog, x, reps)
        best = min(v for k, v in row.items() if k != "model")
        row["winner"] = [k for k, v in row.items() if k != "model" and v == best][0]
        rows.append(row)
    return rows


def run_quant(models: Optional[List[str]] = None, reps: int = 3,
              device: DeviceLike = None) -> List[Dict]:
    """fp32 against int8, per model: the same simplified graph compiled
    twice under ``FixedPolicy(prefer=("torch", "ref"))`` (``repro``'s
    ``("xla", "ref")``), the second time with ``quantize="int8"`` calibrated
    on the model's input (seed 0, ``repro``'s draw).  Rows of {model,
    fp32_s, int8_s, fp32_weight_bytes, int8_weight_bytes, bytes_ratio,
    max_abs_err}."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    pipeline = default_pipeline()
    policy = FixedPolicy(prefer=("torch", "ref"))
    rows = []
    for name in (models or list(CNN_MODELS)):
        g = pipeline.run(build_cnn(name, batch=1))
        x = torch.from_numpy(rng.standard_normal(g.inputs["x"].shape).astype(np.float32)).to(dev)
        prog_fp = compile(g, policy=policy, pipeline=(), device=dev)
        prog_q = compile(g, policy=policy, pipeline=(), quantize="int8", calib_data=x,
                         device=dev)
        fp_b, q_b = weight_bytes(prog_fp), weight_bytes(prog_q)
        rows.append({
            "model": name, "fp32_s": time_program(prog_fp, x, reps),
            "int8_s": time_program(prog_q, x, reps),
            "fp32_weight_bytes": fp_b, "int8_weight_bytes": q_b,
            "bytes_ratio": fp_b / max(q_b, 1),
            "max_abs_err": float((prog_q(x=x)[0] - prog_fp(x=x)[0]).abs().max()),
        })
    return rows


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fast", action="store_true", help="three small models, no autotune")
    ap.add_argument("--int8", action="store_true",
                    help="fp32 vs int8 builds: ms, weight bytes, max abs error")
    ap.add_argument("--autotune-cache", default=None, metavar="PATH",
                    help="autotune cache JSON (default: $ORPHEUS_AUTOTUNE_CACHE or "
                         "~/.cache/orpheus/autotune_repro_torch.json)")
    ap.add_argument("--device", default=None, help="'cpu' for the plain path (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    if args.int8:
        rows = run_quant(models=list(FAST_MODELS) if args.fast else None, reps=2, device=dev)
        print(f"batch 1, median of 2 runs, on {kind}")
        print(f"{'model':14s} {'fp32':>10s} {'int8':>10s} {'fp32 wB':>10s} "
              f"{'int8 wB':>10s} {'ratio':>6s} {'max err':>8s}")
        for r in rows:
            print(f"{r['model']:14s} {r['fp32_s'] * 1e3:8.2f}ms {r['int8_s'] * 1e3:8.2f}ms "
                  f"{r['fp32_weight_bytes']:10d} {r['int8_weight_bytes']:10d} "
                  f"{r['bytes_ratio']:5.2f}x {r['max_abs_err']:8.4f}")
        return
    rows = run(models=list(FAST_MODELS) if args.fast else None, reps=2,
               include_autotune=not args.fast, autotune_cache=args.autotune_cache,
               device=dev)
    cols = [c for c in rows[0] if c not in ("model", "winner")]
    print(f"batch 1, median of 2 runs, on {kind}")
    print(f"{'model':14s} " + " ".join(f"{c:>11s}" for c in cols) + "  winner")
    for r in rows:
        print(f"{r['model']:14s} " + " ".join(f"{r[c] * 1e3:9.2f}ms" for c in cols)
              + f"  {r['winner']}")
    print("\n(The paper's Fig. 2 claim — backend choice is workload-dependent — holds "
          "iff the winner column isn't constant.)")


if __name__ == "__main__":
    main()
