#!/usr/bin/env python3
"""gemma3-1b served by the continuous batcher at fp32 and at its published
bfloat16, in turns, in one process on one card.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 chip_bf16_ab.py

It builds the kernels, then runs ``chip_smoke.layerstack_phase`` (phase
8: 26 layers, 4 slots, cache 2048, 8 requests of 200-1400 prompt tokens,
32 new tokens each, token-exact against the unbatched greedy run, exact
launch counts) four times: fp32, bf16, bf16, fp32.  Host-clock step
times move with the host between calls, so the two dtypes are compared
only within this one call.  Prints each run's serving numbers, the card's
name and power limit, and one JSON line of the four runs last; any gate
that fails exits non-zero.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main() -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core.device import resolve_device
    from repro_torch.kernels import _cuda
    from repro_torch.launch.serve import serving_config

    _cuda.build()
    _cuda.library()
    resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    K = cs.Kernels()
    bf16 = serving_config("gemma3-1b", full=True, device="cuda")
    fp32 = bf16.with_overrides(dtype="float32", param_dtype="float32")
    runs = []
    for cfg in (fp32, bf16, bf16, fp32):
        print(f"[layerstack {cfg.dtype}]", flush=True)
        launches, stats = cs.layerstack_phase(torch, K, cfg, card, max_new=32, tag="layerstack")
        runs.append({"dtype": cfg.dtype, "launches": launches, **stats})
        cs.release(torch)
    print(json.dumps({"runs": runs, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
