"""Where a batcher decode step's time goes: host or device.

    PYTHONPATH=src python -m repro_torch.launch.profile_step --arch mamba2-370m --full
    PYTHONPATH=src python -m repro_torch.launch.profile_step --arch gemma3-1b --device cpu

Serves random-prompt requests through :class:`ContinuousBatcher` as
``chip_smoke.py``'s phases 8-10 do (8 requests of 200-1400 tokens from
seed 0, 4 slots, cache 2048, 32 new tokens, weights from seed 0;
``--full``: the published widths in fp32), for ``--warmup`` + ``--steps``
decode steps.  Every decode step is timed on the host clock between two
synchronises.  After ``--warmup`` steps it profiles ``--steps`` decode
steps with :mod:`torch.profiler` and prints
one JSON line: the step's wall time without and with the profiler, the
device's busy time per step (the union of the kernels' intervals inside
the step), its idle share, the launches per step, and the kernels by
device time and the host ops by self time per step.  Where the profile
holds no device event (``--device cpu``) the device columns are 0 and the
idle share is null.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from collections import defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.launch.serve import serving_config
from repro_torch.models.lm import LM
from repro_torch.runtime.batching import ContinuousBatcher, Request

__all__ = ["busy_us", "step_profile", "main"]

STEP_LABEL = "profile_step.decode_step"

Interval = Tuple[float, float]


def busy_us(intervals: Iterable[Interval]) -> float:
    """Length of the union of [start, end) intervals (microseconds)."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def step_profile(steps: Sequence[Interval], kernels: Sequence[Tuple[str, float, float]],
                 host_ops: Sequence[Tuple[str, float, float, float]], top: int = 10) -> Dict:
    """Per-step numbers from profiler events.  ``steps``: the decode steps'
    host ranges (start, end); ``kernels``: (name, start, end) of every
    device event; ``host_ops``: (name, start, end, self time) of every host
    op.  Times in microseconds; every step ends in a synchronise, so its
    kernels lie inside its range.  Events outside every step, and the
    step's label where the profiler mirrors it onto the device timeline,
    are left out; with no device event at all the idle share is None."""
    n = len(steps)
    if n == 0:
        raise ValueError("no decode step was profiled")

    def owner(s, e):
        for i, (a, b) in enumerate(steps):
            if a <= s and e <= b:
                return i
        return None

    by_step: List[List[Interval]] = [[] for _ in steps]
    k_time: Dict[str, float] = defaultdict(float)
    k_calls: Dict[str, int] = defaultdict(int)
    for name, s, e in kernels:
        i = owner(s, e)
        # the profiler mirrors the step's own label onto the device timeline
        if i is None or name == STEP_LABEL:
            continue
        by_step[i].append((s, e))
        k_time[name] += e - s
        k_calls[name] += 1
    h_time: Dict[str, float] = defaultdict(float)
    for name, s, e, self_us in host_ops:
        if name != STEP_LABEL and owner(s, e) is not None:
            h_time[name] += self_us
    wall = sum(b - a for a, b in steps)
    busy = sum(busy_us(iv) for iv in by_step)
    return {
        "steps": n,
        "wall_ms": wall / n / 1e3,
        "device_busy_ms": busy / n / 1e3,
        "device_idle_share": 1.0 - busy / wall if wall > 0 and k_calls else None,
        "launches_per_step": sum(len(iv) for iv in by_step) / n,
        "kernels": [{"name": k[:120], "ms_per_step": t / n / 1e3, "calls_per_step": k_calls[k] / n}
                    for k, t in sorted(k_time.items(), key=lambda x: -x[1])[:top]],
        "host_ops": [{"name": k[:120], "self_ms_per_step": t / n / 1e3}
                     for k, t in sorted(h_time.items(), key=lambda x: -x[1])[:top]],
    }


def _events(prof) -> Tuple[List[Interval], list, list]:
    """Step ranges, device events and host ops of a finished profile."""
    from torch.autograd import DeviceType
    steps, kernels, host = [], [], []
    for ev in prof.events():
        s, e = float(ev.time_range.start), float(ev.time_range.end)
        if ev.device_type == DeviceType.CPU:
            if ev.name == STEP_LABEL:
                steps.append((s, e))
            host.append((ev.name, s, e, float(ev.self_cpu_time_total)))
        else:
            kernels.append((ev.name, s, e))
    return sorted(steps), kernels, host


class _ProfiledLM(LM):
    """Times every decode step between two synchronises, and profiles the
    steps in [warmup, warmup + n_prof)."""

    def __init__(self, cfg, device, warmup: int, n_prof: int):
        super().__init__(cfg)
        self.device, self.warmup, self.n_prof = device, warmup, n_prof
        self.step_s: List[float] = []
        self.prof = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def decode_step(self, *args, **kw):
        i = len(self.step_s)
        if i == self.warmup:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
        self._sync()
        t = time.perf_counter()
        with torch.profiler.record_function(STEP_LABEL):
            out = super().decode_step(*args, **kw)
            self._sync()
        self.step_s.append(time.perf_counter() - t)
        if i == self.warmup + self.n_prof - 1:
            self.prof.stop()
        return out


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2-370m")
    ap.add_argument("--full", action="store_true",
                    help="the published config (fp32) instead of the reduced one")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--warmup", type=int, default=8, help="decode steps before the profile")
    ap.add_argument("--steps", type=int, default=16, help="decode steps profiled")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = serving_config(args.arch, full=args.full, device=device)
    model = _ProfiledLM(cfg, device, args.warmup, args.steps)
    params = model.init_params(0, device=device)
    rng = np.random.default_rng(0)
    batcher = ContinuousBatcher(model, params, n_slots=4, cache_cap=2048, eos_id=-1)
    for i, n in enumerate(rng.integers(200, 1401, 8)):
        batcher.submit(Request(uid=i, prompt=rng.integers(0, cfg.vocab, int(n)).astype(np.int32),
                               max_new_tokens=32))
    batcher.run(max_steps=args.warmup + args.steps)
    if len(model.step_s) < args.warmup + args.steps:
        raise SystemExit(f"{len(model.step_s)} decode steps ran; --warmup + --steps need "
                         f"{args.warmup + args.steps}")
    out = {"arch": cfg.name, "device": str(device),
           "step_ms_unprofiled": 1e3 * statistics.median(model.step_s[:args.warmup]),
           "step_ms_profiled": 1e3 * statistics.median(
               model.step_s[args.warmup:args.warmup + args.steps])}
    out.update(step_profile(*_events(model.prof)))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
