"""Where a decode step's time goes: host or device.

    PYTHONPATH=src python -m repro_torch.launch.profile_step --arch mamba2-370m --full
    PYTHONPATH=src python -m repro_torch.launch.profile_step --arch gemma3-1b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.profile_step --engine dense paged --full

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
idle share is null.  The batcher's prefills (one a request admitted, none
profiled) are timed the same way: ``prefill_ms_per_token`` is their summed
time over their summed prompt tokens, as ``chip_smoke.py``'s batcher
phases give it.

``--engine dense paged`` profiles the decode ticks of
:func:`~repro_torch.runtime.engine.build_lm_serving`'s engines instead, one
JSON line each (``--full``: phi3-mini-3.8b widths, 32 layers, 4 slots, chunk
64, cache 1024, pages of 16; 8 requests of 128-700 tokens, 32 new, from seed
0 — ``chip_smoke.py``'s phases 5 and 6; else the default small
``GraphLMConfig``).  A tick is the stepper's decode call, which ends with
the logits on the host.  The script imports only the package's public
entry points, so run by path with another checkout's ``src`` on
``PYTHONPATH`` it profiles that checkout's engine.
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

__all__ = ["busy_us", "step_profile", "engine_profiles", "main"]

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


class _StepTimer:
    """Times every call of a step function between two synchronises, and
    profiles the calls in [warmup, warmup + n_prof)."""

    def __init__(self, device, warmup: int, n_prof: int):
        self.device, self.warmup, self.n_prof = device, warmup, n_prof
        self.step_s: List[float] = []
        self.prof = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __call__(self, fn, *args, **kw):
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
            out = fn(*args, **kw)
            self._sync()
        self.step_s.append(time.perf_counter() - t)
        if i == self.warmup + self.n_prof - 1:
            self.prof.stop()
        return out

    def report(self, **head) -> Dict:
        """``head`` plus the unprofiled steps' and the profile's numbers."""
        w, n = self.warmup, self.n_prof
        if len(self.step_s) < w + n:
            raise SystemExit(f"{len(self.step_s)} decode steps ran; --warmup + --steps need "
                             f"{w + n}")
        plain = self.step_s[:w] + self.step_s[w + n:]
        out = dict(head, step_ms_unprofiled=1e3 * statistics.median(plain),
                   step_ms_unprofiled_mean=1e3 * statistics.mean(plain),
                   steps_unprofiled=len(plain),
                   step_ms_profiled=1e3 * statistics.median(self.step_s[w:w + n]))
        out.update(step_profile(*_events(self.prof)))
        return out


class _ProfiledLM(LM):
    def __init__(self, cfg, timer: _StepTimer):
        super().__init__(cfg)
        self.timer = timer
        self.prefills: List[Tuple[float, int]] = []      # (seconds, prompt tokens)

    def decode_step(self, *args, **kw):
        return self.timer(super().decode_step, *args, **kw)

    def prefill(self, params, batch, **kw):
        self.timer._sync()
        t = time.perf_counter()
        out = super().prefill(params, batch, **kw)
        self.timer._sync()
        self.prefills.append((time.perf_counter() - t, int(batch["tokens"].shape[1])))
        return out


def engine_profiles(modes: Sequence[str], device, warmup: int, n_prof: int,
                    full: bool) -> List[Dict]:
    """The decode ticks of one engine per mode (``dense`` or ``paged``:
    fp32 pages), on one set of weights (the module docstring)."""
    from repro_torch.models.graph_lm import GraphLMConfig, init_lm_params_torch
    from repro_torch.runtime.engine import EngineRequest, build_lm_serving
    if full:
        cfg = GraphLMConfig(vocab=32064, d_model=3072, n_layers=32, n_heads=32,
                            n_kv_heads=32, d_ff=8192)
        chunk, cache_cap, page, lo, hi, new = 64, 1024, 16, 128, 701, 32
    else:
        cfg = GraphLMConfig()
        chunk, cache_cap, page, lo, hi, new = 8, 64, 8, 8, 33, 8
    params = init_lm_params_torch(cfg, seed=0, device=device)
    outs = []
    for mode in modes:
        kw = (dict(paged=True, page_size=page, n_blocks=4 * cache_cap // page)
              if mode == "paged" else {})
        engine, _ = build_lm_serving(cfg, n_slots=4, chunk=chunk, cache_cap=cache_cap,
                                     params=params, device=device, **kw)
        timer = _StepTimer(device, warmup, n_prof)
        decode = engine.stepper.decode
        engine.stepper.decode = lambda *a, _f=decode: timer(_f, *a)
        rng = np.random.default_rng(0)
        for i in range(8):
            prompt = rng.integers(0, cfg.vocab, int(rng.integers(lo, hi))).astype(np.int32)
            engine.submit(EngineRequest(uid=i, prompt=prompt, max_new_tokens=new))
        engine.run()
        outs.append(timer.report(engine=mode, d_model=cfg.d_model, n_layers=cfg.n_layers,
                                 device=str(device), decode_ticks=engine.metrics.decode_ticks))
        del engine, decode
    return outs


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2-370m")
    ap.add_argument("--full", action="store_true",
                    help="the published config (fp32) instead of the reduced one")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--warmup", type=int, default=8, help="decode steps before the profile")
    ap.add_argument("--steps", type=int, default=16, help="decode steps profiled")
    ap.add_argument("--engine", nargs="+", choices=("dense", "paged"), default=None,
                    help="profile these engines' decode ticks instead of a batcher step")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.engine:
        outs = engine_profiles(args.engine, device, args.warmup, args.steps, args.full)
        for out in outs:
            print(json.dumps(out))
        return outs[0] if len(outs) == 1 else {"engines": outs}
    cfg = serving_config(args.arch, full=args.full, device=device)
    timer = _StepTimer(device, args.warmup, args.steps)
    model = _ProfiledLM(cfg, timer)
    params = model.init_params(0, device=device)
    rng = np.random.default_rng(0)
    batcher = ContinuousBatcher(model, params, n_slots=4, cache_cap=2048, eos_id=-1)
    for i, n in enumerate(rng.integers(200, 1401, 8)):
        batcher.submit(Request(uid=i, prompt=rng.integers(0, cfg.vocab, int(n)).astype(np.int32),
                               max_new_tokens=32))
    batcher.run(max_steps=args.warmup + args.steps)
    seconds, tokens = (sum(x) for x in zip(*model.prefills))
    out = timer.report(arch=cfg.name, device=str(device), prefills=len(model.prefills),
                       prefill_tokens=tokens, prefill_ms_per_token=1e3 * seconds / tokens)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
