#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. device  — the card's name and power limit (nvidia-smi) and torch's name.
2. build   — compile ``src/repro_torch/csrc/*.cu`` with nvcc (sm_90a) into
             one shared library; print the time and ptxas' register lines.
3. kernels — hold each of the four kernels against its plain PyTorch
             version on the card: small edge cases, then the shapes the
             full-width serving path gives it; time kernel, plain version
             and one PyTorch library call with CUDA events (cold L2), beside
             the least time the card could take (H100 SXM data-sheet peaks:
             67 TFLOP/s fp32, 3.35 TB/s).
4. model   — a small model's prefill and decode Programs on the card agree
             with the same Programs on the CPU (plain PyTorch path).
5. serving — phi3-mini widths, all 32 layers, random weights from a seed:
             the engine serves 8 requests (4 slots, chunk 64, cache 1024);
             every request's tokens must equal the unbatched reference's,
             every kernel's launch count must rise, and the step assignment
             must show ``cuda`` for dense, rmsnorm and both attentions.

The last three lines of standard output are JSON: the serving numbers, one
entry per kernel (``{"kernels": [...]}``), and the result line.  Without a CUDA device, or away from the
repository's ``src/``, it exits with code 2 and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_FP32_FLOPS = 67e12     # H100 SXM, fp32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12    # H100 SXM HBM3


def fail(msg: str, code: int = 1) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def say(*parts) -> None:
    print(*parts, flush=True)


# --------------------------------------------------------------------------- #
# measurement helpers
# --------------------------------------------------------------------------- #

class Timer:
    """Median time of ``fn()`` over ``reps`` launches, each after a write of
    a buffer larger than the 50 MB L2, with CUDA events around the call
    alone (the serving path finds its weights and caches cold)."""

    def __init__(self, torch, reps: int = 15):
        self.torch = torch
        self.reps = reps
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn) -> float:
        torch = self.torch
        fn()
        fn()
        times = []
        for _ in range(self.reps):
            self.flush.zero_()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            times.append((e0, e1))
        torch.cuda.synchronize()
        vals = sorted(a.elapsed_time(b) for a, b in times)
        return vals[len(vals) // 2]


def bound(flops: float, nbytes: float):
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def max_err(torch, got, want) -> float:
    if got.shape != want.shape:
        fail(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        fail("non-finite kernel output")
    return float((got - want).abs().max()) if got.numel() else 0.0


def check_close(torch, name, got, want, atol, rtol) -> float:
    err = max_err(torch, got, want)
    bad = (got - want).abs() > atol + rtol * want.abs()
    if bool(bad.any()):
        fail(f"{name}: max |err| {err:.3e} exceeds atol {atol} + rtol {rtol}*|plain|")
    return err


# --------------------------------------------------------------------------- #
# phase 3: kernels
# --------------------------------------------------------------------------- #

def kernel_cases(torch, K):
    """Small edge cases of each kernel against its plain version.  Tolerance
    2e-5 (abs and rel): both sides are fp32, summed in another order."""
    g = torch.Generator(device="cuda")
    g.manual_seed(0)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    tol = dict(atol=2e-5, rtol=2e-5)
    n = 0
    for m, nn, kk in ((5, 37, 19), (1, 64, 64), (64, 130, 33), (4, 3, 1), (70, 65, 200)):
        x, w = rn(m, kk), rn(kk, nn)
        check_close(torch, f"gemm {m}x{nn}x{kk}", K.gemm(x, w), K.gemm_plain(x, w), **tol)
        n += 1
    for rows, d in ((1, 8), (7, 96), (3, 3072), (5, 100)):
        x, w, r = rn(rows, d), rn(d), rn(rows, d)
        check_close(torch, "rmsnorm", K.rmsnorm(x, w), K.rmsnorm_plain(x, w), **tol)
        check_close(torch, "rmsnorm+res", K.rmsnorm(x, w, residual=r),
                    K.rmsnorm_plain(x, w, residual=r), **tol)
        n += 2
    for hq, hk in ((1, 1), (2, 1), (4, 2), (4, 4)):
        for d, dv in ((8, 8), (96, 96), (8, 16), (96, 64)):
            for scale in (None, 0.0):
                b, s = 3, 70
                q, k, v = rn(b, hq, d), rn(b, s, hk, d), rn(b, s, hk, dv)
                lengths = torch.tensor([0, s, 37], dtype=torch.int32, device="cuda")
                sc = (1.0 / math.sqrt(d)) if scale is None else scale
                got = K.flash_decode(q, k, v, lengths, scale=scale)
                check_close(torch, f"flash_decode hq={hq} hk={hk} d={d} dv={dv}",
                            got, K.flash_decode_plain(q, k, v, lengths, sc), **tol)
                if float(got[0].abs().max()) != 0.0:
                    fail("flash_decode: a length-0 row is not 0")
                n += 1
            b, t, s = 3, 16, 48
            q, k, v = rn(b, t, hq, d), rn(b, s, hk, d), rn(b, s, hk, d)
            for start_vals in ((0, 5, s - t), (s - t, 0, 20)):  # start + T == cap
                start = torch.tensor(start_vals, dtype=torch.int32, device="cuda")
                for scale in (None, 0.0):
                    sc = (1.0 / math.sqrt(d)) if scale is None else scale
                    check_close(torch, f"flash_chunk_attention hq={hq} hk={hk} d={d}",
                                K.flash_chunk_attention(q, k, v, start, scale=scale),
                                K.flash_chunk_attention_plain(q, k, v, start, sc), **tol)
                    n += 1
    torch.cuda.synchronize()
    return n


def full_width_shapes(cfg, n_slots, chunk, cache_cap):
    """The shapes the serving path gives each kernel (first one per kernel
    is the headline reported in the JSON line)."""
    dm, ff, v = cfg.d_model, cfg.d_ff, cfg.vocab
    gemm = []
    for m, tag in ((n_slots, "engine decode"), (n_slots * chunk, "engine prefill"),
                   (1, "reference decode"), (chunk, "reference prefill")):
        for kk, nn, what in ((dm, ff, "gate/up"), (dm, dm, "q/k/v/o"),
                             (ff, dm, "down"), (dm, v, "lm_head")):
            gemm.append((f"{tag} {what}", m, nn, kk))
    rms = [("engine decode", n_slots), ("engine prefill", n_slots * chunk),
           ("reference decode", 1), ("reference prefill", chunk)]
    return gemm, rms


def kernels_phase(torch, K, cfg, n_slots, chunk, cache_cap, limit_line):
    timer = Timer(torch)
    g = torch.Generator(device="cuda")
    g.manual_seed(1)

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    F = torch.nn.functional
    results, by_tag = {}, {}
    full_tol = dict(atol=1e-4, rtol=1e-4)

    def record(name, tag, shape_tag, err, ms, plain_ms, lib_ms, flops, nbytes):
        by_tag[(name, tag)] = ms
        b_ms, b_by = bound(flops, nbytes)
        say(f"  {name:22s} {shape_tag:34s} err {err:.2e}  kernel {ms:.4g} ms  "
            f"plain {plain_ms:.4g} ms  library {lib_ms:.4g} ms  bound {b_ms:.4g} ms "
            f"({b_by})  [{limit_line}]")
        if name not in results:
            results[name] = dict(shape=shape_tag, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                 library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        else:
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)

    gemm_shapes, rms_shapes = full_width_shapes(cfg, n_slots, chunk, cache_cap)
    for tag, m, nn, kk in gemm_shapes:
        x, w = rn(m, kk), rn(kk, nn, scale=1.0 / math.sqrt(kk))
        err = check_close(torch, f"gemm {tag}", K.gemm(x, w), K.gemm_plain(x, w), **full_tol)
        ms = timer.ms(lambda: K.gemm(x, w))
        plain = timer.ms(lambda: K.gemm_plain(x, w))
        lib = timer.ms(lambda: torch.matmul(x, w))
        record("gemm", tag, f"{tag} M={m} N={nn} K={kk}", err, ms, plain, lib,
               2.0 * m * nn * kk, 4.0 * (m * kk + kk * nn + m * nn))
        del x, w

    d = cfg.d_model
    for tag, rows in rms_shapes:
        x, w = rn(rows, d), 1.0 + 0.1 * rn(d)
        err = check_close(torch, f"rmsnorm {tag}", K.rmsnorm(x, w, eps=cfg.eps),
                          K.rmsnorm_plain(x, w, eps=cfg.eps), **full_tol)
        ms = timer.ms(lambda: K.rmsnorm(x, w, eps=cfg.eps))
        plain = timer.ms(lambda: K.rmsnorm_plain(x, w, eps=cfg.eps))
        lib = timer.ms(lambda: F.rms_norm(x, (d,), w, cfg.eps))
        record("rmsnorm", tag, f"{tag} rows={rows} D={d}", err, ms, plain, lib,
               3.0 * rows * d, 4.0 * (2 * rows * d + d))

    hq, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    for tag, b, lens in (("engine decode", n_slots, [731, 400, 129, 0]),
                         ("reference decode", 1, [731])):
        q = rn(b, hq, dh)
        k, v = rn(b, cache_cap, hk, dh), rn(b, cache_cap, hk, dh)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        sc = 1.0 / math.sqrt(dh)
        err = check_close(torch, f"flash_decode {tag}", K.flash_decode(q, k, v, lengths),
                          K.flash_decode_plain(q, k, v, lengths, sc), **full_tol)
        ms = timer.ms(lambda: K.flash_decode(q, k, v, lengths))
        plain = timer.ms(lambda: K.flash_decode_plain(q, k, v, lengths, sc))
        pos = torch.arange(cache_cap, device="cuda")
        mask = (pos[None, :] < lengths[:, None])[:, None, None, :]
        qs, ks, vs = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
        lib = timer.ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask))
        live = sum(min(max(x, 0), cache_cap) for x in lens)
        record("flash_decode", tag, f"{tag} B={b} S={cache_cap} len={lens}", err, ms, plain,
               lib, 2.0 * live * hq * 2 * dh,
               4.0 * (live * hk * 2 * dh + 2 * b * hq * dh + b))
        del q, k, v

    for tag, b, starts in (("engine prefill", n_slots, [640, 320, 64, 0]),
                           ("reference prefill", 1, [640])):
        t = chunk
        q = rn(b, t, hq, dh)
        k, v = rn(b, cache_cap, hk, dh), rn(b, cache_cap, hk, dh)
        start = torch.tensor(starts, dtype=torch.int32, device="cuda")
        sc = 1.0 / math.sqrt(dh)
        err = check_close(torch, f"flash_chunk_attention {tag}",
                          K.flash_chunk_attention(q, k, v, start),
                          K.flash_chunk_attention_plain(q, k, v, start, sc), **full_tol)
        ms = timer.ms(lambda: K.flash_chunk_attention(q, k, v, start))
        plain = timer.ms(lambda: K.flash_chunk_attention_plain(q, k, v, start, sc))
        qpos = start[:, None] + torch.arange(t, device="cuda")[None, :]
        mask = (torch.arange(cache_cap, device="cuda")[None, None, :]
                <= qpos[:, :, None])[:, None]
        qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        lib = timer.ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask))
        cols = sum(min(cache_cap, s0 + i + 1) for s0 in starts for i in range(t))
        rows_read = sum(min(cache_cap, s0 + t) for s0 in starts)
        record("flash_chunk_attention", tag, f"{tag} B={b} T={t} S={cache_cap} start={starts}",
               err, ms, plain, lib, 2.0 * cols * hq * 2 * dh,
               4.0 * (rows_read * hk * 2 * dh + 2 * b * t * hq * dh + b))
        del q, k, v
    del timer
    torch.cuda.empty_cache()
    return results, by_tag


def tick_estimate(by_tag, n_layers):
    """Kernel milliseconds in one engine tick: each kernel's time at the
    tick's shapes (phase 3) times its launches per tick.  Attention is
    timed at representative cache lengths, not the run's own."""
    L = n_layers
    out = {}
    for phase, attn in (("decode", "flash_decode"), ("prefill", "flash_chunk_attention")):
        tag = f"engine {phase}"

        def g(what):
            return by_tag[("gemm", f"{tag} {what}")]

        out[phase] = {
            "gemm": 4 * L * g("q/k/v/o") + 2 * L * g("gate/up") + L * g("down") + g("lm_head"),
            "rmsnorm": (2 * L + 1) * by_tag[("rmsnorm", tag)],
            "attention": L * by_tag[(attn, tag)],
        }
    return out


# --------------------------------------------------------------------------- #
# phase 4: small model, card vs CPU
# --------------------------------------------------------------------------- #

def model_phase(torch):
    import numpy as np
    from repro_torch.core.program import compile
    from repro_torch.models.graph_lm import (GraphLMConfig, build_decode_graph,
                                             build_prefill_graph, init_lm_params)
    cfg = GraphLMConfig(vocab=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=96)
    params = init_lm_params(cfg, seed=3)
    rng = np.random.default_rng(3)
    b, t, cap = 3, 16, 40
    worst = 0.0
    for graph, tt in ((build_prefill_graph(cfg, params, batch=b, chunk=t, cache_cap=cap), t),
                      (build_decode_graph(cfg, params, batch=b, cache_cap=cap), 1)):
        inputs = {"tokens": rng.integers(0, cfg.vocab, (b, tt)).astype(np.int32),
                  "start": np.array([0, 7, cap - tt], np.int32),
                  "n_new": np.array([tt, 0, tt], np.int32)}
        for name, spec in graph.inputs.items():
            if name.startswith("cache_"):
                inputs[name] = rng.standard_normal(spec.shape).astype(np.float32)
        on_card = compile(graph, device="cuda")(**inputs)
        on_cpu = compile(graph, device="cpu")(**inputs)
        for got, want in zip(on_card, on_cpu):
            worst = max(worst, check_close(torch, f"{graph.name}", got.cpu(), want,
                                           atol=1e-4, rtol=1e-4))
    return worst


# --------------------------------------------------------------------------- #
# phase 5: serving at full width
# --------------------------------------------------------------------------- #

def serving_phase(torch, K, cfg, n_slots, chunk, cache_cap, n_requests, max_new):
    import numpy as np
    from repro_torch.models.graph_lm import init_lm_params_torch
    from repro_torch.runtime.engine import EngineRequest, build_lm_serving

    t0 = time.perf_counter()
    params = init_lm_params_torch(cfg, seed=0, device="cuda")
    n_params = sum(p.numel() for p in params.values())
    engine, reference = build_lm_serving(cfg, n_slots=n_slots, chunk=chunk,
                                         cache_cap=cache_cap, params=params,
                                         device="cuda")
    torch.cuda.synchronize()
    say(f"  weights {n_params / 1e9:.3f} B params ({4 * n_params / 1e9:.2f} GB fp32), "
        f"engine built in {time.perf_counter() - t0:.1f} s")
    summary = engine.stepper.backend_summary()
    for phase, op in (("prefill", "dense"), ("prefill", "rmsnorm"),
                      ("prefill", "chunk_attention"), ("decode", "dense"),
                      ("decode", "rmsnorm"), ("decode", "decode_attention")):
        if set(summary[phase][op]) != {"cuda"}:
            fail(f"{phase} {op} assigned {summary[phase][op]}, expected cuda only")
    say(f"  step assignment: {json.dumps(summary, sort_keys=True)}")

    rng = np.random.default_rng(0)
    reqs = [EngineRequest(uid=i, prompt=rng.integers(0, cfg.vocab, int(rng.integers(128, 701)))
                          .astype(np.int32), max_new_tokens=max_new)
            for i in range(n_requests)]
    torch.cuda.reset_peak_memory_stats()
    for kern in K.KERNELS:
        kern.launches = 0
    for r in reqs:
        if not engine.submit(r):
            fail(f"request {r.uid} rejected: {r.dropped}")
    t_run = time.perf_counter()
    engine.run()
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t_run
    launches = {kern.__name__: kern.launches for kern in K.KERNELS}
    m = engine.metrics
    say(f"  engine: {len(reqs)} requests, prompts {[len(r.prompt) for r in reqs]}, "
        f"{m.tokens_out} tokens in {t_run:.2f} s; {m.prefill_ticks} prefill + "
        f"{m.decode_ticks} decode ticks")
    say(f"  launches during the engine run: {launches}")
    for name, n in launches.items():
        if n == 0:
            fail(f"kernel {name} was never launched by the engine")
    ticks = m.prefill_ticks + m.decode_ticks
    per_tick = {"gemm": 7 * cfg.n_layers + 1, "rmsnorm": 2 * cfg.n_layers + 1}
    for name, n in per_tick.items():
        if launches[name] != n * ticks:
            fail(f"{name}: {launches[name]} launches, expected {n} x {ticks} ticks")
    if launches["flash_decode"] != cfg.n_layers * m.decode_ticks or \
            launches["flash_chunk_attention"] != cfg.n_layers * m.prefill_ticks:
        fail(f"attention launches {launches} do not match the tick counts")
    peak = torch.cuda.max_memory_allocated()
    stats = {
        "tokens_per_s": m.tokens_per_s,
        "ttft_p50_s": m.summary()["ttft_s"]["p50"],
        "decode_ms_per_tick": 1e3 * m.decode_wall_s / max(m.decode_ticks, 1),
        "prefill_ms_per_tick": 1e3 * m.prefill_wall_s / max(m.prefill_ticks, 1),
        "max_memory_allocated_gb": peak / 1e9,
        "engine_wall_s": t_run,
    }
    say(f"  serving: {json.dumps(stats)}")
    if any(not r.done or len(r.out_tokens) != max_new for r in reqs):
        fail("not every request finished with its tokens")

    t_ref = time.perf_counter()
    for r in reqs:
        want = reference.generate(r.prompt, max_new, chunk=chunk)
        if r.out_tokens != want:
            fail(f"request {r.uid}: engine {r.out_tokens} != reference {want}")
    say(f"  all {len(reqs)} requests token-exact against the unbatched reference "
        f"({time.perf_counter() - t_ref:.2f} s)")
    return launches, stats


class Kernels:
    """The port's four kernel wrappers and their plain versions."""

    def __init__(self):
        from repro_torch.kernels.flash_attention import (flash_chunk_attention,
                                                         flash_chunk_attention_plain)
        from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain
        from repro_torch.kernels.gemm import gemm, gemm_plain
        from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain
        self.gemm, self.gemm_plain = gemm, gemm_plain
        self.rmsnorm, self.rmsnorm_plain = rmsnorm, rmsnorm_plain
        self.flash_decode, self.flash_decode_plain = flash_decode, flash_decode_plain
        self.flash_chunk_attention = flash_chunk_attention
        self.flash_chunk_attention_plain = flash_chunk_attention_plain
        self.KERNELS = (gemm, rmsnorm, flash_decode, flash_chunk_attention)


SOURCES = {
    "gemm": ("src/repro_torch/csrc/gemm.cu", "src/repro/kernels/gemm.py:64"),
    "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm.py:39"),
    "flash_decode": ("src/repro_torch/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_decode.py:148"),
    "flash_chunk_attention": ("src/repro_torch/csrc/flash_attention.cu",
                              "src/repro/kernels/flash_attention.py:207"),
}


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "__init__.py").exists():
        fail(f"src/repro_torch not found beside {Path(__file__).name}; run from a "
             "checkout of the repository", code=2)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU", code=2)
    t_start = time.perf_counter()
    phase_s = {}

    # 1. device
    t = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    limit_line = smi.stdout.strip().splitlines()[0].strip()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    say(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"torch.cuda.get_device_name(0) = {kind}; device_count = {count}")
    say("[device] nvidia-smi name, power.limit:")
    say(limit_line)
    phase_s["device"] = time.perf_counter() - t

    # 2. build
    t = time.perf_counter()
    from repro_torch.kernels import _cuda
    path, build_s, log = _cuda.build()
    _cuda.library()
    say(f"[build] {path.relative_to(ROOT)} built in {build_s:.1f} s "
        f"({len(_cuda.SOURCES)} nvcc processes in parallel, then one link)")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            say(f"[build]   {line.strip()}")
    phase_s["build"] = time.perf_counter() - t

    from repro_torch.core.device import resolve_device
    from repro_torch.models.graph_lm import GraphLMConfig
    resolve_device("cuda")  # pins fp32 matmuls (no TF32) for the plain versions
    K = Kernels()

    # phi3-mini-3.8b widths (src/repro/configs/phi3_mini_3_8b.py): d_model 3072,
    # 32 heads, 32 kv heads (d_head 96), SwiGLU d_ff 8192, vocab 32064, 32 layers
    cfg = GraphLMConfig(vocab=32064, d_model=3072, n_layers=32, n_heads=32,
                        n_kv_heads=32, d_ff=8192)
    n_slots, chunk, cache_cap = 4, 64, 1024

    # 3. kernels
    t = time.perf_counter()
    n_cases = kernel_cases(torch, K)
    say(f"[kernels] {n_cases} small cases match their plain versions "
        f"(atol = rtol = 2e-5)")
    say(f"[kernels] full-width shapes (tolerance atol = rtol = 1e-4; median of 15 "
        f"cold-L2 launches; bound from 67 TFLOP/s fp32 and 3.35 TB/s):")
    results, by_tag = kernels_phase(torch, K, cfg, n_slots, chunk, cache_cap, limit_line)
    phase_s["kernels"] = time.perf_counter() - t

    # 4. small model, card vs CPU
    t = time.perf_counter()
    worst = model_phase(torch)
    say(f"[model] small model prefill + decode Programs: card vs CPU max |err| {worst:.2e} "
        f"(atol = rtol = 1e-4)")
    phase_s["model"] = time.perf_counter() - t

    # 5. serving
    t = time.perf_counter()
    say(f"[serving] phi3-mini widths, {cfg.n_layers} layers, {n_slots} slots, chunk {chunk}, "
        f"cache {cache_cap} [{limit_line}]")
    launches, stats = serving_phase(torch, K, cfg, n_slots, chunk, cache_cap,
                                    n_requests=8, max_new=32)
    phase_s["serving"] = time.perf_counter() - t
    estimate = tick_estimate(by_tag, cfg.n_layers)
    for phase in ("decode", "prefill"):
        tick_ms = stats[f"{phase}_ms_per_tick"]
        kern = estimate[phase]
        rest = tick_ms - sum(kern.values())
        parts = ", ".join(f"{k} {v:.2f} ms ({100 * v / tick_ms:.0f}%)" for k, v in kern.items())
        say(f"[breakdown] engine {phase} tick {tick_ms:.2f} ms: {parts}, everything else "
            f"(plain ops, cache copies, logits to host, Python) {rest:.2f} ms "
            f"({100 * rest / tick_ms:.0f}%) [{limit_line}]")
    phase_s["total"] = time.perf_counter() - t_start
    say(f"[done] wall seconds per phase {json.dumps(phase_s)}")

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        r = results[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "shape": r["shape"]})
    say(json.dumps({"serving": stats, "tick_kernel_ms": estimate, "card": limit_line}))
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
