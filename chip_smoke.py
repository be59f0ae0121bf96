#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. device  — the card's name and power limit (nvidia-smi) and torch's name.
2. build   — compile ``src/repro_torch/csrc/*.cu`` with nvcc (sm_90a) into
             one shared library; print the time and ptxas' register lines.
3. kernels — hold each of the six kernels against its plain PyTorch
             version on the card: small edge cases, then the shapes the
             full-width serving path gives it; time kernel, plain version
             and one PyTorch library call with CUDA events (cold L2), beside
             the least time the card could take (H100 SXM data-sheet peaks:
             67 TFLOP/s fp32, 3.35 TB/s).  The two paged kernels run in both
             modes (fp32 and int8 pages); their fp32 output must be bitwise
             equal to the dense kernel's on the gathered cache, and the
             dense kernel's time at the same logical shape is their
             yardstick (no PyTorch call reads KV through a block table).
             The cache-write ops of the three serving paths are timed too.
4. model   — a small model's prefill and decode Programs on the card agree
             with the same Programs on the CPU (plain PyTorch path): dense,
             paged fp32 (1e-4) and paged int8 (logits within 5e-2).
5. serving — phi3-mini widths, all 32 layers, random weights from a seed:
             the engine serves 8 requests (4 slots, chunk 64, cache 1024);
             every request's tokens must equal the unbatched reference's,
             every kernel's launch count must rise, and the step assignment
             must show ``cuda`` for dense, rmsnorm and both attentions.
6. paged   — the same model, weights, slots, chunk and cache with the paged
             fp32 cache (page 16, 256 blocks = the dense memory), in two
             waves: phase 5's requests plus A (a 512-token shared prefix S
             and a tail), then B and C (S plus other tails) and D (A's
             written stream plus one diverging token, which claims A's
             partial tail page and copies it on its first write).  Every
             request must be token-exact against the dense reference, wave
             2 must hit the prefix cache and copy on write, and only the
             paged attention kernels may run.
7. kv8     — the same two waves with int8 pages and the block count of
             equal bytes; completion, launches, hits and copies are checked,
             and agreement with the fp32 reference is reported, not
             asserted (int8 KV is lossy).

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
    return n + paged_kernel_cases(torch, K, rn, g, tol)


def paged_layout(torch, g, *, b, n, page, mp, hk, d, dv, lengths, quant):
    """A scrambled page pool: the live pages of every sequence are distinct
    blocks in random order, table entries past them are junk (any id, even
    out of range: the kernels clip and never read them), and int8 pools
    hold one all-zero page with scale 0.  Returns (pages_k, pages_v,
    tables, scales kwargs)."""
    perm = torch.randperm(n, generator=g, device="cuda")
    tables = torch.randint(-2, n + 2, (b, mp), generator=g, device="cuda")
    used = 0
    for bi, length in enumerate(lengths):
        live = -(-min(length, mp * page) // page)
        tables[bi, :live] = perm[used:used + live]
        used += live
    tables = tables.to(torch.int32)
    if not quant:
        return (torch.randn(n, page, hk, d, generator=g, device="cuda"),
                torch.randn(n, page, hk, dv, generator=g, device="cuda"), tables, {})
    pk = torch.randint(-127, 128, (n, page, hk, d), generator=g, device="cuda",
                       dtype=torch.int8)
    pv = torch.randint(-127, 128, (n, page, hk, dv), generator=g, device="cuda",
                       dtype=torch.int8)
    ks = torch.rand(n, hk, generator=g, device="cuda") * 0.05
    vs = torch.rand(n, hk, generator=g, device="cuda") * 0.05
    zero = int(perm[0])
    pk[zero], pv[zero], ks[zero], vs[zero] = 0, 0, 0.0, 0.0
    return pk, pv, tables, dict(k_scales=ks, v_scales=vs)


def paged_kernel_cases(torch, K, rn, g, tol):
    """The paged kernels, both modes: GQA groups, pages of 1 to 128 rows,
    lengths 0 and MP*P, start + T == MP*P, scale None and 0.0, scrambled
    tables with junk entries, an all-zero int8 page.  fp32 pages must give
    the dense kernel's output on the gathered cache bit for bit."""
    n = 0
    for quant in (False, True):
        mode = "int8" if quant else "fp32"
        for hq, hk in ((1, 1), (2, 1), (4, 2), (4, 4)):
            for page, mp in ((1, 70), (5, 14), (16, 5), (64, 2), (128, 1)):
                cap = page * mp
                for scale in (None, 0.0):
                    lens = [0, cap, 37, 1]
                    pk, pv, tables, sc = paged_layout(torch, g, b=4, n=4 * mp + 3, page=page,
                                                      mp=mp, hk=hk, d=96, dv=64, lengths=lens,
                                                      quant=quant)
                    q = rn(4, hq, 96)
                    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
                    s = (1.0 / math.sqrt(96)) if scale is None else scale
                    tag = f"{mode} hq={hq} hk={hk} P={page} scale={scale}"
                    got = K.flash_paged_decode(q, pk, pv, tables, lengths, scale=scale, **sc)
                    check_close(torch, f"flash_paged_decode {tag}", got,
                                K.flash_paged_decode_plain(q, pk, pv, tables, lengths, s,
                                                           sc.get("k_scales"),
                                                           sc.get("v_scales")), **tol)
                    if float(got[0].abs().max()) != 0.0:
                        fail(f"flash_paged_decode {tag}: a length-0 row is not 0")
                    if not quant and not torch.equal(got, K.flash_decode(
                            q, K.gather_pages(pk, tables), K.gather_pages(pv, tables),
                            lengths, scale=scale)):
                        fail(f"flash_paged_decode {tag}: not bitwise equal to flash_decode")
                    t = 16
                    pk, pv, tables, sc = paged_layout(torch, g, b=4, n=4 * mp + 3, page=page,
                                                      mp=mp, hk=hk, d=64, dv=64,
                                                      lengths=[cap] * 4, quant=quant)
                    q = rn(4, t, hq, 64)
                    start = torch.tensor([0, cap - t, 5, cap // 2], dtype=torch.int32,
                                         device="cuda")
                    s = 0.125 if scale is None else scale
                    got = K.flash_paged_chunk_attention(q, pk, pv, tables, start, scale=scale,
                                                        **sc)
                    check_close(torch, f"flash_paged_chunk_attention {tag}", got,
                                K.flash_paged_chunk_attention_plain(
                                    q, pk, pv, tables, start, s, sc.get("k_scales"),
                                    sc.get("v_scales")), **tol)
                    if not quant and not torch.equal(got, K.flash_chunk_attention(
                            q, K.gather_pages(pk, tables), K.gather_pages(pv, tables), start,
                            scale=scale)):
                        fail(f"flash_paged_chunk_attention {tag}: not bitwise equal to "
                             "flash_chunk_attention")
                    n += 2
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


def kernels_phase(torch, K, cfg, n_slots, chunk, cache_cap, page, pools, limit_line):
    timer = Timer(torch)
    g = torch.Generator(device="cuda")
    g.manual_seed(1)

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    F = torch.nn.functional
    results, by_tag = {}, {}
    full_tol = dict(atol=1e-4, rtol=1e-4)

    def record(name, tag, shape_tag, err, ms, plain_ms, lib_ms, flops, nbytes,
               mode=None, dense_ms=None):
        by_tag[(name, tag)] = ms
        b_ms, b_by = bound(flops, nbytes)
        other = (f"library {lib_ms:.4g} ms" if dense_ms is None
                 else f"dense kernel {dense_ms:.4g} ms")
        say(f"  {name:27s} {shape_tag:44s} err {err:.2e}  kernel {ms:.4g} ms  "
            f"plain {plain_ms:.4g} ms  {other}  bound {b_ms:.4g} ms ({b_by})  "
            f"[{limit_line}]")
        entry = dict(shape=shape_tag, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                     library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        if dense_ms is not None:
            entry["dense_kernel_ms"] = dense_ms
        if name not in results:
            results[name] = entry
        elif mode is not None and mode not in results[name]:
            results[name][mode] = entry
        else:
            target = results[name] if mode is None else results[name][mode]
            target["max_abs_err"] = max(target["max_abs_err"], err)

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

    # the paged kernels at the engine's shapes: pools of the serving phases
    # (fp32: 256 blocks, int8: the block count of equal bytes), page 16
    mp = cache_cap // page
    t = chunk
    for mode, n_blocks in pools.items():
        quant = mode == "int8"
        item = 1 if quant else 4
        lens = [731, 400, 129, 0]
        pk, pv, tables, sc = paged_layout(torch, g, b=n_slots, n=n_blocks, page=page, mp=mp,
                                          hk=hk, d=dh, dv=dh, lengths=lens, quant=quant)
        q = rn(n_slots, hq, dh)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        sc_ = 1.0 / math.sqrt(dh)
        k, v = K.gather_pages(pk, tables, sc.get("k_scales")), \
            K.gather_pages(pv, tables, sc.get("v_scales"))
        got = K.flash_paged_decode(q, pk, pv, tables, lengths, **sc)
        err = check_close(torch, f"flash_paged_decode {mode}", got,
                          K.flash_paged_decode_plain(q, pk, pv, tables, lengths, sc_,
                                                     sc.get("k_scales"), sc.get("v_scales")),
                          **full_tol)
        if not quant and not torch.equal(got, K.flash_decode(q, k, v, lengths)):
            fail("flash_paged_decode fp32: not bitwise equal to flash_decode at full width")
        ms = timer.ms(lambda: K.flash_paged_decode(q, pk, pv, tables, lengths, **sc))
        plain = timer.ms(lambda: K.flash_paged_decode_plain(
            q, pk, pv, tables, lengths, sc_, sc.get("k_scales"), sc.get("v_scales")))
        dense = timer.ms(lambda: K.flash_decode(q, k, v, lengths))
        live = sum(lens)
        pages_live = sum(-(-x // page) for x in lens)
        record("flash_paged_decode", f"{mode} engine decode",
               f"{mode} B={n_slots} P={page} MP={mp} N={n_blocks} len={lens}", err, ms, plain,
               None, 2.0 * live * hq * 2 * dh,
               item * live * hk * 2 * dh + (8.0 * pages_live * hk if quant else 0.0)
               + 4.0 * (pages_live + 2 * n_slots * hq * dh + n_slots),
               mode=mode, dense_ms=dense)
        starts = [640, 320, 64, 0]
        ends = [s0 + t for s0 in starts]
        pk, pv, tables, sc = paged_layout(torch, g, b=n_slots, n=n_blocks, page=page, mp=mp,
                                          hk=hk, d=dh, dv=dh, lengths=ends, quant=quant)
        q = rn(n_slots, t, hq, dh)
        start = torch.tensor(starts, dtype=torch.int32, device="cuda")
        k, v = K.gather_pages(pk, tables, sc.get("k_scales")), \
            K.gather_pages(pv, tables, sc.get("v_scales"))
        got = K.flash_paged_chunk_attention(q, pk, pv, tables, start, **sc)
        err = check_close(torch, f"flash_paged_chunk_attention {mode}", got,
                          K.flash_paged_chunk_attention_plain(
                              q, pk, pv, tables, start, sc_, sc.get("k_scales"),
                              sc.get("v_scales")), **full_tol)
        if not quant and not torch.equal(got, K.flash_chunk_attention(q, k, v, start)):
            fail("flash_paged_chunk_attention fp32: not bitwise equal to "
                 "flash_chunk_attention at full width")
        ms = timer.ms(lambda: K.flash_paged_chunk_attention(q, pk, pv, tables, start, **sc))
        plain = timer.ms(lambda: K.flash_paged_chunk_attention_plain(
            q, pk, pv, tables, start, sc_, sc.get("k_scales"), sc.get("v_scales")))
        dense = timer.ms(lambda: K.flash_chunk_attention(q, k, v, start))
        cols = sum(min(cache_cap, s0 + i + 1) for s0 in starts for i in range(t))
        rows_read = sum(min(cache_cap, e) for e in ends)
        pages_live = sum(-(-e // page) for e in ends)
        record("flash_paged_chunk_attention", f"{mode} engine prefill",
               f"{mode} B={n_slots} T={t} P={page} N={n_blocks} start={starts}", err, ms, plain,
               None, 2.0 * cols * hq * 2 * dh,
               item * rows_read * hk * 2 * dh + (8.0 * pages_live * hk if quant else 0.0)
               + 4.0 * (pages_live + 2 * n_slots * t * hq * dh + n_slots),
               mode=mode, dense_ms=dense)
        del pk, pv, k, v, q

    # the cache writes of the three serving paths (plain PyTorch ops, not
    # kernels): each copies its whole cache or pool (functional, as in JAX);
    # the int8 write also requantizes the whole pool
    from repro_torch.core.registry import get_impl
    ops_ms = {}
    for phase, tt in (("decode", 1), ("prefill", t)):
        new = rn(n_slots, tt, hk, dh)
        begin = torch.tensor([731, 400, 129, 0] if tt == 1 else [640, 320, 64, 0],
                             dtype=torch.int32, device="cuda")
        n_new = torch.tensor([tt, tt, tt, 0], dtype=torch.int32, device="cuda")
        cache = torch.zeros(n_slots, cache_cap, hk, dh, device="cuda")
        fn = get_impl("cache_update", "ref")
        ops_ms[("dense", phase)] = timer.ms(lambda: fn([cache, new, begin, n_new], {}))
        del cache
        for mode, n_blocks in pools.items():
            tables = torch.arange(n_slots * mp, dtype=torch.int32,
                                  device="cuda").reshape(n_slots, mp) % n_blocks
            if mode == "int8":
                pool = torch.zeros(n_blocks, page, hk, dh, dtype=torch.int8, device="cuda")
                scales = torch.zeros(n_blocks, hk, device="cuda")
                fn = get_impl("paged_cache_update_q", "ref")
                args = [pool, scales, new, tables, begin, n_new]
            else:
                pool = torch.zeros(n_blocks, page, hk, dh, device="cuda")
                fn = get_impl("paged_cache_update", "ref")
                args = [pool, new, tables, begin, n_new]
            ops_ms[(f"paged {mode}", phase)] = timer.ms(lambda: fn(args, {}))
            del pool, args
    for (path, phase), ms in ops_ms.items():
        say(f"  cache write op ({path}, {phase}) {ms:.4g} ms per call, "
            f"{2 * cfg.n_layers} calls per tick  [{limit_line}]")
    del timer
    torch.cuda.empty_cache()
    return results, by_tag, ops_ms


def tick_estimate(by_tag, ops_ms, n_layers, path):
    """Milliseconds of one engine tick of a serving path, by part: each
    kernel's time at the tick's shapes (phase 3) times its launches per
    tick, and the cache-write ops' time times their calls per tick.
    Attention is timed at representative cache lengths, not the run's
    own.  Each part was timed alone, from its first launch to its last
    kernel's end; in the engine the host's dispatch of one part overlaps
    the device work of the one before, so the parts can add up to more
    than the tick."""
    L = n_layers
    out = {}
    for phase, attn in (("decode", "flash_decode"), ("prefill", "flash_chunk_attention")):
        tag = f"engine {phase}"

        def g(what):
            return by_tag[("gemm", f"{tag} {what}")]

        if path == "dense":
            attn_ms = by_tag[(attn, tag)]
        else:
            mode = path.split()[-1]
            attn_ms = by_tag[(attn.replace("flash_", "flash_paged_"), f"{mode} {tag}")]
        out[phase] = {
            "gemm": 4 * L * g("q/k/v/o") + 2 * L * g("gate/up") + L * g("down") + g("lm_head"),
            "rmsnorm": (2 * L + 1) * by_tag[("rmsnorm", tag)],
            "attention": L * attn_ms,
            "cache writes": 2 * L * ops_ms[(path, phase)],
        }
    return out


# --------------------------------------------------------------------------- #
# phase 4: small model, card vs CPU
# --------------------------------------------------------------------------- #

def model_phase(torch):
    """Returns the worst |card - CPU| over the dense and paged fp32 Programs'
    outputs (tolerance 1e-4) and over the int8-paged Programs' logits
    (bound 5e-2: a K/V value an ulp apart on the two sides can round to
    another int8 level).  int8 pages may differ by one level and scales by
    1e-4 relative."""
    import numpy as np
    from repro_torch.core.program import compile
    from repro_torch.models.graph_lm import (GraphLMConfig, build_decode_graph,
                                             build_paged_decode_graph,
                                             build_paged_prefill_graph,
                                             build_prefill_graph, init_lm_params)
    cfg = GraphLMConfig(vocab=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=96)
    params = init_lm_params(cfg, seed=3)
    rng = np.random.default_rng(3)
    b, t, cap = 3, 16, 40
    page, mp = 5, 8                               # cap = 40 logical rows
    n_blocks = b * mp + 2
    tables = rng.permutation(n_blocks)[:b * mp].reshape(b, mp).astype(np.int32)
    paged = dict(n_blocks=n_blocks, page_size=page, max_pages=mp)
    graphs = [(build_prefill_graph(cfg, params, batch=b, chunk=t, cache_cap=cap), t),
              (build_decode_graph(cfg, params, batch=b, cache_cap=cap), 1)]
    for kv in ("float32", "int8"):
        graphs += [(build_paged_prefill_graph(cfg, params, batch=b, chunk=t, kv_dtype=kv,
                                              **paged), t),
                   (build_paged_decode_graph(cfg, params, batch=b, kv_dtype=kv, **paged), 1)]
    worst, worst_kv8 = 0.0, 0.0
    for graph, tt in graphs:
        inputs = {"tokens": rng.integers(0, cfg.vocab, (b, tt)).astype(np.int32),
                  "start": np.array([0, 7, cap - tt], np.int32),
                  "n_new": np.array([tt, 0, tt], np.int32)}
        if "block_tables" in graph.inputs:
            inputs["block_tables"] = tables
        for name, spec in graph.inputs.items():
            if not name.startswith("cache_"):
                continue
            if spec.dtype == "int8":
                inputs[name] = rng.integers(-127, 128, spec.shape).astype(np.int8)
            elif name.endswith("_scale"):
                inputs[name] = (rng.random(spec.shape) * 0.05).astype(np.float32)
            else:
                inputs[name] = rng.standard_normal(spec.shape).astype(np.float32)
        on_card = compile(graph, device="cuda")(**inputs)
        on_cpu = compile(graph, device="cpu")(**inputs)
        kv8 = "kv8" in graph.name
        for name, got, want in zip(graph.outputs, on_card, on_cpu):
            got = got.cpu()
            if not kv8:
                worst = max(worst, check_close(torch, f"{graph.name} {name}", got, want,
                                               atol=1e-4, rtol=1e-4))
            elif name == "logits":
                worst_kv8 = max(worst_kv8, check_close(torch, f"{graph.name} {name}", got,
                                                       want, atol=5e-2, rtol=0.0))
            elif got.dtype == torch.int8:
                if int((got.int() - want.int()).abs().max()) > 1:
                    fail(f"{graph.name} {name}: int8 pages differ by more than one level")
            else:
                check_close(torch, f"{graph.name} {name}", got, want, atol=0.0, rtol=1e-4)
    return worst, worst_kv8


# --------------------------------------------------------------------------- #
# phase 5: serving at full width
# --------------------------------------------------------------------------- #

def serving_phase(torch, K, cfg, params, n_slots, chunk, cache_cap, n_requests, max_new):
    """Returns the launches, the serving numbers, and each request's prompt
    with the reference's tokens (phases 6 and 7 serve the same prompts)."""
    import numpy as np
    from repro_torch.runtime.engine import EngineRequest, build_lm_serving

    t0 = time.perf_counter()
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
        if (n == 0) != name.startswith("flash_paged"):
            fail(f"kernel {name}: {n} launches by the dense-cache engine")
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
    served = []
    for r in reqs:
        want = reference.generate(r.prompt, max_new, chunk=chunk)
        if r.out_tokens != want:
            fail(f"request {r.uid}: engine {r.out_tokens} != reference {want}")
        served.append((r.prompt, want))
    say(f"  all {len(reqs)} requests token-exact against the unbatched reference "
        f"({time.perf_counter() - t_ref:.2f} s)")
    return launches, stats, served


def first_divergence(got, want):
    """Index of the first token where two streams differ, or None."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            return i
    return None if len(got) == len(want) else min(len(got), len(want))


def paged_serving_phase(torch, K, cfg, params, served, ref_cache, *, n_slots, chunk,
                        cache_cap, page, n_blocks, kv_dtype, max_new, card):
    """Phases 6 and 7: the paged engine in two waves (see the module
    docstring).  ``served`` is phase 5's (prompt, reference tokens) list;
    ``ref_cache`` maps a prompt's bytes to the dense reference's tokens and
    is filled here, so phase 7 reuses phase 6's reference runs.  Returns
    the launches, the serving numbers and the agreement record."""
    import numpy as np
    from repro_torch.runtime.engine import EngineRequest, build_lm_serving

    t0 = time.perf_counter()
    engine, reference = build_lm_serving(cfg, n_slots=n_slots, chunk=chunk,
                                         cache_cap=cache_cap, params=params, paged=True,
                                         page_size=page, n_blocks=n_blocks,
                                         kv_dtype=kv_dtype, device="cuda")
    st, pool = engine.stepper, engine.stepper.pool
    say(f"  {kv_dtype} pool: {n_blocks} blocks of {page} rows, "
        f"{pool.page_bytes * n_blocks / 1e9:.3f} GB ({pool.page_bytes} B per page); "
        f"engine built in {time.perf_counter() - t0:.1f} s")
    q = "_q" if kv_dtype == "int8" else ""
    summary = st.backend_summary()
    for phase, op in (("prefill", f"paged_chunk_attention{q}"),
                      ("decode", f"paged_decode_attention{q}"),
                      ("prefill", "dense"), ("decode", "dense"), ("decode", "rmsnorm")):
        if set(summary[phase][op]) != {"cuda"}:
            fail(f"{kv_dtype} {phase} {op} assigned {summary[phase][op]}, expected cuda only")
    say(f"  step assignment: {json.dumps(summary, sort_keys=True)}")

    rng = np.random.default_rng(1)
    shared = rng.integers(0, cfg.vocab, 512).astype(np.int32)      # S

    def extend(tail_len):
        return np.concatenate([shared, rng.integers(0, cfg.vocab, tail_len).astype(np.int32)])

    wave1 = [EngineRequest(uid=i, prompt=p, max_new_tokens=max_new)
             for i, (p, _) in enumerate(served)]
    a = EngineRequest(uid=len(wave1), prompt=extend(40), max_new_tokens=max_new)
    wave1.append(a)              # last: its pages are the newest cached ones
    b_prompt, c_prompt = extend(24), extend(80)
    torch.cuda.reset_peak_memory_stats()
    for kern in K.KERNELS:
        kern.launches = 0
    t_run = time.perf_counter()
    for r in wave1:
        if not engine.submit(r):
            fail(f"{kv_dtype} request {r.uid} rejected: {r.dropped}")
    engine.run()
    # D: A's written stream (its prompt and every output but the last,
    # which is emitted and never written) plus one diverging token
    stream = np.concatenate([a.prompt, np.asarray(a.out_tokens[:-1], np.int32)])
    d_prompt = np.concatenate([stream, np.asarray([(a.out_tokens[-1] + 1) % cfg.vocab],
                                                  np.int32)])
    hits0, cow0 = pool.hit_tokens, pool.cow_count
    wave2 = [EngineRequest(uid=len(wave1) + i, prompt=p, max_new_tokens=max_new)
             for i, p in enumerate((b_prompt, c_prompt, d_prompt))]
    for r in wave2:
        if not engine.submit(r):
            fail(f"{kv_dtype} request {r.uid} rejected: {r.dropped}")
    engine.run()
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t_run
    launches = {kern.__name__: kern.launches for kern in K.KERNELS}
    hits, cows = pool.hit_tokens - hits0, pool.cow_count - cow0
    pool.check_integrity()
    m = engine.metrics
    reqs = wave1 + wave2
    say(f"  engine: {len(reqs)} requests in two waves, {m.tokens_out} tokens in "
        f"{t_run:.2f} s; {m.prefill_ticks} prefill + {m.decode_ticks} decode ticks; "
        f"D = {len(stream)} written rows of A ({len(stream) % page} in a partial page) + 1")
    say(f"  pool: wave 2 prefix hits {hits} tokens, {cows} copy-on-write copies; "
        f"stats {json.dumps(pool.stats())}")
    say(f"  launches during the engine run: {launches}")
    if any(not r.done or len(r.out_tokens) != max_new for r in reqs):
        fail(f"{kv_dtype}: not every request finished with its tokens")
    need = 2 * len(shared) + len(d_prompt) - 1
    if hits < need or cows < 1:
        fail(f"{kv_dtype}: wave 2 hit {hits} tokens (need >= {need}) with {cows} copies "
             "(need >= 1)")
    L, ticks = cfg.n_layers, m.prefill_ticks + m.decode_ticks
    want = {"gemm": (7 * L + 1) * ticks, "rmsnorm": (2 * L + 1) * ticks,
            "flash_paged_chunk_attention": L * m.prefill_ticks,
            "flash_paged_decode": L * m.decode_ticks,
            "flash_decode": 0, "flash_chunk_attention": 0}
    if launches != want:
        fail(f"{kv_dtype}: launches {launches} != expected {want}")
    stats = {
        "tokens_per_s": m.tokens_per_s,
        "ttft_p50_s": m.summary()["ttft_s"]["p50"],
        "decode_ms_per_tick": 1e3 * m.decode_wall_s / max(m.decode_ticks, 1),
        "prefill_ms_per_tick": 1e3 * m.prefill_wall_s / max(m.prefill_ticks, 1),
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "engine_wall_s": t_run,
        "prefill_ticks": m.prefill_ticks,
        "decode_ticks": m.decode_ticks,
        "wave2_hit_tokens": hits,
        "wave2_cow_copies": cows,
    }
    say(f"  serving ({kv_dtype} pages): {json.dumps(stats)} [{card}]")

    t_ref = time.perf_counter()
    known = {p.tobytes(): toks for p, toks in served}
    known.update(ref_cache)
    agreement = {"exact": 0, "requests": len(reqs), "first_divergence": {}}
    for r in reqs:
        key = r.prompt.tobytes()
        if key not in known:
            known[key] = ref_cache[key] = reference.generate(r.prompt, max_new, chunk=chunk)
        div = first_divergence(r.out_tokens, known[key])
        if div is None:
            agreement["exact"] += 1
        else:
            agreement["first_divergence"][r.uid] = div
            if kv_dtype == "float32":
                fail(f"paged request {r.uid} (prompt {len(r.prompt)}): engine {r.out_tokens} "
                     f"!= reference {known[key]}")
    say(f"  {agreement['exact']} of {len(reqs)} requests token-exact against the dense fp32 "
        f"reference; first divergence (request: token index) "
        f"{agreement['first_divergence']} ({time.perf_counter() - t_ref:.2f} s)")
    return launches, stats, agreement


class Kernels:
    """The port's four kernel wrappers and their plain versions."""

    def __init__(self):
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import flash_decode as fd
        from repro_torch.kernels.gemm import gemm, gemm_plain
        from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain
        self.gemm, self.gemm_plain = gemm, gemm_plain
        self.rmsnorm, self.rmsnorm_plain = rmsnorm, rmsnorm_plain
        self.flash_decode, self.flash_decode_plain = fd.flash_decode, fd.flash_decode_plain
        self.flash_chunk_attention = fa.flash_chunk_attention
        self.flash_chunk_attention_plain = fa.flash_chunk_attention_plain
        self.flash_paged_decode = fd.flash_paged_decode
        self.flash_paged_decode_plain = fd.flash_paged_decode_plain
        self.flash_paged_chunk_attention = fa.flash_paged_chunk_attention
        self.flash_paged_chunk_attention_plain = fa.flash_paged_chunk_attention_plain
        self.gather_pages = fd.gather_pages
        self.KERNELS = (gemm, rmsnorm, fd.flash_decode, fa.flash_chunk_attention,
                        fd.flash_paged_decode, fa.flash_paged_chunk_attention)


SOURCES = {
    "gemm": ("src/repro_torch/csrc/gemm.cu", "src/repro/kernels/gemm.py:64"),
    "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm.py:39"),
    "flash_decode": ("src/repro_torch/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_decode.py:148"),
    "flash_chunk_attention": ("src/repro_torch/csrc/flash_attention.cu",
                              "src/repro/kernels/flash_attention.py:207"),
    "flash_paged_decode": ("src/repro_torch/csrc/flash_decode.cu",
                           "src/repro/kernels/flash_decode.py:206"),
    "flash_paged_chunk_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                    "src/repro/kernels/flash_attention.py:297"),
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
    from repro_torch.models.graph_lm import GraphLMConfig, init_lm_params_torch
    from repro_torch.runtime.kv_cache import kv_page_bytes
    resolve_device("cuda")  # pins fp32 matmuls (no TF32) for the plain versions
    K = Kernels()

    # phi3-mini-3.8b widths (src/repro/configs/phi3_mini_3_8b.py): d_model 3072,
    # 32 heads, 32 kv heads (d_head 96), SwiGLU d_ff 8192, vocab 32064, 32 layers
    cfg = GraphLMConfig(vocab=32064, d_model=3072, n_layers=32, n_heads=32,
                        n_kv_heads=32, d_ff=8192)
    n_slots, chunk, cache_cap, page, max_new = 4, 64, 1024, 16, 32
    # the paged pools: fp32 with the dense cache's memory (build_lm_serving's
    # default), int8 with the same bytes
    n_fp32 = n_slots * (cache_cap // page)
    n_int8 = n_fp32 * kv_page_bytes(cfg.n_layers, cfg.n_kv_heads, cfg.d_head, page) \
        // kv_page_bytes(cfg.n_layers, cfg.n_kv_heads, cfg.d_head, page, "int8")
    pools = {"fp32": n_fp32, "int8": n_int8}

    # 3. kernels
    t = time.perf_counter()
    n_cases = kernel_cases(torch, K)
    say(f"[kernels] {n_cases} small cases match their plain versions "
        f"(atol = rtol = 2e-5); fp32 paged outputs bitwise equal to the dense kernels")
    say(f"[kernels] full-width shapes (tolerance atol = rtol = 1e-4; median of 15 "
        f"cold-L2 launches; bound from 67 TFLOP/s fp32 and 3.35 TB/s):")
    results, by_tag, ops_ms = kernels_phase(torch, K, cfg, n_slots, chunk, cache_cap, page,
                                            pools, limit_line)
    phase_s["kernels"] = time.perf_counter() - t

    # 4. small model, card vs CPU
    t = time.perf_counter()
    worst, worst_kv8 = model_phase(torch)
    say(f"[model] small model prefill + decode Programs, dense and paged fp32: card vs CPU "
        f"max |err| {worst:.2e} (atol = rtol = 1e-4); paged int8: max |logit err| "
        f"{worst_kv8:.2e} (bound 5e-2)")
    phase_s["model"] = time.perf_counter() - t

    t = time.perf_counter()
    params = init_lm_params_torch(cfg, seed=0, device="cuda")
    phase_s["weights"] = time.perf_counter() - t
    estimates, serving = {}, {}

    # 5. serving, dense cache
    t = time.perf_counter()
    say(f"[serving] phi3-mini widths, {cfg.n_layers} layers, {n_slots} slots, chunk {chunk}, "
        f"cache {cache_cap} [{limit_line}]")
    launches, stats, served = serving_phase(torch, K, cfg, params, n_slots, chunk, cache_cap,
                                            n_requests=8, max_new=max_new)
    torch.cuda.empty_cache()
    phase_s["serving"] = time.perf_counter() - t
    runs = {"dense": (launches, stats)}

    # 6. and 7. serving, paged cache
    ref_cache = {}
    agreement = {}
    for phase, mode, kv_dtype in (("paged", "fp32", "float32"), ("kv8", "int8", "int8")):
        t = time.perf_counter()
        say(f"[{phase}] phi3-mini widths, {cfg.n_layers} layers, {n_slots} slots, chunk "
            f"{chunk}, cache {cache_cap}, {kv_dtype} pages of {page} rows, {pools[mode]} "
            f"blocks [{limit_line}]")
        launches, stats, agree = paged_serving_phase(
            torch, K, cfg, params, served, ref_cache, n_slots=n_slots, chunk=chunk,
            cache_cap=cache_cap, page=page, n_blocks=pools[mode], kv_dtype=kv_dtype,
            max_new=max_new, card=limit_line)
        torch.cuda.empty_cache()
        runs[f"paged {mode}"] = (launches, stats)
        agreement[mode] = agree
        phase_s[phase] = time.perf_counter() - t

    for path, (_, stats) in runs.items():
        estimates[path] = tick_estimate(by_tag, ops_ms, cfg.n_layers, path)
        serving[path] = stats
        for phase in ("decode", "prefill"):
            tick_ms = stats[f"{phase}_ms_per_tick"]
            parts_ms = estimates[path][phase]
            rest = tick_ms - sum(parts_ms.values())
            parts = ", ".join(f"{k} {v:.2f} ms ({100 * v / tick_ms:.0f}%)"
                              for k, v in parts_ms.items())
            say(f"[breakdown] {path} {phase} tick {tick_ms:.2f} ms: {parts}, remainder "
                f"(other plain ops, logits to host, Python, less the overlap of parts "
                f"timed alone) {rest:.2f} ms ({100 * rest / tick_ms:.0f}%) [{limit_line}]")
    phase_s["total"] = time.perf_counter() - t_start
    say(f"[done] wall seconds per phase {json.dumps(phase_s)}")

    kernels = []
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    for name, (source, replaces) in SOURCES.items():
        r = results[name]
        by_path = {path: run[0][name] for path, run in runs.items()}
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": sum(by_path.values()), "launches_by_path": by_path,
                 **{k: r[k] for k in keys}}
        if "int8" in r:
            entry["dense_kernel_ms"] = r["dense_kernel_ms"]
            entry["fp32"] = {"launches": by_path["paged fp32"],
                             **{k: r[k] for k in keys}, "dense_kernel_ms": r["dense_kernel_ms"]}
            entry["int8"] = {"launches": by_path["paged int8"],
                             **{k: r["int8"][k] for k in keys},
                             "dense_kernel_ms": r["int8"]["dense_kernel_ms"]}
        kernels.append(entry)
    say(json.dumps({"serving": serving, "tick_ms_by_part": estimates,
                    "kv8_agreement": agreement, "card": limit_line}))
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
