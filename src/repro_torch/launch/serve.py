"""Serving entry point: continuous batching over a layer-stack LM, or the
Program-backed engine over the graph LM — counterpart of
:mod:`repro.launch.serve`.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b [--full] \\
        [--device cpu] [--requests 16 --slots 4 --cache-cap 64 --max-new 12]

    PYTHONPATH=src python -m repro_torch.launch.serve --engine [--int8] [--paged] \\
        [--kv-dtype int8] [--device cpu] --requests 16 --slots 4 --chunk 8

    PYTHONPATH=src python -m repro_torch.launch.serve --engine --tp 2 --device cuda:0

Default mode submits a stream of random-prompt requests and runs the
slot-based continuous batcher (prefill on admit, batched decode) over a
:class:`repro_torch.models.lm.LM` with random weights from seed 0 (the
attention configs, the MoE, MLA, SSD and hybrid ones); it serves the
reduced config (fp32), or with ``--full`` the published one at its
published bfloat16 (every config: each kernel op they run on the card has
a bf16 body, the MoE experts, MLA's absorbed decode and the Mamba2 scan
included; see :func:`serving_config`).  It prints the dtype it serves in.  Like JAX's entry point it serves token LMs
only: the encoder-decoder (seamless-m4t-medium, :class:`repro_torch.models.encdec.EncDec`)
and the ``embeds`` frontend (pixtral-12b) are refused.  On the card every
op runs on the port's hand-written
kernels (:data:`repro_torch.models.lm.CUDA_BACKENDS`); ``--device cpu``
runs the plain ``ref`` backends.  Without ``--device`` it needs a
card and raises without one.  ``--engine`` instead serves the graph LM
through :func:`repro_torch.runtime.engine.build_lm_serving` and prints the
lines ``repro.launch.serve --engine`` prints; with ``--int8`` the decode
and prefill Programs have int8 weights (one shared calibration).

``--tp N`` (or ``--mesh model=N``) serves the engine tensor-parallel over N
ranks, token-identical to one rank: the launcher spawns the N ranks
(:func:`repro_torch.launch.mesh.spawn_ranks`), or, started under
``torchrun``, joins the group the environment describes; every rank serves
the same requests and rank 0 prints the lines.  ``--device cuda`` gives each
rank a card of its own (NCCL), ``--device cuda:0`` puts every rank on card 0
(gloo), ``--device cpu`` runs the ranks on the CPU (gloo).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import ArchConfig, Block
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.kernels.flash_attention import attention_fits
from repro_torch.kernels.flash_decode import decode_fits
from repro_torch.kernels.ops import BF16_OPS
from repro_torch.models.lm import CUDA_BACKENDS, LM
from repro_torch.runtime.batching import ContinuousBatcher, Request


def kernel_ops(cfg: ArchConfig) -> set:
    """The kernel ops ``cfg``'s layers run on the card, as (op, widths):
    the attention ops with the (Hq, Hk, D, Dv) they are called at (MLA's
    prefill over its up-projected heads, its absorbed decode over the
    latent cache), every other op with None.  An encoder layer is an
    ``attn`` block."""
    ops = {("rmsnorm", None), ("dense", None)}
    blocks = list(cfg.plan.all_blocks()) + [Block("attn", "mlp")] * bool(cfg.n_encoder_layers)
    gqa = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.head_dim)
    for blk in blocks:
        if blk.mixer in ("attn", "attn_local", "shared_attn") or blk.cross:
            ops |= {("attention", gqa), ("decode_attention", gqa)}
        if blk.mixer == "mla":
            m, h = cfg.mla, cfg.n_heads
            ops |= {("attention", (h, h, m.qk_dim, m.v_dim)),
                    ("decode_attention", (h, 1, m.kv_lora_rank + m.rope_dim, m.kv_lora_rank)),
                    ("moe_gemm", None)}
        if blk.mixer == "mamba":
            ops.add(("ssd", None))
        if blk.ffn == "moe":
            ops.add(("moe_gemm", None))
    return ops


def has_bf16_bodies(cfg: ArchConfig) -> bool:
    """Whether every kernel op ``cfg`` runs on the card (:func:`kernel_ops`)
    has a bf16 body that takes its widths (ops.BF16_OPS; the attention
    kernels' fits at bf16, MLA's wide absorbed decode included).  It holds
    for every published config."""
    for op, widths in kernel_ops(cfg):
        if op not in BF16_OPS:
            return False
        if op == "attention" and not attention_fits(*widths):
            return False
        if op == "decode_attention" and not decode_fits(*widths, bf16=True):
            return False
    return True


def serving_config(arch: str, *, full: bool = False, device: DeviceLike = None) -> ArchConfig:
    """The config the entry point serves: ``get_reduced(arch)`` (fp32), or
    with ``full`` the published config at its published dtypes where every
    kernel op it runs on the card has a bf16 body (:func:`has_bf16_bodies`,
    which holds for every published config), else in fp32.  The dtype does
    not depend on the device: the CPU serves what the card would.  On the
    card the ops run on the kernels' backends."""
    cfg = get_config(arch) if full else get_reduced(arch)
    if full and not has_bf16_bodies(cfg):
        cfg = cfg.with_overrides(dtype="float32", param_dtype="float32")
    if resolve_device(device).type == "cuda":
        cfg = cfg.with_overrides(backends={**cfg.backends, **CUDA_BACKENDS})
    return cfg


def tp_degree(args) -> int:
    """The tensor-parallel degree ``--tp`` or ``--mesh model=N`` asks for
    (1 without either)."""
    if args.mesh:
        if args.tp is not None:
            raise SystemExit("pass --tp or --mesh, not both")
        axis, _, size = args.mesh.partition("=")
        if axis != "model" or not size.isdigit():
            raise SystemExit(f"--mesh wants model=N, got {args.mesh!r}")
        return int(size)
    return args.tp if args.tp is not None else 1


def run_engine(args) -> None:
    tp = tp_degree(args)
    if tp > 1 and "WORLD_SIZE" not in os.environ:
        from repro_torch.launch.mesh import spawn_ranks
        spawn_ranks(serve_engine, tp, args, tp)
        return
    serve_engine(args, tp)


def serve_engine(args, tp: int = 1) -> None:
    """Build the engine (one rank of ``tp`` when tp > 1), serve the
    requests and print the lines (rank 0 only)."""
    from repro_torch.models.graph_lm import GraphLMConfig
    from repro_torch.runtime.engine import EngineRequest, build_lm_serving

    cfg = GraphLMConfig()
    cache_cap = max(args.cache_cap, args.chunk + args.max_new + 16)
    paged = args.paged or args.kv_dtype != "float32"
    mesh = None
    if tp > 1 or args.tp is not None or args.mesh:
        from repro_torch.launch.mesh import make_serving_mesh
        mesh = make_serving_mesh(tp, device=args.device)
    engine, _ = build_lm_serving(cfg, n_slots=args.slots, chunk=args.chunk,
                                 cache_cap=cache_cap,
                                 quantize="int8" if args.int8 else None,
                                 paged=paged, kv_dtype=args.kv_dtype,
                                 device=None if mesh is not None else args.device, mesh=mesh)
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, size=int(rng.integers(2, 14))).astype(np.int32)
        reqs.append(EngineRequest(uid=i, prompt=prompt, max_new_tokens=args.max_new))
    for r in reqs:
        engine.submit(r)
    engine.run(max_ticks=100_000)
    if mesh is not None and mesh.rank != 0:
        return
    tp_note = ""
    if mesh is not None:
        part = engine.stepper.decode_program.partition
        tp_note = f" mesh={dict(part['mesh'])}" if part is not None else " mesh=?"
    print(f"engine: slots={args.slots} chunk={args.chunk} "
          f"int8={args.int8} paged={paged} kv_dtype={args.kv_dtype} "
          f"requests={len(reqs)}{tp_note}")
    print(json.dumps(engine.metrics.summary(), indent=1, sort_keys=True))
    if paged:
        s = engine.stepper.pool.stats()
        print(f"paged pool: {s['n_blocks']} blocks x {s['page_size']} rows "
              f"({s['kv_dtype']}, {s['page_bytes']}B/page), "
              f"hit rate {s['hit_rate']:.0%}, CoW {s['cow_count']}")
    for r in reqs[:3]:
        print(f"  req{r.uid}: prompt[:4]={r.prompt[:4].tolist()} "
              f"-> out[:6]={r.out_tokens[:6]}")


def run_batcher(args) -> None:
    device = resolve_device(args.device)
    cfg = serving_config(args.arch, full=args.full, device=device)
    if cfg.n_encoder_layers or cfg.frontend == "embeds":
        raise SystemExit("the batcher serves token-LM archs only")
    model = LM(cfg)
    params = model.init_params(0, device=device)
    batcher = ContinuousBatcher(model, params, n_slots=args.slots,
                                cache_cap=args.cache_cap, eos_id=1)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i,
                    prompt=rng.integers(2, cfg.vocab, size=int(rng.integers(4, 12))
                                        ).astype(np.int32),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    for r in reqs:
        batcher.submit(r)

    t0 = time.time()
    batcher.run(max_steps=5000)
    dt = time.time() - t0
    n_out = sum(len(r.out_tokens) for r in reqs)
    print(f"arch={cfg.name} device={device} dtype={cfg.dtype} requests={len(reqs)} "
          f"slots={args.slots}")
    print(f"generated {n_out} tokens in {dt:.2f}s ({n_out / dt:,.1f} tok/s), "
          f"decode steps={batcher.steps}, slot utilisation={batcher.utilisation:.0%}")
    print(f"completed {sum(r.done for r in reqs)}/{len(reqs)}")
    for r in reqs[:3]:
        print(f"  req{r.uid}: prompt[:4]={r.prompt[:4].tolist()} "
              f"-> out[:6]={r.out_tokens[:6]}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--full", action="store_true",
                    help="the published config instead of the reduced one (bf16 where every "
                         "kernel op it runs has a bf16 body, else fp32)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a card)")
    ap.add_argument("--engine", action="store_true",
                    help="serve compiled Programs via the serving engine")
    ap.add_argument("--int8", action="store_true",
                    help="with --engine: serve int8-quantized Programs")
    ap.add_argument("--paged", action="store_true",
                    help="with --engine: serve through the paged KV cache")
    ap.add_argument("--kv-dtype", choices=("float32", "int8"), default="float32",
                    help="with --engine: paged KV page storage dtype (int8 implies --paged)")
    ap.add_argument("--chunk", type=int, default=8,
                    help="with --engine: prefill chunk size")
    ap.add_argument("--tp", type=int, default=None,
                    help="with --engine: tensor-parallel degree (N ranks, spawned here "
                         "unless started under torchrun)")
    ap.add_argument("--mesh", default=None, metavar="model=N",
                    help="with --engine: the serving mesh (alternative to --tp)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-cap", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=12)
    args = ap.parse_args()
    if args.engine:
        run_engine(args)
    else:
        run_batcher(args)


if __name__ == "__main__":
    main()
