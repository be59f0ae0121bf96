"""Serving entry point: continuous batching over a layer-stack LM, or the
Program-backed engine over the graph LM — counterpart of
:mod:`repro.launch.serve`.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b [--full] \\
        [--device cpu] [--requests 16 --slots 4 --cache-cap 64 --max-new 12]

    PYTHONPATH=src python -m repro_torch.launch.serve --engine [--paged] \\
        [--kv-dtype int8] [--device cpu] --requests 16 --slots 4 --chunk 8

Default mode submits a stream of random-prompt requests and runs the
slot-based continuous batcher (prefill on admit, batched decode) over a
:class:`repro_torch.models.lm.LM` with random weights from seed 0; it
serves the reduced config, or with ``--full`` the published one in fp32
(every kernel of the port is fp32; that is the one change from the
published config).  On the card every op runs on the port's hand-written
kernels (:data:`repro_torch.models.lm.CUDA_BACKENDS`); ``--device cpu``
runs the plain ``ref`` backends.  Without ``--device`` it needs a
card and raises without one.  ``--engine`` instead serves the graph LM
through :func:`repro_torch.runtime.engine.build_lm_serving`.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.models.lm import CUDA_BACKENDS, LM
from repro_torch.runtime.batching import ContinuousBatcher, Request


def serving_config(arch: str, *, full: bool = False, device: DeviceLike = None) -> ArchConfig:
    """The config the entry point serves: ``get_reduced(arch)``, or with ``full``
    the published config in fp32; on the card with the kernels' backends."""
    cfg = get_config(arch) if full else get_reduced(arch)
    if full:
        cfg = cfg.with_overrides(dtype="float32", param_dtype="float32")
    if resolve_device(device).type == "cuda":
        cfg = cfg.with_overrides(backends={**cfg.backends, **CUDA_BACKENDS})
    return cfg


def run_engine(args) -> None:
    from repro_torch.models.graph_lm import GraphLMConfig
    from repro_torch.runtime.engine import EngineRequest, build_lm_serving

    cfg = GraphLMConfig()
    cache_cap = max(args.cache_cap, args.chunk + args.max_new + 16)
    paged = args.paged or args.kv_dtype != "float32"
    engine, _ = build_lm_serving(cfg, n_slots=args.slots, chunk=args.chunk,
                                 cache_cap=cache_cap, paged=paged, kv_dtype=args.kv_dtype,
                                 device=args.device)
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, size=int(rng.integers(2, 14))).astype(np.int32)
        reqs.append(EngineRequest(uid=i, prompt=prompt, max_new_tokens=args.max_new))
    for r in reqs:
        engine.submit(r)
    engine.run(max_ticks=100_000)
    print(f"engine: slots={args.slots} chunk={args.chunk} paged={paged} "
          f"kv_dtype={args.kv_dtype} requests={len(reqs)}")
    print(json.dumps(engine.metrics.summary(), indent=1, sort_keys=True))
    for r in reqs[:3]:
        print(f"  req{r.uid}: prompt[:4]={r.prompt[:4].tolist()} "
              f"-> out[:6]={r.out_tokens[:6]}")


def run_batcher(args) -> None:
    device = resolve_device(args.device)
    cfg = serving_config(args.arch, full=args.full, device=device)
    if cfg.frontend == "embeds":
        raise SystemExit("the batcher serves token-LM archs")
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
    print(f"arch={cfg.name} device={device} requests={len(reqs)} slots={args.slots}")
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
                    help="the published config (fp32) instead of the reduced one")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a card)")
    ap.add_argument("--engine", action="store_true",
                    help="serve compiled Programs via the serving engine")
    ap.add_argument("--paged", action="store_true",
                    help="with --engine: serve through the paged KV cache")
    ap.add_argument("--kv-dtype", choices=("float32", "int8"), default="float32",
                    help="with --engine: paged KV page storage dtype (int8 implies --paged)")
    ap.add_argument("--chunk", type=int, default=8,
                    help="with --engine: prefill chunk size")
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
