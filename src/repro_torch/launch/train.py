"""End-to-end training driver — counterpart of :mod:`repro.launch.train`,
on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b \\
        --reduced --device cpu --steps 300 --batch 8 --seq 64 --ckpt-dir build/ckpt

Wires together the training layers of the port: config -> model -> train
step (:func:`repro_torch.runtime.train.make_train_step`) -> synthetic data
with prefetch -> AdamW + cosine schedule -> checkpoint manager (async,
rotated, SIGTERM-safe) -> straggler watchdog -> auto-resume from the
latest checkpoint.  The flags, the loop and the log lines are JAX's, plus
``--device`` (default ``cuda``, which raises without a card; the CPU only
when asked for).  The weights are ``init_params(seed=0)``, as JAX's driver
fixes ``PRNGKey(0)`` (the port's draws, not JAX's numbers); the batches are
JAX's bit for bit, and the checkpoints are in JAX's format, so either
driver resumes the other's run.  ``--reduced`` uses the smoke-scale config
so the loop runs on the CPU.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_reduced
from repro_torch.core.device import resolve_device, to_tensor
from repro_torch.core.tree import tree_leaves
from repro_torch.data import PrefetchLoader, SyntheticLM
from repro_torch.ft import StepWatchdog
from repro_torch.models.encdec import EncDec
from repro_torch.models.lm import LM, strip_derived
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.runtime.train import make_train_step


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-mini-3.8b")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-interval", type=int, default=100)
    ap.add_argument("--log-interval", type=int, default=10)
    ap.add_argument("--d-model", type=int, default=None,
                    help="override width (e.g. ~100M model on CPU)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if args.d_model:
        import dataclasses
        head = max(args.d_model // max(cfg.n_heads, 1), 8)
        cfg = dataclasses.replace(cfg, d_model=args.d_model,
                                  head_dim=head, d_ff=4 * args.d_model)
    model = EncDec(cfg) if cfg.n_encoder_layers else LM(cfg)

    opt_cfg = AdamWConfig(lr=args.lr,
                          schedule=warmup_cosine(args.lr, 20, args.steps))
    params = strip_derived(model.init_params(seed=0, device=dev))
    opt_state = adamw.init(params, opt_cfg)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"steps={args.steps} batch={args.batch}x{args.seq}")

    step_fn = make_train_step(model, cfg, opt_cfg, donate=False)
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq, batch=args.batch,
                     seed=0)

    def batch_fn(i):
        b = dict(ds.batch_at(i))
        if cfg.n_encoder_layers:
            b["src_embeds"] = np.random.default_rng(i).standard_normal(
                (args.batch, args.seq // 2, cfg.d_model), np.float32)
            b["tokens"] = b["tokens"][:, :args.seq // 2]
            b["labels"] = b["labels"][:, :args.seq // 2]
        elif cfg.frontend == "embeds":
            b["embeds"] = np.random.default_rng(i).standard_normal(
                (args.batch, args.seq, cfg.d_model), np.float32)
        return {k: to_tensor(v, dev) for k, v in b.items()}

    start_step = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, interval=args.ckpt_interval)
        latest = mgr.latest_step()
        if latest is not None:
            restored = mgr.restore({"params": params, "opt": opt_state}, step=latest)
            params, opt_state = restored["params"], restored["opt"]
            start_step = latest
            print(f"resumed from step {latest}")
        mgr.save_on_signal(lambda: (step_holder[0],
                                    {"params": params, "opt": opt_state}))

    loader = PrefetchLoader(batch_fn, start_step=start_step, prefetch=2)
    wd = StepWatchdog()
    step_holder = [start_step]
    losses = []
    t0 = time.time()
    try:
        for _ in range(start_step, args.steps):
            step_i, batch = next(loader)
            wd.start()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            straggler = wd.stop()
            step_holder[0] = step_i + 1
            losses.append(float(metrics["loss"]))
            if mgr:
                mgr.maybe_save(step_i + 1, {"params": params, "opt": opt_state},
                               {"loss": losses[-1]})
            if (step_i + 1) % args.log_interval == 0:
                tok_s = (args.batch * args.seq * args.log_interval
                         / max(time.time() - t0, 1e-9))
                flag = " STRAGGLER" if straggler else ""
                print(f"step {step_i+1:5d} loss {losses[-1]:.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.2f} "
                      f"{tok_s:,.0f} tok/s{flag}")
                t0 = time.time()
    finally:
        loader.close()
        if mgr:
            mgr.wait()
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f}); "
          f"stragglers: {len(wd.stragglers)}")


if __name__ == "__main__":
    main()
