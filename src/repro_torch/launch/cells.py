"""Cells: (architecture x input shape) -> lowerable step + fake
arguments — counterpart of :mod:`repro.launch.cells`.

A *cell* is one entry of the assigned 10x4 grid.  ``build_cell`` returns
everything the dry-run needs: the step function on a mesh and fake-tensor
stand-ins for every argument (params, optimizer state, batch, caches), made
under one ``FakeTensorMode``: nothing is allocated on any device (JAX's
uses ``ShapeDtypeStruct``).  :meth:`Cell.lower` runs the step once on them
and returns its :class:`~repro_torch.core.lowering.Lowered` record (FLOPs,
bytes accessed, argument bytes, the mesh's collective records).

Step kinds:
  train    -> ``make_train_step`` (fwd + bwd + AdamW update; on a mesh the
              rank's param and optimizer slices, the global batch)
  prefill  -> ``make_prefill_step`` (forward + cache build)
  decode   -> ``make_decode_step`` (ONE new token vs a seq_len-deep cache;
              the rank's cache slices)

The serve steps take the params whole on every rank
(:mod:`repro_torch.runtime.serve`'s port-only design), so their FLOPs and
argument bytes a rank exceed JAX's per-chip numbers wherever GSPMD splits
a weight over "model".

Enc-dec conventions (seamless): train splits seq_len into src=tgt=S/2;
prefill encodes S frames + 1k decoder prefill; decode runs the decoder
against S-deep cross-attention KV with a 1k self cache.  Frontend stubs
(audio/vlm): embeds inputs replace token ids where the config says so.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Union

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig, ShapeCfg
from repro_torch.core.lowering import Lowered, fake_mode, lower_call

__all__ = ["build_cell", "Cell", "DEC_SELF_CAP", "ENC_DEC_PREFILL_TGT"]

DEC_SELF_CAP = 1024       # enc-dec decoder self-attention cache at decode
ENC_DEC_PREFILL_TGT = 1024


@dataclass
class Cell:
    name: str
    arch: str
    shape: str
    kind: str
    step: Callable            # called with **args
    args: Dict[str, Any]      # fake-tensor trees by argument name
    model: Any
    cfg: ArchConfig
    mesh: Any
    mode: Any                 # the FakeTensorMode of ``args``

    def lower(self) -> Lowered:
        """One call of the step on the fake arguments (nothing allocated,
        no kernel launched): its cost record."""
        return lower_call(self.step, self.args, mode=self.mode, mesh=self.mesh)


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _train_batch(cfg: ArchConfig, sc: ShapeCfg) -> Dict[str, Any]:
    b, s = sc.global_batch, sc.seq_len
    i32, dt = torch.int32, _dtype(cfg.dtype)
    if cfg.n_encoder_layers:
        half = s // 2
        return {"src_embeds": torch.empty((b, half, cfg.d_model), dtype=dt),
                "tokens": torch.empty((b, half), dtype=i32),
                "labels": torch.empty((b, half), dtype=i32)}
    if cfg.frontend == "embeds":
        return {"embeds": torch.empty((b, s, cfg.d_model), dtype=dt),
                "labels": torch.empty((b, s), dtype=i32)}
    return {"tokens": torch.empty((b, s), dtype=i32), "labels": torch.empty((b, s), dtype=i32)}


def build_cell(arch: str, shape: Union[str, ShapeCfg], mesh: Any = None,
               cfg: Optional[ArchConfig] = None, seq_shard_fallback: bool = True) -> Cell:
    """The cell of ``arch`` at ``shape`` (a name of ``cfg.shapes``, or a
    :class:`ShapeCfg`) on ``mesh`` (a ProcessMesh: one rank's view, e.g.
    :func:`repro_torch.launch.mesh.make_production_mesh`; ``None``: one
    device)."""
    from repro_torch.models.encdec import EncDec
    from repro_torch.models.lm import LM, strip_derived
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.serve import (make_decode_step, make_prefill_step,
                                           serve_shardings)
    from repro_torch.runtime.train import make_train_step, train_state_shardings
    from repro_torch.sharding.specs import shard_tree
    cfg = cfg or get_config(arch)
    sc = shape if isinstance(shape, ShapeCfg) else cfg.shape(shape)
    if sc.name in cfg.skip_shapes:
        raise ValueError(f"{arch}: shape {sc.name} is documented-skip (see DESIGN.md §4)")
    model = EncDec(cfg) if cfg.n_encoder_layers else LM(cfg)
    mode = fake_mode()
    name = f"{arch}/{sc.name}"
    b, s = sc.global_batch, sc.seq_len

    def cell(kind, step, **args):
        return Cell(name, arch, sc.name, kind, step, args, model, cfg, mesh, mode)

    if sc.kind == "train":
        opt_cfg = AdamWConfig()
        with mode:
            batch = _train_batch(cfg, sc)
            params = strip_derived(model.init_params(0, device="cpu"))
            opt = adamw.init(params, opt_cfg)
            if mesh is not None:
                p_spec, o_spec, _ = train_state_shardings(model, cfg, mesh, batch, opt_cfg)
                params, opt = shard_tree(params, p_spec, mesh), shard_tree(opt, o_spec, mesh)
        step = make_train_step(model, cfg, opt_cfg, mesh=mesh, batch_example=batch,
                               donate=False)
        return cell("train", step, params=params, opt_state=opt, batch=batch)

    with mode:
        params = model.init_params(0, device="cpu")
    if sc.kind == "prefill":
        enc_len, cap = (s, ENC_DEC_PREFILL_TGT) if cfg.n_encoder_layers else (0, s)
        with mode:
            if cfg.n_encoder_layers:
                inputs = {"src_embeds": torch.empty((b, s, cfg.d_model), dtype=_dtype(cfg.dtype)),
                          "tokens": torch.empty((b, ENC_DEC_PREFILL_TGT), dtype=torch.int32)}
            elif cfg.frontend == "embeds":
                inputs = {"embeds": torch.empty((b, s, cfg.d_model), dtype=_dtype(cfg.dtype))}
            else:
                inputs = {"tokens": torch.empty((b, s), dtype=torch.int32)}
        step = make_prefill_step(model, cfg, mesh, batch=b, seq=s, cache_cap=cap,
                                 enc_len=enc_len, seq_shard_fallback=seq_shard_fallback)
        return cell("prefill", step, params=params, inputs=inputs)

    # ---- decode ----
    enc_len = s if cfg.n_encoder_layers else 0
    cap = DEC_SELF_CAP if cfg.n_encoder_layers else s
    step = make_decode_step(model, cfg, mesh, batch=b, cache_cap=cap, enc_len=enc_len,
                            seq_shard_fallback=seq_shard_fallback)
    with mode:
        caches = (model.init_caches(b, cap, enc_len, device="cpu") if enc_len
                  else model.init_caches(b, cap, device="cpu"))
        if mesh is not None:
            _, c_spec = serve_shardings(model, cfg, mesh, b, cap, enc_len,
                                        seq_shard_fallback=seq_shard_fallback)
            caches = shard_tree(caches, c_spec, mesh)
        tokens = torch.empty((b,), dtype=torch.int32)
        lengths = torch.empty((b,), dtype=torch.int32)
    return cell("decode", step, params=params, tokens=tokens, caches=caches, lengths=lengths)
