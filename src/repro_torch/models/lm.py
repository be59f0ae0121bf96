"""Decoder-only LM assembled from a LayerPlan: embed -> stack -> norm -> head
— counterpart of :class:`repro.models.lm.LM`, for the configs whose blocks
are all ``attn``/``attn_local`` with ``swiglu``/``mlp`` FFNs (gemma3-1b,
phi3-mini-3.8b, stablelm-12b, minitron-4b, and pixtral-12b through its
``embeds`` frontend).  Any other config raises on ``LM(cfg)`` with the
ROADMAP item that brings it.

API (functions of params, a dict tree of tensors):
  init_params(seed, device)                -> params (drawn on the device)
  prefill(params, batch, cache_cap)        -> (last_logits, caches, lengths)
  decode_step(params, tokens, caches, lengths) -> (logits, new_caches)

The tied head goes through ``dense`` with ``cfg.backend("dense")`` (the
JAX package uses a bare einsum): on the card that is the batch-invariant
GEMM kernel, so the batched decode step's logits equal the unbatched
ones bit for bit.  The kernel wants a contiguous (d, V) weight, so tied
params carry ``embed_t``, one contiguous transposed copy of the embedding
made when the params are built (init_params, params_from_numpy) and never
per step.  ``train_loss`` and ``cross_entropy`` come with the training
slice (ROADMAP Queue 1 item 13f).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import DeviceLike, resolve_device, to_tensor
from repro_torch.layers.attention import CROSS_ITEM
from repro_torch.layers.common import dense, dense_init, embed_init, norm
from repro_torch.models.stack import check_block, init_stack_caches, stack_apply, stack_init

__all__ = ["LM", "CUDA_BACKENDS", "mask_vocab", "params_from_numpy"]

Params = Dict[str, Any]

# The op backends the port serves with on the card: the hand-written kernels.
CUDA_BACKENDS = {"attention": "cuda", "decode_attention": "cuda", "rmsnorm": "cuda",
                 "dense": "cuda"}


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def mask_vocab(logits: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """-1e30 the padding vocab rows (vocab_padded > vocab)."""
    if cfg.vocab_padded == cfg.vocab:
        return logits
    mask = torch.arange(logits.shape[-1], device=logits.device) < cfg.vocab
    return torch.where(mask, logits, torch.full_like(logits, -1e30))


def _with_head(params: Params) -> Params:
    """Tied params (no ``lm_head``) get ``embed_t``: the embedding transposed
    to (d, V), contiguous, once."""
    if "lm_head" not in params:
        params["embed_t"] = params["embed"].t().contiguous()
    return params


def params_from_numpy(tree: Any, device: DeviceLike = None) -> Params:
    """The JAX package's ``LM.init_params`` tree (numpy leaves; nested dicts
    and lists, period params stacked on axis 0) as the port's: the same
    tree of tensors on ``device``, bit for bit, plus ``embed_t`` when the
    embedding is tied."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        # np.array copies: JAX hands out read-only buffers
        return to_tensor(x if isinstance(x, torch.Tensor) else np.array(x), dev)

    return _with_head(conv(tree))


class LM:
    def __init__(self, cfg: ArchConfig):
        if cfg.n_encoder_layers:
            raise NotImplementedError(f"{cfg.name}: encoder-decoder models: {CROSS_ITEM}")
        for blk in cfg.plan.all_blocks():
            check_block(blk)
        self.cfg = cfg

    # ------------------------------------------------------------------ #
    def init_params(self, seed: int = 0, device: DeviceLike = None,
                    dtype: Optional[torch.dtype] = None) -> Params:
        """Random weights drawn on ``device`` from a ``torch.Generator``
        seeded with ``seed`` (the JAX package's distributions, not its
        numbers)."""
        cfg = self.cfg
        dev = resolve_device(device)
        dtype = _dtype(cfg.param_dtype) if dtype is None else dtype
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        p: Params = {
            "embed": embed_init(gen, cfg.vocab_padded, cfg.d_model, dtype=dtype),
            "stack": stack_init(gen, cfg, cfg.plan, dtype=dtype),
            "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        }
        if not cfg.tie_embeddings:
            p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_padded, dtype=dtype)
        return _with_head(p)

    # ------------------------------------------------------------------ #
    def _embed(self, params: Params, batch: Dict[str, torch.Tensor],
               dtype: torch.dtype) -> torch.Tensor:
        if self.cfg.frontend == "embeds" and "embeds" in batch:
            return batch["embeds"].to(dtype)
        return params["embed"][batch["tokens"].long()].to(dtype)

    def _head(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        w = params["embed_t"] if self.cfg.tie_embeddings else params["lm_head"]
        return dense(h, w, backend=self.cfg.backend("dense"))

    # ------------------------------------------------------------------ #
    def forward(self, params: Params, batch: Dict[str, torch.Tensor], *,
                mode: str, caches=None, lengths=None, cache_cap: Optional[int] = None):
        cfg = self.cfg
        h = self._embed(params, batch, _dtype(cfg.dtype))
        h, new_caches, aux = stack_apply(
            params["stack"], h, cfg.plan, cfg=cfg, mode=mode, caches=caches,
            lengths=lengths, cache_cap=cache_cap)
        h = norm(h, params["final_norm"], eps=cfg.norm_eps, backend=cfg.backend("rmsnorm"))
        return h, new_caches, aux

    # ------------------------------------------------------------------ #
    def prefill(self, params: Params, batch: Dict[str, torch.Tensor], *,
                cache_cap: Optional[int] = None):
        """Returns (last-position logits (B, V), caches, lengths (B,) int32)."""
        x = batch["tokens"] if "tokens" in batch else batch["embeds"]
        bsz, seq = x.shape[0], x.shape[1]
        h, caches, _ = self.forward(params, batch, mode="prefill", cache_cap=cache_cap or seq)
        logits = self._head(params, h[:, -1])
        lengths = torch.full((bsz,), seq, dtype=torch.int32, device=h.device)
        return mask_vocab(logits, self.cfg), caches, lengths

    def decode_step(self, params: Params, tokens: torch.Tensor, caches,
                    lengths: torch.Tensor):
        """tokens (B,) -> (logits (B, V), new_caches). The caller increments
        lengths afterwards."""
        h, new_caches, _ = self.forward(params, {"tokens": tokens[:, None]}, mode="decode",
                                        caches=caches, lengths=lengths)
        logits = self._head(params, h[:, 0])
        return mask_vocab(logits, self.cfg), new_caches

    # ------------------------------------------------------------------ #
    def init_caches(self, batch: int, cache_cap: int, dtype: Optional[torch.dtype] = None,
                    device: DeviceLike = None):
        dtype = _dtype(self.cfg.dtype) if dtype is None else dtype
        return init_stack_caches(self.cfg, self.cfg.plan, batch, cache_cap, dtype=dtype,
                                 device=resolve_device(device))
