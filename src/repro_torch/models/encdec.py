"""Encoder-decoder model (seamless-m4t backbone) — counterpart of
:class:`repro.models.encdec.EncDec`.

Encoder: non-causal attn + MLP blocks over precomputed frame embeddings
(the audio frontend is a stub: the caller passes (B, S_src, d)
embeddings).  Decoder: causal self-attn + cross-attn + MLP over text
tokens.  Decode-time cross-attention K/V are computed once at prefill and
cached read-only.

API (functions of params, a dict tree of tensors):
  init_params(seed, device)                         -> params
  encode(params, src_embeds)                        -> enc_out (B, S_src, d)
  train_loss(params, batch)                         -> (loss, metrics)
  prefill(params, batch, cache_cap)                 -> (last_logits, caches, lengths)
  decode_step(params, tokens, caches, lengths, enc_lengths) -> (logits, new_caches)
  init_caches(batch, cache_cap, enc_len)            -> zero caches

As in :class:`repro_torch.models.lm.LM`, the head goes through ``dense``
with ``cfg.backend("dense")`` (the JAX package uses a bare einsum): on the
card the batch-invariant GEMM kernel, so a batch's tokens equal batch-1
runs'.  ``train_loss`` is JAX's: the encoder and decoder stacks with
``remat`` (each period recomputed in the backward pass), teacher-forced
CE on ``batch["labels"]`` and no auxiliary term in the loss; it refuses a
config with an op on a backend that has no backward pass
(:func:`repro_torch.models.lm.check_trainable`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig, Block, LayerPlan
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.layers.common import dense, dense_init, embed_init, norm
from repro_torch.models.lm import (_dtype, batch_metrics, check_trainable, cross_entropy,
                                  mask_vocab)
from repro_torch.models.stack import init_stack_caches, stack_apply, stack_init

__all__ = ["EncDec"]

Params = Dict[str, Any]


class EncDec:
    def __init__(self, cfg: ArchConfig):
        if not cfg.n_encoder_layers:
            raise ValueError(f"{cfg.name} has no encoder: serve it with "
                             "repro_torch.models.lm.LM")
        self.cfg = cfg
        self.enc_plan = LayerPlan(period=(Block("attn", "mlp"),),
                                  n_periods=cfg.n_encoder_layers)
        self.dec_plan = cfg.plan  # blocks carry cross=True

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
        return {
            "embed": embed_init(gen, cfg.vocab_padded, cfg.d_model, dtype=dtype),
            "encoder": stack_init(gen, cfg, self.enc_plan, dtype=dtype),
            "enc_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
            "decoder": stack_init(gen, cfg, self.dec_plan, dtype=dtype),
            "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
            "lm_head": dense_init(gen, cfg.d_model, cfg.vocab_padded, dtype=dtype),
        }

    # ------------------------------------------------------------------ #
    def encode(self, params: Params, src_embeds: torch.Tensor,
               remat: bool = True) -> torch.Tensor:
        """(B, S_src, d) frame embeddings -> the normed encoder output."""
        cfg = self.cfg
        h = src_embeds.to(_dtype(cfg.dtype))
        h, _, _ = stack_apply(params["encoder"], h, self.enc_plan, cfg=cfg, mode="train",
                              causal=False, remat=remat)
        return norm(h, params["enc_norm"], eps=cfg.norm_eps, backend=cfg.backend("rmsnorm"))

    def _decoder(self, params: Params, h: torch.Tensor, *, mode: str, caches,
                 lengths, enc_out, enc_lengths, cache_cap, remat: bool = False, dp=None,
                 shard=None):
        """-> (h, new_caches, aux)"""
        cfg = self.cfg
        h, new_caches, aux = stack_apply(
            params["decoder"], h, self.dec_plan, cfg=cfg, mode=mode, caches=caches,
            lengths=lengths, enc_out=enc_out, enc_lengths=enc_lengths, cache_cap=cache_cap,
            remat=remat, dp=dp, shard=shard)
        h = norm(h, params["final_norm"], eps=cfg.norm_eps, backend=cfg.backend("rmsnorm"))
        return h, new_caches, aux

    def _decode_trunk(self, params: Params, h: torch.Tensor, **kw):
        """-> (h, new_caches)"""
        return self._decoder(params, h, **kw)[:2]

    # ------------------------------------------------------------------ #
    def train_loss(self, params: Params, batch: Dict[str, torch.Tensor], *,
                   remat: bool = True, dp=None):
        """(ce, {"ce", "aux"}) of the decoder's next-token ``batch["labels"]``
        given ``batch["src_embeds"]`` and the teacher-forced
        ``batch["tokens"]``; ``dp`` as in :meth:`LM.train_loss`."""
        cfg = self.cfg
        check_trainable(cfg)
        enc_out = self.encode(params, batch["src_embeds"], remat=remat)
        h = params["embed"][batch["tokens"].long()].to(_dtype(cfg.dtype))
        h, _, aux = self._decoder(params, h, mode="train", caches=None, lengths=None,
                                  enc_out=enc_out, enc_lengths=None, cache_cap=None,
                                  remat=remat, dp=dp)
        logits = dense(h, params["lm_head"], backend=cfg.backend("dense"))
        ce = cross_entropy(logits, batch["labels"], cfg, dp)
        return ce, batch_metrics(ce, aux, dp)

    def _head(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        return mask_vocab(dense(h, params["lm_head"], backend=self.cfg.backend("dense")),
                          self.cfg)

    # ------------------------------------------------------------------ #
    def prefill(self, params: Params, batch: Dict[str, torch.Tensor], *, cache_cap: int,
                dp=None):
        """Encode ``batch["src_embeds"]``, prefill the decoder over
        ``batch["tokens"]``; returns (last-position logits (B, V), caches,
        lengths (B,) int32).  ``dp`` (the decoder's MoE layers) as in
        :meth:`repro_torch.models.lm.LM.prefill`."""
        cfg = self.cfg
        enc_out = self.encode(params, batch["src_embeds"], remat=False)
        b, s_src = enc_out.shape[0], enc_out.shape[1]
        tokens = batch["tokens"]
        h = params["embed"][tokens.long()].to(_dtype(cfg.dtype))
        enc_lengths = torch.full((b,), s_src, dtype=torch.int32, device=h.device)
        h, caches = self._decode_trunk(params, h, mode="prefill", caches=None, lengths=None,
                                       enc_out=enc_out, enc_lengths=enc_lengths,
                                       cache_cap=cache_cap, dp=dp)
        lengths = torch.full((b,), tokens.shape[1], dtype=torch.int32, device=h.device)
        return self._head(params, h[:, -1]), caches, lengths

    def decode_step(self, params: Params, tokens: torch.Tensor, caches,
                    lengths: torch.Tensor, enc_lengths: torch.Tensor, shard=None, dp=None):
        """tokens (B,) -> (logits (B, V), new_caches); the cross-attention
        reads ``enc_lengths`` rows of each encoder cache.  The caller
        increments lengths afterwards.  ``shard`` and ``dp`` as in
        :meth:`repro_torch.models.lm.LM.decode_step`."""
        h = params["embed"][tokens.long()[:, None]].to(_dtype(self.cfg.dtype))
        h, new_caches = self._decode_trunk(params, h, mode="decode", caches=caches,
                                           lengths=lengths, enc_out=None,
                                           enc_lengths=enc_lengths, cache_cap=None,
                                           shard=shard, dp=dp)
        return self._head(params, h[:, 0]), new_caches

    # ------------------------------------------------------------------ #
    def init_caches(self, batch: int, cache_cap: int, enc_len: int,
                    dtype: Optional[torch.dtype] = None, device: DeviceLike = None):
        dtype = _dtype(self.cfg.dtype) if dtype is None else dtype
        return init_stack_caches(self.cfg, self.dec_plan, batch, cache_cap, enc_len=enc_len,
                                 dtype=dtype, device=resolve_device(device))
