"""Decoder-only LM assembled from a LayerPlan: embed -> stack -> norm -> head
— counterpart of :class:`repro.models.lm.LM`, for every decoder-only config:
dense (phi3-mini-3.8b, stablelm-12b, minitron-4b), local:global
(gemma3-1b), MoE (qwen2-moe-a2.7b; deepseek-v2-lite-16b with MLA), SSM
(mamba2-370m), hybrid (zamba2-7b: Mamba2 blocks and two shared attention
blocks, which re-read the initial embedding ``emb0``) and pixtral-12b
through its ``embeds`` frontend.  The encoder-decoder config
(seamless-m4t-medium) is served by :class:`repro_torch.models.encdec.EncDec`;
``LM(cfg)`` refuses it.

API (functions of params, a dict tree of tensors):
  init_params(seed, device)                -> params (drawn on the device)
  train_loss(params, batch)                -> (loss, metrics)
  prefill(params, batch, cache_cap)        -> (last_logits, caches, lengths)
  decode_step(params, tokens, caches, lengths) -> (logits, new_caches)

The tied head goes through ``dense`` with ``cfg.backend("dense")`` (the
JAX package uses a bare einsum): on the card that is the batch-invariant
GEMM kernel, so the batched decode step's logits equal the unbatched
ones bit for bit.  The kernel wants a contiguous (d, V) weight, so tied
params carry ``embed_t``, one contiguous transposed copy of the embedding
made when the params are built (init_params, params_from_numpy) and never
per step.

Training (``train_loss``, as JAX's) differentiates with ``torch.autograd``
through the config's own backends, which are plain PyTorch (``ref``, and
mamba2's and zamba2's ``chunked`` ssd): the JAX package trains through
its ``ref`` backends too, and none of its kernels has a backward pass.  A
``cuda`` kernel's output has no ``grad_fn``, so :func:`check_trainable`
refuses a config that puts any op on a backend outside
:data:`DIFFERENTIABLE_BACKENDS`, naming the op.  The trainable tree is
exactly JAX's: :func:`strip_derived` takes the derived serving leaves
(``embed_t``, MLA's ``wuk_h`` / ``wuv_h``) out, and ``train_loss`` refuses
params that carry them (a gradient into ``embed_t`` would train a stale
copy of the tied embedding); :func:`with_derived` adds them back for
serving.  The tied head is ``h @ params["embed"].T``, as in JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import DeviceLike, resolve_device, to_tensor
from repro_torch.layers.attention import is_mla, with_mla_heads
from repro_torch.layers.common import dense, dense_init, embed_init, norm
from repro_torch.models.stack import check_block, init_stack_caches, stack_apply, stack_init
from repro_torch.sharding.collectives import GlobalBatch

__all__ = ["LM", "CUDA_BACKENDS", "DIFFERENTIABLE_BACKENDS", "DERIVED_LEAVES", "mask_vocab",
           "cross_entropy", "batch_metrics", "check_trainable", "params_from_numpy", "strip_derived",
           "with_derived"]

Params = Dict[str, Any]

# The op backends the port serves with on the card: the hand-written kernels
# (they override a config's own choice, such as mamba2's ``ssd: chunked``).
CUDA_BACKENDS = {"attention": "cuda", "decode_attention": "cuda", "rmsnorm": "cuda",
                 "dense": "cuda", "moe_gemm": "cuda", "ssd": "cuda"}

# The backends training may run on: plain PyTorch, which autograd
# differentiates (a ``cuda`` backend runs its plain version on CPU tensors
# but launches a kernel without a backward pass on the card).
DIFFERENTIABLE_BACKENDS = frozenset({"ref", "chunked"})

# Leaves derived from others when params are built for serving: the tied
# head's transposed embedding and MLA's per-head up-projections.
DERIVED_LEAVES = ("embed_t", "wuk_h", "wuv_h")


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def mask_vocab(logits: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """-1e30 the padding vocab rows (vocab_padded > vocab)."""
    if cfg.vocab_padded == cfg.vocab:
        return logits
    mask = torch.arange(logits.shape[-1], device=logits.device) < cfg.vocab
    return torch.where(mask, logits, torch.full_like(logits, -1e30))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  cfg: ArchConfig, dp: Optional[GlobalBatch] = None) -> torch.Tensor:
    """Token-mean CE in f32; every label < 0 is ignored (the padding vocab
    rows masked to -1e30 first).  With ``dp`` the rank's share of the
    global batch's: its CE sum over the valid labels of every data rank
    (the shares add up to the global token mean, not a mean of means)."""
    logits = mask_vocab(logits, cfg).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, torch.clamp(labels.long(), min=0)[..., None])[..., 0]
    valid = (labels >= 0).to(torch.float32)
    nll = (lse - ll) * valid
    count = valid.sum() if dp is None else dp.sum(valid.sum())
    return nll.sum() / torch.clamp(count, min=1.0)


def batch_metrics(ce: torch.Tensor, aux: torch.Tensor,
                  dp: Optional[GlobalBatch]) -> Dict[str, torch.Tensor]:
    """``{"ce", "aux"}`` of the global batch: the ranks' shares summed (one
    all-reduce) under ``dp``."""
    if dp is None:
        return {"ce": ce, "aux": aux}
    ce_g, aux_g = dp.sum(torch.stack([ce, aux.to(ce.dtype)]))
    return {"ce": ce_g, "aux": aux_g}


def check_trainable(cfg: ArchConfig) -> None:
    """Raise ``ValueError`` naming the first op ``cfg`` puts on a backend
    with no backward pass."""
    for op, backend in sorted(cfg.backends.items()):
        if backend not in DIFFERENTIABLE_BACKENDS:
            raise ValueError(
                f"{cfg.name}: op {op!r} runs on backend {backend!r}, which has no backward "
                f"pass; train on {sorted(DIFFERENTIABLE_BACKENDS)} (the config's own "
                f"backends), as the JAX package trains on its ref backends")


def _derived_paths(tree: Any, prefix: str = "") -> list:
    """Paths of the derived serving leaves in ``tree``."""
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            path = f"{prefix}/{k}"
            out += [path] if k in DERIVED_LEAVES else _derived_paths(v, path)
        return out
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in _derived_paths(v, f"{prefix}/{i}")]
    return []


def strip_derived(params: Params) -> Params:
    """The trainable tree (JAX's): ``params`` without the derived serving
    leaves; the other leaves are shared, not copied."""
    if isinstance(params, dict):
        return {k: strip_derived(v) for k, v in params.items() if k not in DERIVED_LEAVES}
    if isinstance(params, (list, tuple)):
        return [strip_derived(v) for v in params]
    return params


def with_derived(params: Params) -> Params:
    """A trained tree ready to serve: the derived leaves computed anew from
    the trained ones (``embed_t`` when the embedding is tied, ``wuk_h`` /
    ``wuv_h`` in each MLA mixer)."""
    def conv(x):
        if isinstance(x, dict):
            out = {k: conv(v) for k, v in x.items() if k not in DERIVED_LEAVES}
            return with_mla_heads(out) if is_mla(out) else out
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        return x

    return _with_head(conv(params))


def _with_head(params: Params) -> Params:
    """Tied params (no ``lm_head``) get ``embed_t``: the embedding transposed
    to (d, V), contiguous, once."""
    if "lm_head" not in params and "embed" in params:
        params["embed_t"] = params["embed"].t().contiguous()
    return params


def params_from_numpy(tree: Any, device: DeviceLike = None) -> Params:
    """The JAX package's ``LM.init_params`` or ``EncDec.init_params`` tree
    (numpy leaves; nested dicts and lists, period params stacked on axis 0,
    a zamba2 stack's ``shared`` slot, an encoder-decoder's ``encoder`` /
    ``decoder`` / ``enc_norm``) as the port's: the same tree of tensors on
    ``device``, bit for bit.  It adds only derived leaves: ``embed_t`` when
    the embedding is tied, and ``wuk_h`` / ``wuv_h`` (the per-head
    up-projections, :func:`repro_torch.layers.attention.with_mla_heads`) to
    each MLA mixer."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            out = {k: conv(v) for k, v in x.items()}
            return with_mla_heads(out) if is_mla(out) else out
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        # np.array copies: JAX hands out read-only buffers
        return to_tensor(x if isinstance(x, torch.Tensor) else np.array(x), dev)

    return _with_head(conv(tree))


class LM:
    def __init__(self, cfg: ArchConfig):
        if cfg.n_encoder_layers:
            raise ValueError(f"{cfg.name} is an encoder-decoder config: serve it with "
                             "repro_torch.models.encdec.EncDec, not LM")
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
                mode: str, caches=None, lengths=None, cache_cap: Optional[int] = None,
                remat: Optional[bool] = None, dp: Optional[GlobalBatch] = None, shard=None):
        cfg = self.cfg
        remat = cfg.remat if remat is None else remat
        h = self._embed(params, batch, _dtype(cfg.dtype))
        # zamba2's shared blocks re-read the initial embedding (at decode,
        # the current token's)
        h, new_caches, aux = stack_apply(
            params["stack"], h, cfg.plan, cfg=cfg, mode=mode, caches=caches,
            lengths=lengths, emb0=h, cache_cap=cache_cap, remat=remat, dp=dp, shard=shard)
        h = norm(h, params["final_norm"], eps=cfg.norm_eps, backend=cfg.backend("rmsnorm"))
        return h, new_caches, aux

    # ------------------------------------------------------------------ #
    def train_loss(self, params: Params, batch: Dict[str, torch.Tensor], *,
                   aux_weight: float = 0.01, remat: Optional[bool] = None,
                   dp: Optional[GlobalBatch] = None):
        """(loss, {"ce", "aux"}): the token-mean CE of the next-token
        ``batch["labels"]`` plus ``aux_weight`` times the MoE balance loss.
        ``params`` is the trainable tree (:func:`strip_derived`).  With
        ``dp`` (data-parallel training: ``batch`` is this rank's rows) the
        loss is the rank's share of the global batch's, whose gradients
        summed over the data ranks are the single-device gradients, and the
        metrics are the global batch's."""
        check_trainable(self.cfg)
        derived = _derived_paths(params)
        if derived:
            raise ValueError(f"train_loss takes the trainable tree; params carry the derived "
                             f"serving leaves {derived[:3]}: pass strip_derived(params)")
        h, _, aux = self.forward(params, batch, mode="train", remat=remat, dp=dp)
        w = params["embed"].t() if self.cfg.tie_embeddings else params["lm_head"]
        logits = dense(h, w, backend=self.cfg.backend("dense"))
        ce = cross_entropy(logits, batch["labels"], self.cfg, dp)
        loss = ce + aux_weight * aux
        return loss, batch_metrics(ce, aux, dp)

    # ------------------------------------------------------------------ #
    def prefill(self, params: Params, batch: Dict[str, torch.Tensor], *,
                cache_cap: Optional[int] = None, dp: Optional[GlobalBatch] = None):
        """Returns (last-position logits (B, V), caches, lengths (B,) int32).
        ``dp``: ``batch`` is this rank's rows of a global batch, which a
        global-dispatch MoE layer routes as one
        (:func:`repro_torch.runtime.serve.make_prefill_step`)."""
        x = batch["tokens"] if "tokens" in batch else batch["embeds"]
        bsz, seq = x.shape[0], x.shape[1]
        h, caches, _ = self.forward(params, batch, mode="prefill", cache_cap=cache_cap or seq,
                                    dp=dp)
        logits = self._head(params, h[:, -1])
        lengths = torch.full((bsz,), seq, dtype=torch.int32, device=h.device)
        return mask_vocab(logits, self.cfg), caches, lengths

    def decode_step(self, params: Params, tokens: torch.Tensor, caches,
                    lengths: torch.Tensor, shard=None, dp: Optional[GlobalBatch] = None):
        """tokens (B,) -> (logits (B, V), new_caches). The caller increments
        lengths afterwards.  ``shard``: the caches are this rank's slices on
        a mesh (:func:`repro_torch.runtime.serve.make_decode_step`); ``dp``
        as in :meth:`prefill`."""
        h, new_caches, _ = self.forward(params, {"tokens": tokens[:, None]}, mode="decode",
                                        caches=caches, lengths=lengths, shard=shard, dp=dp)
        logits = self._head(params, h[:, 0])
        return mask_vocab(logits, self.cfg), new_caches

    # ------------------------------------------------------------------ #
    def init_caches(self, batch: int, cache_cap: int, dtype: Optional[torch.dtype] = None,
                    device: DeviceLike = None):
        dtype = _dtype(self.cfg.dtype) if dtype is None else dtype
        return init_stack_caches(self.cfg, self.cfg.plan, batch, cache_cap, dtype=dtype,
                                 device=resolve_device(device))
