"""Block-stack machinery: init/apply for a LayerPlan (prefix + periods +
suffix) — counterpart of :mod:`repro.models.stack`.

Parameters for position i of the period are stacked along axis 0
(n_periods, ...), as in the JAX package, and caches follow the same layout.
JAX scans over that axis; here the period loop is a Python loop over it.

Every block kind of the configs is ported: ``attn``/``attn_local``/``mla``/
``mamba``/``shared_attn`` mixers, ``swiglu``/``mlp``/``moe``/``none`` FFNs
and cross-attention (``Block.cross``, the encoder-decoder's decoder blocks,
which read ``enc_out`` at train / prefill and their cross cache at decode).

Train mode with ``remat`` runs each period under
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``, as JAX
wraps the period body in ``jax.checkpoint``: the backward pass recomputes
the period's activations instead of keeping them, so the live set is
O(period).  The numbers are the same with and without it; only memory
changes.  (JAX's policy keeps the matmul outputs; here nothing inside a
period is kept.)  A period's parameters are views of the stacked tensors
(``unbind`` once per call), so the backward pass stacks their gradients in
one op.

Zamba2's *shared* attention blocks live OUTSIDE the stacking: the stack's
``"shared"`` slot holds two blocks stacked on axis 0, and an application
uses block ``period_idx % 2`` (prefix blocks 0, suffix blocks
``n_periods % 2``).  Their params are shared; their caches are one per
application and therefore stacked like every other cache.  A shared block
re-reads the initial embedding ``emb0`` and its output replaces ``h``.

:func:`stack_init` copies each period's parameters into one preallocated
``(n_periods, ...)`` tensor per leaf as soon as they are drawn: at most one
period's parameters exist beside the stacked ones.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, Block, LayerPlan
from repro_torch.core.tree import tree_map
from repro_torch.layers.attention import (attn_apply, attn_init, mla_apply, mla_init,
                                          shared_attn_apply, shared_attn_init)
from repro_torch.layers.common import norm
from repro_torch.layers.mlp import mlp_apply, mlp_init, swiglu_apply, swiglu_init
from repro_torch.layers.moe import moe_apply, moe_init
from repro_torch.layers.ssm import mamba_apply, mamba_init

Params = Dict[str, Any]

MIXERS = ("attn", "attn_local", "mla", "mamba", "shared_attn")
FFNS = ("swiglu", "mlp", "moe", "none")


def check_block(blk: Block) -> None:
    """Raise ``ValueError`` for a block no config describes."""
    if blk.mixer not in MIXERS:
        raise ValueError(f"unknown mixer {blk.mixer!r}")
    if blk.ffn not in FFNS:
        raise ValueError(f"unknown ffn {blk.ffn!r}")


def _unbind(tree: Any, n: int) -> List[Any]:
    """A tree of stacked (n, ...) tensors -> n trees of their slices."""
    if isinstance(tree, dict):
        per = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, (list, tuple)):
        per = [_unbind(v, n) for v in tree]
        return [[p[i] for p in per] for i in range(n)]
    if tree is None:
        return [None] * n
    return list(tree.unbind(0))


# --------------------------------------------------------------------------- #
# single block
# --------------------------------------------------------------------------- #

def block_init(gen: torch.Generator, cfg: ArchConfig, blk: Block, *,
               dtype: torch.dtype = torch.float32) -> Params:
    check_block(blk)
    d = cfg.d_model
    p: Params = {}
    if blk.mixer != "shared_attn":        # a shared block's params live in the "shared" slot
        mixer = {"mamba": mamba_init, "mla": mla_init}.get(blk.mixer, attn_init)
        p["norm1"] = torch.ones((d,), dtype=dtype, device=gen.device)
        p["mixer"] = mixer(gen, cfg, dtype=dtype)
    if blk.cross:
        p["norm_x"] = torch.ones((d,), dtype=dtype, device=gen.device)
        p["cross"] = attn_init(gen, cfg, cross=True, dtype=dtype)
    if blk.ffn != "none":
        p["norm2"] = torch.ones((d,), dtype=dtype, device=gen.device)
        if blk.ffn == "moe":
            p["ffn"] = moe_init(gen, cfg, dtype=dtype)
        else:
            init = swiglu_init if blk.ffn == "swiglu" else mlp_init
            p["ffn"] = init(gen, d, cfg.d_ff, dtype=dtype)
    return p


def block_apply(p: Params, h: torch.Tensor, blk: Block, *, cfg: ArchConfig,
                mode: str, cache: Any = None, lengths=None, emb0=None,
                enc_out=None, enc_lengths=None, shared_params: Optional[Params] = None,
                cache_cap: Optional[int] = None, causal: bool = True, dp: Any = None,
                shard: Any = None) -> Tuple[torch.Tensor, Any, torch.Tensor]:
    """Returns (h, new_cache, aux_loss). ``cache`` is a dict with optional
    keys 'mix' and 'cross' (block-level cache container).  aux_loss is a
    float32 scalar tensor, 0 unless the FFN is MoE; ``dp`` (data-parallel
    training's GlobalBatch) goes to the MoE layer; ``shard`` (decode on a
    mesh: the block's :class:`repro_torch.runtime.serve.ServeShard`) to the
    mixer and the cross-attention."""
    check_block(blk)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    cache = cache or {}
    new_cache: Dict[str, Any] = {}
    nb = cfg.backend("rmsnorm")
    eps = cfg.norm_eps

    if blk.mixer == "shared_attn":        # its output replaces h (no outer residual)
        h, c = shared_attn_apply(shared_params, h, emb0, cfg=cfg, mode=mode,
                                 cache=cache.get("mix"), lengths=lengths, cache_cap=cache_cap,
                                 shard=_sub(shard, "mix"))
    else:
        x = norm(h, p["norm1"], eps=eps, backend=nb)
        if blk.mixer == "mamba":
            y, c = mamba_apply(p["mixer"], x, cfg=cfg, mode=mode, cache=cache.get("mix"),
                               lengths=lengths, shard=_sub(shard, "mix"))
        elif blk.mixer == "mla":
            y, c = mla_apply(p["mixer"], x, cfg=cfg, mode=mode, cache=cache.get("mix"),
                             lengths=lengths, cache_cap=cache_cap, shard=_sub(shard, "mix"))
        else:
            window = cfg.window if blk.mixer == "attn_local" else None
            y, c = attn_apply(p["mixer"], x, cfg=cfg, mode=mode, window=window,
                              cache=cache.get("mix"), lengths=lengths,
                              cache_cap=cache_cap, causal=causal, shard=_sub(shard, "mix"))
        h = h + y
    if c is not None:
        new_cache["mix"] = c

    if blk.cross:
        x = norm(h, p["norm_x"], eps=eps, backend=nb)
        y, c = attn_apply(p["cross"], x, cfg=cfg, mode=mode, cross=True,
                          cache=cache.get("cross"), enc_out=enc_out, enc_lengths=enc_lengths,
                          shard=_sub(shard, "cross"))
        h = h + y
        if c is not None:
            new_cache["cross"] = c

    if blk.ffn != "none":
        x = norm(h, p["norm2"], eps=eps, backend=nb)
        if blk.ffn == "moe":
            y, aux = moe_apply(p["ffn"], x, cfg=cfg, dp=dp)
        else:
            y = (swiglu_apply if blk.ffn == "swiglu" else mlp_apply)(p["ffn"], x, cfg=cfg)
        h = h + y

    return h, (new_cache if new_cache else None), aux


# --------------------------------------------------------------------------- #
# stack = prefix + periods + suffix
# --------------------------------------------------------------------------- #

def stack_init(gen: torch.Generator, cfg: ArchConfig, plan: LayerPlan, *,
               dtype: torch.dtype = torch.float32) -> Params:
    """Parameters drawn on ``gen``'s device; period leaves stacked on axis 0.
    Each stacked tensor is allocated from the first period's draw, and every
    period is copied into its slot as soon as it is drawn."""
    p: Params = {"prefix": [], "period": [], "suffix": []}
    for blk in plan.prefix:
        p["prefix"].append(block_init(gen, cfg, blk, dtype=dtype))
    for blk in plan.period:
        stacked: Params = {}
        for i in range(plan.n_periods):
            one = block_init(gen, cfg, blk, dtype=dtype)
            if i == 0:
                stacked = tree_map(lambda a: torch.empty((plan.n_periods, *a.shape),
                                                          dtype=a.dtype, device=a.device), one)
            tree_map(lambda out, a: out[i].copy_(a), stacked, one)
        p["period"].append(stacked)
    for blk in plan.suffix:
        p["suffix"].append(block_init(gen, cfg, blk, dtype=dtype))
    if any(b.mixer == "shared_attn" for b in plan.all_blocks()):
        # two alternating shared blocks (Zamba2), stacked on axis 0
        sh = [shared_attn_init(gen, cfg, dtype=dtype) for _ in range(2)]
        p["shared"] = tree_map(lambda *xs: torch.stack(xs), *sh)
    return p


def _sub(shard: Any, *keys: Any) -> Any:
    """The ServeShard of a part of the cache tree (None stays None)."""
    return None if shard is None else shard.child(*keys)


def stack_apply(params: Params, h: torch.Tensor, plan: LayerPlan, *,
                cfg: ArchConfig, mode: str, caches: Any = None,
                lengths=None, emb0=None, enc_out=None, enc_lengths=None,
                cache_cap: Optional[int] = None, causal: bool = True,
                remat: bool = True, dp: Any = None, shard: Any = None):
    """Returns (h, new_caches, aux_total); new_caches is None in train mode.
    ``remat`` recomputes each period in the backward pass (train mode with
    gradients on only); ``dp`` as in :func:`block_apply`; ``shard`` is the
    ServeShard of the whole cache tree (decode on a mesh)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    caches = caches or {"prefix": [None] * len(plan.prefix),
                        "period": [None] * len(plan.period),
                        "suffix": [None] * len(plan.suffix)}
    new_caches: Dict[str, Any] = {"prefix": [], "period": None, "suffix": []}
    shared = params.get("shared")

    def pick_shared(period_idx: int) -> Optional[Params]:
        if shared is None:
            return None
        return tree_map(lambda a: a[period_idx % 2], shared)

    common = dict(cfg=cfg, mode=mode, lengths=lengths, emb0=emb0, enc_out=enc_out,
                  enc_lengths=enc_lengths, cache_cap=cache_cap, causal=causal, dp=dp)

    for i, (blk, bp, bc) in enumerate(zip(plan.prefix, params["prefix"], caches["prefix"])):
        h, c, aux = block_apply(bp, h, blk, cache=bc, shared_params=pick_shared(0),
                                shard=_sub(shard, "prefix", i), **common)
        new_caches["prefix"].append(c)
        aux_total = aux_total + aux

    if plan.n_periods > 0:
        per_params = [_unbind(p, plan.n_periods) for p in params["period"]]

        def period(h, aux_total, pidx):
            """One period's blocks -> (h, aux_total, their new caches)."""
            cs = []
            for j, blk in enumerate(plan.period):
                bc = caches["period"][j]
                bc = None if bc is None else tree_map(lambda a: a[pidx], bc)
                h, c, aux = block_apply(per_params[j][pidx], h, blk, cache=bc,
                                        shared_params=pick_shared(pidx),
                                        shard=_sub(shard, "period", j), **common)
                aux_total = aux_total + aux
                cs.append(c)
            return h, aux_total, cs

        # each period's new cache is copied into one (n_periods, ...) tensor
        # per leaf as soon as it exists, so at most one period's worth of
        # new caches lives beside the stacked input and output
        stacked: List[Any] = [None] * len(plan.period)
        recompute = remat and mode == "train" and torch.is_grad_enabled()
        for pidx in range(plan.n_periods):
            if recompute:
                h, aux_total, _ = checkpoint(period, h, aux_total, pidx, use_reentrant=False)
                continue
            h, aux_total, cs = period(h, aux_total, pidx)
            if mode == "train":
                continue
            for j, c in enumerate(cs):
                if c is None:
                    continue
                if stacked[j] is None:
                    stacked[j] = tree_map(
                        lambda a: torch.empty((plan.n_periods, *a.shape), dtype=a.dtype,
                                              device=a.device), c)
                tree_map(lambda out, a: out[pidx].copy_(a), stacked[j], c)
        if mode != "train":
            new_caches["period"] = stacked

    for i, (blk, bp, bc) in enumerate(zip(plan.suffix, params["suffix"], caches["suffix"])):
        h, c, aux = block_apply(bp, h, blk, cache=bc,
                                shared_params=pick_shared(plan.n_periods),
                                shard=_sub(shard, "suffix", i), **common)
        new_caches["suffix"].append(c)
        aux_total = aux_total + aux

    return h, (new_caches if mode != "train" else None), aux_total


def init_stack_caches(cfg: ArchConfig, plan: LayerPlan, batch: int, cache_cap: int, *,
                      enc_len: int = 0, dtype: torch.dtype = torch.float32,
                      device: Optional[torch.device] = None) -> Any:
    """Zero caches for decode-from-scratch (period caches are real stacked
    tensors, not broadcast views: the batcher writes slots into them).  A
    mamba block's cache is its conv tails in ``dtype`` and its SSM state in
    float32; an MLA block's its latent and rope rows; a cross block adds
    ``enc_len`` rows of encoder K/V."""
    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    def one(blk: Block, lead=()):
        check_block(blk)
        c: Dict[str, Any] = {}
        if blk.mixer == "mamba":
            s = cfg.ssm
            gn, tail = s.n_groups * s.state, lead + (batch, s.conv_kernel - 1)
            c["mix"] = {"conv_x": zeros(tail + (s.d_inner,)),
                        "conv_B": zeros(tail + (gn,)), "conv_C": zeros(tail + (gn,)),
                        "ssm": zeros(lead + (batch, s.n_heads, s.head_dim, s.state),
                                     torch.float32)}
        elif blk.mixer == "mla":
            m = cfg.mla
            c["mix"] = {"ckv": zeros(lead + (batch, cache_cap, m.kv_lora_rank)),
                        "kpe": zeros(lead + (batch, cache_cap, m.rope_dim))}
        else:
            cap = min(cfg.window, cache_cap) if blk.mixer == "attn_local" else cache_cap
            shape = lead + (batch, cap, cfg.n_kv_heads, cfg.head_dim)
            c["mix"] = {"k": zeros(shape), "v": zeros(shape)}
        if blk.cross:
            shape = lead + (batch, enc_len, cfg.n_kv_heads, cfg.head_dim)
            c["cross"] = {"k": zeros(shape), "v": zeros(shape)}
        return c

    return {
        "prefix": [one(b) for b in plan.prefix],
        "period": [one(b, (plan.n_periods,)) for b in plan.period],
        "suffix": [one(b) for b in plan.suffix],
    }
