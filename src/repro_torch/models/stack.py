"""Block-stack machinery: init/apply for a LayerPlan (prefix + periods +
suffix) — counterpart of :mod:`repro.models.stack`.

Parameters for position i of the period are stacked along axis 0
(n_periods, ...), as in the JAX package, and caches follow the same layout.
JAX scans over that axis; here the period loop is a Python loop over it.

Blocks with ``attn``/``attn_local`` mixers and ``swiglu``/``mlp`` FFNs are
ported.  ``mla``, ``mamba`` and ``shared_attn`` mixers, ``moe`` FFNs and
cross-attention raise ``NotImplementedError`` naming the ROADMAP item that
brings them.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, Block, LayerPlan
from repro_torch.layers.attention import (CROSS_ITEM, MLA_ITEM, SHARED_ITEM, attn_apply,
                                          attn_init)
from repro_torch.layers.common import norm
from repro_torch.layers.mlp import mlp_apply, mlp_init, swiglu_apply, swiglu_init

Params = Dict[str, Any]

MAMBA_ITEM = "Mamba2 (SSD) mixers are not ported yet (ROADMAP Queue 1 item 13c)"
MOE_ITEM = "MoE FFNs are not ported yet (ROADMAP Queue 1 item 13b)"
_NOT_PORTED = {"mla": MLA_ITEM, "mamba": MAMBA_ITEM, "shared_attn": SHARED_ITEM,
               "moe": MOE_ITEM}


def check_block(blk: Block) -> None:
    """Raise ``NotImplementedError`` for a block the port cannot run yet,
    ``ValueError`` for one no config describes."""
    for kind in (blk.mixer, blk.ffn):
        if kind in _NOT_PORTED:
            raise NotImplementedError(_NOT_PORTED[kind])
    if blk.cross:
        raise NotImplementedError(CROSS_ITEM)
    if blk.mixer not in ("attn", "attn_local"):
        raise ValueError(f"unknown mixer {blk.mixer!r}")
    if blk.ffn not in ("swiglu", "mlp", "none"):
        raise ValueError(f"unknown ffn {blk.ffn!r}")


def _tree_map(fn, *trees):
    """``fn`` over the tensors of dict/list trees of one structure."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return [_tree_map(fn, *xs) for xs in zip(*trees)]
    if t0 is None:
        return None
    return fn(*trees)


# --------------------------------------------------------------------------- #
# single block
# --------------------------------------------------------------------------- #

def block_init(gen: torch.Generator, cfg: ArchConfig, blk: Block, *,
               dtype: torch.dtype = torch.float32) -> Params:
    check_block(blk)
    d = cfg.d_model
    p: Params = {"norm1": torch.ones((d,), dtype=dtype, device=gen.device),
                 "mixer": attn_init(gen, cfg, dtype=dtype)}
    if blk.ffn != "none":
        p["norm2"] = torch.ones((d,), dtype=dtype, device=gen.device)
        init = swiglu_init if blk.ffn == "swiglu" else mlp_init
        p["ffn"] = init(gen, d, cfg.d_ff, dtype=dtype)
    return p


def block_apply(p: Params, h: torch.Tensor, blk: Block, *, cfg: ArchConfig,
                mode: str, cache: Any = None, lengths=None,
                cache_cap: Optional[int] = None, causal: bool = True
                ) -> Tuple[torch.Tensor, Any, float]:
    """Returns (h, new_cache, aux_loss). ``cache`` is a dict with optional
    key 'mix' (block-level cache container).  aux_loss is 0: only MoE
    blocks have one."""
    check_block(blk)
    cache = cache or {}
    new_cache: Dict[str, Any] = {}
    nb = cfg.backend("rmsnorm")
    eps = cfg.norm_eps

    x = norm(h, p["norm1"], eps=eps, backend=nb)
    window = cfg.window if blk.mixer == "attn_local" else None
    y, c = attn_apply(p["mixer"], x, cfg=cfg, mode=mode, window=window,
                      cache=cache.get("mix"), lengths=lengths,
                      cache_cap=cache_cap, causal=causal)
    h = h + y
    if c is not None:
        new_cache["mix"] = c

    if blk.ffn != "none":
        x = norm(h, p["norm2"], eps=eps, backend=nb)
        fn = swiglu_apply if blk.ffn == "swiglu" else mlp_apply
        h = h + fn(p["ffn"], x, cfg=cfg)

    return h, (new_cache if new_cache else None), 0.0


# --------------------------------------------------------------------------- #
# stack = prefix + periods + suffix
# --------------------------------------------------------------------------- #

def stack_init(gen: torch.Generator, cfg: ArchConfig, plan: LayerPlan, *,
               dtype: torch.dtype = torch.float32) -> Params:
    p: Params = {"prefix": [], "period": [], "suffix": []}
    for blk in plan.prefix:
        p["prefix"].append(block_init(gen, cfg, blk, dtype=dtype))
    for blk in plan.period:
        per = [block_init(gen, cfg, blk, dtype=dtype) for _ in range(plan.n_periods)]
        p["period"].append(_tree_map(lambda *xs: torch.stack(xs), *per) if per else {})
    for blk in plan.suffix:
        p["suffix"].append(block_init(gen, cfg, blk, dtype=dtype))
    return p


def stack_apply(params: Params, h: torch.Tensor, plan: LayerPlan, *,
                cfg: ArchConfig, mode: str, caches: Any = None,
                lengths=None, cache_cap: Optional[int] = None, causal: bool = True):
    """Returns (h, new_caches, aux_total); new_caches is None in train mode."""
    aux_total = 0.0
    caches = caches or {"prefix": [None] * len(plan.prefix),
                        "period": [None] * len(plan.period),
                        "suffix": [None] * len(plan.suffix)}
    new_caches: Dict[str, Any] = {"prefix": [], "period": None, "suffix": []}
    common = dict(cfg=cfg, mode=mode, lengths=lengths, cache_cap=cache_cap, causal=causal)

    for blk, bp, bc in zip(plan.prefix, params["prefix"], caches["prefix"]):
        h, c, aux = block_apply(bp, h, blk, cache=bc, **common)
        new_caches["prefix"].append(c)
        aux_total = aux_total + aux

    if plan.n_periods > 0:
        collected: List[List[Any]] = []
        for pidx in range(plan.n_periods):
            cs = []
            for j, blk in enumerate(plan.period):
                bp = _tree_map(lambda a: a[pidx], params["period"][j])
                bc = caches["period"][j]
                bc = None if bc is None else _tree_map(lambda a: a[pidx], bc)
                h, c, aux = block_apply(bp, h, blk, cache=bc, **common)
                aux_total = aux_total + aux
                cs.append(c)
            collected.append(cs)
        if mode != "train":
            new_caches["period"] = _tree_map(lambda *xs: torch.stack(xs), *collected)

    for blk, bp, bc in zip(plan.suffix, params["suffix"], caches["suffix"]):
        h, c, aux = block_apply(bp, h, blk, cache=bc, **common)
        new_caches["suffix"].append(c)
        aux_total = aux_total + aux

    return h, (new_caches if mode != "train" else None), aux_total


def init_stack_caches(cfg: ArchConfig, plan: LayerPlan, batch: int, cache_cap: int, *,
                      dtype: torch.dtype = torch.float32,
                      device: Optional[torch.device] = None) -> Any:
    """Zero caches for decode-from-scratch (period caches are real stacked
    tensors, not broadcast views: the batcher writes slots into them)."""
    def one(blk: Block, lead=()):
        check_block(blk)
        cap = min(cfg.window, cache_cap) if blk.mixer == "attn_local" else cache_cap
        shape = lead + (batch, cap, cfg.n_kv_heads, cfg.head_dim)
        return {"mix": {"k": torch.zeros(shape, dtype=dtype, device=device),
                        "v": torch.zeros(shape, dtype=dtype, device=device)}}

    return {
        "prefix": [one(b) for b in plan.prefix],
        "period": [one(b, (plan.n_periods,)) for b in plan.period],
        "suffix": [one(b) for b in plan.suffix],
    }
