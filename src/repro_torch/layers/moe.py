"""Mixture-of-Experts channel mixer (routed top-k + optional shared experts)
— counterpart of :mod:`repro.layers.moe`.

Dispatch is capacity-based (Switch/GShard style): the routed tokens are
written into a dense (E, capacity, d) buffer and the expert FFNs run as
batched GEMMs through the registry (``moe_gemm``: ``ref`` einsum or the
``cuda`` batched-GEMM kernel).  Position-within-expert is a stable-sort
rank; tokens over capacity are dropped (weight 0).  Padding experts (qwen2's
60 -> 64) get router logits of -1e30, so they are never selected.

``dispatch="global"`` pools the capacity over all tokens of the call;
``"local"`` pools it per batch row, as JAX's vmapped dispatch does.  The
local path folds the batch into the GEMMs' rows: one (E, B*cap, d) launch
per projection, row ``b*cap + pos`` of expert e holding row b's token at
position ``pos``.  Each row's arithmetic is the same as in JAX's per-row
products (the ``cuda`` kernel's rows do not depend on M), and the experts'
weights are read once per call instead of once per row.  JAX's mesh
constraints on the dispatched buffer (``constrain`` under ``jit``) bind
specs to GSPMD and have no eager counterpart; they are not carried over.

The writes and sums give the same bits on any device: each kept token's
row is written (not added) into its own (expert, slot) — the pairs are
distinct — and a dropped token's row goes to a spare expert buffer that
the experts never read (one plain ``index_put_``; no boolean-mask
indexing, so the shapes do not depend on the data, nothing waits on the
device, and a step lowers on fake tensors); and each
token's top-k contributions are added in k order, as JAX's scatter-add
does on the CPU.

Data-parallel training passes ``dp`` (a
:class:`~repro_torch.sharding.collectives.GlobalBatch`): the rank holds its
rows of the global batch, and the routing terms are the global batch's.
The balance loss takes ``f`` from the expert counts summed over the ranks
and returns the rank's share ``E * sum_e f_e * probsum_e / T_global`` (the
shares add up to the single-device loss).  Under ``"global"`` dispatch the
capacity comes from the global token count, and a token's position within
its expert is offset by the counts of the lower data ranks (whose rows come
first in the global batch), so the same tokens drop as on one device; the
rank's dispatch buffer holds its own tokens at their local positions.
``"local"`` dispatch pools per row and needs only the global balance loss.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.layers.common import dense, dense_init
from repro_torch.layers.mlp import swiglu_apply, swiglu_init
from repro_torch.sharding.collectives import GlobalBatch

Params = Dict[str, Any]

__all__ = ["moe_init", "route", "moe_apply", "moe_apply_local"]


def moe_init(gen: torch.Generator, cfg: ArchConfig, *,
             dtype: torch.dtype = torch.float32) -> Params:
    mo = cfg.moe
    d, f, e = cfg.d_model, mo.d_expert, mo.n_experts

    def randn(shape):
        return torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)

    scale = 1.0 / math.sqrt(d)
    p: Params = {
        "router": dense_init(gen, d, e, dtype=torch.float32, scale=0.02),
        "w_gate": (randn((e, d, f)) * scale).to(dtype),
        "w_up": (randn((e, d, f)) * scale).to(dtype),
        "w_down": (randn((e, f, d)) / math.sqrt(f)).to(dtype),
    }
    if mo.n_shared:
        p["shared"] = swiglu_init(gen, d, mo.d_shared, dtype=dtype)
    return p


def _capacity(n_tokens: int, cfg: ArchConfig) -> int:
    """Slots per expert.  The round-up to 8 is part of the semantics: it
    decides which tokens drop."""
    mo = cfg.moe
    c = int(math.ceil(n_tokens * mo.top_k / mo.n_experts * mo.capacity_factor))
    return max(8, ((c + 7) // 8) * 8)


def route(logits: torch.Tensor, cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, E) router logits -> (top-k weights, top-k expert ids), ids in
    descending weight order."""
    mo = cfg.moe
    if mo.n_routed_padded and mo.n_routed_padded > mo.n_routed:
        pad = torch.arange(logits.shape[-1], device=logits.device) >= mo.n_routed
        logits = torch.where(pad[None, :], torch.full_like(logits, -1e30), logits)
    probs = torch.softmax(logits.float(), dim=-1)
    topw, topi = torch.topk(probs, mo.top_k, dim=-1, sorted=True)
    if mo.router_norm_topk:
        topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    return topw, topi


def _aux_loss(logits: torch.Tensor, topi: torch.Tensor, e: int,
              total: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Switch load-balance loss E * sum_e f_e p_e, from the unmasked logits.
    ``total`` (the global batch's expert counts, summed over the data
    ranks) makes it this rank's share of the global batch's loss."""
    probs = torch.softmax(logits.float(), dim=-1)
    if total is None:
        frac_tokens = _expert_counts(topi, e).float() / topi.numel()
        return e * torch.sum(frac_tokens * probs.mean(0))
    n = total.sum().float()                                      # global T * k
    t_global = n / topi.shape[-1]
    return e * torch.sum(total.float() / n * (probs.sum(0) / t_global))


def _expert_counts(ids: torch.Tensor, e: int) -> torch.Tensor:
    """How many entries of ``ids`` pick each of the ``e`` experts (int64):
    ``bincount(minlength=e)``'s counts, as a fixed-shape comparison, so a
    step also runs on fake tensors (launch/cells.py)."""
    return (ids.reshape(-1, 1) == torch.arange(e, device=ids.device)).sum(0)


def _dispatch(expert: torch.Tensor, slot_c: torch.Tensor, keep: torch.Tensor,
              rows: torch.Tensor, e: int, m: int) -> torch.Tensor:
    """(E, m, d) buffer holding each kept entry's row at ``[expert,
    slot_c]`` and zeros elsewhere.  The kept slots are distinct, so each
    holds its one row bit for bit; a dropped entry's row goes to a spare
    expert ``e``, which is sliced off unread, whatever the row holds.  No
    boolean-mask indexing: the shapes do not depend on the data."""
    xe = torch.zeros((e + 1, m, rows.shape[-1]), dtype=rows.dtype, device=rows.device)
    xe.index_put_((torch.where(keep, expert, e), slot_c), rows)
    return xe[:e]


def _positions(fi: torch.Tensor, e: int) -> torch.Tensor:
    """fi (R, T*k) expert ids per pool -> each entry's position within its
    expert, in token order (a stable sort's rank)."""
    order = torch.argsort(fi, dim=-1, stable=True)
    counts = torch.zeros((fi.shape[0], e), dtype=torch.long, device=fi.device)
    counts.scatter_add_(1, fi, torch.ones_like(fi))
    starts = torch.cumsum(counts, dim=-1) - counts
    ranks = torch.arange(fi.shape[1], device=fi.device)[None, :]
    pos_sorted = ranks - torch.gather(starts, 1, torch.gather(fi, 1, order))
    return torch.empty_like(fi).scatter_(1, order, pos_sorted)


def _experts(p: Params, xe: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """(E, M, d) dispatched rows -> (E, M, d) through the expert SwiGLUs."""
    mb = cfg.backend("moe_gemm")
    g = kops.moe_gemm(xe, p["w_gate"].to(xe.dtype), backend=mb)
    u = kops.moe_gemm(xe, p["w_up"].to(xe.dtype), backend=mb)
    h = kops.swiglu(g, u, backend=cfg.backend("swiglu"))
    return kops.moe_gemm(h, p["w_down"].to(xe.dtype), backend=mb)


def _combine(gathered: torch.Tensor) -> torch.Tensor:
    """(..., k, d) weighted expert outputs -> (..., d), added in k order."""
    y = gathered[..., 0, :]
    for j in range(1, gathered.shape[-2]):
        y = y + gathered[..., j, :]
    return y


def _route(p: Params, xt: torch.Tensor, cfg: ArchConfig):
    """(router logits, top-k weights, top-k ids) of (T, d) tokens."""
    logits = dense(xt.float(), p["router"].float(), backend=cfg.backend("dense"))
    return (logits, *route(logits, cfg))


def moe_apply(p: Params, x: torch.Tensor, *, cfg: ArchConfig,
              dp: Optional[GlobalBatch] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d), aux_loss scalar tensor)."""
    if cfg.moe.dispatch == "local":
        return moe_apply_local(p, x, cfg=cfg, dp=dp)
    mo = cfg.moe
    b, s, d = x.shape
    t, k, e = b * s, mo.top_k, mo.n_experts
    xt = x.reshape(t, d)
    logits, topw, topi = _route(p, xt, cfg)

    fi = topi.reshape(-1)                                        # (T*k,)
    slot = _positions(fi[None], e)[0]                            # within this call's tokens
    if dp is None:
        pos, total, t_all = slot, None, t
    else:                                                        # within the global batch
        before, total = dp.before(_expert_counts(fi, e))
        pos, t_all = slot + before[fi], dp.total_rows(t)
    aux = _aux_loss(logits, topi, e, total)
    cap = _capacity(t_all, cfg)
    keep = pos < cap
    slot_c = torch.clamp(slot, max=cap - 1)
    tok = torch.arange(t, device=x.device).repeat_interleave(k)

    xe = _dispatch(fi, slot_c, keep, xt[tok], e, cap)
    ye = _experts(p, xe, cfg)                                    # (E, cap, d)

    weight = (keep * topw.reshape(-1)).to(x.dtype)
    y = _combine((ye[fi, slot_c] * weight[:, None]).reshape(t, k, d))
    if mo.n_shared:
        y = y + swiglu_apply(p["shared"], xt, cfg=cfg)
    return y.reshape(b, s, d), aux


def moe_apply_local(p: Params, x: torch.Tensor, *, cfg: ArchConfig,
                    dp: Optional[GlobalBatch] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch-local dispatch: capacity pools and ranks per batch row (per-row
    drops instead of global drops), the rows folded into one GEMM row axis."""
    mo = cfg.moe
    b, s, d = x.shape
    k, e = mo.top_k, mo.n_experts
    cap = _capacity(s, cfg)
    logits, topw, topi = _route(p, x.reshape(b * s, d), cfg)
    total = None if dp is None else dp.sum(_expert_counts(topi, e))
    aux = _aux_loss(logits, topi, e, total)

    fi = topi.reshape(b, s * k)
    pos = _positions(fi, e)
    keep = pos < cap
    rows = torch.arange(b, device=x.device)[:, None] * cap
    slot_c = rows + torch.clamp(pos, max=cap - 1)
    tok = torch.arange(s, device=x.device).repeat_interleave(k)
    src = (torch.arange(b, device=x.device)[:, None] * s + tok[None, :]).reshape(-1)

    xe = _dispatch(fi.reshape(-1), slot_c.reshape(-1), keep.reshape(-1),
                   x.reshape(b * s, d)[src], e, b * cap)
    ye = _experts(p, xe, cfg)                                    # (E, B*cap, d)

    weight = (keep * topw.reshape(b, s * k)).to(x.dtype)
    y = _combine((ye[fi, slot_c] * weight[..., None]).reshape(b, s, k, d))
    if mo.n_shared:
        y = y + swiglu_apply(p["shared"], x.reshape(b * s, d), cfg=cfg).reshape(b, s, d)
    return y, aux
