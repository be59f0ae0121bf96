"""Attention blocks: GQA (global + sliding-window), MLA (DeepSeek-V2),
cross-attention (enc-dec) and Zamba2-style shared blocks — counterpart of
:mod:`repro.layers.attention`.

Three modes share one code path per variant:

* ``train``   — full-sequence attention (causal unless the caller says
  otherwise), no cache.
* ``prefill`` — same compute; additionally returns the KV cache.
* ``decode``  — one new token per sequence against the cache.

Cache layout (per block):
  global attn:  {"k","v"}: (B, cap, Hkv, Dh) with cap = max context
  local  attn:  rolling buffer, cap = window; slot = position % cap
  MLA:          {"ckv": (B, cap, rank), "kpe": (B, cap, rope_dim)}, the
                latent cache, zero past the prompt; decode absorbs W_uk into
                the query and W_uv into the output and runs one-KV-head
                flash-decode over [ckv, kpe] (D = rank + rope_dim) with the
                latent as V (Dv = rank)
  cross attn:   the encoder's K/V, computed once at prefill and read-only
                afterwards

``lengths`` (B,) int32 counts valid cache entries BEFORE the current decode
step; the new token is written at slot ``lengths`` (mod cap for local) and
attention runs over ``min(lengths + 1, cap)`` entries.  A write past a
global or latent cache's end is dropped, as JAX's scatter drops it.

Unlike the JAX package, whose projections call ``dense`` with its default
``ref`` backend, every projection here goes through ``cfg.backend("dense")``:
on the card that is the batch-invariant GEMM kernel, so a sequence's
decode step gives the same bits at batch 4 as at batch 1 (a library GEMM
picks its kernel by the row count).  For the same reason MLA's two absorbed
per-head products (JAX: einsums outside any kernel) go through
``moe_gemm`` (``cfg.backend("moe_gemm")``; on the card the batched GEMM
kernel, heads as experts, the batch as rows) on per-head weights ``wuk_h``
(H, nope, rank) and ``wuv_h`` (H, rank, v): leaves derived from ``wuk`` and
``wuv`` once, when the params are built (:func:`with_mla_heads`).  On the
CPU both are the same fp32 products.  Cache updates are functional (a new
tensor), as in JAX.

On a process mesh, decode takes ``shard``
(:class:`repro_torch.runtime.serve.ServeShard`): the cache is the rank's
slice, its KV heads split over "model" (the rank projects and attends
over its heads, then all-gathers them) or its length split (a write lands
only on the rank that owns the row; attention is the tree decode).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.layers.common import (apply_rope, dense, dense_init, norm, rope_for_seq,
                                       rope_table)

Params = Dict[str, Any]
Cache = Optional[Dict[str, torch.Tensor]]


# --------------------------------------------------------------------------- #
# init
# --------------------------------------------------------------------------- #

def attn_init(gen: torch.Generator, cfg: ArchConfig, *, cross: bool = False,
              dtype: torch.dtype = torch.float32) -> Params:
    """Q/K/V/O projections; a cross-attention block (``cross``) has the same
    leaves, its K/V read from the encoder."""
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": dense_init(gen, d, hq * dh, dtype=dtype),
        "wk": dense_init(gen, d, hkv * dh, dtype=dtype),
        "wv": dense_init(gen, d, hkv * dh, dtype=dtype),
        "wo": dense_init(gen, hq * dh, d, dtype=dtype),
    }


def mla_init(gen: torch.Generator, cfg: ArchConfig, *, dtype=torch.float32) -> Params:
    """JAX's leaves (the up-projections from the latent are (rank, H * w)),
    plus the derived per-head ``wuk_h`` / ``wuv_h``."""
    d, hq = cfg.d_model, cfg.n_heads
    m = cfg.mla
    return with_mla_heads({
        "wq": dense_init(gen, d, hq * m.qk_dim, dtype=dtype),
        "wdkv": dense_init(gen, d, m.kv_lora_rank, dtype=dtype),
        "wkpe": dense_init(gen, d, m.rope_dim, dtype=dtype),
        "wuk": dense_init(gen, m.kv_lora_rank, hq * m.nope_dim, dtype=dtype),
        "wuv": dense_init(gen, m.kv_lora_rank, hq * m.v_dim, dtype=dtype),
        "wo": dense_init(gen, hq * m.v_dim, d, dtype=dtype),
    })


def is_mla(p: Any) -> bool:
    """Whether ``p`` is an MLA mixer's params (its JAX leaves)."""
    return isinstance(p, dict) and all(k in p for k in ("wq", "wdkv", "wkpe", "wuk", "wuv"))


def with_mla_heads(p: Params) -> Params:
    """Add ``wuk_h`` (..., H, nope, rank) and ``wuv_h`` (..., H, rank, v) to
    an MLA mixer's params (leading axes, such as a stack's period axis,
    kept): ``wuk`` (..., rank, H * nope) and ``wuv`` (..., rank, H * v)
    regrouped by head, contiguous, once.  H is read from the shapes:
    ``wq`` has H * (nope + rope) columns, ``wkpe`` rope."""
    wq, wuk, wuv = p["wq"], p["wuk"], p["wuv"]
    h = (wq.shape[-1] - wuk.shape[-1]) // p["wkpe"].shape[-1]
    rank = wuk.shape[-2]
    lead = wuk.shape[:-2]
    n = len(lead)
    p["wuk_h"] = wuk.reshape(*lead, rank, h, -1).permute(
        *range(n), n + 1, n + 2, n).contiguous()
    p["wuv_h"] = wuv.reshape(*lead, rank, h, -1).permute(
        *range(n), n + 1, n, n + 2).contiguous()
    return p


# --------------------------------------------------------------------------- #
# GQA attention (global / sliding window / cross)
# --------------------------------------------------------------------------- #

def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, -1)


def _write_rows(cache: torch.Tensor, slot: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """cache (B, cap, ...) with row ``slot[b]`` of sequence b set to
    ``new[b]``; a slot >= cap writes nothing (JAX's scatter drops it, and
    an index past the end would fault on the card)."""
    cap = cache.shape[1]
    hit = torch.arange(cap, device=cache.device)[None, :] == slot[:, None]   # (B, cap)
    hit = hit.reshape(hit.shape + (1,) * (cache.dim() - 2))
    return torch.where(hit, new.to(cache.dtype)[:, None], cache)


def attn_apply(p: Params, x: torch.Tensor, *, cfg: ArchConfig, mode: str,
               window: Optional[int] = None, cache: Cache = None,
               lengths: Optional[torch.Tensor] = None,
               enc_out: Optional[torch.Tensor] = None,
               enc_lengths: Optional[torch.Tensor] = None,
               cross: bool = False, causal: bool = True,
               cache_cap: Optional[int] = None, shard: Any = None) -> Tuple[torch.Tensor, Cache]:
    """Returns (output, new_cache). x: (B,S,d) train/prefill, (B,1,d) decode.
    ``shard`` (decode on a mesh: :class:`repro_torch.runtime.serve.ServeShard`)
    says which slice of the cache this rank holds."""
    if cross:
        return _cross_attn(p, x, cfg=cfg, mode=mode, cache=cache, enc_out=enc_out,
                           enc_lengths=enc_lengths, shard=shard)
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ab = cfg.backend("attention")
    db = cfg.backend("decode_attention")
    mb = cfg.backend("dense")

    if mode in ("train", "prefill"):
        b, s, _ = x.shape
        q = _split_heads(dense(x, p["wq"], backend=mb), hq)
        k = _split_heads(dense(x, p["wk"], backend=mb), hkv)
        v = _split_heads(dense(x, p["wv"], backend=mb), hkv)
        cos, sin = rope_for_seq(s, dh, cfg.rope_theta, device=x.device)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        o = kops.attention(q, k, v, causal=causal, window=window, backend=ab)
        y = dense(o.reshape(b, s, hq * dh), p["wo"], backend=mb)
        new_cache = None
        if mode == "prefill":
            cap = cache_cap or s
            if window is not None:
                cap = min(cap, window)
            if cap == s:       # the whole sequence is the buffer
                ck, cv = k, v
            else:
                ck = k.new_zeros((b, cap, hkv, dh))
                cv = v.new_zeros((b, cap, hkv, dh))
                if cap > s:    # straight copy into the head of the buffer
                    ck[:, :s] = k
                    cv[:, :s] = v
                else:          # rolling buffer: token t lives at slot t % cap
                    idx = torch.arange(s - cap, s, device=x.device) % cap
                    ck[:, idx] = k[:, s - cap:]
                    cv[:, idx] = v[:, s - cap:]
            new_cache = {"k": ck, "v": cv}
        return y, new_cache

    if mode != "decode":
        raise ValueError(f"unknown mode {mode!r}")
    if cache is None or lengths is None:
        raise ValueError("decode needs a cache and lengths")
    b = x.shape[0]
    cap = cache["k"].shape[1]             # this rank's rows: cap * n_len in all
    x0 = x[:, 0]
    wq, wk, wv = _head_cols(p, shard, "k", hq, hkv, dh)
    q = dense(x0, wq, backend=mb).reshape(b, -1, dh)
    k_new = dense(x0, wk, backend=mb).reshape(b, -1, dh)
    v_new = dense(x0, wv, backend=mb).reshape(b, -1, dh)
    cos, sin = rope_table(lengths, dh, cfg.rope_theta)              # (B, rd/2)
    cos, sin = cos[:, None, :], sin[:, None, :]
    q = apply_rope(q, cos, sin)
    k_new = apply_rope(k_new, cos, sin)
    n_len = 1 if shard is None else shard.split("k", 1)[0]
    slot = lengths % (cap * n_len) if window is not None else lengths
    if shard is not None:
        slot = shard.local_slot("k", slot, cap)
    ck = _write_rows(cache["k"], slot, k_new)
    cv = _write_rows(cache["v"], slot, v_new)
    eff_len = torch.clamp(lengths + 1, max=cap * n_len)
    if shard is None:
        o = kops.decode_attention(q, ck, cv, eff_len, backend=db)
    else:
        o = shard.gather(shard.attend(q, ck, cv, eff_len, "k", backend=db), "k", 2, 1)
    y = dense(o.reshape(b, 1, hq * dh), p["wo"], backend=mb)
    return y, {"k": ck, "v": cv}


def _head_cols(p: Params, shard: Any, name: str, hq: int, hkv: int, dh: int):
    """(wq, wk, wv): the whole projections, or their columns of this rank's
    query and KV heads when ``shard`` splits leaf ``name``'s heads."""
    heads = None if shard is None else shard.heads(name, hq, hkv)
    if heads is None:
        return p["wq"], p["wk"], p["wv"]
    qs, ks = heads

    def cols(w, sl):
        return w[:, sl.start * dh:sl.stop * dh].contiguous()

    return cols(p["wq"], qs), cols(p["wk"], ks), cols(p["wv"], ks)


def _cross_attn(p, x, *, cfg, mode, cache, enc_out, enc_lengths, shard=None):
    """Decoder rows over the encoder's: non-causal and without RoPE.  At
    train / prefill K/V come from ``enc_out`` (and prefill returns them as
    the cache); at decode from the read-only cache, ``enc_lengths`` rows of
    each."""
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    mb = cfg.backend("dense")
    b, s = x.shape[0], x.shape[1]
    if mode in ("train", "prefill"):
        if enc_out is None:
            raise ValueError(f"cross-attention {mode} needs enc_out")
        k = _split_heads(dense(enc_out, p["wk"], backend=mb), hkv)
        v = _split_heads(dense(enc_out, p["wv"], backend=mb), hkv)
    elif mode == "decode":
        if cache is None or enc_lengths is None:
            raise ValueError("cross-attention decode needs its cache and enc_lengths")
        k, v = cache["k"], cache["v"]
    else:
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "decode" and shard is not None:
        wq = _head_cols(p, shard, "k", hq, hkv, dh)[0]
        q = dense(x[:, 0], wq, backend=mb).reshape(b, -1, dh)
        o = shard.attend(q, k, v, enc_lengths, "k", backend=cfg.backend("decode_attention"))
        o = shard.gather(o, "k", 2, 1)[:, None]
        y = dense(o.reshape(b, s, hq * dh), p["wo"], backend=mb)
        return y, cache
    q = _split_heads(dense(x, p["wq"], backend=mb), hq)
    if mode == "decode":
        o = kops.decode_attention(q[:, 0].contiguous(), k, v, enc_lengths,
                                  backend=cfg.backend("decode_attention"))[:, None]
    else:
        o = kops.attention(q, k, v, causal=False, backend=cfg.backend("attention"))
    y = dense(o.reshape(b, s, hq * dh), p["wo"], backend=mb)
    new_cache = {"k": k, "v": v} if mode == "prefill" else (cache if mode == "decode" else None)
    return y, new_cache


# --------------------------------------------------------------------------- #
# MLA (DeepSeek-V2): latent KV cache + absorbed decode
# --------------------------------------------------------------------------- #

def mla_apply(p: Params, x: torch.Tensor, *, cfg: ArchConfig, mode: str,
              cache: Cache = None, lengths: Optional[torch.Tensor] = None,
              cache_cap: Optional[int] = None, shard: Any = None) -> Tuple[torch.Tensor, Cache]:
    """Returns (output, new_cache).  Train / prefill attend with the
    up-projected K (nope + the shared rope key, D = qk) and V; decode
    attends over the latent cache (the absorbed form).  Both use the scale
    1 / sqrt(qk_dim), passed explicitly."""
    m = cfg.mla
    hq = cfg.n_heads
    scale = 1.0 / math.sqrt(m.qk_dim)
    mb = cfg.backend("dense")
    if mode in ("train", "prefill"):
        b, s, _ = x.shape
        q = dense(x, p["wq"], backend=mb).reshape(b, s, hq, m.qk_dim)
        q_nope, q_pe = q[..., :m.nope_dim], q[..., m.nope_dim:]
        ckv = dense(x, p["wdkv"], backend=mb)                      # (B,S,rank)
        kpe = dense(x, p["wkpe"], backend=mb)                      # (B,S,rope_dim)
        cos, sin = rope_for_seq(s, m.rope_dim, cfg.rope_theta, rotary_dim=m.rope_dim,
                                device=x.device)
        q_pe = apply_rope(q_pe, cos, sin)
        kpe = apply_rope(kpe[:, :, None, :], cos, sin)             # (B,S,1,rd)
        k_nope = dense(ckv, p["wuk"], backend=mb).reshape(b, s, hq, m.nope_dim)
        v = dense(ckv, p["wuv"], backend=mb).reshape(b, s, hq, m.v_dim)
        k = torch.cat([k_nope, kpe.expand(b, s, hq, m.rope_dim)], dim=-1)
        qc = torch.cat([q_nope, q_pe], dim=-1)
        o = kops.attention(qc, k, v, causal=True, scale=scale,
                           backend=cfg.backend("attention"))
        y = dense(o.reshape(b, s, hq * m.v_dim), p["wo"], backend=mb)
        new_cache = None
        if mode == "prefill":
            cap = cache_cap or s
            ckv_c, kpe_c = ckv, kpe[:, :, 0, :]
            if cap > s:
                ckv_c = torch.cat([ckv_c, ckv.new_zeros((b, cap - s, m.kv_lora_rank))], dim=1)
                kpe_c = torch.cat([kpe_c, kpe.new_zeros((b, cap - s, m.rope_dim))], dim=1)
            new_cache = {"ckv": ckv_c, "kpe": kpe_c}
        return y, new_cache

    if mode != "decode":
        raise ValueError(f"unknown mode {mode!r}")
    if cache is None or lengths is None:
        raise ValueError("decode needs a cache and lengths")
    # absorbed: score = q_nope^T Wuk ckv + q_pe^T kpe, out = (P ckv) Wuv
    b = x.shape[0]
    x0 = x[:, 0]
    gb = cfg.backend("moe_gemm")
    q = dense(x0, p["wq"], backend=mb).reshape(b, hq, m.qk_dim)
    q_nope, q_pe = q[..., :m.nope_dim], q[..., m.nope_dim:]
    cos, sin = rope_table(lengths, m.rope_dim, cfg.rope_theta, rotary_dim=m.rope_dim)
    cos, sin = cos[:, None, :], sin[:, None, :]
    q_pe = apply_rope(q_pe, cos, sin)
    ckv_new = dense(x0, p["wdkv"], backend=mb)                     # (B,rank)
    kpe_new = apply_rope(dense(x0, p["wkpe"], backend=mb)[:, None, :], cos, sin)[:, 0]
    slot = lengths if shard is None else shard.local_slot("ckv", lengths, cache["ckv"].shape[1])
    ckv = _write_rows(cache["ckv"], slot, ckv_new)
    kpe = _write_rows(cache["kpe"], slot, kpe_new)
    # q_lat[b, h] = q_nope[b, h] @ Wuk[h]: heads as experts, the batch as rows
    q_lat = kops.moe_gemm(q_nope.transpose(0, 1).contiguous(), p["wuk_h"], backend=gb)
    q_cat = torch.cat([q_lat.transpose(0, 1), q_pe], dim=-1)       # (B,H,rank+rd)
    k_cat = torch.cat([ckv, kpe], dim=-1)[:, :, None, :]           # (B,S,1,rank+rd)
    attend = kops.decode_attention if shard is None else partial(shard.attend, name="ckv")
    o_lat = attend(q_cat, k_cat, ckv[:, :, None, :], lengths + 1, scale=scale,
                   backend=cfg.backend("decode_attention"))                 # (B,H,rank)
    # out[b, h] = o_lat[b, h] @ Wuv[h]
    o = kops.moe_gemm(o_lat.transpose(0, 1).contiguous(), p["wuv_h"], backend=gb)
    y = dense(o.transpose(0, 1).reshape(b, 1, hq * m.v_dim), p["wo"], backend=mb)
    return y, {"ckv": ckv, "kpe": kpe}


# --------------------------------------------------------------------------- #
# Zamba2-style shared attention block (weights shared across periods)
# --------------------------------------------------------------------------- #

def shared_attn_init(gen: torch.Generator, cfg: ArchConfig, *,
                     dtype=torch.float32) -> Params:
    from repro_torch.layers.mlp import swiglu_init  # local import to avoid a cycle
    d = cfg.d_model
    return {
        "fuse": dense_init(gen, 2 * d, d, dtype=dtype),
        "attn": attn_init(gen, cfg, dtype=dtype),
        "mlp": swiglu_init(gen, d, cfg.d_ff, dtype=dtype),
        "norm1": torch.ones((d,), dtype=dtype, device=gen.device),
        "norm2": torch.ones((d,), dtype=dtype, device=gen.device),
    }


def shared_attn_apply(p: Params, x: torch.Tensor, emb0: torch.Tensor, *,
                      cfg: ArchConfig, mode: str, cache: Cache = None,
                      lengths: Optional[torch.Tensor] = None,
                      cache_cap: Optional[int] = None, shard: Any = None
                      ) -> Tuple[torch.Tensor, Cache]:
    """Zamba2 shared block: fuse(concat(h, initial embedding)) -> attention
    and SwiGLU halves, each with its own norm and residual around it.  The
    result replaces the caller's hidden state: no residual is added outside
    (JAX's ``block_apply`` adds none, whatever its docstring says)."""
    from repro_torch.layers.mlp import swiglu_apply
    nb, eps = cfg.backend("rmsnorm"), cfg.norm_eps
    h_in = dense(torch.cat([x, emb0], dim=-1), p["fuse"],
                 backend=cfg.backend("dense"))
    a, new_cache = attn_apply(p["attn"], norm(h_in, p["norm1"], eps=eps, backend=nb), cfg=cfg,
                              mode=mode, cache=cache, lengths=lengths, cache_cap=cache_cap,
                              shard=shard)
    h = h_in + a
    h = h + swiglu_apply(p["mlp"], norm(h, p["norm2"], eps=eps, backend=nb), cfg=cfg)
    return h, new_cache
