"""Attention blocks: GQA (global + sliding-window) — counterpart of
:mod:`repro.layers.attention`.  MLA, cross-attention and Zamba2-style
shared blocks are not ported yet: their entry points raise
``NotImplementedError`` naming the ROADMAP item that brings them.

Three modes share one code path:

* ``train``   — full-sequence causal attention, no cache.
* ``prefill`` — same compute; additionally returns the KV cache.
* ``decode``  — one new token per sequence against the cache.

Cache layout (per block):
  global attn:  {"k","v"}: (B, cap, Hkv, Dh) with cap = max context
  local  attn:  rolling buffer, cap = window; slot = position % cap

``lengths`` (B,) int32 counts valid cache entries BEFORE the current decode
step; the new token is written at slot ``lengths`` (mod cap for local) and
attention runs over ``min(lengths + 1, cap)`` entries.  A write past a
global cache's end is dropped, as JAX's scatter drops it.

Unlike the JAX package, whose projections call ``dense`` with its default
``ref`` backend, every projection here goes through ``cfg.backend("dense")``:
on the card that is the batch-invariant GEMM kernel, so a sequence's
decode step gives the same bits at batch 4 as at batch 1 (a library GEMM
picks its kernel by the row count).  On the CPU both are the same fp32
matmul.  Cache updates are functional (a new tensor), as in JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.layers.common import apply_rope, dense, dense_init, rope_for_seq, rope_table

Params = Dict[str, Any]
Cache = Optional[Dict[str, torch.Tensor]]

MLA_ITEM = "MLA is not ported yet (ROADMAP Queue 1 item 13d)"
CROSS_ITEM = "cross-attention is not ported yet (ROADMAP Queue 1 item 13e)"
SHARED_ITEM = ("Zamba2 shared attention blocks are not ported yet "
               "(ROADMAP Queue 1 item 13c)")


# --------------------------------------------------------------------------- #
# init
# --------------------------------------------------------------------------- #

def attn_init(gen: torch.Generator, cfg: ArchConfig, *,
              dtype: torch.dtype = torch.float32) -> Params:
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": dense_init(gen, d, hq * dh, dtype=dtype),
        "wk": dense_init(gen, d, hkv * dh, dtype=dtype),
        "wv": dense_init(gen, d, hkv * dh, dtype=dtype),
        "wo": dense_init(gen, hq * dh, d, dtype=dtype),
    }


def mla_init(gen: torch.Generator, cfg: ArchConfig, *, dtype=torch.float32) -> Params:
    raise NotImplementedError(MLA_ITEM)


# --------------------------------------------------------------------------- #
# GQA attention (global / sliding window)
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
               cache_cap: Optional[int] = None) -> Tuple[torch.Tensor, Cache]:
    """Returns (output, new_cache). x: (B,S,d) train/prefill, (B,1,d) decode."""
    if cross:
        return _cross_attn(p, x, cfg=cfg, mode=mode, cache=cache, enc_out=enc_out,
                           enc_lengths=enc_lengths)
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
    cap = cache["k"].shape[1]
    x0 = x[:, 0]
    q = dense(x0, p["wq"], backend=mb).reshape(b, hq, dh)
    k_new = dense(x0, p["wk"], backend=mb).reshape(b, hkv, dh)
    v_new = dense(x0, p["wv"], backend=mb).reshape(b, hkv, dh)
    cos, sin = rope_table(lengths, dh, cfg.rope_theta)              # (B, rd/2)
    cos, sin = cos[:, None, :], sin[:, None, :]
    q = apply_rope(q, cos, sin)
    k_new = apply_rope(k_new, cos, sin)
    slot = lengths % cap if window is not None else lengths
    ck = _write_rows(cache["k"], slot, k_new)
    cv = _write_rows(cache["v"], slot, v_new)
    eff_len = torch.clamp(lengths + 1, max=cap)
    o = kops.decode_attention(q, ck, cv, eff_len, backend=db)
    y = dense(o.reshape(b, 1, hq * dh), p["wo"], backend=mb)
    return y, {"k": ck, "v": cv}


def _cross_attn(p, x, *, cfg, mode, cache, enc_out, enc_lengths):
    raise NotImplementedError(CROSS_ITEM)


# --------------------------------------------------------------------------- #
# MLA (DeepSeek-V2) and Zamba2-style shared blocks: not ported yet
# --------------------------------------------------------------------------- #

def mla_apply(p: Params, x: torch.Tensor, *, cfg: ArchConfig, mode: str,
              cache: Cache = None, lengths: Optional[torch.Tensor] = None,
              cache_cap: Optional[int] = None) -> Tuple[torch.Tensor, Cache]:
    raise NotImplementedError(MLA_ITEM)


def shared_attn_init(gen: torch.Generator, cfg: ArchConfig, *,
                     dtype=torch.float32) -> Params:
    raise NotImplementedError(SHARED_ITEM)


def shared_attn_apply(p: Params, x: torch.Tensor, emb0: torch.Tensor, *,
                      cfg: ArchConfig, mode: str, cache: Cache = None,
                      lengths: Optional[torch.Tensor] = None,
                      cache_cap: Optional[int] = None) -> Tuple[torch.Tensor, Cache]:
    raise NotImplementedError(SHARED_ITEM)
