"""Serving graph ops — counterpart of :mod:`repro.kernels.serving_ops`, for
the dense-cache path.

* ``embedding``       — token id -> row lookup (``ref``).
* ``cache_update``    — length-aware scatter of new K/V rows into a
  fixed-capacity cache at per-sequence offsets (``ref``).  Functional: it
  returns a new cache and never writes its input.
* ``chunk_attention`` — chunked-prefill attention: query t at absolute
  position ``start + t`` attends cache keys at positions ``<= start + t``
  (``ref``, and ``cuda``: the hand-written flash kernel).

Op names, input order, attrs, shape and cost functions match ``repro``'s.
The paged, int8, verify and tensor-parallel serving ops are not ported yet.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from repro_torch.core.ir import TensorSpec
from repro_torch.core.registry import Cost, defop, impl
from repro_torch.kernels import ref as R
from repro_torch.kernels.flash_attention import chunk_fits, flash_chunk_attention



def _bytes(specs: Sequence[TensorSpec]) -> float:
    return float(sum(s.nbytes for s in specs))


# --------------------------------------------------------------------------- #
# embedding — inputs (ids (B,T) int32, table (V,D))
# --------------------------------------------------------------------------- #

def _embedding_shape(specs, attrs):
    ids, table = specs
    return [TensorSpec(tuple(ids.shape) + (table.shape[1],), table.dtype)]


def _embedding_cost(specs, attrs):
    out = _embedding_shape(specs, attrs)[0]
    return Cost(flops=0.0, bytes=2.0 * out.nbytes + specs[0].nbytes)


defop("embedding", _embedding_shape, _embedding_cost,
      doc="token embedding lookup; inputs (ids (B,T) int32, table (V,D))")


@impl("embedding", "ref")
def _embedding_ref(inputs, attrs):
    ids, table = inputs
    rows = torch.index_select(table, 0, ids.reshape(-1))
    return [rows.reshape(*ids.shape, table.shape[1])]


# --------------------------------------------------------------------------- #
# cache_update — inputs (cache (B,S,H,D), new (B,T,H,D), start (B,), n_new (B,))
# --------------------------------------------------------------------------- #

def _cache_update_shape(specs, attrs):
    cache, new = specs[0], specs[1]
    if cache.shape[0] != new.shape[0] or cache.shape[2:] != new.shape[2:]:
        raise ValueError(f"cache_update mismatch: {cache.shape} vs {new.shape}")
    if new.shape[1] > cache.shape[1]:
        raise ValueError(f"chunk {new.shape[1]} exceeds cache cap {cache.shape[1]}")
    return [cache]


def _cache_update_cost(specs, attrs):
    new = specs[1]
    return Cost(flops=0.0, bytes=3.0 * new.nbytes + _bytes(specs[2:]))


defop("cache_update", _cache_update_shape, _cache_update_cost,
      doc="scatter n_new K/V rows into a cache at per-sequence offsets; "
          "inputs (cache (B,S,H,D), new (B,T,H,D), start (B,), n_new (B,))")


@impl("cache_update", "ref",
      note="masked row scatter into a copy of the cache; rows at or past "
           "n_new are dropped (never clipped onto a real row), so n_new==0 "
           "slots are exact no-ops")
def _cache_update_ref(inputs, attrs):
    cache, new, start, n_new = inputs
    b, cap = cache.shape[0], cache.shape[1]
    t = new.shape[1]
    rest = tuple(cache.shape[2:])
    rows = torch.arange(t, device=cache.device)
    idx = (start.long()[:, None] + rows[None, :]).clamp(0, cap - 1)
    valid = rows[None, :] < n_new.long()[:, None]
    # torch's index_copy_ has no drop mode: the copy gets one spare row past
    # the end, every masked row is sent there, and the spare row is cut off
    flat = torch.arange(b, device=cache.device)[:, None] * cap + idx
    dest = torch.where(valid, flat, torch.full_like(flat, b * cap))
    out = cache.new_empty((b * cap + 1,) + rest)
    out[:-1].copy_(cache.reshape((b * cap,) + rest))
    out.index_copy_(0, dest.reshape(-1), new.reshape((b * t,) + rest))
    return [out[:-1].view((b, cap) + rest)]


# --------------------------------------------------------------------------- #
# chunk_attention — inputs (q (B,T,Hq,D), k (B,S,Hk,D), v (B,S,Hk,D), start (B,))
# --------------------------------------------------------------------------- #

def _chunk_attn_shape(specs, attrs):
    return [specs[0]]


def _chunk_attn_cost(specs, attrs):
    q, k = specs[0], specs[1]
    b, t, hq, d = q.shape
    s = k.shape[1]
    return Cost(flops=4.0 * b * hq * t * s * d, bytes=_bytes(specs) + q.nbytes)


defop("chunk_attention", _chunk_attn_shape, _chunk_attn_cost,
      doc="chunked-prefill attention: query t (absolute position start+t) "
          "attends cache keys at positions <= start+t; "
          "inputs (q (B,T,Hq,D), k (B,S,Hk,D), v, start (B,)); attrs: scale")


def _chunk_attn_scale(attrs, d: int) -> float:
    # NOT `attrs.get("scale") or default`: an explicit scale=0.0 is falsy
    # but meaningful (uniform attention over the allowed positions)
    scale = attrs.get("scale")
    return (1.0 / math.sqrt(d)) if scale is None else scale


def _chunk_attn_ref_cost(specs, attrs):
    """Adds the oracle's materialisation traffic: GQA-repeated K/V in fp32
    plus the dense (B, Hq, T, S) logits and probability tensors."""
    q, k = specs[0], specs[1]
    b, t, hq, d = q.shape
    s = k.shape[1]
    base = _chunk_attn_cost(specs, attrs)
    extra = 4.0 * (2.0 * b * s * hq * d + 2.0 * b * hq * t * s)
    return Cost(flops=base.flops, bytes=base.bytes + extra)


@impl("chunk_attention", "ref", cost_fn=_chunk_attn_ref_cost,
      note="dense offset-causal masked attention in fp32 (the oracle)")
def _chunk_attention_ref(inputs, attrs):
    q, k, v, start = inputs
    b, t, hq, d = q.shape
    s = k.shape[1]
    scale = _chunk_attn_scale(attrs, d)
    kf = R._repeat_kv(k, hq).float()
    vf = R._repeat_kv(v, hq).float()
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, kf)
    qpos = start.long()[:, None] + torch.arange(t, device=q.device)[None, :]
    allowed = torch.arange(s, device=q.device)[None, None, :] <= qpos[:, :, None]
    logits = torch.where(allowed[:, None, :, :], logits,
                         torch.full_like(logits, R._NEG_INF))
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    return [o.to(q.dtype)]


def _chunk_attn_cuda_supports(specs, attrs):
    q, k, v = specs[0], specs[1], specs[2]
    return (all(x.dtype == "float32" for x in (q, k, v))
            and chunk_fits(q.shape[2], k.shape[2], q.shape[3], v.shape[3]))


@impl("chunk_attention", "cuda", supports=_chunk_attn_cuda_supports,
      note="flash-style CUDA kernel; per-sequence offset-causal masking, "
           "fixed 64-row KV tiles from column 0, tiles past the last "
           "allowed column skipped")
def _chunk_attention_cuda(inputs, attrs):
    q, k, v, start = inputs
    return [flash_chunk_attention(q, k, v, start,
                                  scale=_chunk_attn_scale(attrs, q.shape[3]))]
