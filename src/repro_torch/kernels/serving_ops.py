"""Serving graph ops — counterpart of :mod:`repro.kernels.serving_ops`, for
the dense-cache and paged-cache paths.

* ``embedding``       — token id -> row lookup (``ref``).
* ``cache_update``    — length-aware scatter of new K/V rows into a
  fixed-capacity cache at per-sequence offsets (``ref``).  Functional: it
  returns a new cache and never writes its input.
* ``chunk_attention`` — chunked-prefill attention: query t at absolute
  position ``start + t`` attends cache keys at positions ``<= start + t``
  (``ref``, and ``cuda``: the hand-written flash kernel).
* ``paged_cache_update`` / ``paged_cache_update_q`` — the same scatter into
  a shared page pool through block tables, fp32 or int8 with running
  per-(page, kv head) scales (``ref``; the JAX package has no kernel).
* ``paged_chunk_attention[_q]`` / ``paged_decode_attention[_q]`` —
  attention reading K/V through block tables (``ref``: gather, dequantize,
  dense oracle; ``cuda``: the hand-written paged flash kernels).
* ``greedy_token`` — the in-graph argmax that feeds the draft Program's
  greedy output back as its next input token (``ref``; ties break to the
  lowest id, as ``np.argmax``).
* ``verify_attention`` / ``paged_verify_attention`` /
  ``paged_verify_attention_q`` — speculative verify: the committed next
  token and the draft proposals (T = spec_k + 1 rows) scored in one call,
  offset-causal like a prefill chunk (``ref``, and ``cuda``: the chunk and
  paged chunk kernels at the verify shape).  The int8 form is two-source:
  the committed prefix dequantizes from the pages, the call's own rows come
  in as float32 and are never written to the pages.

Op names, input order, attrs, shape and cost functions match ``repro``'s.
The ``cuda`` guards are only what the kernels need (fp32 q, fp32 or int8
pages as the op says, whole GQA groups, head widths <= 256, shared memory);
the TPU's ``page_size % 8`` and ``T % block_q`` guards are not carried over,
because the kernels walk fixed logical tiles for any page size and mask
their own ragged edges; the verify ops' ``cuda`` guards are the chunk
kernels' (any T: a verify call is a chunk of spec_k + 1 rows).

Tensor-parallel serving: the nine attention ops of :data:`TP_ATTENTION_OPS`
have a ``tp`` backend, selected when a serving mesh (:func:`serving_mesh`)
with a "model" axis of size tp > 1 is active and tp divides both head
counts.  Each rank runs the op's ``cuda`` backend (on the card: the flash
kernels) on its slice of the heads, and the slices are all-gathered back on
the head dim (:func:`repro_torch.sharding.collectives.all_gather_heads`).
The cache operands (dense caches, page pools, scale sidecars) arrive
already head-sharded — the engine gives each rank its slice
(``runtime/engine.py``); the query and the verify op's fp32 new rows arrive
whole, from the whole-weight projections, and are sliced here.  The cache
writes take whole new rows into sharded caches: a partitioned Program
slices those rows to the rank's heads before the write
(:func:`tp_write_slices`, ``core/program.py``).
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Any, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.ir import TensorSpec
from repro_torch.core.registry import Cost, defop, get_impl, get_op, impl
from repro_torch.kernels import ref as R
from repro_torch.kernels.flash_attention import (chunk_fits, flash_chunk_attention,
                                                 flash_paged_chunk_attention,
                                                 paged_chunk_fits)
from repro_torch.kernels.flash_decode import (flash_paged_decode, gather_pages,
                                              paged_decode_fits)


def _bytes(specs: Sequence[TensorSpec]) -> float:
    return float(sum(s.nbytes for s in specs))


def _scatter_rows(pages, rows, blk, row, valid):
    """A copy of ``pages`` (N, P, ...) with ``rows`` (B, T, ...) written at
    (blk, row) where ``valid``.  torch's index_copy_ has no drop mode: the
    copy gets one spare row past the end, every masked row is sent there,
    and the spare row is cut off, so masked rows never land on a real row.
    Valid targets are unique (each writable page belongs to one sequence),
    so the result does not depend on the write order."""
    n, p = pages.shape[0], pages.shape[1]
    rest = tuple(pages.shape[2:])
    dest = torch.where(valid, blk * p + row, torch.full_like(blk, n * p))
    out = pages.new_empty((n * p + 1,) + rest)
    out[:-1].copy_(pages.reshape((n * p,) + rest))
    out.index_copy_(0, dest.reshape(-1), rows.reshape((-1,) + rest))
    return out[:-1].view(pages.shape)


def _valid_rows(n_new, t, device):
    """(B, T) mask of the rows each slot writes: those below ``n_new``."""
    return torch.arange(t, device=device)[None, :] < n_new.long()[:, None]


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
    # sequence b's cache is "page" b of cap rows
    idx = (start.long()[:, None] + torch.arange(t, device=cache.device)[None, :]
           ).clamp(0, cap - 1)
    seq = torch.arange(b, device=cache.device)[:, None].expand(b, t)
    return [_scatter_rows(cache, new, seq, idx, _valid_rows(n_new, t, cache.device))]


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


# --------------------------------------------------------------------------- #
# Paged serving ops — K/V rows live in a shared page pool
# (n_blocks, page_size, Hk, D) and each sequence reaches its rows through an
# int32 block table (B, max_pages): logical page -> physical block.  The
# engine side of the contract (allocation, refcounts, prefix reuse, CoW)
# lives in repro_torch.runtime.kv_cache; these ops only move and read rows.
# Garbage table entries (unallocated logical pages, filled with 0) are
# harmless: reads of those positions are masked by start/lengths, writes
# never target them (start .. start+n_new-1 always lies in allocated pages).
# The dense view of a table is kernels.flash_decode.gather_pages (the JAX
# package's _gather_pages and _gather_pages_q).
# --------------------------------------------------------------------------- #

def _gathered_bytes(pages_spec, tables_spec) -> float:
    """HBM bytes of one gathered dense K or V view."""
    n, p, h, d = pages_spec.shape
    b, mp = tables_spec.shape
    itemsize = pages_spec.nbytes / max(pages_spec.nelems, 1)
    return float(b * mp * p * h * d) * itemsize


def _paged_rows(tables, start, t, p, n_blocks):
    """Physical (block, row) targets for T rows per slot from ``start``
    (both (B, T) int64); the caller masks rows at or past ``n_new``."""
    mp = tables.shape[1]
    pos = start.long()[:, None] + torch.arange(t, device=tables.device)[None, :]
    blk = torch.gather(tables.long(), 1, torch.clamp(pos // p, 0, mp - 1))
    return torch.clamp(blk, 0, n_blocks - 1), pos % p


# ---- paged_cache_update --------------------------------------------------- #
# inputs (pages (N,P,H,D), new (B,T,H,D), tables (B,MP) i32, start, n_new)

def _paged_update_shape(specs, attrs):
    pages, new, tables = specs[0], specs[1], specs[2]
    if pages.shape[2:] != new.shape[2:]:
        raise ValueError(f"page/new head mismatch: {pages.shape} vs {new.shape}")
    if new.shape[0] != tables.shape[0]:
        raise ValueError(f"batch mismatch: {new.shape} vs {tables.shape}")
    return [pages]


def _paged_update_cost(specs, attrs):
    new = specs[1]
    # read-modify-write of T rows per sequence through the table
    return Cost(flops=0.0, bytes=3.0 * new.nbytes + _bytes(specs[2:]))


defop("paged_cache_update", _paged_update_shape, _paged_update_cost,
      doc="scatter n_new K/V rows into a shared page pool through per-"
          "sequence block tables; inputs (pages (N,P,H,D), new (B,T,H,D), "
          "tables (B,MP) int32, start (B,), n_new (B,))")


@impl("paged_cache_update", "ref",
      note="masked row scatter into a copy of the pool; rows at or past "
           "n_new are dropped, so n_new==0 slots are exact no-ops")
def _paged_cache_update_ref(inputs, attrs):
    pages, new, tables, start, n_new = inputs
    n_blocks, p = pages.shape[0], pages.shape[1]
    t = new.shape[1]
    blk, row = _paged_rows(tables, start, t, p, n_blocks)
    return [_scatter_rows(pages, new, blk, row, _valid_rows(n_new, t, pages.device))]


# ---- paged_chunk_attention ------------------------------------------------ #
# inputs (q (B,T,Hq,D), pages_k (N,P,Hk,D), pages_v, tables (B,MP), start)

def _paged_chunk_shape(specs, attrs):
    return [specs[0]]


def _paged_chunk_cost(specs, attrs):
    q, pk, tables = specs[0], specs[1], specs[3]
    b, t, hq, d = q.shape
    s = tables.shape[1] * pk.shape[1]
    gathered = 2.0 * _gathered_bytes(pk, tables)      # stream K and V once
    return Cost(flops=4.0 * b * hq * t * s * d,
                bytes=2.0 * q.nbytes + tables.nbytes + gathered)


defop("paged_chunk_attention", _paged_chunk_shape, _paged_chunk_cost,
      doc="chunked-prefill attention reading K/V through block tables; "
          "inputs (q (B,T,Hq,D), pages_k (N,P,Hk,D), pages_v, "
          "tables (B,MP) int32, start (B,)); attrs: scale")


def _paged_chunk_ref_cost(specs, attrs):
    """Charges the materialised dense gather plus the ref oracle's
    GQA-repeated K/V and dense logits/probability tensors."""
    q, pk, tables = specs[0], specs[1], specs[3]
    b, t, hq, d = q.shape
    s = tables.shape[1] * pk.shape[1]
    base = _paged_chunk_cost(specs, attrs)
    extra = 2.0 * 2.0 * _gathered_bytes(pk, tables)   # written then re-read
    extra += 4.0 * (2.0 * b * s * hq * d + 2.0 * b * hq * t * s)
    return Cost(flops=base.flops, bytes=base.bytes + extra)


@impl("paged_chunk_attention", "ref", cost_fn=_paged_chunk_ref_cost,
      note="gather pages to a dense view, then the dense fp32 offset-"
           "causal oracle")
def _paged_chunk_attention_ref(inputs, attrs):
    q, pk, pv, tables, start = inputs
    return _chunk_attention_ref(
        [q, gather_pages(pk, tables), gather_pages(pv, tables), start], attrs)


def _paged_attn_cuda_supports(specs, pages_dtype, fits):
    """fp32 q, pages of the op's dtype (fp32 scale sidecars for int8), and
    the kernel's fits check (whole GQA groups, D and Dv <= 256, shared
    memory); any page size and chunk length."""
    q, pk = specs[0], specs[1]
    quant = pages_dtype == "int8"
    pv = specs[3] if quant else specs[2]
    scales = (specs[2], specs[4]) if quant else ()
    return (q.dtype == "float32" and pk.dtype == pages_dtype and pv.dtype == pages_dtype
            and all(sc.dtype == "float32" for sc in scales)
            and fits(q.shape[-2], pk.shape[2], q.shape[-1], pv.shape[3]))


@impl("paged_chunk_attention", "cuda",
      supports=lambda specs, attrs: _paged_attn_cuda_supports(
          specs, "float32", paged_chunk_fits),
      note="paged flash CUDA kernel: fixed 64-row logical KV tiles from "
           "column 0, filled row by row through the block table")
def _paged_chunk_attention_cuda(inputs, attrs):
    q, pk, pv, tables, start = inputs
    return [flash_paged_chunk_attention(q, pk, pv, tables, start,
                                        scale=attrs.get("scale"))]


# ---- paged_decode_attention ----------------------------------------------- #
# inputs (q (B,Hq,D), pages_k (N,P,Hk,D), pages_v, tables (B,MP), lengths)

def _paged_dec_shape(specs, attrs):
    return [specs[0]]


def _paged_dec_cost(specs, attrs):
    q, pk, tables = specs[0], specs[1], specs[3]
    b, hq, d = q.shape
    s = tables.shape[1] * pk.shape[1]
    gathered = 2.0 * _gathered_bytes(pk, tables)
    return Cost(flops=4.0 * b * hq * s * d,
                bytes=2.0 * q.nbytes + tables.nbytes + gathered)


defop("paged_decode_attention", _paged_dec_shape, _paged_dec_cost,
      doc="single-token attention reading the KV cache through block "
          "tables; inputs (q (B,Hq,D), pages_k (N,P,Hk,D), pages_v, "
          "tables (B,MP) int32, lengths (B,)); attrs: scale")


def _paged_dec_ref_cost(specs, attrs):
    """Adds the materialised dense gather and the oracle's GQA-repeated
    K/V to the op's streaming cost."""
    q, pk, tables = specs[0], specs[1], specs[3]
    b, hq, d = q.shape
    s = tables.shape[1] * pk.shape[1]
    base = _paged_dec_cost(specs, attrs)
    extra = 2.0 * 2.0 * _gathered_bytes(pk, tables)
    extra += 4.0 * (2.0 * b * s * hq * d)
    return Cost(flops=base.flops, bytes=base.bytes + extra)


@impl("paged_decode_attention", "ref", cost_fn=_paged_dec_ref_cost,
      note="gather pages to a dense view + the dense fp32 decode oracle")
def _paged_decode_attention_ref(inputs, attrs):
    q, pk, pv, tables, lengths = inputs
    return [R.decode_attention_ref(q, gather_pages(pk, tables), gather_pages(pv, tables),
                                   lengths, scale=attrs.get("scale"))]


@impl("paged_decode_attention", "cuda",
      supports=lambda specs, attrs: _paged_attn_cuda_supports(
          specs, "float32", paged_decode_fits),
      note="paged flash-decode CUDA kernel; one block per (b, kv head, shard), "
           "rows staged through the block table, shards combined in order")
def _paged_decode_attention_cuda(inputs, attrs):
    q, pk, pv, tables, lengths = inputs
    return [flash_paged_decode(q, pk, pv, tables, lengths, scale=attrs.get("scale"))]


# --------------------------------------------------------------------------- #
# Quantized paged ops — pages stored int8 with a per-(page, kv-head) float32
# scale sidecar (N, Hk).  Symmetric scheme: scale = absmax / 127, row = q *
# scale.  Scales only ever GROW (running per-page max): a write that raises a
# page's absmax requantizes that page's existing rows by old/new; pages whose
# scale did not change requantize by exactly 1.0, which is bit-exact, so
# prefix-shared pages keep identical bits across sequences.  An all-zero page
# keeps scale 0.0 and quantizes via a `scale > 0` guard (`x / 0` would be
# inf).  The fp32 cache is never kept: the ref backends dequantize after the
# gather, the cuda kernels while staging each tile.  Every step below is the
# JAX package's, in the same order and precision (round half to even, a true
# division), so the pools come out bitwise equal.
# --------------------------------------------------------------------------- #

_Q_MAX = 127.0


def _scale_bytes(specs) -> float:
    return float(sum(s.nbytes for s in specs if len(s.shape) == 2
                     and s.dtype == "float32"))


# ---- paged_cache_update_q ------------------------------------------------- #
# inputs (pages (N,P,H,D) int8, scales (N,H) f32, new (B,T,H,D) f32,
#         tables (B,MP) i32, start (B,), n_new (B,)) -> [pages, scales]

def _paged_update_q_shape(specs, attrs):
    pages, scales, new, tables = specs[0], specs[1], specs[2], specs[3]
    if pages.dtype != "int8":
        raise ValueError(f"quantized pages must be int8, got {pages.dtype}")
    if scales.shape != (pages.shape[0], pages.shape[2]):
        raise ValueError(f"scales {scales.shape} != (N, Hk) "
                         f"({pages.shape[0]}, {pages.shape[2]})")
    if pages.shape[2:] != new.shape[2:]:
        raise ValueError(f"page/new head mismatch: {pages.shape} vs {new.shape}")
    if new.shape[0] != tables.shape[0]:
        raise ValueError(f"batch mismatch: {new.shape} vs {tables.shape}")
    return [pages, scales]


def _paged_update_q_cost(specs, attrs):
    """int8-honest traffic: RMW of the written rows at 1 byte/elem, the
    fp32 chunk read once, plus the full-pool requantize pass (read+write
    every int8 page and both scale sidecar states)."""
    pages, scales, new = specs[0], specs[1], specs[2]
    return Cost(flops=2.0 * pages.nelems,
                bytes=(2.0 * pages.nbytes + 3.0 * new.nelems + new.nbytes
                       + 3.0 * scales.nbytes + _bytes(specs[3:])))


defop("paged_cache_update_q", _paged_update_q_shape, _paged_update_q_cost,
      doc="quantize-on-write scatter into an int8 page pool with running "
          "per-(page, kv-head) max scales; inputs (pages (N,P,H,D) int8, "
          "scales (N,Hk) f32, new (B,T,H,D), tables (B,MP) int32, "
          "start (B,), n_new (B,)); outputs [pages, scales]")


def _quantize_rows(x, scale):
    """fp32 rows -> int8 given a broadcastable scale; scale==0 rows are
    all-zero by construction (scale is their absmax / 127)."""
    pos = scale > 0
    q = torch.where(pos, x / torch.where(pos, scale, torch.ones_like(scale)),
                    torch.zeros((), dtype=x.dtype, device=x.device))
    return torch.clamp(torch.round(q), -_Q_MAX, _Q_MAX).to(torch.int8)


def _paged_update_q_common(inputs):
    """Shared scale bookkeeping: returns (requantized pages, new scales,
    int8 rows to scatter, blk, row, valid).  Order-independent: scales use
    a scatter-max, write targets are unique."""
    pages, scales, new, tables, start, n_new = inputs
    n_blocks, p = pages.shape[0], pages.shape[1]
    b, t, h = new.shape[0], new.shape[1], new.shape[2]
    blk, row = _paged_rows(tables, start, t, p, n_blocks)
    valid = _valid_rows(n_new, t, pages.device)                      # (B, T)
    tgt = torch.where(valid, blk, torch.full_like(blk, n_blocks))    # (B, T)
    # running per-(page, head) max: only written pages can grow.  The max
    # goes into a copy with one spare row, where every masked row lands and
    # is cut off (JAX's scatter mode="drop").
    row_amax = new.abs().amax(dim=-1)                                # (B, T, H)
    # divide by a tensor on the device: CUDA turns `x / python_scalar` into
    # a multiply by the reciprocal, one bit off JAX's true division
    q_max = torch.full((), _Q_MAX, dtype=new.dtype, device=new.device)
    row_scale = torch.where(valid[..., None], row_amax / q_max,
                            torch.zeros((), dtype=new.dtype, device=new.device))
    grown = torch.cat([scales, scales.new_zeros((1, h))])
    grown.scatter_reduce_(0, tgt.reshape(-1, 1).expand(-1, h),
                          row_scale.reshape(b * t, h), reduce="amax", include_self=True)
    new_scales = grown[:-1].contiguous()
    # requantize the pool by old/new; untouched pages have ratio exactly
    # 1.0, so round(q * 1.0) == q and shared pages stay bit-identical
    ratio = torch.where(new_scales > 0, scales / new_scales, torch.ones_like(scales))
    pages_rq = torch.clamp(torch.round(pages.float() * ratio[:, None, :, None]),
                           -_Q_MAX, _Q_MAX).to(torch.int8)
    # quantize the incoming rows with their target page's final scale
    tgt_scale = new_scales[torch.clamp(tgt, 0, n_blocks - 1)]        # (B, T, H)
    q_rows = _quantize_rows(new, tgt_scale[..., None])
    return pages_rq, new_scales, q_rows, blk, row, valid


@impl("paged_cache_update_q", "ref",
      note="int8 row scatter after the shared scale-growth/requantize "
           "pass (the oracle); bitwise equal to repro's ref")
def _paged_cache_update_q_ref(inputs, attrs):
    pages_rq, new_scales, q_rows, blk, row, valid = _paged_update_q_common(inputs)
    return [_scatter_rows(pages_rq, q_rows, blk, row, valid), new_scales]


# ---- paged_chunk_attention_q ---------------------------------------------- #
# inputs (q (B,T,Hq,D), pages_k (N,P,Hk,D) i8, k_scales (N,Hk) f32,
#         pages_v i8, v_scales, tables (B,MP) i32, start (B,))

def _paged_chunk_q_shape(specs, attrs):
    pk, ks = specs[1], specs[2]
    if pk.dtype != "int8":
        raise ValueError(f"quantized pages must be int8, got {pk.dtype}")
    if ks.shape != (pk.shape[0], pk.shape[2]):
        raise ValueError(f"k_scales {ks.shape} != (N, Hk)")
    return [specs[0]]


def _paged_chunk_q_cost(specs, attrs):
    """Streams the gathered K/V once at 1 byte/elem (int8) plus the scale
    sidecars — the whole point of quantized pages on the memory-bound
    serving path."""
    q, pk, tables = specs[0], specs[1], specs[5]
    b, t, hq, d = q.shape
    s = tables.shape[1] * pk.shape[1]
    gathered = 2.0 * _gathered_bytes(pk, tables)      # int8 itemsize
    return Cost(flops=4.0 * b * hq * t * s * d,
                bytes=2.0 * q.nbytes + tables.nbytes + gathered
                + _scale_bytes(specs))


defop("paged_chunk_attention_q", _paged_chunk_q_shape, _paged_chunk_q_cost,
      doc="chunked-prefill attention over int8 pages, dequantized with "
          "per-(page, kv-head) scales; inputs (q (B,T,Hq,D), pages_k int8, "
          "k_scales (N,Hk), pages_v int8, v_scales, tables (B,MP) int32, "
          "start (B,)); attrs: scale")


def _paged_chunk_q_gather_cost(specs, attrs):
    """Adds the materialised fp32 dequantized gather (written then re-read)
    on top of the int8 streaming cost."""
    tables, pk = specs[5], specs[1]
    base = _paged_chunk_q_cost(specs, attrs)
    b, mp = tables.shape
    n, p, h, d = pk.shape
    dense_f32 = 4.0 * b * mp * p * h * d
    return Cost(flops=base.flops, bytes=base.bytes + 2.0 * 2.0 * dense_f32)


@impl("paged_chunk_attention_q", "ref", cost_fn=_paged_chunk_q_gather_cost,
      note="dequantize after the gather, then the dense fp32 offset-causal "
           "oracle")
def _paged_chunk_attention_q_ref(inputs, attrs):
    q, pk, ks, pv, vs, tables, start = inputs
    return _chunk_attention_ref(
        [q, gather_pages(pk, tables, ks), gather_pages(pv, tables, vs), start], attrs)


@impl("paged_chunk_attention_q", "cuda",
      supports=lambda specs, attrs: _paged_attn_cuda_supports(
          specs, "int8", paged_chunk_fits),
      note="paged flash CUDA kernel over int8 pages, dequantized per "
           "(page, kv head) while each 64-row tile is staged")
def _paged_chunk_attention_q_cuda(inputs, attrs):
    q, pk, ks, pv, vs, tables, start = inputs
    return [flash_paged_chunk_attention(q, pk, pv, tables, start, k_scales=ks,
                                        v_scales=vs, scale=attrs.get("scale"))]


# ---- paged_decode_attention_q --------------------------------------------- #
# inputs (q (B,Hq,D), pages_k (N,P,Hk,D) i8, k_scales (N,Hk) f32,
#         pages_v i8, v_scales, tables (B,MP) i32, lengths (B,))

def _paged_dec_q_shape(specs, attrs):
    pk, ks = specs[1], specs[2]
    if pk.dtype != "int8":
        raise ValueError(f"quantized pages must be int8, got {pk.dtype}")
    if ks.shape != (pk.shape[0], pk.shape[2]):
        raise ValueError(f"k_scales {ks.shape} != (N, Hk)")
    return [specs[0]]


def _paged_dec_q_cost(specs, attrs):
    """Streams the gathered K/V once at 1 byte/elem (int8) plus the
    scale sidecars."""
    q, pk, tables = specs[0], specs[1], specs[5]
    b, hq, d = q.shape
    s = tables.shape[1] * pk.shape[1]
    gathered = 2.0 * _gathered_bytes(pk, tables)
    return Cost(flops=4.0 * b * hq * s * d,
                bytes=2.0 * q.nbytes + tables.nbytes + gathered
                + _scale_bytes(specs))


defop("paged_decode_attention_q", _paged_dec_q_shape, _paged_dec_q_cost,
      doc="single-token attention over int8 pages, dequantized with "
          "per-(page, kv-head) scales; inputs (q (B,Hq,D), pages_k int8, "
          "k_scales (N,Hk), pages_v int8, v_scales, tables (B,MP) int32, "
          "lengths (B,)); attrs: scale")


def _paged_dec_q_gather_cost(specs, attrs):
    """Adds the materialised fp32 dequantized gather on top of the int8
    streaming cost."""
    tables, pk = specs[5], specs[1]
    base = _paged_dec_q_cost(specs, attrs)
    b, mp = tables.shape
    n, p, h, d = pk.shape
    dense_f32 = 4.0 * b * mp * p * h * d
    return Cost(flops=base.flops, bytes=base.bytes + 2.0 * 2.0 * dense_f32)


@impl("paged_decode_attention_q", "ref", cost_fn=_paged_dec_q_gather_cost,
      note="dequantize after the gather + the dense fp32 decode oracle")
def _paged_decode_attention_q_ref(inputs, attrs):
    q, pk, ks, pv, vs, tables, lengths = inputs
    return [R.decode_attention_ref(q, gather_pages(pk, tables, ks),
                                   gather_pages(pv, tables, vs), lengths,
                                   scale=attrs.get("scale"))]


@impl("paged_decode_attention_q", "cuda",
      supports=lambda specs, attrs: _paged_attn_cuda_supports(
          specs, "int8", paged_decode_fits),
      note="paged flash-decode CUDA kernel over int8 pages, dequantized per "
           "(page, kv head) while each row is staged")
def _paged_decode_attention_q_cuda(inputs, attrs):
    q, pk, ks, pv, vs, tables, lengths = inputs
    return [flash_paged_decode(q, pk, pv, tables, lengths, k_scales=ks, v_scales=vs,
                               scale=attrs.get("scale"))]


# --------------------------------------------------------------------------- #
# Speculative-decoding ops.  ``verify_attention`` and its paged forms are
# chunk attention at T = spec_k + 1, registered as their own ops so that a
# policy picks a backend for the verify shape apart from the prefill chunk;
# their backends are the chunk ops' (the same offset-causal function).
# --------------------------------------------------------------------------- #

def _greedy_token_shape(specs, attrs):
    logits = specs[0]
    if len(logits.shape) != 2:
        raise ValueError(f"greedy_token wants (B, V) logits, got {logits.shape}")
    return [TensorSpec((logits.shape[0], 1), "int32")]


def _greedy_token_cost(specs, attrs):
    # stream the logits once; the output is negligible
    return Cost(flops=float(specs[0].nelems), bytes=_bytes(specs))


defop("greedy_token", _greedy_token_shape, _greedy_token_cost,
      doc="greedy sampling inside a graph: (B, V) logits -> (B, 1) int32 "
          "argmax token ids (ties break to the lowest id, matching "
          "np.argmax on the host)")


@impl("greedy_token", "ref",
      note="torch.argmax over the vocab axis; ties break to the lowest id, "
           "as the engine's host-side np.argmax")
def _greedy_token_ref(inputs, attrs):
    return [torch.argmax(inputs[0], dim=-1, keepdim=True).to(torch.int32)]


# ---- verify_attention (dense) --------------------------------------------- #
# inputs (q (B,T,Hq,D), k (B,S,Hk,D), v (B,S,Hk,D), start (B,)); T = K+1

defop("verify_attention", _chunk_attn_shape, _chunk_attn_cost,
      doc="speculative-verify attention: score K+1 tokens (committed next "
          "token + K draft proposals) against the dense cache in one call; "
          "offset-causal exactly like chunk_attention (row t attends "
          "positions <= start+t); inputs (q (B,T,Hq,D), k (B,S,Hk,D), v, "
          "start (B,)); attrs: scale")

impl("verify_attention", "ref", cost_fn=_chunk_attn_ref_cost,
     note="dense offset-causal masked attention in fp32 (the chunk_attention "
          "oracle: a verify step is a T=K+1 chunk)")(_chunk_attention_ref)
impl("verify_attention", "cuda", supports=_chunk_attn_cuda_supports,
     note="the flash chunk CUDA kernel at the T=K+1 verify shape")(_chunk_attention_cuda)


# ---- paged_verify_attention ----------------------------------------------- #
# inputs (q (B,T,Hq,D), pages_k (N,P,Hk,D), pages_v, tables (B,MP), start)

defop("paged_verify_attention", _paged_chunk_shape, _paged_chunk_cost,
      doc="speculative-verify attention reading K/V through block tables "
          "(paged_chunk_attention semantics at T = K+1); inputs "
          "(q (B,T,Hq,D), pages_k (N,P,Hk,D), pages_v, tables (B,MP) "
          "int32, start (B,)); attrs: scale")

impl("paged_verify_attention", "ref", cost_fn=_paged_chunk_ref_cost,
     note="gather pages to a dense view, then the dense fp32 offset-causal "
          "oracle")(_paged_chunk_attention_ref)
impl("paged_verify_attention", "cuda",
     supports=lambda specs, attrs: _paged_attn_cuda_supports(
         specs, "float32", paged_chunk_fits),
     note="the paged flash chunk CUDA kernel at the verify shape, reading "
          "pages in place through the block table")(_paged_chunk_attention_cuda)


# ---- paged_verify_attention_q --------------------------------------------- #
# inputs (q (B,T,Hq,D), pages_k i8, k_scales (N,Hk), pages_v i8, v_scales,
#         tables (B,MP), start, k_new (B,T,Hk,D) f32, v_new (B,T,Hk,D) f32)
#
# TWO-SOURCE on purpose: the committed prefix streams from the int8 pages,
# but this call's own K+1 speculative rows come in as fp32 ``k_new/v_new``
# and are NEVER written to the pages here.  Quantize-on-write page scales
# only grow, and a raise requantizes the whole page, so writing draft rows
# that are later rejected would lossily perturb committed rows sharing
# their page.  Accepted rows are written afterwards by the spec-commit
# Program.

def _paged_verify_q_shape(specs, attrs):
    q, pk, ks, kn, vn = specs[0], specs[1], specs[2], specs[7], specs[8]
    if pk.dtype != "int8":
        raise ValueError(f"quantized pages must be int8, got {pk.dtype}")
    if ks.shape != (pk.shape[0], pk.shape[2]):
        raise ValueError(f"k_scales {ks.shape} != (N, Hk)")
    want = (q.shape[0], q.shape[1], pk.shape[2], pk.shape[3])
    for name, spec in (("k_new", kn), ("v_new", vn)):
        if spec.shape != want:
            raise ValueError(f"{name} {spec.shape} != (B, T, Hk, D) {want}")
    return [specs[0]]


def _paged_verify_q_cost(specs, attrs):
    base = _paged_chunk_q_cost(specs[:7], attrs)
    return Cost(flops=base.flops, bytes=base.bytes + _bytes(specs[7:]))


def _paged_verify_q_gather_cost(specs, attrs):
    base = _paged_chunk_q_gather_cost(specs[:7], attrs)
    return Cost(flops=base.flops, bytes=base.bytes + _bytes(specs[7:]))


defop("paged_verify_attention_q", _paged_verify_q_shape, _paged_verify_q_cost,
      doc="speculative-verify attention over int8 pages: the committed "
          "prefix dequantizes from the pages, this call's K+1 rows read "
          "from fp32 k_new/v_new (two-source — speculative rows are never "
          "quantized into pages before acceptance); inputs (q (B,T,Hq,D), "
          "pages_k int8, k_scales (N,Hk), pages_v int8, v_scales, tables "
          "(B,MP) int32, start (B,), k_new (B,T,Hk,D), v_new); attrs: scale")


def _patch_new_rows(dense, new, start):
    """A copy of the dequantized gather ``dense`` (B, S, Hk, D) with this
    call's fp32 rows written at rows ``start + 0..T-1`` (per batch); rows
    past the dense view are dropped, as JAX's ``mode="drop"``."""
    b, s, t = dense.shape[0], dense.shape[1], new.shape[1]
    pos = start.long()[:, None] + torch.arange(t, device=dense.device)[None, :]
    seq = torch.arange(b, device=dense.device)[:, None].expand(b, t)
    return _scatter_rows(dense, new, seq, pos.clamp(0, s - 1), pos < s)


def _paged_verify_q_sources(inputs):
    q, pk, ks, pv, vs, tables, start, kn, vn = inputs
    k = _patch_new_rows(gather_pages(pk, tables, ks), kn, start)
    v = _patch_new_rows(gather_pages(pv, tables, vs), vn, start)
    return q, k, v, start


@impl("paged_verify_attention_q", "ref", cost_fn=_paged_verify_q_gather_cost,
      note="dequantize after the gather, patch in the fp32 speculative "
           "rows, then the dense fp32 offset-causal oracle")
def _paged_verify_attention_q_ref(inputs, attrs):
    return _chunk_attention_ref(list(_paged_verify_q_sources(inputs)), attrs)


def _paged_verify_q_cuda_supports(specs, attrs):
    """int8 pages with fp32 scales, fp32 q and new rows, and the dense chunk
    kernel's fits check (whole GQA groups, D and Dv <= 256, shared memory);
    any T and page size.  The TPU's ``T % block_q`` guard does not apply:
    the kernel masks its own ragged query tile."""
    q, pk, ks, pv, vs, kn, vn = (specs[0], specs[1], specs[2], specs[3], specs[4],
                                 specs[7], specs[8])
    return (q.dtype == kn.dtype == vn.dtype == ks.dtype == vs.dtype == "float32"
            and pk.dtype == pv.dtype == "int8"
            and chunk_fits(q.shape[2], pk.shape[2], q.shape[3], pv.shape[3]))


@impl("paged_verify_attention_q", "cuda", supports=_paged_verify_q_cuda_supports,
      note="gather, dequantize and patch in plain PyTorch feeding the flash "
           "chunk CUDA kernel at the verify shape (the two-source patch "
           "cannot stream pages in place)")
def _paged_verify_attention_q_cuda(inputs, attrs):
    return _chunk_attention_cuda(list(_paged_verify_q_sources(inputs)), attrs)


# --------------------------------------------------------------------------- #
# repro's ``xla`` backends of these ops, folded into ``ref`` in the port:
# the cost an OXF bundle records for the name ``xla`` where it is not the
# op's own (repro serving_ops.py's ``*_xla_cost``; core/importer.py)
# --------------------------------------------------------------------------- #

def _embedding_xla_cost(specs, attrs):
    """One-hot matmul: 2*N*V*D flops plus the materialised (N, V)
    one-hot, traded against the gather's pure byte cost."""
    ids, table = specs
    v, d = table.shape
    n = ids.nelems
    out = _embedding_shape(specs, attrs)[0]
    return Cost(flops=2.0 * n * v * d,
                bytes=table.nbytes + out.nbytes + 4.0 * n * v)


def _paged_gather_xla_cost(op_cost):
    def cost(specs, attrs):
        """The materialised dense gather on top of the op's streaming cost;
        GQA stays grouped."""
        base = op_cost(specs, attrs)
        return Cost(flops=base.flops,
                    bytes=base.bytes + 2.0 * 2.0 * _gathered_bytes(specs[1], specs[3]))
    return cost


for _op, _cost in (("embedding", _embedding_xla_cost),
                   ("paged_chunk_attention", _paged_gather_xla_cost(_paged_chunk_cost)),
                   ("paged_verify_attention", _paged_gather_xla_cost(_paged_chunk_cost)),
                   ("paged_decode_attention", _paged_gather_xla_cost(_paged_dec_cost)),
                   ("paged_chunk_attention_q", _paged_chunk_q_gather_cost),
                   ("paged_verify_attention_q", _paged_verify_q_gather_cost),
                   ("paged_decode_attention_q", _paged_dec_q_gather_cost)):
    get_op(_op).xla_cost = _cost


# --------------------------------------------------------------------------- #
# Serving mesh context — how the ``tp`` backends learn about the mesh:
# supports() and cost() run at compile time and the bodies at call time,
# each with only (specs or inputs, attrs) in hand, so the engine publishes
# its mesh here instead of threading it through every call.
# --------------------------------------------------------------------------- #

_SERVING_MESH: Optional[Any] = None


@contextmanager
def serving_mesh(mesh):
    """Make ``mesh`` visible to the ``tp`` backends and to the executor of a
    partitioned Program.  The engine wraps its compiles (so ``supports()``
    sees the mesh during selection) and every Program call in it."""
    global _SERVING_MESH
    prev = _SERVING_MESH
    _SERVING_MESH = mesh
    try:
        yield mesh
    finally:
        _SERVING_MESH = prev


def current_serving_mesh():
    """The mesh published by the innermost :func:`serving_mesh` (or None)."""
    return _SERVING_MESH


def _tp_state():
    """(mesh, degree) when a serving mesh with a >1 "model" axis is active,
    else (None, 1)."""
    mesh = current_serving_mesh()
    if mesh is None or "model" not in getattr(mesh, "axis_names", ()):
        return None, 1
    tp = int(mesh.shape["model"])
    return (mesh, tp) if tp > 1 else (None, 1)


def tp_slice(x: torch.Tensor, dim: int, mesh: Any) -> torch.Tensor:
    """This rank's contiguous slice of ``x``'s heads along ``dim``: rank r of
    tp holds heads [r * H / tp, (r + 1) * H / tp) (GQA groups stay whole:
    q head h reads kv head h // (Hq / Hk))."""
    tp = int(mesh.shape["model"])
    h = x.shape[dim] // tp
    return x.narrow(dim, mesh.rank * h, h).contiguous()


# --------------------------------------------------------------------------- #
# ``tp`` backends — tensor-parallel attention over the head dim.  Heads are
# independent through the whole softmax, so each rank runs the single-rank
# ``cuda`` backend on its head slice with no inner collective and, per head,
# the single-rank arithmetic (the kernels' shards depend on the row counts
# alone, never on the head count); the only collective is the exact
# all-gather of the output.  (repro's per-device body is ``xla``, its
# default policy's first choice; the port's default prefers ``cuda``, and
# token identity with the single-rank engine needs the same body.)
# --------------------------------------------------------------------------- #

# op -> (replicated inputs sliced here, already head-sharded inputs), each
# an (input index, head dim) pair; the query is input 0
_TP_LAYOUT = {
    "chunk_attention": (((0, 2),), ((1, 2), (2, 2))),
    "verify_attention": (((0, 2),), ((1, 2), (2, 2))),
    "decode_attention": (((0, 1),), ((1, 2), (2, 2))),
    "paged_chunk_attention": (((0, 2),), ((1, 2), (2, 2))),
    "paged_verify_attention": (((0, 2),), ((1, 2), (2, 2))),
    "paged_decode_attention": (((0, 1),), ((1, 2), (2, 2))),
    "paged_chunk_attention_q": (((0, 2),), ((1, 2), (2, 1), (3, 2), (4, 1))),
    "paged_decode_attention_q": (((0, 1),), ((1, 2), (2, 1), (3, 2), (4, 1))),
    "paged_verify_attention_q": (((0, 2), (7, 2), (8, 2)),
                                 ((1, 2), (2, 1), (3, 2), (4, 1))),
}

# the ops whose ``tp`` backend the engine prefers when given a mesh
TP_ATTENTION_OPS = tuple(_TP_LAYOUT)

# the cache writes: op -> (cache input, new-rows input); both hold their
# kv heads on dim 2
_TP_WRITES = {"cache_update": (0, 1), "paged_cache_update": (0, 1),
              "paged_cache_update_q": (0, 2)}


def tp_write_slices(nodes, specs) -> List[Optional[Tuple[int, int]]]:
    """For each node of a partitioned Program, in execution order: the
    (input index, head dim) of the whole new rows that a cache write
    slices to the rank's heads, because the cache it writes is sharded on
    "model" at its head dim; None for every other node.  A cache's spec is
    its partition spec, or, for a cache an earlier write produced, that
    write's (a verify commit writes each cache once a stage)."""
    sharded = {name for name, spec in specs.items()
               if len(spec) > 2 and spec[2] == "model"}
    out: List[Optional[Tuple[int, int]]] = []
    for node in nodes:
        io = _TP_WRITES.get(node.op)
        if io is not None and node.inputs[io[0]] in sharded:
            out.append((io[1], 2))
            sharded.add(node.outputs[0])
        else:
            out.append(None)
    return out


def _tp_local_specs(op: str, specs, tp: int):
    """The specs one rank's ``cuda`` body sees: every head dim over tp."""
    local = list(specs)
    for idx, dim in (*_TP_LAYOUT[op][0], *_TP_LAYOUT[op][1]):
        shape = list(specs[idx].shape)
        shape[dim] //= tp
        local[idx] = TensorSpec(tuple(shape), specs[idx].dtype)
    return local


def tp_heads_divide(specs, tp: int) -> bool:
    """tp divides both Hq and Hk: whole GQA groups on every rank."""
    return specs[0].shape[-2] % tp == 0 and specs[1].shape[2] % tp == 0


def tp_local_supported(op: str, specs, attrs, tp: int) -> bool:
    """Whether the ``cuda`` backend takes one rank's slice of the heads."""
    return get_impl(op, "cuda").supports(_tp_local_specs(op, specs, tp), attrs)


def _tp_supports(op: str):
    def supports(specs, attrs):
        """serving mesh active with a "model" axis of size tp > 1 dividing
        both Hq and Hk (whole GQA groups per rank), and the ``cuda``
        backend taking the rank's slice of the heads"""
        mesh, tp = _tp_state()
        return (mesh is not None and tp_heads_divide(specs, tp)
                and tp_local_supported(op, specs, attrs, tp))
    return supports


def _tp_cost_fn(op: str):
    base_cost, shape_fn = get_op(op).cost_fn, get_op(op).shape_fn

    def cost(specs, attrs):
        """op streaming cost plus the (tp-1)/tp all-gather returning the
        head-sharded output to the replicated Program (collectives.
        allgather_bytes)"""
        from repro_torch.sharding.collectives import allgather_bytes
        _, tp = _tp_state()
        base = base_cost(specs, attrs)
        out = shape_fn(specs, attrs)[0]
        return Cost(flops=base.flops, bytes=base.bytes + allgather_bytes(out.nbytes, tp))
    return cost


def _tp_body(op: str):
    body = get_impl(op, "cuda").fn
    sliced, _ = _TP_LAYOUT[op]
    q_dim = sliced[0][1]

    def run(inputs, attrs):
        from repro_torch.sharding.collectives import all_gather_heads
        mesh, tp = _tp_state()
        if mesh is None:
            raise RuntimeError(f"{op}: backend 'tp' called with no serving mesh of tp > 1")
        local = list(inputs)
        for idx, dim in sliced:
            local[idx] = tp_slice(inputs[idx], dim, mesh)
        out = body(local, attrs)[0]
        return [all_gather_heads(out, mesh, q_dim)]
    return run


for _op in TP_ATTENTION_OPS:
    impl(_op, "tp", supports=_tp_supports(_op), cost_fn=_tp_cost_fn(_op),
         note="the cuda backend on this rank's heads of the serving mesh; the output "
              "all-gathered back on the head dim")(_tp_body(_op))
