"""Flash attention — counterpart of
:func:`repro.kernels.flash_attention.flash_attention` (a sequence's own
K/V: causal or not, sliding window, static query offset),
:func:`repro.kernels.flash_attention.flash_chunk_attention` (chunked
prefill over a dense cache) and
:func:`repro.kernels.flash_attention.flash_paged_chunk_attention` (page
pool reached through block tables, fp32 or int8 pages).

The three wrappers launch the hand-written CUDA kernel
``csrc/flash_attention.cu`` on CUDA tensors and run their plain versions on
CPU tensors.  The kernel gives one block 64 query rows (every query head of
a GQA group at 64 / G positions) and one shard of
:func:`attention_shard_cols` cache columns (a function of the cache's
column count alone, never of the batch or the chunk), walks the shard in
fixed tiles of 64 columns, and merges a row's
shards in shard order with a combine kernel in the same call.  For the
chunk wrappers query row t of sequence b sits at ``start[b] + t`` and
attends cache columns ``<= start[b] + t``.  Each wrapper's ``launches``
attribute counts its calls that launched the kernel.

:func:`flash_attention` also takes bf16 q, k and v, as the Pallas kernel
does.  ``flash_attention_bf16`` is a body of its own on the tensor cores:
one warpgroup a block, the same 64-row GQA tiles and 64-column K/V tiles,
Q K^T and P V as ``wgmma.m64n64k16`` with fp32 accumulators, the softmax in
fp32 registers with P split into two bf16 halves (hi + lo, two products)
for the second product, and the output rounded once to bf16.  Its shards come from
:func:`attention_shard_cols_bf16` (the key count and the head counts, never
the batch or the query count), so a row's bits do not depend on the batch,
on Sq or on its place in the tile; they are not the fp32 entry's output
rounded.  Those calls count in ``flash_attention.bf16.launches``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.flash_decode import _workspace, check_paged, gather_pages
from repro_torch.kernels.ref import attention_mask

__all__ = ["flash_attention", "flash_attention_plain", "attention_fits",
           "flash_chunk_attention", "flash_chunk_attention_plain", "chunk_fits",
           "flash_paged_chunk_attention", "flash_paged_chunk_attention_plain",
           "paged_chunk_fits", "attention_shard_cols", "attention_shard_cols_bf16",
           "attention_smem_bytes"]

_NEG_INF = -1e30
# The layout of csrc/flash_attention.cu:
BLOCK_ROWS = 64        # query rows per block (BR): 64 / G positions of G heads
BLOCK_KV = 64          # columns per K/V tile (BKV)
SHARD_COLS = 256       # columns per shard of a cache of up to 256 * MAX_SHARDS
MAX_SHARDS = 8
# The bf16 body's layout (attention_wgmma_kernel): one warpgroup a block,
# [64][64] bf16 panels in shared memory, and the SMs its shard plan fills
BF16_THREADS = 128
BF16_PANEL_BYTES = 64 * 64 * 2
SMS = 132              # streaming multiprocessors of an H100 SXM


def attention_shard_cols(s_len: int) -> int:
    """Columns per shard of the attention kernel over ``s_len`` cache (or
    key) columns: SHARD_COLS, doubled until there are at most MAX_SHARDS
    shards.  It depends on the column count alone, never on the batch or
    the chunk, so a row's shards (and its result) are the same at batch 4
    as at batch 1 and wherever its chunk starts."""
    shard = SHARD_COLS
    while -(-s_len // shard) > MAX_SHARDS:
        shard *= 2
    return shard


def attention_shard_cols_bf16(s_len: int, hq: int, hk: int) -> int:
    """Columns per shard of the bf16 body over ``s_len`` key columns: one
    shard (``s_len`` rounded up to whole K/V tiles) where the query tiles
    of one sequence of ``s_len`` rows times the kv heads already give a
    block per SM, else :func:`attention_shard_cols`.  A function of the key
    count and the head counts alone, never of the batch or the query count,
    so a row's shards are the same in every call."""
    gp = 1
    while gp < hq // hk:
        gp *= 2
    if -(-s_len // (BLOCK_ROWS // gp)) * hk >= SMS:
        return -(-s_len // BLOCK_KV) * BLOCK_KV
    return attention_shard_cols(s_len)


def _pad4(x: int) -> int:
    return -(-x // 4) * 4


def attention_smem_bytes(d: int, dv: int, *, bf16: bool = False) -> int:
    """Dynamic shared memory of one block (csrc/flash_attention.cu): the
    fp32 body's (attn_smem_floats) pre-scaled Q [BLOCK_ROWS][D4] and P
    [BLOCK_ROWS][BLOCK_KV] fp32, K [BLOCK_KV][D4 + 4] and V [BLOCK_KV][Dv4]
    fp32, widths padded to 4; ``bf16``: the tensor-core body's
    (tc_smem_bytes) Q, K and V as [64][64] bf16 panels, pad64(D) / 64 each
    for Q and K and pad64(Dv) / 64 for V, and 1024 bytes of slack to align
    them."""
    if bf16:
        pd, pv = -(-d // 64), -(-dv // 64)
        return 1024 + BF16_PANEL_BYTES * (2 * pd + pv)
    d4, dv4 = _pad4(d), _pad4(dv)
    return 4 * (BLOCK_ROWS * d4 + BLOCK_KV * (d4 + 4) + BLOCK_KV * dv4
                + BLOCK_ROWS * BLOCK_KV)


def chunk_fits(hq: int, hk: int, d: int, dv: int) -> bool:
    """Whether the kernel takes these head counts and widths: whole GQA
    groups of at most BLOCK_ROWS heads, D and Dv <= 256, and its shared
    memory within the H100's 227 KB per block."""
    if hk < 1 or hq % hk or hq // hk > BLOCK_ROWS:
        return False
    if not (0 < d <= _cuda.MAX_HEAD_DIM and 0 < dv <= _cuda.MAX_HEAD_DIM):
        return False
    return attention_smem_bytes(d, dv) <= _cuda.MAX_SMEM_BYTES


def _partials(s_len: int, b: int, t: int, hq: int, dv: int, device,
              shard: Optional[int] = None):
    """The shard size (``attention_shard_cols(s_len)`` unless given) and the
    workspace of the shards' partials: acc (NS, B*T, Hq, Dv), m and l (NS,
    B*T, Hq), views of one allocation, or None when the cache is one shard
    (the C entry points then take null pointers)."""
    shard = attention_shard_cols(s_len) if shard is None else shard
    n_shards = -(-s_len // shard)
    return shard, (_workspace(n_shards, b * t, hq, dv, device) if n_shards > 1 else None)


def _pointers(ws) -> tuple:
    return (0, 0, 0) if ws is None else tuple(x.data_ptr() for x in ws)


def _masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      allowed: torch.Tensor, scale: float) -> torch.Tensor:
    """GQA softmax attention in fp32 (on the upcast inputs, rounded to q's
    dtype) under ``allowed`` ((B or 1, T, S) bool): masked entries weigh
    exactly 0 and each row finishes as acc / max(l, 1e-30), so a row that
    sees nothing gives 0."""
    dtype = q.dtype
    q, k, v = q.float(), k.float(), v.float()
    b, t, hq, d = q.shape
    hk = k.shape[2]
    g = hq // hk
    qg = (q * scale).reshape(b, t, hk, g, d)
    s = torch.einsum("btkgd,bskd->bkgts", qg, k)
    allowed = allowed[:, None, None, :, :]                          # (B,1,1,T,S)
    s = torch.where(allowed, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(allowed, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgts,bskd->bkgtd", p, v) / torch.clamp(l, min=1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(b, t, hq, v.shape[3]).to(dtype)


def flash_chunk_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                start: torch.Tensor, scale: float) -> torch.Tensor:
    """The kernel's function in plain PyTorch (fp32): offset-causal masked
    softmax whose masked entries weigh exactly 0, finished as
    acc / max(l, 1e-30)."""
    t, s_len = q.shape[1], k.shape[1]
    qpos = start.to(q.device).long()[:, None] + torch.arange(t, device=q.device)[None, :]
    allowed = torch.arange(s_len, device=q.device)[None, None, :] <= qpos[:, :, None]
    return _masked_attention(q, k, v, allowed, scale)


def flash_chunk_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          start: torch.Tensor, *,
                          scale: Optional[float] = None) -> torch.Tensor:
    """q (B, T, Hq, D), k (B, S, Hk, D), v (B, S, Hk, Dv), start (B,) int32
    -> (B, T, Hq, Dv)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_chunk_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    b, t, hq, d = q.shape
    s_len, hk = k.shape[1], k.shape[2]
    dv = v.shape[3]
    if k.shape != (b, s_len, hk, d) or v.shape[:3] != (b, s_len, hk):
        raise ValueError(f"flash_chunk_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.float32:
            raise TypeError(f"flash_chunk_attention: {name} must be float32, got {x.dtype}")
    if not chunk_fits(hq, hk, d, dv):
        raise ValueError(f"flash_chunk_attention: unsupported heads/widths "
                         f"Hq={hq} Hk={hk} D={d} Dv={dv}")
    if start.shape != (b,) or start.dtype != torch.int32:
        raise ValueError(f"flash_chunk_attention: start must be ({b},) int32, got "
                         f"{tuple(start.shape)} {start.dtype}")
    scale = (1.0 / math.sqrt(d)) if scale is None else float(scale)
    tensors = (q, k, v, start)
    if all(x.device.type == "cpu" for x in tensors):
        return flash_chunk_attention_plain(q, k, v, start, scale)
    if q.device.type != "cuda" or any(x.device != q.device for x in tensors):
        raise ValueError("flash_chunk_attention: all inputs must be on one CUDA device")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("flash_chunk_attention: inputs must be contiguous")
    out = torch.empty((b, t, hq, dv), dtype=torch.float32, device=q.device)
    if b == 0 or t == 0:
        return out
    if s_len == 0:                   # every row sees nothing
        return out.zero_()
    shard, ws = _partials(s_len, b, t, hq, dv, q.device)
    err = _cuda.library().flash_chunk_attention_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), start.data_ptr(), *_pointers(ws),
        out.data_ptr(), b, t, hq, hk, s_len, d, dv, shard, scale, _cuda.stream_of(q))
    _cuda.check(err, "flash_chunk_attention")
    flash_chunk_attention.launches += 1
    return out


flash_chunk_attention.launches = 0


# the paged kernel runs the chunk kernel's body: its shared memory is the
# same (and does not depend on the page size).
paged_chunk_fits = chunk_fits


def attention_fits(hq: int, hk: int, d: int, dv: int) -> bool:
    """Whether both bodies of :func:`flash_attention` take these head counts
    and widths: :func:`chunk_fits` (the fp32 body is the chunk kernel's)
    and the bf16 body's shared memory within the H100's limit."""
    return (chunk_fits(hq, hk, d, dv)
            and attention_smem_bytes(d, dv, bf16=True) <= _cuda.MAX_SMEM_BYTES)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool, window: Optional[int], scale: float) -> torch.Tensor:
    """The kernel's function in plain PyTorch (fp32 on the upcast inputs,
    rounded to q's dtype): query row i sits at position ``Skv - Sq + i``;
    it sees columns ``<= row`` when ``causal`` and columns ``> row -
    window`` with a window.  Masked entries weigh exactly 0 and a row that
    sees nothing gives 0 (``ref.attention_ref`` gives the mean of V
    there)."""
    sq, skv = q.shape[1], k.shape[1]
    allowed = attention_mask(sq, skv, causal=causal, window=window, offset=skv - sq,
                             device=q.device)
    return _masked_attention(q, k, v, allowed[None], scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Sq, Hq, D), k (B, Skv, Hk, D), v (B, Skv, Hk, Dv) -> (B, Sq, Hq, Dv),
    all float32 or all bfloat16 (the output in q's dtype).

    Query row i sits at absolute position ``Skv - Sq + i``, as in
    ``ref.attention_ref``; ``window`` (None or >= 1) keeps columns
    ``> row - window``.  Tiles that no row of a query tile can see are
    skipped."""
    fn = "flash_attention"
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{fn}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, sq, hq, d = q.shape
    skv, hk = k.shape[1], k.shape[2]
    dv = v.shape[3]
    if k.shape != (b, skv, hk, d) or v.shape[:3] != (b, skv, hk):
        raise ValueError(f"{fn}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype not in (torch.float32, torch.bfloat16) or x.dtype != q.dtype:
            raise TypeError(f"{fn}: {name} must be float32 or bfloat16 (q, k and v alike), "
                            f"got {x.dtype}")
    if not attention_fits(hq, hk, d, dv):
        raise ValueError(f"{fn}: unsupported heads/widths Hq={hq} Hk={hk} D={d} Dv={dv}")
    if window is not None and int(window) < 1:
        raise ValueError(f"{fn}: window must be None or >= 1, got {window}")
    scale = (1.0 / math.sqrt(d)) if scale is None else float(scale)
    tensors = (q, k, v)
    if all(x.device.type == "cpu" for x in tensors):
        return flash_attention_plain(q, k, v, causal=causal, window=window, scale=scale)
    if q.device.type != "cuda" or any(x.device != q.device for x in tensors):
        raise ValueError(f"{fn}: all inputs must be on one CUDA device")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError(f"{fn}: inputs must be contiguous")
    out = torch.empty((b, sq, hq, dv), dtype=q.dtype, device=q.device)
    if b == 0 or sq == 0:
        return out
    if skv == 0:
        return out.zero_()
    bf16 = q.dtype == torch.bfloat16
    shard, ws = _partials(skv, b, sq, hq, dv, q.device,
                          attention_shard_cols_bf16(skv, hq, hk) if bf16 else None)
    lib = _cuda.library()
    err = (lib.flash_attention_bf16 if bf16 else lib.flash_attention_f32)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *_pointers(ws), out.data_ptr(), b, sq, hq,
        hk, skv, d, dv, int(bool(causal)), 0 if window is None else int(window), shard, scale,
        _cuda.stream_of(q))
    _cuda.check(err, fn)
    if bf16:
        flash_attention.bf16.launches += 1
    else:
        flash_attention.launches += 1
    return out


flash_attention.launches = 0
flash_attention.bf16 = _cuda.LaunchCount("flash_attention_bf16")


def flash_paged_chunk_attention_plain(q: torch.Tensor, pages_k: torch.Tensor,
                                      pages_v: torch.Tensor, block_tables: torch.Tensor,
                                      start: torch.Tensor, scale: float,
                                      k_scales: Optional[torch.Tensor] = None,
                                      v_scales: Optional[torch.Tensor] = None
                                      ) -> torch.Tensor:
    """The paged kernel's function in plain PyTorch: gather (and dequantize)
    the pages into a dense cache, then :func:`flash_chunk_attention_plain`."""
    return flash_chunk_attention_plain(q, gather_pages(pages_k, block_tables, k_scales),
                                       gather_pages(pages_v, block_tables, v_scales),
                                       start, scale)


def flash_paged_chunk_attention(q: torch.Tensor, pages_k: torch.Tensor,
                                pages_v: torch.Tensor, block_tables: torch.Tensor,
                                start: torch.Tensor, *,
                                k_scales: Optional[torch.Tensor] = None,
                                v_scales: Optional[torch.Tensor] = None,
                                scale: Optional[float] = None) -> torch.Tensor:
    """q (B, T, Hq, D), pages_k (N, P, Hk, D), pages_v (N, P, Hk, Dv),
    block_tables (B, MP) int32, start (B,) int32 -> (B, T, Hq, Dv).

    Offset-causal over the logical cache ``block_tables`` describes (entries
    clipped to [0, N-1]); table entries past the chunk's last allowed column
    may hold any block id.  With ``k_scales``/``v_scales`` ((N, Hk) float32)
    the pages are int8, dequantized per (page, kv head)."""
    fn = "flash_paged_chunk_attention"
    if q.dim() != 4:
        raise ValueError(f"{fn}: q {tuple(q.shape)}")
    quant = check_paged(fn, q, pages_k, pages_v, block_tables, k_scales, v_scales)
    b, t, hq, d = q.shape
    n, page, hk = pages_k.shape[0], pages_k.shape[1], pages_k.shape[2]
    dv, mp = pages_v.shape[3], block_tables.shape[1]
    if not paged_chunk_fits(hq, hk, d, dv):
        raise ValueError(f"{fn}: unsupported heads/widths Hq={hq} Hk={hk} D={d} Dv={dv}")
    if start.shape != (b,) or start.dtype != torch.int32:
        raise ValueError(f"{fn}: start must be ({b},) int32, got "
                         f"{tuple(start.shape)} {start.dtype}")
    scale = (1.0 / math.sqrt(d)) if scale is None else float(scale)
    tensors = (q, pages_k, pages_v, block_tables, start) + (
        (k_scales, v_scales) if quant else ())
    if all(x.device.type == "cpu" for x in tensors):
        return flash_paged_chunk_attention_plain(q, pages_k, pages_v, block_tables, start,
                                                 scale, k_scales, v_scales)
    if q.device.type != "cuda" or any(x.device != q.device for x in tensors):
        raise ValueError(f"{fn}: all inputs must be on one CUDA device")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError(f"{fn}: inputs must be contiguous")
    out = torch.empty((b, t, hq, dv), dtype=torch.float32, device=q.device)
    if b == 0 or t == 0:
        return out
    if mp * page == 0:
        return out.zero_()
    lib = _cuda.library()
    shard, ws = _partials(mp * page, b, t, hq, dv, q.device)
    dims = (b, t, hq, hk, n, page, mp, d, dv, shard, scale, _cuda.stream_of(q))
    if quant:
        err = lib.flash_paged_chunk_attention_i8(
            q.data_ptr(), pages_k.data_ptr(), k_scales.data_ptr(), pages_v.data_ptr(),
            v_scales.data_ptr(), block_tables.data_ptr(), start.data_ptr(), *_pointers(ws),
            out.data_ptr(), *dims)
    else:
        err = lib.flash_paged_chunk_attention_f32(
            q.data_ptr(), pages_k.data_ptr(), pages_v.data_ptr(), block_tables.data_ptr(),
            start.data_ptr(), *_pointers(ws), out.data_ptr(), *dims)
    _cuda.check(err, fn)
    flash_paged_chunk_attention.launches += 1
    return out


flash_paged_chunk_attention.launches = 0
