"""Chunked-prefill flash attention over a KV cache — counterpart of
:func:`repro.kernels.flash_attention.flash_chunk_attention` (dense cache)
and :func:`repro.kernels.flash_attention.flash_paged_chunk_attention` (page
pool reached through block tables, fp32 or int8 pages).

:func:`flash_chunk_attention` and :func:`flash_paged_chunk_attention`
launch the hand-written CUDA kernel ``csrc/flash_attention.cu`` (one block
per (sequence, query head, 32-row query tile); fixed 64-row logical K/V
tiles from column 0) on CUDA tensors and run their plain versions on CPU
tensors.  Query row t of sequence b sits at ``start[b] + t`` and attends
cache columns ``<= start[b] + t``.  Each wrapper's ``launches`` attribute
counts its kernel launches.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.flash_decode import check_paged, gather_pages

__all__ = ["flash_chunk_attention", "flash_chunk_attention_plain", "chunk_fits",
           "flash_paged_chunk_attention", "flash_paged_chunk_attention_plain",
           "paged_chunk_fits"]

_NEG_INF = -1e30
BLOCK_Q = 32           # query rows per block (csrc/flash_attention.cu BQ)
BLOCK_KV = 64          # rows per K/V tile (BKV)


def chunk_fits(hq: int, hk: int, d: int, dv: int) -> bool:
    """Whether the kernel takes these head counts and widths: whole GQA
    groups, D and Dv <= 256, and its shared memory (the layout of
    csrc/flash_attention.cu) within the H100's 227 KB per block."""
    if hk < 1 or hq % hk or not (0 < d <= _cuda.MAX_HEAD_DIM and 0 < dv <= _cuda.MAX_HEAD_DIM):
        return False
    floats = (BLOCK_Q * d + BLOCK_Q * dv + BLOCK_Q * BLOCK_KV + 3 * BLOCK_Q
              + BLOCK_KV * (d + 1) + BLOCK_KV * dv)
    return 4 * floats <= _cuda.MAX_SMEM_BYTES


def flash_chunk_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                start: torch.Tensor, scale: float) -> torch.Tensor:
    """The kernel's function in plain PyTorch (fp32): offset-causal masked
    softmax whose masked entries weigh exactly 0, finished as
    acc / max(l, 1e-30)."""
    b, t, hq, d = q.shape
    s_len, hk = k.shape[1], k.shape[2]
    g = hq // hk
    qg = (q * scale).reshape(b, t, hk, g, d)
    s = torch.einsum("btkgd,bskd->bkgts", qg, k)
    qpos = start.to(q.device).long()[:, None] + torch.arange(t, device=q.device)[None, :]
    allowed = (torch.arange(s_len, device=q.device)[None, None, :]
               <= qpos[:, :, None])[:, None, None, :, :]            # (B,1,1,T,S)
    s = torch.where(allowed, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(allowed, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgts,bskd->bkgtd", p, v) / torch.clamp(l, min=1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(b, t, hq, v.shape[3])


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
    err = _cuda.library().flash_chunk_attention_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), start.data_ptr(), out.data_ptr(),
        b, t, hq, hk, s_len, d, dv, scale, _cuda.stream_of(q))
    _cuda.check(err, "flash_chunk_attention")
    flash_chunk_attention.launches += 1
    return out


flash_chunk_attention.launches = 0


# The paged kernel stages the same tiles as the dense one: its shared memory
# does not depend on the page size.
paged_chunk_fits = chunk_fits


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
    lib = _cuda.library()
    dims = (b, t, hq, hk, n, page, mp, d, dv, scale, _cuda.stream_of(q))
    if quant:
        err = lib.flash_paged_chunk_attention_i8(
            q.data_ptr(), pages_k.data_ptr(), k_scales.data_ptr(), pages_v.data_ptr(),
            v_scales.data_ptr(), block_tables.data_ptr(), start.data_ptr(),
            out.data_ptr(), *dims)
    else:
        err = lib.flash_paged_chunk_attention_f32(
            q.data_ptr(), pages_k.data_ptr(), pages_v.data_ptr(), block_tables.data_ptr(),
            start.data_ptr(), out.data_ptr(), *dims)
    _cuda.check(err, fn)
    flash_paged_chunk_attention.launches += 1
    return out


flash_paged_chunk_attention.launches = 0
