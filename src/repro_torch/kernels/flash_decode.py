"""Flash-decode: one-token GQA attention over a KV cache — counterpart of
:func:`repro.kernels.flash_decode.flash_decode` (dense cache),
:func:`repro.kernels.flash_decode.flash_decode_partial` (the unnormalised
partials of KV shards, for split-KV decode) and
:func:`repro.kernels.flash_decode.flash_paged_decode` (page pool reached
through block tables, fp32 or int8 pages).

:func:`flash_decode` and :func:`flash_paged_decode` launch the hand-written
CUDA kernel ``csrc/flash_decode.cu`` (one block per (sequence, kv head)
holding the whole query group; K/V streamed in fixed 64-row logical tiles)
on CUDA tensors and run :func:`flash_decode_plain` /
:func:`flash_paged_decode_plain` on CPU tensors; :func:`flash_decode_partial`
launches the same kernel body once over every shard (grid (B * Hk,
n_splits)) and runs :func:`flash_decode_partial_plain` on CPU tensors.  Both follow the Pallas
kernel, not the ``ref`` oracle: a sequence of length 0 gives 0 (``acc /
max(l, 1e-30)`` with a finite -1e30 mask), where ``ref`` gives the mean of
V.  Each wrapper's ``launches`` attribute counts its kernel launches.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _cuda

__all__ = ["flash_decode", "flash_decode_plain", "flash_decode_partial",
           "flash_decode_partial_plain", "decode_fits", "flash_paged_decode",
           "flash_paged_decode_plain", "paged_decode_fits", "gather_pages"]

_NEG_INF = -1e30
BLOCK_KV = 64          # rows per K/V tile (csrc/flash_decode.cu BKV)


def decode_fits(hq: int, hk: int, d: int, dv: int) -> bool:
    """Whether the kernel takes these head counts and widths: whole GQA
    groups, D and Dv <= 256, and the group's shared memory (the layout of
    csrc/flash_decode.cu) within the H100's 227 KB per block."""
    if hk < 1 or hq % hk or not (0 < d <= _cuda.MAX_HEAD_DIM and 0 < dv <= _cuda.MAX_HEAD_DIM):
        return False
    g = hq // hk
    floats = g * d + g * dv + g * BLOCK_KV + 3 * g + BLOCK_KV * (d + 1) + BLOCK_KV * dv
    return 4 * floats <= _cuda.MAX_SMEM_BYTES


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       lengths: torch.Tensor, scale: float) -> torch.Tensor:
    """The kernel's function in plain PyTorch (fp32): masked softmax whose
    masked entries weigh exactly 0, finished as acc / max(l, 1e-30)."""
    b, hq, d = q.shape
    s_len, hk = k.shape[1], k.shape[2]
    g = hq // hk
    qg = (q * scale).reshape(b, hk, g, d)
    s = torch.einsum("bhgd,bshd->bhgs", qg, k)
    valid = (torch.arange(s_len, device=q.device)[None, :]
             < lengths.to(q.device).long()[:, None])[:, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgs,bshd->bhgd", p, v) / torch.clamp(l, min=1e-30)
    return o.reshape(b, hq, v.shape[3])


def _check_dense(fn: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor, scale: Optional[float]) -> float:
    """Validate a dense-cache decode call; returns the resolved scale."""
    if q.dim() != 3 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{fn}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, hq, d = q.shape
    s_len, hk = k.shape[1], k.shape[2]
    dv = v.shape[3]
    if k.shape != (b, s_len, hk, d) or v.shape[:3] != (b, s_len, hk):
        raise ValueError(f"{fn}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"{fn}: {name} must be float32, got {t.dtype}")
    if not decode_fits(hq, hk, d, dv):
        raise ValueError(f"{fn}: unsupported heads/widths Hq={hq} Hk={hk} D={d} Dv={dv}")
    if lengths.shape != (b,) or lengths.dtype != torch.int32:
        raise ValueError(f"{fn}: lengths must be ({b},) int32, got "
                         f"{tuple(lengths.shape)} {lengths.dtype}")
    return (1.0 / math.sqrt(d)) if scale is None else float(scale)


def _on_card(fn: str, tensors) -> bool:
    """False for CPU tensors (the plain version runs); True for tensors on
    one CUDA device, contiguous (the kernel runs); raises otherwise."""
    if all(t.device.type == "cpu" for t in tensors):
        return False
    q = tensors[0]
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError(f"{fn}: all inputs must be on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{fn}: inputs must be contiguous")
    return True


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor, *,
                 scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Hq, D), k (B, S, Hk, D), v (B, S, Hk, Dv), lengths (B,) int32
    -> (B, Hq, Dv), softmax-normalised over positions < lengths[b]."""
    scale = _check_dense("flash_decode", q, k, v, lengths, scale)
    if not _on_card("flash_decode", (q, k, v, lengths)):
        return flash_decode_plain(q, k, v, lengths, scale)
    b, hq, d = q.shape
    s_len, hk, dv = k.shape[1], k.shape[2], v.shape[3]
    out = torch.empty((b, hq, dv), dtype=torch.float32, device=q.device)
    if b == 0:
        return out
    err = _cuda.library().flash_decode_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), b, hq, hk, s_len, d, dv, scale, _cuda.stream_of(q))
    _cuda.check(err, "flash_decode")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


def flash_decode_partial_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               lengths: torch.Tensor, scale: float, n_splits: int = 1):
    """The partial kernel's function in plain PyTorch (fp32): for each shard
    i of S / n_splits rows, with length clip(len - i * part, 0, part), the
    running max m of the masked scores (-1e30 for an empty shard), the sum
    l of exp(s - m) over the valid rows, and acc = sum of exp(s - m) * v.
    Returns acc (n_splits, B, Hq, Dv), m and l (n_splits, B, Hq)."""
    b, hq, d = q.shape
    s_len, hk = k.shape[1], k.shape[2]
    g, part = hq // hk, s_len // n_splits
    qg = (q * scale).reshape(b, hk, g, d)
    lengths = lengths.to(q.device).long().clamp(0, s_len)
    accs, ms, ls = [], [], []
    for i in range(n_splits):
        ks, vs = k[:, i * part:(i + 1) * part], v[:, i * part:(i + 1) * part]
        n_i = (lengths - i * part).clamp(0, part)
        s = torch.einsum("bhgd,bshd->bhgs", qg, ks)
        valid = (torch.arange(part, device=q.device)[None, :] < n_i[:, None])[:, None, None, :]
        s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
        accs.append(torch.einsum("bhgs,bshd->bhgd", p, vs).reshape(b, hq, v.shape[3]))
        ms.append(m.reshape(b, hq))
        ls.append(p.sum(dim=-1).reshape(b, hq))
    return torch.stack(accs), torch.stack(ms), torch.stack(ls)


def flash_decode_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor, *, scale: Optional[float] = None,
                         n_splits: int = 1):
    """Unnormalised flash partials of each of ``n_splits`` KV shards (rows
    [i * S / n_splits, (i + 1) * S / n_splits)) in one launch: q (B, Hq, D),
    k (B, S, Hk, D), v (B, S, Hk, Dv), lengths (B,) int32 -> acc (n_splits,
    B, Hq, Dv), m (n_splits, B, Hq), l (n_splits, B, Hq).  With
    ``n_splits=1`` it is JAX's ``flash_decode_partial`` over the whole cache
    (with a leading axis of 1).  Combine with ``ref.combine_partials_ref``."""
    fn = "flash_decode_partial"
    scale = _check_dense(fn, q, k, v, lengths, scale)
    b, hq, d = q.shape
    s_len, hk, dv = k.shape[1], k.shape[2], v.shape[3]
    if n_splits < 1 or s_len % n_splits:
        raise ValueError(f"{fn}: n_splits={n_splits} must be >= 1 and divide S={s_len}")
    if not _on_card(fn, (q, k, v, lengths)):
        return flash_decode_partial_plain(q, k, v, lengths, scale, n_splits)
    acc = torch.empty((n_splits, b, hq, dv), dtype=torch.float32, device=q.device)
    m = torch.empty((n_splits, b, hq), dtype=torch.float32, device=q.device)
    l = torch.empty((n_splits, b, hq), dtype=torch.float32, device=q.device)
    if b == 0:
        return acc, m, l
    err = _cuda.library().flash_decode_partial_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), acc.data_ptr(),
        m.data_ptr(), l.data_ptr(), b, hq, hk, s_len, d, dv, n_splits, scale,
        _cuda.stream_of(q))
    _cuda.check(err, fn)
    flash_decode_partial.launches += 1
    return acc, m, l


flash_decode_partial.launches = 0


# The paged kernel stages the same tiles as the dense one: its shared memory
# does not depend on the page size.
paged_decode_fits = decode_fits


def gather_pages(pages: torch.Tensor, tables: torch.Tensor,
                 scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, P, H, D) pages + (B, MP) int32 tables -> the dense (B, MP*P, H, D)
    cache they describe, table entries clipped to [0, N-1].  With ``scales``
    ((N, H) float32) the pages are int8 and come back dequantized as
    ``float(x) * scale[block, h]`` — the JAX package's ``_gather_pages`` and
    ``_gather_pages_q``."""
    n, p = pages.shape[0], pages.shape[1]
    idx = tables.to(pages.device).long().clamp(0, n - 1)
    g = pages[idx]                                        # (B, MP, P, H, D)
    if scales is not None:
        g = g.float() * scales[idx][:, :, None, :, None]
    return g.reshape(tables.shape[0], tables.shape[1] * p, *pages.shape[2:])


def flash_paged_decode_plain(q: torch.Tensor, pages_k: torch.Tensor,
                             pages_v: torch.Tensor, block_tables: torch.Tensor,
                             lengths: torch.Tensor, scale: float,
                             k_scales: Optional[torch.Tensor] = None,
                             v_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The paged kernel's function in plain PyTorch: gather (and dequantize)
    the pages into a dense cache, then :func:`flash_decode_plain`."""
    return flash_decode_plain(q, gather_pages(pages_k, block_tables, k_scales),
                              gather_pages(pages_v, block_tables, v_scales),
                              lengths, scale)


def check_paged(fn: str, q: torch.Tensor, pages_k: torch.Tensor, pages_v: torch.Tensor,
                block_tables: torch.Tensor, k_scales: Optional[torch.Tensor],
                v_scales: Optional[torch.Tensor]) -> bool:
    """Validate the page pool, tables and scales a paged attention wrapper
    was given; returns whether the pages are int8 (both scales given)."""
    quant = k_scales is not None
    if quant != (v_scales is not None):
        raise ValueError(f"{fn}: need both k_scales and v_scales, or neither")
    if pages_k.dim() != 4 or pages_v.dim() != 4 or pages_k.shape[:3] != pages_v.shape[:3]:
        raise ValueError(f"{fn}: pages_k {tuple(pages_k.shape)}, pages_v {tuple(pages_v.shape)}")
    n, _, hk, d = pages_k.shape
    if n < 1 or d != q.shape[-1]:
        raise ValueError(f"{fn}: q {tuple(q.shape)}, pages_k {tuple(pages_k.shape)}")
    if q.dtype != torch.float32:
        raise TypeError(f"{fn}: q must be float32, got {q.dtype}")
    want = torch.int8 if quant else torch.float32
    for name, t in (("pages_k", pages_k), ("pages_v", pages_v)):
        if t.dtype != want:
            raise TypeError(f"{fn}: {name} must be {want}, got {t.dtype}")
    if quant:
        for name, t in (("k_scales", k_scales), ("v_scales", v_scales)):
            if t.shape != (n, hk) or t.dtype != torch.float32:
                raise ValueError(f"{fn}: {name} must be ({n}, {hk}) float32, got "
                                 f"{tuple(t.shape)} {t.dtype}")
    if (block_tables.dim() != 2 or block_tables.shape[0] != q.shape[0]
            or block_tables.dtype != torch.int32):
        raise ValueError(f"{fn}: block_tables must be ({q.shape[0]}, MP) int32, got "
                         f"{tuple(block_tables.shape)} {block_tables.dtype}")
    return quant


def flash_paged_decode(q: torch.Tensor, pages_k: torch.Tensor, pages_v: torch.Tensor,
                       block_tables: torch.Tensor, lengths: torch.Tensor, *,
                       k_scales: Optional[torch.Tensor] = None,
                       v_scales: Optional[torch.Tensor] = None,
                       scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Hq, D), pages_k (N, P, Hk, D), pages_v (N, P, Hk, Dv),
    block_tables (B, MP) int32, lengths (B,) int32 -> (B, Hq, Dv).

    Logical position ``pi * P + r`` of sequence b is row r of block
    ``block_tables[b, pi]`` (clipped to [0, N-1]); positions >= lengths[b]
    are masked, so table entries past the length may hold any block id.
    With ``k_scales``/``v_scales`` ((N, Hk) float32) the pages are int8,
    dequantized per (page, kv head) as ``float(x) * scale``."""
    fn = "flash_paged_decode"
    if q.dim() != 3:
        raise ValueError(f"{fn}: q {tuple(q.shape)}")
    quant = check_paged(fn, q, pages_k, pages_v, block_tables, k_scales, v_scales)
    b, hq, d = q.shape
    n, page, hk = pages_k.shape[0], pages_k.shape[1], pages_k.shape[2]
    dv, mp = pages_v.shape[3], block_tables.shape[1]
    if not paged_decode_fits(hq, hk, d, dv):
        raise ValueError(f"{fn}: unsupported heads/widths Hq={hq} Hk={hk} D={d} Dv={dv}")
    if lengths.shape != (b,) or lengths.dtype != torch.int32:
        raise ValueError(f"{fn}: lengths must be ({b},) int32, got "
                         f"{tuple(lengths.shape)} {lengths.dtype}")
    scale = (1.0 / math.sqrt(d)) if scale is None else float(scale)
    tensors = (q, pages_k, pages_v, block_tables, lengths) + (
        (k_scales, v_scales) if quant else ())
    if all(t.device.type == "cpu" for t in tensors):
        return flash_paged_decode_plain(q, pages_k, pages_v, block_tables, lengths,
                                        scale, k_scales, v_scales)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError(f"{fn}: all inputs must be on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{fn}: inputs must be contiguous")
    out = torch.empty((b, hq, dv), dtype=torch.float32, device=q.device)
    if b == 0:
        return out
    lib = _cuda.library()
    dims = (b, hq, hk, n, page, mp, d, dv, scale, _cuda.stream_of(q))
    if quant:
        err = lib.flash_paged_decode_i8(
            q.data_ptr(), pages_k.data_ptr(), k_scales.data_ptr(), pages_v.data_ptr(),
            v_scales.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), *dims)
    else:
        err = lib.flash_paged_decode_f32(
            q.data_ptr(), pages_k.data_ptr(), pages_v.data_ptr(), block_tables.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), *dims)
    _cuda.check(err, fn)
    flash_paged_decode.launches += 1
    return out


flash_paged_decode.launches = 0
