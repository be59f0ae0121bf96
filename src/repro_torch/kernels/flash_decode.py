"""Flash-decode: one-token GQA attention over a dense KV cache —
counterpart of :func:`repro.kernels.flash_decode.flash_decode`.

:func:`flash_decode` launches the hand-written CUDA kernel
``csrc/flash_decode.cu`` (one block per (sequence, kv head) holding the
whole query group; K/V streamed in 64-row tiles) on CUDA tensors and runs
:func:`flash_decode_plain` on CPU tensors.  Both follow the Pallas kernel,
not the ``ref`` oracle: a sequence of length 0 gives 0 (``acc / max(l,
1e-30)`` with a finite -1e30 mask), where ``ref`` gives the mean of V.
``flash_decode.launches`` counts kernel launches.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _cuda

__all__ = ["flash_decode", "flash_decode_plain", "decode_fits"]

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


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor, *,
                 scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Hq, D), k (B, S, Hk, D), v (B, S, Hk, Dv), lengths (B,) int32
    -> (B, Hq, Dv), softmax-normalised over positions < lengths[b]."""
    if q.dim() != 3 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_decode: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, hq, d = q.shape
    s_len, hk = k.shape[1], k.shape[2]
    dv = v.shape[3]
    if k.shape != (b, s_len, hk, d) or v.shape[:3] != (b, s_len, hk):
        raise ValueError(f"flash_decode: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"flash_decode: {name} must be float32, got {t.dtype}")
    if not decode_fits(hq, hk, d, dv):
        raise ValueError(f"flash_decode: unsupported heads/widths Hq={hq} Hk={hk} D={d} Dv={dv}")
    scale = (1.0 / math.sqrt(d)) if scale is None else float(scale)
    if lengths.shape != (b,) or lengths.dtype != torch.int32:
        raise ValueError(f"flash_decode: lengths must be ({b},) int32, got "
                         f"{tuple(lengths.shape)} {lengths.dtype}")
    tensors = (q, k, v, lengths)
    if all(t.device.type == "cpu" for t in tensors):
        return flash_decode_plain(q, k, v, lengths, scale)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError("flash_decode: all inputs must be on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_decode: inputs must be contiguous")
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
