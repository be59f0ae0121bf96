"""Plain PyTorch oracles — counterpart of :mod:`repro.kernels.ref`.

These are the ``ref`` backends of the port's ops and follow the JAX
package's oracles, not its kernels (``decode_attention_ref`` gives the mean
of V for an empty cache, as ``repro``'s does; the kernels give 0).

Shape conventions
-----------------
decode_attention: q (B, Hq, D), k/v (B, Skv, Hkv, D), lengths (B,)
rmsnorm:          x (..., D), w (D,)
gemm:             x (M, K) @ w (K, N)
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["decode_attention_ref", "rmsnorm_ref", "gemm_ref", "swiglu_ref"]

_NEG_INF = -1e30  # large-negative instead of -inf: keeps masked softmax NaN-free


def _repeat_kv(k: torch.Tensor, hq: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, Hq, D) by repeating each kv head."""
    hkv = k.shape[2]
    if hkv == hq:
        return k
    if hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    return torch.repeat_interleave(k, hq // hkv, dim=2)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: Optional[torch.Tensor] = None, *,
                         scale: Optional[float] = None) -> torch.Tensor:
    """One-new-token attention against a KV cache; ``lengths[b]`` valid
    cache entries per sequence."""
    b, hq, d = q.shape
    skv = k.shape[1]
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    k = _repeat_kv(k, hq)
    v = _repeat_kv(v, hq)
    s = torch.einsum("bhd,bkhd->bhk", q.float() * scale, k.float())
    if lengths is not None:
        pos = torch.arange(skv, device=q.device)
        valid = pos[None, None, :] < lengths.to(q.device)[:, None, None]
        s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhk,bkhd->bhd", p, v.float())
    return o.to(q.dtype)


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RMSNorm with optional fused residual add (norm(x + residual))."""
    xf = x.float()
    if residual is not None:
        xf = xf + residual.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * w.float()
    return y.to(x.dtype)


def gemm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def swiglu_ref(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return (F.silu(gate.float()) * up.float()).to(gate.dtype)
