"""Shared layer primitives: linear, embedding, RoPE, norm dispatch —
counterpart of :mod:`repro.layers.common`.

Functional style throughout: ``init(gen, ...) -> params`` (tensors drawn
from the ``torch.Generator`` ``gen`` on its device) and ``apply(params, x,
...)``.  All matmul-bearing layers route through the registry-dispatched
ops, so the backend assignment of a config (``ref`` / ``cuda``) applies
uniformly.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.registry import get_impl
from repro_torch.kernels import ops as kops

Params = Dict[str, Any]


# --------------------------------------------------------------------------- #
# init helpers
# --------------------------------------------------------------------------- #

def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               dtype: torch.dtype = torch.float32,
               scale: Optional[float] = None) -> torch.Tensor:
    scale = (1.0 / math.sqrt(d_in)) if scale is None else scale
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device, dtype=torch.float32)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, *,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, device=gen.device, dtype=torch.float32)
    return (w * 0.02).to(dtype)


def dense(x: torch.Tensor, w: torch.Tensor, *, backend: str = "ref") -> torch.Tensor:
    """Registry-dispatched matmul in x.dtype (the ``cuda`` backend is the
    batch-invariant fp32 GEMM kernel: a row's result does not depend on the
    other rows of the call)."""
    return get_impl("dense", backend)([x, w.to(x.dtype)], {})[0]


def norm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
         residual: Optional[torch.Tensor] = None, backend: str = "ref") -> torch.Tensor:
    return kops.rmsnorm(x, w, eps=eps, residual=residual, backend=backend)


# --------------------------------------------------------------------------- #
# RoPE
# --------------------------------------------------------------------------- #

def rope_table(positions: torch.Tensor, head_dim: int, theta: float = 1e4,
               rotary_dim: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for ``positions`` (any shape) -> (..., rotary_dim/2).

    In float32 and in the JAX package's order (the frequencies first, then
    position times frequency): at theta = 1e6 and positions near 2048 one
    ulp of the angle is ~2e-4, so another order would move the tables."""
    rd = head_dim if rotary_dim is None else rotary_dim
    if rd % 2:
        raise ValueError(f"rotary dim {rd} must be even")
    exps = torch.arange(0, rd, 2, dtype=torch.float32, device=positions.device) / rd
    inv_freq = 1.0 / (theta ** exps)
    ang = positions.to(torch.float32)[..., None] * inv_freq        # (..., rd/2)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., H, D); cos/sin broadcastable to (..., 1, D_rot/2).
    Rotates the first ``2 * cos.shape[-1]`` features (pair-interleaved
    halves, GPT-NeoX style); the rest pass through."""
    rd2 = cos.shape[-1]
    xr, xp = x[..., :2 * rd2], x[..., 2 * rd2:]
    x1, x2 = xr[..., :rd2], xr[..., rd2:]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1, out2, xp], dim=-1).to(x.dtype)


def rope_for_seq(seq_len: int, head_dim: int, theta: float = 1e4,
                 offset: int = 0, rotary_dim: Optional[int] = None,
                 device: Optional[torch.device] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin shaped (seq, 1, rd/2) — broadcast over (B, S, H, D)."""
    pos = torch.arange(offset, offset + seq_len, device=device)
    cos, sin = rope_table(pos, head_dim, theta, rotary_dim)
    return cos[:, None, :], sin[:, None, :]
