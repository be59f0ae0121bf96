"""Plain PyTorch oracles — counterpart of :mod:`repro.kernels.ref`.

These are the ``ref`` backends of the port's ops and follow the JAX
package's oracles, not its kernels (``decode_attention_ref`` gives the mean
of V for an empty cache, as ``repro``'s does; the kernels give 0).

Shape conventions
-----------------
attention:        q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D), Hq % Hkv == 0
decode_attention: q (B, Hq, D), k/v (B, Skv, Hkv, D), lengths (B,)
rmsnorm:          x (..., D), w (D,)
gemm:             x (M, K) @ w (K, N)
batched_gemm:     x (E, M, K) @ w (E, K, N)
ssd:              x (B, S, H, P), dt (B, S, H), A (H,), B/C (B, S, G, N)

JAX's ``lax.scan`` loops (the sequential and the chunked SSD) are Python
loops here.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["attention_mask", "attention_ref", "decode_attention_ref",
           "combine_partials_ref", "rmsnorm_ref", "gemm_ref", "batched_gemm_ref", "swiglu_ref", "ssd_ref", "ssd_step_ref",
           "ssd_chunked_ref", "with_d"]

_NEG_INF = -1e30  # large-negative instead of -inf: keeps masked softmax NaN-free


def _repeat_kv(k: torch.Tensor, hq: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, Hq, D) by repeating each kv head."""
    hkv = k.shape[2]
    if hkv == hq:
        return k
    if hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    return torch.repeat_interleave(k, hq // hkv, dim=2)


def attention_mask(sq: int, skv: int, *, causal: bool,
                   window: Optional[int] = None, offset: int = 0,
                   device: Optional[torch.device] = None) -> torch.Tensor:
    """(Sq, Skv) boolean mask. ``offset`` is the absolute position of query
    row 0 minus key col 0 (for decode/chunked prefill: offset = skv - sq)."""
    row = torch.arange(sq, device=device)[:, None] + offset
    col = torch.arange(skv, device=device)[None, :]
    m = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        m &= col <= row
    if window is not None:
        m &= col > row - window
    return m


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Full (training/prefill) attention with GQA, causal + sliding window."""
    b, sq, hq, d = q.shape
    skv = k.shape[1]
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    k = _repeat_kv(k, hq)
    v = _repeat_kv(v, hq)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    mask = attention_mask(sq, skv, causal=causal, window=window, offset=skv - sq,
                          device=q.device)
    s = torch.where(mask[None, None], s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype)


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


def combine_partials_ref(outs: torch.Tensor, ms: torch.Tensor,
                         ls: torch.Tensor) -> torch.Tensor:
    """Combine flash partials over a leading 'split' axis.

    outs (S, ..., D) unnormalised accumulators, ms (S, ...) running max,
    ls (S, ...) running sum of exp.  Returns the exact softmax-weighted
    output.  The splits are merged in index order by elementwise ops (no
    library reduction, whose strategy may depend on the shape), so a row's
    result does not depend on the other rows.  An empty shard (m = -1e30,
    l = 0, acc = 0) weighs exp(-1e30 - m) = 0, and all-empty rows give 0."""
    m = ms[0]
    for i in range(1, ms.shape[0]):
        m = torch.maximum(m, ms[i])
    l = torch.zeros_like(ls[0])
    o = torch.zeros_like(outs[0])
    for i in range(ms.shape[0]):
        alpha = torch.exp(ms[i] - m)
        l = l + ls[i] * alpha
        o = o + outs[i] * alpha[..., None]
    return o / torch.clamp(l, min=1e-30)[..., None]


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


def batched_gemm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(E, M, K) @ (E, K, N) -> (E, M, N)."""
    return torch.einsum("emk,ekn->emn", x.float(), w.float()).to(x.dtype)


def swiglu_ref(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return (F.silu(gate.float()) * up.float()).to(gate.dtype)


# --------------------------------------------------------------------------- #
# Mamba2 SSD
# --------------------------------------------------------------------------- #

def _state0(init_state, b, h, p, n, device) -> torch.Tensor:
    if init_state is None:
        return torch.zeros((b, h, p, n), dtype=torch.float32, device=device)
    return init_state.float()


def with_d(y: torch.Tensor, x: torch.Tensor, D: Optional[torch.Tensor]) -> torch.Tensor:
    """y + D x per head (the SSD skip term), in fp32, cast to x's dtype."""
    if D is not None:
        y = y.float() + x.float() * D.float()[None, None, :, None]
    return y.to(x.dtype)


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
            C: torch.Tensor, D: Optional[torch.Tensor] = None,
            init_state: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential state-space-duality recurrence (the exact oracle).

    x (B,S,H,P), dt (B,S,H), A (H,) negative, B/C (B,S,G,N) with H % G == 0.
    Returns y (B,S,H,P) and final state (B,H,P,N).

        a_t   = exp(dt_t * A)            (per head, scalar)
        S_t   = a_t S_{t-1} + (dt_t x_t) B_t^T   (P x N)
        y_t   = S_t C_t + D x_t
    """
    b, s, h, p = x.shape
    n = B.shape[3]
    hpg = h // B.shape[2]
    Bh = torch.repeat_interleave(B, hpg, dim=2).float()        # (B,S,H,N)
    Ch = torch.repeat_interleave(C, hpg, dim=2).float()
    a = torch.exp(dt.float() * A.float()[None, None, :])
    xbar = x.float() * dt.float()[..., None]
    state = _state0(init_state, b, h, p, n, x.device)
    ys = []
    for t in range(s):
        state = state * a[:, t, :, None, None] + xbar[:, t, :, :, None] * Bh[:, t, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch[:, t]))
    y = torch.stack(ys, dim=1) if ys else torch.zeros((b, 0, h, p), device=x.device)
    return with_d(y, x, D), state


def ssd_step_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                 C: torch.Tensor, D: Optional[torch.Tensor],
                 state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single decode step. x (B,H,P), dt (B,H), B/C (B,G,N), state (B,H,P,N).
    Returns (y (B,H,P), new_state)."""
    y, new_state = ssd_ref(x[:, None], dt[:, None], A, B[:, None], C[:, None], D,
                           init_state=state)
    return y[:, 0], new_state


def ssd_chunked_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                    C: torch.Tensor, D: Optional[torch.Tensor] = None,
                    init_state: Optional[torch.Tensor] = None,
                    chunk: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD — the algorithm the kernel implements (intra-chunk
    quadratic + inter-chunk state carry).  The decay ``exp(cs_i - cs_j)`` is
    taken only where j <= i (elsewhere the difference is positive and the
    exp could overflow; JAX masks it after the exp, which gives the same
    numbers wherever it is finite)."""
    b, s, h, p = x.shape
    n = B.shape[3]
    if s % chunk:
        raise ValueError(f"pad sequence {s} to a multiple of the chunk {chunk}")
    nc = s // chunk
    hpg = h // B.shape[2]
    Bh = torch.repeat_interleave(B, hpg, dim=2).float()
    Ch = torch.repeat_interleave(C, hpg, dim=2).float()
    la = dt.float() * A.float()[None, None, :]                  # log a
    xbar = x.float() * dt.float()[..., None]
    state = _state0(init_state, b, h, p, n, x.device)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    ys = []
    for ci in range(nc):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        lac, xc, Bc, Cc = la[:, sl], xbar[:, sl], Bh[:, sl], Ch[:, sl]
        cs = torch.cumsum(lac, dim=1)                             # (B,chunk,H)
        smat = torch.einsum("bihn,bjhn->bhij", Cc, Bc)
        dec = cs[:, :, None, :] - cs[:, None, :, :]               # (B,i,j,H)
        L = torch.exp(torch.where(mask[None, :, :, None], dec, torch.zeros_like(dec)))
        L = torch.where(mask[None, :, :, None], L, torch.zeros_like(L))
        y_intra = torch.einsum("bhij,bjhp->bihp", smat * L.permute(0, 3, 1, 2), xc)
        y_inter = torch.einsum("bihn,bhpn->bihp", Cc, state) * torch.exp(cs)[..., None]
        w = torch.exp(cs[:, -1:, :] - cs)                         # (B,chunk,H)
        state = (state * torch.exp(cs[:, -1, :])[..., None, None]
                 + torch.einsum("bjhp,bjhn->bhpn", xc * w[..., None], Bc))
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1) if ys else torch.zeros((b, 0, h, p), device=x.device)
    return with_d(y, x, D), state
