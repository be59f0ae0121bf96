"""Mamba2 block (SSD sequence mixer) — train/prefill/decode — counterpart of
:mod:`repro.layers.ssm`.

Block structure (Mamba2, arXiv:2405.21060):

    z  = x @ wz                      (gate,   d -> d_inner)
    xs = silu(conv_x(x @ wx))        (stream, d -> d_inner)
    B  = silu(conv_B(x @ wB))        (d -> G*N)
    C  = silu(conv_C(x @ wC))        (d -> G*N)
    dt = softplus(x @ wdt + bias)    (d -> H)
    y  = SSD(xs, dt, A, B, C) + D*xs  <- registry op: ref / chunked / cuda
    out = (rmsnorm(y * silu(z))) @ out_proj

The projections are stored separately, as in JAX.  Every projection goes
through ``cfg.backend("dense")`` (JAX uses its default ``ref``): on the card
the batch-invariant GEMM kernel, so a sequence's decode step gives the same
bits at any batch size; the one-step SSD update (``ops.ssd_step``) is
written to the same end.

Decode carries two states per block: the conv tails ((B, K-1, ·) per
stream) and the SSM state (B, H, P, N) in float32 — O(1) per step.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.layers.common import dense, dense_init, norm

Params = Dict[str, Any]
Cache = Optional[Dict[str, torch.Tensor]]

__all__ = ["mamba_init", "mamba_apply"]


def mamba_init(gen: torch.Generator, cfg: ArchConfig, *,
               dtype: torch.dtype = torch.float32) -> Params:
    s = cfg.ssm
    d, h = cfg.d_model, s.n_heads
    gn = s.n_groups * s.state
    dev = gen.device
    # dt bias init so softplus(dt_bias) spans [dt_min, dt_max] (mamba2 init)
    u = torch.rand((h,), generator=gen, device=dev, dtype=torch.float32)
    dt = torch.exp(u * (math.log(s.dt_max) - math.log(s.dt_min)) + math.log(s.dt_min))
    dt_bias = dt + torch.log(-torch.expm1(-dt))  # inverse softplus

    def conv_w(c: int) -> torch.Tensor:
        w = torch.randn((s.conv_kernel, c), generator=gen, device=dev, dtype=torch.float32)
        return (w / math.sqrt(s.conv_kernel)).to(dtype)

    return {
        "wz": dense_init(gen, d, s.d_inner, dtype=dtype),
        "wx": dense_init(gen, d, s.d_inner, dtype=dtype),
        "wB": dense_init(gen, d, gn, dtype=dtype),
        "wC": dense_init(gen, d, gn, dtype=dtype),
        "wdt": dense_init(gen, d, h, dtype=dtype),
        "conv_x": conv_w(s.d_inner),
        "conv_B": conv_w(gn),
        "conv_C": conv_w(gn),
        "conv_bx": torch.zeros((s.d_inner,), dtype=dtype, device=dev),
        "conv_bB": torch.zeros((gn,), dtype=dtype, device=dev),
        "conv_bC": torch.zeros((gn,), dtype=dtype, device=dev),
        "dt_bias": dt_bias,
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, device=dev)),
        "D": torch.ones((h,), dtype=torch.float32, device=dev),
        "norm_w": torch.ones((s.d_inner,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, s.d_inner, d, dtype=dtype),
    }


def _causal_conv(xs: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv, width K. xs (B,S,C), w (K,C). ``tail``
    (B,K-1,C) supplies left context (decode / chunked prefill)."""
    k = w.shape[0]
    if tail is None:
        tail = torch.zeros((xs.shape[0], k - 1, xs.shape[2]), dtype=xs.dtype, device=xs.device)
    xp = torch.cat([tail, xs], dim=1)                          # (B, S+K-1, C)
    out = sum(xp[:, i:i + xs.shape[1], :] * w[i][None, None, :] for i in range(k))
    return out + b[None, None, :]


def mamba_apply(p: Params, x: torch.Tensor, *, cfg: ArchConfig, mode: str,
                cache: Cache = None, lengths: Optional[torch.Tensor] = None,
                shard: Any = None) -> Tuple[torch.Tensor, Cache]:
    """Returns (output, new_cache).  At decode on a mesh, ``shard``
    (:class:`repro_torch.runtime.serve.ServeShard`) may split the SSM state's
    heads and ``conv_x``'s channels over "model": the rank then steps its
    own heads and all-gathers the gated output before the norm."""
    s = cfg.ssm
    h, pd, g, n = s.n_heads, s.head_dim, s.n_groups, s.state
    b = x.shape[0]
    A = -torch.exp(p["A_log"])
    dt_c = x.dtype
    bd = cfg.backend("dense")

    def conv(raw, name, tail=None):
        return F.silu(_causal_conv(raw, p[f"conv_{name}"].to(dt_c),
                                   p[f"conv_b{name}"].to(dt_c), tail=tail))

    if mode in ("train", "prefill"):
        sl = x.shape[1]
        z = dense(x, p["wz"], backend=bd)
        x_raw = dense(x, p["wx"], backend=bd)
        B_raw = dense(x, p["wB"], backend=bd)
        C_raw = dense(x, p["wC"], backend=bd)
        dt_raw = dense(x, p["wdt"], backend=bd)
        xs = conv(x_raw, "x").reshape(b, sl, h, pd)
        Bm = conv(B_raw, "B").reshape(b, sl, g, n)
        Cm = conv(C_raw, "C").reshape(b, sl, g, n)
        dt = F.softplus(dt_raw.float() + p["dt_bias"][None, None, :])
        y, ssm_state = kops.ssd(xs, dt, A, Bm, Cm, p["D"], chunk=s.chunk,
                                backend=cfg.backend("ssd"))
        y = y.reshape(b, sl, s.d_inner)
        y = norm(y * F.silu(z.float()).to(y.dtype), p["norm_w"], eps=cfg.norm_eps,
                 backend=cfg.backend("rmsnorm"))
        out = dense(y, p["out_proj"], backend=bd)
        new_cache = None
        if mode == "prefill":
            k = s.conv_kernel           # the tails are copied: a view would keep the whole stream
            new_cache = {"conv_x": x_raw[:, -(k - 1):, :].clone(),
                         "conv_B": B_raw[:, -(k - 1):, :].clone(),
                         "conv_C": C_raw[:, -(k - 1):, :].clone(), "ssm": ssm_state.float()}
        return out, new_cache

    # ---- decode: one step, O(1) state update ----
    if cache is None:
        raise ValueError("mamba decode needs the cache of a prefill")
    heads = _local_heads(shard, h)
    if heads is not None:
        p = _head_params(p, heads, pd)
        A = A[heads]
        h = heads.stop - heads.start
    xt = x[:, 0]
    z = dense(xt, p["wz"], backend=bd)
    new = {name: dense(xt, p[f"w{name}"], backend=bd)[:, None] for name in ("x", "B", "C")}
    dt_raw = dense(xt, p["wdt"], backend=bd)
    streams, tails = {}, {}
    for name, val in new.items():
        tail = cache[f"conv_{name}"]
        streams[name] = conv(val, name, tail=tail)[:, 0]
        tails[f"conv_{name}"] = torch.cat([tail[:, 1:], val], dim=1)
    dtv = F.softplus(dt_raw.float() + p["dt_bias"][None, :])
    Bs, Cs = streams["B"].reshape(b, g, n), streams["C"].reshape(b, g, n)
    if heads is not None:          # each local head's group, as a group of its own
        group = torch.arange(heads.start, heads.stop, device=x.device) // (s.n_heads // g)
        Bs, Cs = Bs[:, group], Cs[:, group]
    y, ssm_state = kops.ssd_step(streams["x"].reshape(b, h, pd), dtv, A, Bs, Cs,
                                 p["D"], cache["ssm"])
    gated = y.reshape(b, 1, h * pd) * F.silu(z[:, None].float()).to(y.dtype)
    if heads is not None:
        gated = shard.gather(gated, "ssm", 1, 2)
    y = norm(gated, p["norm_w"], eps=cfg.norm_eps, backend=cfg.backend("rmsnorm"))
    out = dense(y, p["out_proj"], backend=bd)
    return out, {**tails, "ssm": ssm_state}


def _local_heads(shard: Any, n_heads: int) -> Optional[slice]:
    """This rank's SSM heads when ``shard`` splits the state's heads, else
    None; ``conv_x`` must split its channels with them."""
    if shard is None:
        return None
    n, i = shard.split("ssm", 1)
    if shard.split("conv_x", 2)[0] != n:
        raise ValueError(f"mamba decode: the SSM state splits its heads {n} ways and conv_x "
                         f"its channels {shard.split('conv_x', 2)[0]} ways")
    return None if n == 1 else slice(i * n_heads // n, (i + 1) * n_heads // n)


def _head_params(p: Params, heads: slice, pd: int) -> Params:
    """The params of the heads ``heads``: their columns of the x / z
    streams and the conv over x, their dt, A and D entries; B, C, the norm
    and the output projection whole."""
    c = slice(heads.start * pd, heads.stop * pd)
    out = dict(p)
    for name in ("wz", "wx", "conv_x"):
        out[name] = p[name][:, c].contiguous()
    out["conv_bx"] = p["conv_bx"][c]
    out["wdt"] = p["wdt"][:, heads].contiguous()
    for name in ("dt_bias", "D"):
        out[name] = p[name][heads]
    return out
