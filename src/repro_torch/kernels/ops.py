"""Kernel ops + registry integration — counterpart of
:mod:`repro.kernels.ops`, for the ops of the dense serving path and the
layer-stack models' mixers.

Declares ``attention``, ``decode_attention``, ``rmsnorm``, ``ssd``,
``moe_gemm`` and ``swiglu`` (shape and cost functions match ``repro``'s),
registers their ``ref`` backends (the plain PyTorch oracles of
:mod:`repro_torch.kernels.ref`; ``ssd`` also has ``chunked``, the plain
chunked algorithm) and the ``cuda`` backends of ``attention``,
``decode_attention``, ``rmsnorm``, ``ssd``, ``moe_gemm``, ``dense``,
``conv2d`` and ``conv2d_fused`` (the hand-written Hopper kernels, in the
slot ``pallas`` fills in ``repro``; the convolutions are im2col + the GEMM
kernel).  ``decode_attention`` also has ``cuda_split`` (the slot of
``pallas_split``): the partial kernel over ``n_splits`` KV shards in one
launch, combined in a fixed order.  A ``cuda`` backend runs its kernel's
plain version on CPU tensors.  The dispatchers ``attention``,
``decode_attention``, ``decode_attention_partial``, ``rmsnorm``, ``ssd``,
``ssd_step``, ``moe_gemm`` and ``swiglu`` are what :mod:`repro_torch.layers`
calls.

The ``cuda`` guards are only what the kernels need (whole GQA groups,
head widths <= 256, or for the dense decode D <= 640 and Dv <= 512 within
the shared memory, a chunk of at most 128, ungrouped convolutions, and the
kernels' types); the TPU's block-divisibility guards are not carried over,
because each kernel masks its own ragged edges.  The ops of
:data:`BF16_OPS` (``attention``, ``decode_attention``, ``rmsnorm``,
``dense``, ``moe_gemm`` and ``ssd``) take inputs all float32 or all
bfloat16 on ``cuda`` (``ssd``: x, B and C so, dt, A and D float32), as
JAX's Pallas backends take either; ``decode_attention``'s ``cuda_split``
takes either too (the partial kernel's bf16 entry, merged as JAX's
``pallas_split`` merges: the bf16 partials upcast, rounded once at the
end); the convolutions take float32 only.  A call outside a kernel's types
raises ``TypeError`` from its wrapper: no op moves to another backend by
itself.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import nnops as _nnops
from repro_torch.core.ir import TensorSpec
from repro_torch.core.registry import Cost, defop, get_impl, impl
from repro_torch.kernels import ref as R
from repro_torch.kernels.flash_attention import attention_fits, flash_attention
from repro_torch.kernels.flash_decode import (combine_partials, decode_fits, flash_decode,
                                              flash_decode_partial, flash_decode_partial_plain)
from repro_torch.kernels.gemm import batched_gemm as _batched_gemm_kernel
from repro_torch.kernels.gemm import gemm as _gemm_kernel
from repro_torch.kernels.rmsnorm import rmsnorm as _rmsnorm_kernel
from repro_torch.kernels.ssd import scan_fits, ssd_scan_plain
from repro_torch.kernels.ssd import ssd_scan as _ssd_kernel

__all__ = ["attention", "decode_attention", "decode_attention_partial", "rmsnorm", "ssd",
           "ssd_step", "moe_gemm", "swiglu", "BF16_OPS"]

# The ops whose ``cuda`` backend has a bf16 body (the kernels' bf16 entries).
BF16_OPS = frozenset({"attention", "decode_attention", "rmsnorm", "dense", "moe_gemm", "ssd"})


def _bytes(specs: Sequence[TensorSpec]) -> float:
    return float(sum(s.nbytes for s in specs))


def _all_f32(specs: Sequence[TensorSpec]) -> bool:
    return all(s.dtype == "float32" for s in specs)


def _f32_or_bf16(specs: Sequence[TensorSpec]) -> bool:
    """All float32, or all bfloat16: the types of the BF16_OPS kernels."""
    return _all_f32(specs) or all(s.dtype == "bfloat16" for s in specs)


# --------------------------------------------------------------------------- #
# attention (prefill / training forward)
# inputs: q (B,Sq,Hq,D), k (B,Skv,Hkv,D), v — attrs: causal, window, scale
# --------------------------------------------------------------------------- #

def _attn_shape(specs, attrs):
    q = specs[0]
    return [q]


def _attn_cost(specs, attrs):
    q, k = specs[0], specs[1]
    b, sq, hq, d = q.shape
    skv = k.shape[1]
    causal_frac = 0.5 if attrs.get("causal", True) and sq == skv else 1.0
    if attrs.get("window") and attrs["window"] < skv:
        causal_frac = min(causal_frac, attrs["window"] / skv)
    flops = 4.0 * b * hq * sq * skv * d * causal_frac
    out_b = q.nbytes
    return Cost(flops=flops, bytes=_bytes(specs) + out_b)


defop("attention", _attn_shape, _attn_cost,
      doc="GQA flash-style attention; attrs: causal, window, scale")


@impl("attention", "ref")
def _attention_ref_impl(inputs, attrs):
    q, k, v = inputs
    return [R.attention_ref(q, k, v, causal=attrs.get("causal", True),
                            window=attrs.get("window"), scale=attrs.get("scale"))]


def _attn_cuda_supports(specs, attrs):
    q, k, v = specs[0], specs[1], specs[2]
    return (_f32_or_bf16((q, k, v))
            and attention_fits(q.shape[2], k.shape[2], q.shape[3], v.shape[3]))


@impl("attention", "cuda", supports=_attn_cuda_supports,
      note="flash attention CUDA kernel; 64 query rows of a GQA group per "
           "block over fixed shards of 64-column K/V tiles (256 columns at "
           "fp32; bf16 one shard where the tiles fill the SMs), tiles "
           "outside the causal/window mask skipped, shards merged in order; "
           "bf16 on the tensor cores (wgmma for QK^T and PV)")
def _attention_cuda_impl(inputs, attrs):
    q, k, v = inputs
    return [flash_attention(q, k, v, causal=attrs.get("causal", True),
                            window=attrs.get("window"), scale=attrs.get("scale"))]


def attention(q, k, v, *, causal=True, window=None, scale=None, backend="ref", **kw):
    return get_impl("attention", backend)(
        [q, k, v], {"causal": causal, "window": window, "scale": scale, **kw})[0]


# --------------------------------------------------------------------------- #
# decode_attention — one token vs KV cache
# inputs: q (B,Hq,D), k/v (B,Skv,Hkv,D), lengths (B,)
# --------------------------------------------------------------------------- #

def _dec_shape(specs, attrs):
    return [specs[0]]


def _dec_cost(specs, attrs):
    q, k = specs[0], specs[1]
    b, hq, d = q.shape
    skv = k.shape[1]
    return Cost(flops=4.0 * b * hq * skv * d,
                bytes=_bytes(specs) + q.nbytes)


defop("decode_attention", _dec_shape, _dec_cost,
      doc="single-token attention vs KV cache; inputs (q, k, v, lengths)")


@impl("decode_attention", "ref")
def _decode_ref_impl(inputs, attrs):
    q, k, v, lengths = inputs
    return [R.decode_attention_ref(q, k, v, lengths, scale=attrs.get("scale"))]


def _dec_cuda_supports(specs, attrs):
    q, k, v = specs[0], specs[1], specs[2]
    return (_f32_or_bf16((q, k, v))
            and decode_fits(q.shape[1], k.shape[2], q.shape[2], v.shape[3],
                            bf16=q.dtype == "bfloat16"))


@impl("decode_attention", "cuda", supports=_dec_cuda_supports,
      note="flash-decode CUDA kernel; one block per (b, kv head, shard), the "
           "GQA group shares one K/V read, shards combined in order")
def _decode_cuda_impl(inputs, attrs):
    q, k, v, lengths = inputs
    return [flash_decode(q, k, v, lengths, scale=attrs.get("scale"))]


def _full_lengths(lengths, q, k):
    if lengths is None:
        return torch.full((q.shape[0],), k.shape[1], dtype=torch.int32, device=q.device)
    return lengths


def _dec_split_supports(specs, attrs):
    """What the partial kernel needs (re-derived, not JAX's guard): the
    cuda backend's guard (q, k and v all fp32 or all bf16, the shared
    memory), n_splits >= 2, and S a multiple of n_splits (equal
    shards, one launch).  JAX's "shards of >= 8 rows" and "each shard a
    multiple of its block_kv" are TPU sublane and BlockSpec rules: the
    kernel walks 4-row tiles from each shard's first row and masks the
    ragged end, so a shard of any length >= 1 works."""
    k = specs[1]
    n_splits = int(attrs.get("n_splits", 2))
    return _dec_cuda_supports(specs, attrs) and n_splits >= 2 and k.shape[1] % n_splits == 0


def _dec_split_cost(specs, attrs):
    """Adds the combine overhead: per-split (acc, m, l) partials written
    then re-read by the exact merge (repro's model as is)."""
    q = specs[0]
    n_splits = int(attrs.get("n_splits", 2))
    base = _dec_cost(specs, attrs)
    partials = n_splits * (q.nbytes + 8.0 * q.shape[0] * q.shape[1])
    return Cost(flops=base.flops, bytes=base.bytes + 2.0 * partials)


@impl("decode_attention", "cuda_split", supports=_dec_split_supports, cost_fn=_dec_split_cost,
      note="split-KV flash-decode: the partials of n_splits shards in one launch of the "
           "partial kernel, merged in index order by the combine kernel")
def _decode_split_impl(inputs, attrs):
    """At bf16 the partials' acc comes rounded to bf16 (JAX's partial) and
    is upcast for the merge, whose output is rounded once: JAX's
    ``pallas_split``."""
    q, k, v, lengths = inputs
    acc, m, l = flash_decode_partial(q, k, v, _full_lengths(lengths, q, k),
                                     scale=attrs.get("scale"),
                                     n_splits=int(attrs.get("n_splits", 2)))
    return [combine_partials(acc.float(), m, l, dtype=q.dtype)]


def decode_attention(q, k, v, lengths=None, *, scale=None, backend="ref", **kw):
    return get_impl("decode_attention", backend)(
        [q, k, v, lengths], {"scale": scale, **kw})[0]


def decode_attention_partial(q, k, v, lengths=None, *, scale=None, backend="cuda", **kw):
    """(acc, m, l) partials over this KV shard, for cross-shard combination
    (``combine_partials``): acc (B, Hq, Dv) in q's dtype, m and l (B, Hq)
    float32, as JAX's partials.  ``cuda``: the partial kernel over one
    shard (its bf16 entry on bf16 inputs); otherwise its plain version.
    An empty row gives acc 0, m -1e30 and l 0 on both, where JAX's
    dense ``ref`` partial gives l = S and acc = the sum of v: the combined
    result is the same wherever another shard holds a valid row."""
    lengths = _full_lengths(lengths, q, k)
    if backend == "cuda":
        acc, m, l = flash_decode_partial(q, k, v, lengths, scale=scale)
    else:
        scale_ = (1.0 / math.sqrt(q.shape[2])) if scale is None else scale
        acc, m, l = flash_decode_partial_plain(q, k, v, lengths, scale_)
    return acc[0], m[0], l[0]


# --------------------------------------------------------------------------- #
# rmsnorm — attrs: eps; inputs (x, w) or (x, w, residual)
# --------------------------------------------------------------------------- #

def _rms_shape(specs, attrs):
    return [specs[0]]


def _rms_cost(specs, attrs):
    x = specs[0]
    extra = specs[2].nbytes if len(specs) > 2 else 0
    return Cost(flops=3.0 * x.nelems, bytes=2.0 * x.nbytes + specs[1].nbytes + extra)


defop("rmsnorm", _rms_shape, _rms_cost,
      doc="RMSNorm with optional fused residual; inputs (x, w[, residual])")


@impl("rmsnorm", "ref")
def _rms_ref_impl(inputs, attrs):
    x, w = inputs[0], inputs[1]
    res = inputs[2] if len(inputs) > 2 else None
    return [R.rmsnorm_ref(x, w, eps=float(attrs.get("eps", 1e-6)), residual=res)]


@impl("rmsnorm", "cuda", supports=lambda specs, attrs: _f32_or_bf16(specs),
      note="rows in registers over a D-sized thread group: fused residual + fixed-order "
           "reduction + scale")
def _rms_cuda_impl(inputs, attrs):
    x, w = inputs[0], inputs[1]
    res = inputs[2] if len(inputs) > 2 else None
    return [_rmsnorm_kernel(x, w, eps=float(attrs.get("eps", 1e-6)), residual=res)]


def rmsnorm(x, w, *, eps=1e-6, residual=None, backend="ref", **kw):
    inputs = [x, w] if residual is None else [x, w, residual]
    return get_impl("rmsnorm", backend)(inputs, {"eps": eps, **kw})[0]


# --------------------------------------------------------------------------- #
# ssd (Mamba2) — inputs (x, dt, A, B, C, D) -> (y, final_state)
# --------------------------------------------------------------------------- #

def _ssd_shape(specs, attrs):
    x, B = specs[0], specs[3]
    b, s, h, p = x.shape
    n = B.shape[3]
    return [x, TensorSpec((b, h, p, n), "float32")]


def _ssd_cost(specs, attrs):
    x, B = specs[0], specs[3]
    b, s, h, p = x.shape
    n = B.shape[3]
    q = int(attrs.get("chunk", 128))
    # intra: (Q,N)x(N,Q) + (Q,Q)x(Q,P); inter: (Q,N)x(N,P); state: (Q,P)x(Q,N)
    per_chunk = 2.0 * q * q * n + 2.0 * q * q * p + 4.0 * q * n * p
    flops = b * h * (s / q) * per_chunk
    return Cost(flops=flops, bytes=_bytes([sp for sp in specs if sp is not None]) + x.nbytes)


defop("ssd", _ssd_shape, _ssd_cost,
      doc="Mamba2 SSD scan -> (y, final_state); attrs: chunk")


@impl("ssd", "ref", note="exact sequential recurrence (a Python loop over steps)")
def _ssd_ref_impl(inputs, attrs):
    x, dt, A, B, C, D = inputs
    y, st = R.ssd_ref(x, dt, A, B, C, D)
    return [y, st]


def _ssd_pad_chunk(x, dt, B, C, q):
    """Pad seq to a chunk multiple with dt=0 steps — exactly state-preserving
    (decay exp(0·A)=1, contribution dt·x=0); padded outputs are discarded."""
    s = x.shape[1]
    pad = (-s) % q
    if pad == 0:
        return x, dt, B, C, s
    pad4 = (0, 0, 0, 0, 0, pad)                    # F.pad counts from the last axis
    return (F.pad(x, pad4), F.pad(dt, (0, 0, 0, pad)), F.pad(B, pad4), F.pad(C, pad4), s)


def _ssd_padded(scan, inputs, attrs):
    """``scan`` (the kernel or its plain version) over the sequence padded to
    a chunk multiple; the padded rows of y are dropped."""
    x, dt, A, B, C, D = inputs
    q = min(int(attrs.get("chunk", 128)), x.shape[1])
    xp, dtp, Bp, Cp, s = _ssd_pad_chunk(x, dt, B, C, q)
    y, st = scan(xp, dtp, A, Bp.contiguous(), Cp.contiguous(), D, chunk=q)
    return [y[:, :s], st]


@impl("ssd", "chunked", note="chunked SSD in plain PyTorch (matmul form)")
def _ssd_chunked_impl(inputs, attrs):
    return _ssd_padded(ssd_scan_plain, inputs, attrs)


def _ssd_cuda_supports(specs, attrs):
    """x, B and C all float32 or all bfloat16, dt, A and D float32, and a
    chunk and state the kernel takes."""
    x, dt, A, B, C = specs[:5]
    D = specs[5] if len(specs) > 5 else None
    q = min(int(attrs.get("chunk", 128)), x.shape[1])
    return (_f32_or_bf16((x, B, C)) and _all_f32([t for t in (dt, A, D) if t is not None])
            and scan_fits(q, B.shape[3]))


@impl("ssd", "cuda", supports=_ssd_cuda_supports,
      note="SSD scan CUDA kernels: chunk states and per-group scores with every chunk at "
           "once, the start states in chunk order, then every chunk's output at once")
def _ssd_cuda_impl(inputs, attrs):
    return _ssd_padded(_ssd_kernel, inputs, attrs)


def ssd(x, dt, A, B, C, D=None, *, chunk=128, backend="ref", **kw):
    y, st = get_impl("ssd", backend)([x, dt, A, B, C, D], {"chunk": chunk, **kw})
    return y, st


def _sum_last(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis by halving it: an order fixed by its length
    alone, in elementwise adds, so each output's arithmetic is the same
    whatever the other axes hold (a library reduction or batched product
    may pick its strategy by the batch size)."""
    while t.shape[-1] > 1:
        n = t.shape[-1]
        half = t[..., :n // 2] + t[..., n // 2:2 * (n // 2)]
        t = torch.cat([half, t[..., 2 * (n // 2):]], dim=-1) if n % 2 else half
    return t[..., 0]


def ssd_step(x, dt, A, B, C, D, state):
    """Single decode step in plain PyTorch (JAX has no kernel for it: O(1)
    work per token).  x (B,H,P), dt (B,H), B/C (B,G,N), state (B,H,P,N) ->
    (y (B,H,P), new_state).  ``ref.ssd_step_ref``'s arithmetic with the
    (P,N)·(N,) contraction summed by :func:`_sum_last`, so a sequence's
    step gives the same bits at any batch size."""
    hpg = x.shape[1] // B.shape[1]
    Bh = torch.repeat_interleave(B, hpg, dim=1).float()            # (B,H,N)
    Ch = torch.repeat_interleave(C, hpg, dim=1).float()
    a = torch.exp(dt.float() * A.float()[None, :])
    xbar = x.float() * dt.float()[..., None]
    new_state = state.float() * a[..., None, None] + xbar[..., None] * Bh[:, :, None, :]
    y = _sum_last(new_state * Ch[:, :, None, :])
    if D is not None:
        y = y + x.float() * D.float()[None, :, None]
    return y.to(x.dtype), new_state


# --------------------------------------------------------------------------- #
# moe_gemm — (E, C, d) @ (E, d, f): expert GEMMs after dispatch
# --------------------------------------------------------------------------- #

def _moe_gemm_shape(specs, attrs):
    x, w = specs
    return [TensorSpec((x.shape[0], x.shape[1], w.shape[2]), x.dtype)]


def _moe_gemm_cost(specs, attrs):
    x, w = specs
    e, c, d = x.shape
    f = w.shape[2]
    out_b = e * c * f * np.dtype(x.dtype).itemsize
    return Cost(flops=2.0 * e * c * d * f, bytes=_bytes(specs) + out_b)


defop("moe_gemm", _moe_gemm_shape, _moe_gemm_cost,
      doc="batched expert GEMM (E,C,d)@(E,d,f)")


@impl("moe_gemm", "ref")
def _moe_gemm_ref_impl(inputs, attrs):
    return [R.batched_gemm_ref(*inputs)]


@impl("moe_gemm", "cuda", supports=lambda specs, attrs: _f32_or_bf16(specs),
      note="batched FFMA GEMM (fp32, or bf16 with an fp32 accumulator): the dense "
           "kernels per expert (blockIdx.z), row results independent of M")
def _moe_gemm_cuda_impl(inputs, attrs):
    x, w = inputs
    return [_batched_gemm_kernel(x.contiguous(), w.contiguous())]


def moe_gemm(x, w, *, backend="ref", **kw):
    return get_impl("moe_gemm", backend)([x, w], kw)[0]


# --------------------------------------------------------------------------- #
# swiglu — elementwise silu(gate) * up (ref only)
# --------------------------------------------------------------------------- #

defop("swiglu", lambda s, a: [s[0]],
      lambda s, a: Cost(flops=5.0 * s[0].nelems, bytes=_bytes(s) + s[0].nbytes),
      doc="silu(gate) * up")


@impl("swiglu", "ref")
def _swiglu_ref_impl(inputs, attrs):
    return [R.swiglu_ref(*inputs)]


def swiglu(gate, up, *, backend="ref", **kw):
    return get_impl("swiglu", backend)([gate, up], kw)[0]


# --------------------------------------------------------------------------- #
# cuda backends of the graph ops conv2d / conv2d_fused / dense — the paper's
# GEMM convolution on the hand-written GEMM kernel
# --------------------------------------------------------------------------- #

def _conv_cuda_supports(specs, attrs):
    """Ungrouped fp32 convolutions (JAX's pallas guard is groups == 1; the
    kernel is fp32 only)."""
    return int(attrs.get("groups", 1)) == 1 and _all_f32(specs[:2])


@impl("conv2d", "cuda", supports=_conv_cuda_supports,
      note="GEMM convolution: im2col in PyTorch + the fp32 GEMM kernel")
def _conv2d_cuda_impl(inputs, attrs):
    x, w = inputs
    kh, kw, ci, co = w.shape
    stride, dilation, _, pads = _nnops._conv_args(x, w, attrs)
    cols = _nnops._im2col(x, (kh, kw), stride, pads, dilation)
    n, oh, ow, kk = cols.shape
    out = _gemm_kernel(cols.reshape(n * oh * ow, kk).contiguous(),
                       w.reshape(kk, co).contiguous())
    return [out.reshape(n, oh, ow, co)]


impl("conv2d_fused", "cuda",
     supports=lambda specs, attrs: _conv_cuda_supports(specs[:2], attrs),
     note="GEMM conv + bias + act (epilogue in PyTorch)")(_nnops.fused_from(_conv2d_cuda_impl))


@impl("dense", "cuda",
      supports=lambda specs, attrs: _f32_or_bf16(specs[:2]) and len(specs[1].shape) == 2,
      note="FFMA GEMM (fp32, or bf16 with an fp32 accumulator), skinny (M <= 16) or "
           "tiled kernel (row results independent of M)")
def _dense_cuda_impl(inputs, attrs):
    x, w = inputs
    lead = x.shape[:-1]
    # a row slice such as h[:, -1] of a (B, S, d) activation is strided
    out = _gemm_kernel(x.reshape(-1, x.shape[-1]).contiguous(), w)
    return [out.reshape(*lead, w.shape[-1])]
