"""Kernel ops + registry integration — counterpart of
:mod:`repro.kernels.ops`, for the ops of the dense serving path and the
layer-stack models' attention.

Declares ``attention``, ``decode_attention``, ``rmsnorm`` and ``swiglu``
(shape and cost functions match ``repro``'s), registers their ``ref``
backends (the plain PyTorch oracles of :mod:`repro_torch.kernels.ref`) and
the ``cuda`` backends of ``attention``, ``decode_attention``, ``rmsnorm``
and ``dense`` (the hand-written Hopper kernels, in the slot ``pallas``
fills in ``repro``).  A ``cuda`` backend runs its kernel's plain version on
CPU tensors.  The dispatchers ``attention``, ``decode_attention``,
``rmsnorm`` and ``swiglu`` are what :mod:`repro_torch.layers` calls.

The ``cuda`` guards are only what the kernels need (whole GQA groups,
head widths <= 256, fp32); the TPU's block-divisibility guards are not
carried over, because each kernel masks its own ragged edges.
"""

from __future__ import annotations

from typing import Sequence

from repro_torch.core import nnops as _nnops  # noqa: F401  (declares dense)
from repro_torch.core.ir import TensorSpec
from repro_torch.core.registry import Cost, defop, get_impl, impl
from repro_torch.kernels import ref as R
from repro_torch.kernels.flash_attention import attention_fits, flash_attention
from repro_torch.kernels.flash_decode import decode_fits, flash_decode
from repro_torch.kernels.gemm import gemm as _gemm_kernel
from repro_torch.kernels.rmsnorm import rmsnorm as _rmsnorm_kernel

__all__ = ["attention", "decode_attention", "rmsnorm", "swiglu"]


def _bytes(specs: Sequence[TensorSpec]) -> float:
    return float(sum(s.nbytes for s in specs))


def _all_f32(specs: Sequence[TensorSpec]) -> bool:
    return all(s.dtype == "float32" for s in specs)


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
    return (_all_f32((q, k, v))
            and attention_fits(q.shape[2], k.shape[2], q.shape[3], v.shape[3]))


@impl("attention", "cuda", supports=_attn_cuda_supports,
      note="flash attention CUDA kernel; 32-row query tiles over fixed 64-row "
           "K/V tiles, tiles outside the causal/window mask skipped")
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
    return (_all_f32((q, k, v))
            and decode_fits(q.shape[1], k.shape[2], q.shape[2], v.shape[3]))


@impl("decode_attention", "cuda", supports=_dec_cuda_supports,
      note="flash-decode CUDA kernel; one block per (b, kv head), the GQA "
           "group shares one K/V read")
def _decode_cuda_impl(inputs, attrs):
    q, k, v, lengths = inputs
    return [flash_decode(q, k, v, lengths, scale=attrs.get("scale"))]


def decode_attention(q, k, v, lengths=None, *, scale=None, backend="ref", **kw):
    return get_impl("decode_attention", backend)(
        [q, k, v, lengths], {"scale": scale, **kw})[0]


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


@impl("rmsnorm", "cuda", supports=lambda specs, attrs: _all_f32(specs),
      note="one block per row: fused residual + fixed-order reduction + scale")
def _rms_cuda_impl(inputs, attrs):
    x, w = inputs[0], inputs[1]
    res = inputs[2] if len(inputs) > 2 else None
    return [_rmsnorm_kernel(x, w, eps=float(attrs.get("eps", 1e-6)), residual=res)]


def rmsnorm(x, w, *, eps=1e-6, residual=None, backend="ref", **kw):
    inputs = [x, w] if residual is None else [x, w, residual]
    return get_impl("rmsnorm", backend)(inputs, {"eps": eps, **kw})[0]


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
# cuda backend of the graph op dense
# --------------------------------------------------------------------------- #

@impl("dense", "cuda",
      supports=lambda specs, attrs: _all_f32(specs[:2]) and len(specs[1].shape) == 2,
      note="fp32 FFMA GEMM, fixed 64x64 tile (row results independent of M)")
def _dense_cuda_impl(inputs, attrs):
    x, w = inputs
    lead = x.shape[:-1]
    # a row slice such as h[:, -1] of a (B, S, d) activation is strided
    out = _gemm_kernel(x.reshape(-1, x.shape[-1]).contiguous(), w)
    return [out.reshape(*lead, w.shape[-1])]
