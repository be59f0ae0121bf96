"""Kernel ops + registry integration — counterpart of
:mod:`repro.kernels.ops`, for the ops of the dense serving path.

Declares ``decode_attention``, ``rmsnorm`` and ``swiglu`` (shape and cost
functions match ``repro``'s), registers their ``ref`` backends (the plain
PyTorch oracles of :mod:`repro_torch.kernels.ref`) and the ``cuda``
backends of ``decode_attention``, ``rmsnorm`` and ``dense`` (the
hand-written Hopper kernels, in the slot ``pallas`` fills in ``repro``).
A ``cuda`` backend runs its kernel's plain version on CPU tensors.

The ``cuda`` guards are only what the kernels need (whole GQA groups,
head widths <= 256, fp32); the TPU's block-divisibility guards are not
carried over, because each kernel masks its own ragged edges.
"""

from __future__ import annotations

from typing import Sequence

from repro_torch.core import nnops as _nnops  # noqa: F401  (declares dense)
from repro_torch.core.ir import TensorSpec
from repro_torch.core.registry import Cost, defop, impl
from repro_torch.kernels import ref as R
from repro_torch.kernels.flash_decode import decode_fits, flash_decode
from repro_torch.kernels.gemm import gemm as _gemm_kernel
from repro_torch.kernels.rmsnorm import rmsnorm as _rmsnorm_kernel



def _bytes(specs: Sequence[TensorSpec]) -> float:
    return float(sum(s.nbytes for s in specs))


def _all_f32(specs: Sequence[TensorSpec]) -> bool:
    return all(s.dtype == "float32" for s in specs)


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


# --------------------------------------------------------------------------- #
# swiglu — elementwise silu(gate) * up (ref only)
# --------------------------------------------------------------------------- #

defop("swiglu", lambda s, a: [s[0]],
      lambda s, a: Cost(flops=5.0 * s[0].nelems, bytes=_bytes(s) + s[0].nbytes),
      doc="silu(gate) * up")


@impl("swiglu", "ref")
def _swiglu_ref_impl(inputs, attrs):
    return [R.swiglu_ref(*inputs)]


# --------------------------------------------------------------------------- #
# cuda backend of the graph op dense
# --------------------------------------------------------------------------- #

@impl("dense", "cuda",
      supports=lambda specs, attrs: _all_f32(specs[:2]) and len(specs[1].shape) == 2,
      note="fp32 FFMA GEMM, fixed 64x64 tile (row results independent of M)")
def _dense_cuda_impl(inputs, attrs):
    x, w = inputs
    lead = x.shape[:-1]
    out = _gemm_kernel(x.reshape(-1, x.shape[-1]), w)
    return [out.reshape(*lead, w.shape[-1])]
