"""Standard graph operators of the port — counterpart of
:mod:`repro.core.nnops`, with the ops the dense serving graphs use so far:
``dense``, ``add`` and ``reshape``, each with its ``ref`` backend (plain
PyTorch).  Shape and cost functions match ``repro``'s.  The ``cuda``
backend of ``dense`` is registered by :mod:`repro_torch.kernels.ops`.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch

from repro_torch.core.ir import TensorSpec
from repro_torch.core.registry import Cost, defop, impl

Attrs = Dict[str, Any]


def _bytes_of(specs: Sequence[TensorSpec]) -> float:
    return float(sum(s.nbytes for s in specs))


def _ew_cost(specs, attrs):
    out = specs[0]
    return Cost(flops=float(out.nelems), bytes=_bytes_of(specs) + out.nbytes)


# --------------------------------------------------------------------------- #
# dense
# --------------------------------------------------------------------------- #

def _dense_shape(specs, attrs):
    x, w = specs[0], specs[1]
    if x.shape[-1] != w.shape[0]:
        raise ValueError(f"dense mismatch {x.shape} x {w.shape}")
    return [TensorSpec(x.shape[:-1] + (w.shape[1],), x.dtype)]


def _dense_cost(specs, attrs):
    x, w = specs[0], specs[1]
    batch = x.nelems // x.shape[-1]
    flops = 2.0 * batch * w.shape[0] * w.shape[1]
    out_b = batch * w.shape[1] * np.dtype(x.dtype).itemsize
    return Cost(flops=flops, bytes=_bytes_of(specs) + out_b)


defop("dense", _dense_shape, _dense_cost, doc="x @ w")


@impl("dense", "ref")
def _dense_ref(inputs, attrs):
    x, w = inputs
    return [torch.matmul(x, w)]


# --------------------------------------------------------------------------- #
# add
# --------------------------------------------------------------------------- #

def _binop_shape(specs, attrs):
    a, b = specs
    shape = np.broadcast_shapes(a.shape, b.shape)
    return [TensorSpec(tuple(int(d) for d in shape), a.dtype)]


defop("add", _binop_shape, _ew_cost)


@impl("add", "ref")
def _add_ref(inputs, attrs):
    return [inputs[0] + inputs[1]]


# --------------------------------------------------------------------------- #
# reshape
# --------------------------------------------------------------------------- #

def _reshape_shape(specs, attrs):
    x = specs[0]
    shape = tuple(int(d) for d in attrs["shape"])
    if -1 in shape:
        known = -int(np.prod(shape))
        shape = tuple(d if d != -1 else x.nelems // known for d in shape)
    if int(np.prod(shape)) != x.nelems:
        raise ValueError(f"reshape {x.shape} -> {shape} size mismatch")
    return [TensorSpec(shape, x.dtype)]


defop("reshape", _reshape_shape, lambda s, a: Cost(0.0, 0.0))


@impl("reshape", "ref")
def _reshape_ref(inputs, attrs):
    return [inputs[0].reshape(tuple(int(d) for d in attrs["shape"]))]
