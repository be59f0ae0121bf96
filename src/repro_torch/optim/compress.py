"""Gradient compression for the data-parallel all-reduce: int8 quantisation
with error feedback (EF-SGD style) — counterpart of
:mod:`repro.optim.compress`.

Each rank adds its carried quantisation residual, quantises to int8
(symmetric per-tensor scale; 4x fewer wire bytes than f32), all-reduces
and keeps the new residual locally, added back next step.  Error feedback
keeps the induced bias bounded.  The divisions are by tensors on the
gradient's device: CUDA divides by a CPU scalar as a product with its
reciprocal, which can round a value to the other int8 level.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.core.tree import tree_leaves, tree_unflatten
from repro_torch.sharding.collectives import all_reduce_axis

__all__ = ["quantize", "dequantize", "compress_decompress", "compressed_psum_mean"]


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(float(x), dtype=torch.float32, device=like.device)


def quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 -> (int8 payload, f32 scale). Symmetric per-tensor."""
    amax = torch.max(torch.abs(g))
    scale = torch.clamp(amax, min=1e-12) / _f32(127.0, g)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_decompress(g: torch.Tensor, err: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One error-feedback round on one rank: (decompressed, new_error)."""
    g32 = g.to(torch.float32) + err
    q, s = quantize(g32)
    deq = dequantize(q, s)
    return deq, g32 - deq


def compressed_psum_mean(mesh: Any, axis: str = "data"):
    """Returns ``f(local_grads, err_state) -> (mean_grads, new_errs)``.

    Each rank's dequantised tensors are summed over ``axis`` of ``mesh``
    (a :class:`~repro_torch.launch.mesh.ProcessMesh`), in the axis's group,
    and divided by its size.  The psum of per-rank dequantisations equals
    the sum of the quantised rank gradients exactly.  With one rank on the
    axis no collective runs."""
    n = mesh.shape[axis]

    def one(g, err):
        deq, new_err = compress_decompress(g, err)
        if n > 1:
            deq = all_reduce_axis(deq, mesh, axis)
        return deq / _f32(n, deq), new_err

    def wrapped(grads, errs):
        out = [one(g, e) for g, e in zip(tree_leaves(grads), tree_leaves(errs))]
        return (tree_unflatten(grads, [o[0] for o in out]),
                tree_unflatten(grads, [o[1] for o in out]))

    return wrapped
