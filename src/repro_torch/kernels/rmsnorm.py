"""Fused RMSNorm (+ optional residual add) — counterpart of
:func:`repro.kernels.rmsnorm.rmsnorm`.

:func:`rmsnorm` launches the hand-written CUDA kernel ``csrc/rmsnorm.cu``
(one block per row, fixed-order reduction) on CUDA tensors and runs
:func:`rmsnorm_plain` on CPU tensors.  ``rmsnorm.launches`` counts kernel
launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _cuda

__all__ = ["rmsnorm", "rmsnorm_plain"]


def rmsnorm_plain(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
                  residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: normalise ``x`` (or
    ``x + residual``) over the last dim in fp32, then scale by ``w``."""
    xf = x if residual is None else x + residual
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return xf * torch.rsqrt(var + eps) * w


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
            residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (..., D), w (D,) -> (..., D); optionally normalises x + residual."""
    tensors = [("x", x), ("w", w)] + ([] if residual is None else [("residual", residual)])
    for name, t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"rmsnorm: {name} must be float32, got {t.dtype}")
    d = x.shape[-1]
    if w.shape != (d,) or (residual is not None and residual.shape != x.shape):
        raise ValueError(f"rmsnorm: x {tuple(x.shape)}, w {tuple(w.shape)}, residual "
                         f"{None if residual is None else tuple(residual.shape)}")
    if all(t.device.type == "cpu" for _, t in tensors):
        return rmsnorm_plain(x, w, eps=eps, residual=residual)
    if x.device.type != "cuda" or any(t.device != x.device for _, t in tensors):
        raise ValueError("rmsnorm: all inputs must be on one CUDA device")
    if not all(t.is_contiguous() for _, t in tensors):
        raise ValueError("rmsnorm: inputs must be contiguous")
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out
    err = _cuda.library().rmsnorm_f32(
        x.data_ptr(), None if residual is None else residual.data_ptr(),
        w.data_ptr(), out.data_ptr(), rows, d, float(eps), _cuda.stream_of(x))
    _cuda.check(err, "rmsnorm")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
