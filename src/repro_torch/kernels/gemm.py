"""fp32 GEMM — counterpart of :func:`repro.kernels.gemm.gemm`.

:func:`gemm` launches the hand-written CUDA kernel ``csrc/gemm.cu`` on CUDA
tensors (fixed 64x64 tile, 16-deep K step, FFMA; see the source for what
bounds it and why each row's result is independent of M) and runs
:func:`gemm_plain` on CPU tensors.  ``gemm.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _cuda

__all__ = ["gemm", "gemm_plain"]


def gemm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: (M, K) @ (K, N) in fp32."""
    return torch.matmul(x, w)


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"gemm needs (M, K) @ (K, N), got {tuple(x.shape)} @ {tuple(w.shape)}")
    for name, t in (("x", x), ("w", w)):
        if t.dtype != torch.float32:
            raise TypeError(f"gemm: {name} must be float32, got {t.dtype}")


def gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) -> (M, N), fp32."""
    _check(x, w)
    if x.device.type == "cpu" and w.device.type == "cpu":
        return gemm_plain(x, w)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"gemm: x on {x.device}, w on {w.device}; need one CUDA device")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("gemm: inputs must be contiguous")
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    err = _cuda.library().gemm_f32(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                   m, n, k, _cuda.stream_of(x))
    _cuda.check(err, "gemm")
    gemm.launches += 1
    return out


gemm.launches = 0
