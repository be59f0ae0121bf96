"""fp32 GEMM, plain and batched — counterpart of
:func:`repro.kernels.gemm.gemm` and :func:`repro.kernels.gemm.batched_gemm`.

:func:`gemm` and :func:`batched_gemm` launch the hand-written CUDA kernel
``csrc/gemm.cu`` on CUDA tensors (fixed 64x64 tile, 16-deep K step, FFMA;
the batched entry takes the expert as ``blockIdx.z``; see the source for
what bounds it and why each row's result is independent of M) and run
:func:`gemm_plain` / :func:`batched_gemm_plain` on CPU tensors.  Each
wrapper's ``launches`` attribute counts its kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _cuda

__all__ = ["gemm", "gemm_plain", "batched_gemm", "batched_gemm_plain"]


def gemm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: (M, K) @ (K, N) in fp32."""
    return torch.matmul(x, w)


def batched_gemm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The batched kernel's function in plain PyTorch: (E, M, K) @ (E, K, N)
    in fp32."""
    return torch.bmm(x, w)


def _check_dtypes(x: torch.Tensor, w: torch.Tensor, name: str) -> None:
    for arg, t in (("x", x), ("w", w)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} must be float32, got {t.dtype}")


def _check_card(x: torch.Tensor, w: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"{name}: x on {x.device}, w on {w.device}; need one CUDA device")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")


def gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) -> (M, N), fp32."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"gemm needs (M, K) @ (K, N), got {tuple(x.shape)} @ {tuple(w.shape)}")
    _check_dtypes(x, w, "gemm")
    if x.device.type == "cpu" and w.device.type == "cpu":
        return gemm_plain(x, w)
    _check_card(x, w, "gemm")
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


MAX_EXPERTS = 65535      # gridDim.z


def batched_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(E, M, K) @ (E, K, N) -> (E, M, N), fp32; row m of expert e is the
    same FMA chain whatever M is."""
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] or x.shape[2] != w.shape[1]:
        raise ValueError(f"batched_gemm needs (E, M, K) @ (E, K, N), got {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    _check_dtypes(x, w, "batched_gemm")
    if x.device.type == "cpu" and w.device.type == "cpu":
        return batched_gemm_plain(x, w)
    _check_card(x, w, "batched_gemm")
    e, m, k = x.shape
    n = w.shape[2]
    if e > MAX_EXPERTS:
        raise ValueError(f"batched_gemm: {e} experts, the kernel takes at most {MAX_EXPERTS}")
    out = torch.empty((e, m, n), dtype=torch.float32, device=x.device)
    if e == 0 or m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    err = _cuda.library().batched_gemm_f32(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                           e, m, n, k, _cuda.stream_of(x))
    _cuda.check(err, "batched_gemm")
    batched_gemm.launches += 1
    return out


batched_gemm.launches = 0
