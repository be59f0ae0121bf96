"""Fused RMSNorm (+ optional residual add) — counterpart of
:func:`repro.kernels.rmsnorm.rmsnorm`.

:func:`rmsnorm` launches the hand-written CUDA kernel ``csrc/rmsnorm.cu`` on
CUDA tensors and runs :func:`rmsnorm_plain` on CPU tensors.  Each of its
two bodies holds a row in registers (read from device memory once), spread
over threads by a layout that is a function of the row width alone, and
reduces in a fixed order, so a row's result does not depend on the row
count.  The fp32 body (``rmsnorm_f32``) takes :func:`row_layout`: float4
groups of 4 values.  The bf16 body (``rmsnorm_bf16``) has a layout of its
own, :func:`row_layout_bf16`: 16-byte pieces of 8 bf16 values, kept packed
in registers, and w read once a block into shared memory; the residual is
added and every sum taken in fp32 and y rounded once, as the Pallas kernel
does.  Its summation order is not the fp32 body's, so its rows are held
within one bf16 ulp of :func:`rmsnorm_plain` and bitwise across row counts,
not to the fp32 body's result rounded.  ``rmsnorm.launches`` counts the
fp32 kernel's launches, ``rmsnorm.bf16.launches`` the bf16 one's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _cuda

__all__ = ["rmsnorm", "rmsnorm_plain", "row_layout", "row_layout_bf16"]

# The layout of csrc/rmsnorm.cu's fp32 body:
THREADS = 256      # threads per block
MAX_VPT = 8        # float4 groups a thread holds in registers
# ... and of its bf16 body (BF16_THREADS, PIECE, MAX_PPT):
BF16_THREADS = 256   # threads per block
PIECE = 8            # bf16 values a piece (one 16-byte load)
MAX_PPT = 4          # pieces a thread holds in registers

_DTYPES = (torch.float32, torch.bfloat16)


def row_layout(d: int) -> Tuple[int, int]:
    """(threads per row, float4 groups per thread) of the kernel for rows of
    ``d`` floats: the fewest threads, a power of 2 from 32 to 256, that hold
    the row's ceil(d / 4) groups at most MAX_VPT a thread.  Past d = 8192 a
    thread takes more groups and the kernel reads the row twice."""
    g4 = -(-d // 4)
    t = 32
    while t < THREADS and t * MAX_VPT < g4:
        t *= 2
    return t, -(-g4 // t)


def row_layout_bf16(d: int) -> Tuple[int, int]:
    """(threads per row, 16-byte pieces per thread) of the bf16 body for rows
    of ``d`` values: the fewest threads, a power of 2 from 32 to
    BF16_THREADS, that hold the row's ceil(d / 8) pieces at most MAX_PPT a
    thread (piece k * threads + t to thread t).  A block takes
    BF16_THREADS / threads rows.  Past d = 8192 a thread takes more pieces
    and the kernel reads the row twice."""
    n_pieces = -(-d // PIECE)
    t = 32
    while t < BF16_THREADS and t * MAX_PPT < n_pieces:
        t *= 2
    return t, -(-n_pieces // t)


def rmsnorm_plain(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
                  residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: normalise ``x`` (or
    ``x + residual``) over the last dim in fp32, then scale by ``w``; the
    inputs upcast, the result rounded to x's dtype."""
    xf = x.float() if residual is None else x.float() + residual.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
            residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (..., D), w (D,) -> (..., D); optionally normalises x + residual.
    x, w and the residual all float32 or all bfloat16."""
    res = residual
    if x.dtype not in _DTYPES or w.dtype != x.dtype or (res is not None and res.dtype != x.dtype):
        got = ", ".join(f"{n} {t.dtype}" for n, t in (("x", x), ("w", w), ("residual", res))
                        if t is not None)
        raise TypeError(f"rmsnorm: inputs must be all float32 or all bfloat16, got {got}")
    d = x.shape[-1]
    if w.shape != (d,) or (res is not None and res.shape != x.shape):
        raise ValueError(f"rmsnorm: x {tuple(x.shape)}, w {tuple(w.shape)}, residual "
                         f"{None if res is None else tuple(res.shape)}")
    if not x.is_cuda and all(t.device.type == "cpu" for t in (x, w, res) if t is not None):
        return rmsnorm_plain(x, w, eps=eps, residual=res)
    dev = x.get_device()   # -1 off the card; no device objects on the launch path
    if not x.is_cuda or w.get_device() != dev or (res is not None and res.get_device() != dev):
        raise ValueError("rmsnorm: all inputs must be on one CUDA device")
    if not (x.is_contiguous() and w.is_contiguous() and (res is None or res.is_contiguous())):
        raise ValueError("rmsnorm: inputs must be contiguous")
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out
    bf16 = x.dtype == torch.bfloat16
    lib = _cuda.library()
    err = (lib.rmsnorm_bf16 if bf16 else lib.rmsnorm_f32)(
        x.data_ptr(), None if res is None else res.data_ptr(), w.data_ptr(), out.data_ptr(),
        rows, d, eps, _cuda.stream_of(x))
    _cuda.check(err, "rmsnorm")
    if bf16:
        rmsnorm.bf16.launches += 1
    else:
        rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
rmsnorm.bf16 = _cuda.LaunchCount("rmsnorm_bf16")
