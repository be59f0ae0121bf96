"""Mamba2 SSD chunked scan — counterpart of :func:`repro.kernels.ssd.ssd_scan`.

:func:`ssd_scan` precomputes ``xbar = x * dt`` and ``la = dt * A`` (as the
JAX wrapper does) and launches the hand-written CUDA kernel ``csrc/ssd.cu``
on CUDA tensors: one block per (16 state columns, head, sequence), the
chunks in order inside the block with the state slice in shared memory;
see the source for what bounds it.  On CPU tensors it runs
:func:`ssd_scan_plain`, the same chunked algorithm in plain PyTorch
(:func:`repro_torch.kernels.ref.ssd_chunked_ref`).  ``ssd_scan.launches``
counts kernel launches.

Shapes as in ``ref.ssd_ref``: x (B,S,H,P), dt (B,S,H), A (H,), B/C
(B,S,G,N) with H % G == 0 -> y (B,S,H,P), final state (B,H,P,N) fp32.
The sequence must be a multiple of the chunk ``min(chunk, S)``; the ``ssd``
op pads it with dt = 0 steps.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.ref import ssd_chunked_ref, with_d

__all__ = ["ssd_scan", "ssd_scan_plain", "scan_fits"]

MAX_CHUNK = 128       # csrc/ssd.cu MAX_Q
_PT, _RT = 16, 32     # state columns per block, score rows per tile


def scan_fits(chunk: int, n: int) -> bool:
    """Whether the kernel takes this chunk length and state size: chunk <=
    128, and its shared memory (the layout of csrc/ssd.cu) within the
    H100's 227 KB per block."""
    if not (0 < chunk <= MAX_CHUNK and n > 0):
        return False
    floats = (chunk * (n + 1) + chunk * n + chunk * _PT + _PT * (n + 1) + 2 * MAX_CHUNK
              + _RT * MAX_CHUNK)
    return 4 * floats <= _cuda.MAX_SMEM_BYTES


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, D: Optional[torch.Tensor] = None, *,
                   chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: the chunked SSD algorithm."""
    q = min(chunk, x.shape[1])
    return ssd_chunked_ref(x, dt, A, B, C, D, chunk=q)


def _check(x, dt, A, B, C) -> None:
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 4 or C.shape != B.shape:
        raise ValueError(f"ssd_scan needs x (B,S,H,P), dt (B,S,H), A (H,), B/C (B,S,G,N); got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(B.shape)}, {tuple(C.shape)}")
    b, s, h, _ = x.shape
    if tuple(dt.shape) != (b, s, h) or A.shape[0] != h or B.shape[:2] != x.shape[:2]:
        raise ValueError("ssd_scan: x, dt, A, B and C disagree on B, S or H")
    if B.shape[2] < 1 or h % B.shape[2]:
        raise ValueError(f"ssd_scan: {h} heads are not a multiple of {B.shape[2]} groups")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, D: Optional[torch.Tensor] = None, *,
             chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan -> (y (B,S,H,P), final state (B,H,P,N) fp32)."""
    _check(x, dt, A, B, C)
    tensors = (x, dt, A, B, C) + (() if D is None else (D,))
    if all(t.device.type == "cpu" for t in tensors):
        return ssd_scan_plain(x, dt, A, B, C, D, chunk=chunk)
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"ssd_scan: inputs on {sorted({str(t.device) for t in tensors})}; "
                         "need one CUDA device")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C)):
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_scan: {name} must be float32, got {t.dtype}")
    if not (B.is_contiguous() and C.is_contiguous()):
        raise ValueError("ssd_scan: B and C must be contiguous")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"ssd_scan: sequence {s} is not a multiple of the chunk {q}")
    if not scan_fits(q, n):
        raise ValueError(f"ssd_scan: chunk {q} with state {n} is unsupported (chunk <= "
                         f"{MAX_CHUNK}, shared memory <= {_cuda.MAX_SMEM_BYTES} B)")
    la = (dt * A[None, None, :]).contiguous()
    xbar = (x * dt[..., None]).contiguous()
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=dev)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    if y.numel() == 0 or state.numel() == 0:
        return with_d(y, x, D), state.zero_()
    err = _cuda.library().ssd_scan_f32(xbar.data_ptr(), la.data_ptr(), B.data_ptr(),
                                       C.data_ptr(), y.data_ptr(), state.data_ptr(),
                                       b, s, h, p, g, n, q, _cuda.stream_of(x))
    _cuda.check(err, "ssd_scan")
    ssd_scan.launches += 1
    return with_d(y, x, D), state


ssd_scan.launches = 0
