"""Mamba2 SSD chunked scan — counterpart of :func:`repro.kernels.ssd.ssd_scan`.

:func:`ssd_scan` launches the hand-written CUDA kernels of ``csrc/ssd.cu`` on
CUDA tensors, one C entry for the three phases of the state-passing
decomposition: every chunk's cumsum, own state contribution and C.B scores
(once per group) at once; the chunks' start states in order; every chunk's
output at once.  The kernels read x, dt, A and D themselves (the JAX wrapper
forms x * dt, dt * A and the D term outside its kernel).  The scratch comes
from one ``torch.empty`` per call, sized by :func:`scan_scratch`.  On CPU
tensors it runs :func:`ssd_scan_plain`, the chunked algorithm in plain
PyTorch (:func:`repro_torch.kernels.ref.ssd_chunked_ref`).
``ssd_scan.launches`` counts calls that launched the kernels.

x, B and C may be bfloat16 (all three alike; dt, A and D stay float32, as
the mamba layer passes them): ``ssd_scan_bf16`` upcasts each value as it
stages it, runs the fp32 kernels' arithmetic, and rounds y (with its D
term, formed in fp32) once to bf16; the final state is fp32.  So the bf16
y is the fp32 entry's y on the upcast inputs rounded once.  Those calls
count in ``ssd_scan.bf16.launches``.  (JAX's Pallas kernel writes a bf16 y
and its wrapper adds D x and rounds a second time.)

Shapes as in ``ref.ssd_ref``: x (B,S,H,P), dt (B,S,H), A (H,), B/C
(B,S,G,N) with H % G == 0 -> y (B,S,H,P) in x's dtype, final state
(B,H,P,N) fp32.
The sequence must be a multiple of the chunk ``min(chunk, S)``; the ``ssd``
op pads it with dt = 0 steps.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.ref import ssd_chunked_ref

__all__ = ["ssd_scan", "ssd_scan_plain", "scan_fits", "scan_scratch"]

# The layout of csrc/ssd.cu:
TILE = 64             # every product's output tile is TILE x TILE
MAX_CHUNK = 128       # chunk length the per-chunk vectors hold (MAX_Q)


def _up(n: int) -> int:
    return -(-n // TILE) * TILE


def scan_scratch(s: int, h: int, p: int, g: int, n: int, chunk: int) -> Tuple[int, int, int]:
    """Floats of the kernel's scratch for ONE sequence of ``s`` steps:
    the chunks' states (S/q, H, N, PP), the C.B scores (S/q, G, QR, QR) and
    the cumsum of dt * A (H, S), with q = min(chunk, s) and PP, QR the head
    width and q rounded up to TILE.  A batch of B takes B times each."""
    q = min(chunk, s)
    nc = s // q
    return nc * h * n * _up(p), nc * g * _up(q) ** 2, h * s


def scan_fits(chunk: int, n: int) -> bool:
    """Whether the kernel takes this chunk length and state size: 0 < chunk
    <= 128 (the per-chunk vectors) and n > 0.  Every other width is tiled,
    and the kernels' shared memory is static, whatever the shapes."""
    return 0 < chunk <= MAX_CHUNK and n > 0


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, D: Optional[torch.Tensor] = None, *,
                   chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: the chunked SSD algorithm."""
    q = min(chunk, x.shape[1])
    return ssd_chunked_ref(x, dt, A, B, C, D, chunk=q)


def _check_dtypes(x, dt, A, B, C, D) -> None:
    """x, B and C all float32 or all bfloat16; dt, A and D float32."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ssd_scan: x must be float32 or bfloat16, got {x.dtype}")
    for name, t in (("B", B), ("C", C)):
        if t.dtype != x.dtype:
            raise TypeError(f"ssd_scan: {name} must be {x.dtype} as x is, got {t.dtype}")
    for name, t in (("dt", dt), ("A", A), ("D", D)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"ssd_scan: {name} must be float32, got {t.dtype}")


def _check(x, dt, A, B, C, D) -> None:
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 4 or C.shape != B.shape:
        raise ValueError(f"ssd_scan needs x (B,S,H,P), dt (B,S,H), A (H,), B/C (B,S,G,N); got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(B.shape)}, {tuple(C.shape)}")
    b, s, h, _ = x.shape
    if tuple(dt.shape) != (b, s, h) or A.shape[0] != h or B.shape[:2] != x.shape[:2] or \
            (D is not None and tuple(D.shape) != (h,)):
        raise ValueError("ssd_scan: x, dt, A, B, C and D disagree on B, S or H")
    if B.shape[2] < 1 or h % B.shape[2]:
        raise ValueError(f"ssd_scan: {h} heads are not a multiple of {B.shape[2]} groups")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, D: Optional[torch.Tensor] = None, *,
             chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan -> (y (B,S,H,P) in x's dtype with the D term,
    final state (B,H,P,N) fp32); x, B and C float32 or bfloat16, dt, A and
    D float32."""
    _check(x, dt, A, B, C, D)
    _check_dtypes(x, dt, A, B, C, D)
    tensors = (x, dt, A, B, C) + (() if D is None else (D,))
    if all(t.device.type == "cpu" for t in tensors):
        return ssd_scan_plain(x, dt, A, B, C, D, chunk=chunk)
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"ssd_scan: inputs on {sorted({str(t.device) for t in tensors})}; "
                         "need one CUDA device")
    if not (B.is_contiguous() and C.is_contiguous()):
        raise ValueError("ssd_scan: B and C must be contiguous")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"ssd_scan: sequence {s} is not a multiple of the chunk {q}")
    if not scan_fits(q, n):
        raise ValueError(f"ssd_scan: chunk {q} with state {n} is unsupported (0 < chunk <= "
                         f"{MAX_CHUNK})")
    x, dt, A = x.contiguous(), dt.contiguous(), A.contiguous()
    D = None if D is None else D.contiguous()
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=dev)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    if y.numel() == 0 or state.numel() == 0:
        return y, state.zero_()
    n_st, n_sc, n_cs = (b * f for f in scan_scratch(s, h, p, g, n, q))
    work = torch.empty(n_st + n_sc + n_cs, dtype=torch.float32, device=dev)
    w0 = work.data_ptr()
    bf16 = x.dtype == torch.bfloat16
    lib = _cuda.library()
    err = (lib.ssd_scan_bf16 if bf16 else lib.ssd_scan_f32)(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), None if D is None else D.data_ptr(),
        B.data_ptr(), C.data_ptr(), y.data_ptr(), state.data_ptr(),
        w0, w0 + 4 * n_st, w0 + 4 * (n_st + n_sc), b, s, h, p, g, n, q, _cuda.stream_of(x))
    _cuda.check(err, "ssd_scan")
    if bf16:
        ssd_scan.bf16.launches += 1
    else:
        ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0
ssd_scan.bf16 = _cuda.LaunchCount("ssd_scan_bf16")
