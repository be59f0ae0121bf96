"""GEMM, plain and batched, fp32 or bf16 — counterpart of
:func:`repro.kernels.gemm.gemm` and :func:`repro.kernels.gemm.batched_gemm`.

:func:`gemm` launches one of two hand-written CUDA kernels of
``csrc/gemm.cu`` on CUDA tensors, chosen by :func:`gemm_variant` from M:
``skinny`` for M <= SKINNY_MAX_M (a 32- or 16-column strip per block,
each column's M row accumulators in registers, the weights streamed
through a ring of asynchronous copies) and ``tiled`` above it (output
tiles of 128x128 or 32x64 by :func:`gemm_tile`, an 8x8 or 4x4 micro-tile
per thread).  Both compute each output element as one FMA chain
over k = 0..K-1, so a row's bits depend neither on M nor on which kernel
or tile ran it.
:func:`batched_gemm` runs the same two kernels per expert, the expert as
``blockIdx.z`` (the same variant by M and tile by :func:`gemm_tile`), so a
row of expert e has the bits of :func:`gemm`'s row of ``x[e] @ w[e]``
whatever M is.  On CPU tensors they run
:func:`gemm_plain` / :func:`batched_gemm_plain`.  Each wrapper's
``launches`` attribute counts its kernel launches.

:func:`gemm` also takes bf16 operands (both bf16), as the Pallas kernel
does: the same two kernels on bf16 (``gemm_bf16_skinny`` /
``gemm_bf16_tiled``) upcast each value as it reads it, accumulate in fp32
and round each output once to bf16, so the result is the fp32 product of
the upcast operands rounded once, with the same batch invariance.  Those
launches count in ``gemm.bf16.launches``.  :func:`batched_gemm` takes bf16
the same way (``batched_gemm_bf16``: the bf16 kernels per expert), its
launches counted in ``batched_gemm.bf16.launches``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _cuda

__all__ = ["gemm", "gemm_plain", "gemm_variant", "gemm_tile", "batched_gemm",
           "batched_gemm_plain", "SKINNY_MAX_M", "TILES", "MIN_BIG_TILE_BLOCKS"]

SKINNY_MAX_M = 16        # the largest M of the skinny kernel (gemm_f32_skinny)


def gemm_variant(m: int) -> str:
    """The kernel :func:`gemm` launches for an (M, K) @ (K, N) product:
    ``"skinny"`` for M <= SKINNY_MAX_M, else ``"tiled"``.  Only the speed
    depends on it: both give every element the same FMA chain."""
    return "skinny" if m <= SKINNY_MAX_M else "tiled"


# the tiled kernel's instances (BM, BN): 8x8 micro-tiles on 256 threads, 4x4
# on 128
TILES = ((128, 128), (32, 64))
MIN_BIG_TILE_BLOCKS = 128    # about one 128x128 block for each of the 132 SMs


def gemm_tile(m: int, n: int, count: int = 1) -> tuple:
    """The tiled kernel's output tile (BM, BN) for ``count`` (M, N) results
    in one launch (:func:`batched_gemm`'s experts): 128x128 when M fills
    its rows and the launch still gets MIN_BIG_TILE_BLOCKS blocks (the most
    reuse of each staged byte), else 32x64 (a smaller product spread over
    more SMs: the tile is never split along K).  Only the speed depends on
    the tile."""
    big = TILES[0]
    if m >= big[0] and count * -(-m // big[0]) * -(-n // big[1]) >= MIN_BIG_TILE_BLOCKS:
        return big
    return TILES[1]


def gemm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: (M, K) @ (K, N) in fp32 on
    the upcast operands, rounded to x's dtype (nothing to round for fp32)."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def batched_gemm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The batched kernel's function in plain PyTorch: (E, M, K) @ (E, K, N)
    in fp32 on the upcast operands, rounded to x's dtype."""
    return torch.bmm(x.float(), w.float()).to(x.dtype)


def _check_dtypes(x: torch.Tensor, w: torch.Tensor, name: str,
                  dtypes=(torch.float32,)) -> None:
    """x and w of one of ``dtypes``, the same one."""
    for arg, t in (("x", x), ("w", w)):
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: {arg} must be "
                            f"{' or '.join(str(d).split('.')[1] for d in dtypes)}, got {t.dtype}")
    if w.dtype != x.dtype:
        raise TypeError(f"{name}: x is {x.dtype}, w {w.dtype}; need one dtype")


def _check_card(x: torch.Tensor, w: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"{name}: x on {x.device}, w on {w.device}; need one CUDA device")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")


def gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) -> (M, N) in x's dtype, fp32 or bf16 (w the same)."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"gemm needs (M, K) @ (K, N), got {tuple(x.shape)} @ {tuple(w.shape)}")
    _check_dtypes(x, w, "gemm", (torch.float32, torch.bfloat16))
    if x.device.type == "cpu" and w.device.type == "cpu":
        return gemm_plain(x, w)
    _check_card(x, w, "gemm")
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    bf16 = x.dtype == torch.bfloat16
    lib = _cuda.library()
    args = (x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k)
    if gemm_variant(m) == "skinny":
        fn = lib.gemm_bf16_skinny if bf16 else lib.gemm_f32_skinny
        err = fn(*args, _cuda.stream_of(x))
    else:
        fn = lib.gemm_bf16_tiled if bf16 else lib.gemm_f32_tiled
        err = fn(*args, *gemm_tile(m, n), _cuda.stream_of(x))
    _cuda.check(err, "gemm")
    if bf16:
        gemm.bf16.launches += 1
    else:
        gemm.launches += 1
    return out


gemm.launches = 0
gemm.bf16 = _cuda.LaunchCount("gemm_bf16")


MAX_EXPERTS = 65535      # gridDim.z


def batched_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(E, M, K) @ (E, K, N) -> (E, M, N) in x's dtype, fp32 or bf16 (w the
    same); row m of expert e is the same FMA chain whatever M is, the one
    :func:`gemm` gives it."""
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] or x.shape[2] != w.shape[1]:
        raise ValueError(f"batched_gemm needs (E, M, K) @ (E, K, N), got {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    _check_dtypes(x, w, "batched_gemm", (torch.float32, torch.bfloat16))
    if x.device.type == "cpu" and w.device.type == "cpu":
        return batched_gemm_plain(x, w)
    _check_card(x, w, "batched_gemm")
    e, m, k = x.shape
    n = w.shape[2]
    if e > MAX_EXPERTS:
        raise ValueError(f"batched_gemm: {e} experts, the kernel takes at most {MAX_EXPERTS}")
    out = torch.empty((e, m, n), dtype=x.dtype, device=x.device)
    if e == 0 or m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    bf16 = x.dtype == torch.bfloat16
    tile = gemm_tile(m, n, e) if gemm_variant(m) == "tiled" else (0, 0)
    lib = _cuda.library()
    err = (lib.batched_gemm_bf16 if bf16 else lib.batched_gemm_f32)(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), e, m, n, k, *tile, _cuda.stream_of(x))
    _cuda.check(err, "batched_gemm")
    if bf16:
        batched_gemm.bf16.launches += 1
    else:
        batched_gemm.launches += 1
    return out


batched_gemm.launches = 0
batched_gemm.bf16 = _cuda.LaunchCount("batched_gemm_bf16")
