"""GEMM, plain and batched, fp32 or bf16 — counterpart of
:func:`repro.kernels.gemm.gemm` and :func:`repro.kernels.gemm.batched_gemm`.

:func:`gemm` launches, on fp32 CUDA tensors, one of two hand-written FFMA
kernels of ``csrc/gemm.cu``, chosen by :func:`gemm_variant` from M:
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
does, on another body: ``gemm_bf16`` multiplies on the tensor cores
(``wgmma``), the sum fp32 in registers, each output rounded once to bf16.
Its plan, :func:`gemm_bf16_plan`, reads M, N and the expert count alone
and never splits K, and every plan runs every element through the same
chain of ``m64n64k16`` instructions over K from 0 upward, so a row's bits
depend neither on M nor on the plan (the fp32 entry's FMA chain rounded
is no longer the bf16 result: the tensor core sums each 16-deep chunk
its own way).  Those launches count in ``gemm.bf16.launches``.
:func:`batched_gemm` takes bf16 the same way (``batched_gemm_bf16``: the
same body, the expert as ``blockIdx.z``, so expert e's row has the bits of
``gemm(x[e], w[e])``'s), its launches counted in
``batched_gemm.bf16.launches``.  On CPU tensors both run the plain
versions (fp32 on the upcast operands, rounded once).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _cuda

__all__ = ["gemm", "gemm_plain", "gemm_variant", "gemm_tile", "gemm_bf16_plan", "batched_gemm",
           "batched_gemm_plain", "SKINNY_MAX_M", "TILES", "MIN_BIG_TILE_BLOCKS", "BF16_TILES",
           "BF16_BK"]

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


# the bf16 body's plans (BM, BN) (csrc/gemm.cu gemm_bf16): one or two consumer
# warpgroups of 64 rows, one or two 64-column panels, each a chain of
# m64n64k16 instructions; and the K depth of its ring stages
BF16_TILES = ((64, 64), (128, 128))
BF16_BK = 64


def gemm_bf16_plan(m: int, n: int, count: int = 1) -> tuple:
    """The bf16 body's tile (BM, BN) for ``count`` (M, N) results in one
    launch (:func:`batched_gemm`'s experts): 128x128 where M fills more than
    one 64-row warpgroup and the launch still gets MIN_BIG_TILE_BLOCKS
    blocks, else 64x64 (decode's rows, zero past M, and narrow column strips
    that spread the weights over the SMs).  K is never split, and only the
    speed depends on the plan: each output element is the same instruction
    chain in every plan."""
    big = BF16_TILES[1]
    if m > BF16_TILES[0][0] and count * -(-m // big[0]) * -(-n // big[1]) >= MIN_BIG_TILE_BLOCKS:
        return big
    return BF16_TILES[0]


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
    lib = _cuda.library()
    args = (x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k)
    if x.dtype == torch.bfloat16:
        _cuda.check(lib.gemm_bf16(*args, *gemm_bf16_plan(m, n), _cuda.stream_of(x)), "gemm")
        gemm.bf16.launches += 1
        return out
    if gemm_variant(m) == "skinny":
        err = lib.gemm_f32_skinny(*args, _cuda.stream_of(x))
    else:
        err = lib.gemm_f32_tiled(*args, *gemm_tile(m, n), _cuda.stream_of(x))
    _cuda.check(err, "gemm")
    gemm.launches += 1
    return out


gemm.launches = 0
gemm.bf16 = _cuda.LaunchCount("gemm_bf16")


MAX_EXPERTS = 65535      # gridDim.z


def batched_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(E, M, K) @ (E, K, N) -> (E, M, N) in x's dtype, fp32 or bf16 (w the
    same); row m of expert e is the same arithmetic whatever M is, the one
    :func:`gemm` gives it in the same dtype."""
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
    if bf16:
        fn, tile = _cuda.library().batched_gemm_bf16, gemm_bf16_plan(m, n, e)
    else:
        fn = _cuda.library().batched_gemm_f32
        tile = gemm_tile(m, n, e) if gemm_variant(m) == "tiled" else (0, 0)
    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), e, m, n, k, *tile, _cuda.stream_of(x))
    _cuda.check(err, "batched_gemm")
    if bf16:
        batched_gemm.bf16.launches += 1
    else:
        batched_gemm.launches += 1
    return out


batched_gemm.launches = 0
batched_gemm.bf16 = _cuda.LaunchCount("batched_gemm_bf16")
