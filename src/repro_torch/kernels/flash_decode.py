"""Flash-decode: one-token GQA attention over a KV cache — counterpart of
:func:`repro.kernels.flash_decode.flash_decode` (dense cache),
:func:`repro.kernels.flash_decode.flash_decode_partial` (the unnormalised
partials of KV shards, for split-KV decode) and
:func:`repro.kernels.flash_decode.flash_paged_decode` (page pool reached
through block tables, fp32 or int8 pages).

All of them but the bf16 decode run one hand-written CUDA kernel
body, ``csrc/flash_decode.cu``'s fp32 body: a block per (sequence, kv head, up to 8 query heads of its group, shard of
the cache), each warp streaming its own 4-row tiles through a ring of
asynchronous copies with its own online softmax.  :func:`flash_decode` and
:func:`flash_paged_decode` cut the cache into shards of
:func:`decode_shard_rows` rows (a function of the cache's row count only,
never of the batch) and merge the shards' partials in shard order with the
combine kernel, in one call; :func:`flash_decode_partial` takes the
caller's ``n_splits`` equal shards and returns the partials;
:func:`combine_partials` is the combine kernel alone (the ``cuda_split``
backend's merge), whose plain version is ``ref.combine_partials_ref``.  On
CPU tensors each wrapper runs its plain version
(:func:`flash_decode_plain`, :func:`flash_paged_decode_plain`,
:func:`flash_decode_partial_plain`).  They follow the Pallas kernel, not
the ``ref`` oracle: a sequence of length 0 gives 0 (``acc / max(l, 1e-30)``
with a finite -1e30 mask), where ``ref`` gives the mean of V.  Each
wrapper's ``launches`` attribute counts its kernel launches; the combine
kernel's count rises with every :func:`flash_decode` call on the fp32 body,
:func:`flash_paged_decode` and :func:`combine_partials` call on the card.

:func:`flash_decode` also takes bf16 q, k and v, as the Pallas kernel
does.  At D, Dv <= 256 (every served head but MLA's) ``flash_decode_bf16``
is a body of its own, on the tensor cores: a thread-block cluster per
(sequence, kv head, group of up to 8 query heads), one block per shard of
:func:`decode_plan_bf16` rows; each warp stages 16-row tiles of K and V in
bf16 through a ring of ``cp.async`` copies and multiplies q K^T and P V
with ``mma.sync.m16n8k16`` (the query heads as the padded 16 rows, P split
into bf16 hi + lo, every sum and the softmax in fp32), and the cluster
merges its blocks' partials in shard order through distributed shared
memory, so one launch writes the output, rounded once to bf16.  Its order
is not the fp32 body's, so its rows are held within one bf16 ulp of
:func:`flash_decode_plain` and bitwise across batch sizes, not to the fp32
entry's result rounded.  Wider heads (MLA's absorbed D 576 / Dv 512) take
a tensor-core body of their own: a block per (sequence, kv head, up to 16
query heads, shard of :func:`decode_plan_wide_bf16` rows), the heads the
16 rows of both ``mma.sync`` products, 8 warps splitting D for q K^T and
Dv for P V (P = hi + lo), the shards' fp32 partials merged by the combine
kernel into the output, rounded once; its rows too are held within one
bf16 ulp of :func:`flash_decode_plain` and bitwise across batch sizes.
:func:`flash_decode_bf16_ffma` keeps the former wide body (the fp32 body's
wide layout on bf16 rings) as a yardstick.  Those calls count in
``flash_decode.bf16.launches`` (and the wide ones' merge in
``combine_partials.bf16.launches``); :func:`combine_partials` writes bf16
with ``dtype=torch.bfloat16``.
:func:`flash_decode_partial` takes bf16 q, k and v too (both widths):
``flash_decode_partial_bf16`` runs the same tensor-core bodies, each of the
caller's n_splits shards cut into the sub-shards of
:func:`decode_plan_partial_bf16` and merged back into that shard's
unnormalised partial (the narrow body in its partial mode, merged in the
cluster, one launch; the wide body into a workspace, then the combine
kernel merging each caller shard's sub-shards), acc rounded once to bf16 and
m and l fp32, as JAX's partial returns them (acc in q's dtype, m and l
float32).  Its plain version computes in fp32 on the upcast inputs and
rounds acc once; the kernel's rows are held within BF16_TOL (acc) and the
fp32 tolerance (m, l) of it and bitwise across batch sizes.  Those calls
count in ``flash_decode_partial.bf16.launches`` (the wide ones' merge in
``combine_partials.bf16.launches``).  :func:`flash_decode_partial_bf16_ffma`
keeps the former body (the fp32 body on bf16 rings) as a yardstick;
:func:`merge_partial_groups_plain` is the combine's grouped merge in plain
PyTorch.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.ref import combine_partials_ref

__all__ = ["flash_decode", "flash_decode_plain", "flash_decode_partial",
           "flash_decode_partial_plain", "decode_fits", "decode_shard_rows",
           "decode_smem_bytes", "decode_plan_bf16", "decode_tc_smem_bytes",
           "decode_plan_wide_bf16", "decode_wide_smem_bytes", "flash_decode_bf16_ffma",
           "decode_plan_partial_bf16", "flash_decode_partial_bf16_ffma",
           "merge_partial_groups_plain",
           "combine_partials", "flash_paged_decode",
           "flash_paged_decode_plain", "paged_decode_fits", "gather_pages"]

_NEG_INF = -1e30
# The layout of csrc/flash_decode.cu:
BLOCK_KV = 4           # rows per warp tile (ROWS)
WARPS = 4              # warps per block, tile t to warp t % 4 (NWARPS)
RING = 3               # ring slots per warp (NST)
GROUP_HEADS = 8        # query heads per block (GMAX)
SHARD_ROWS = 64        # rows per shard of a cache of up to 64 * MAX_SHARDS rows
MAX_SHARDS = 128
MAX_COMBINE_SHARDS = 12288   # the combine kernel keeps one weight per shard in 48 KB
# the dense kernel's wide layout (WIDE_NCK / WIDE_NCV float4 groups a lane):
# D and Dv up to these, beside the narrow layout's _cuda.MAX_HEAD_DIM (256)
MAX_WIDE_D = 32 * 4 * 5
MAX_WIDE_DV = 32 * 4 * 4
# the narrow bf16 body on the tensor cores (csrc/flash_decode.cu
# decode_tc_kernel): TC_WARPS warps a block, TC_ROWS key rows a warp tile,
# TC_NST ring slots a warp, TC_HEADS query heads a block, at most
# TC_CLUSTER blocks (shards) a cluster
TC_WARPS = 4
TC_ROWS = 16
TC_NST = 3
TC_HEADS = 8
TC_CLUSTER = 8
TC_FILL = 64           # most blocks a sequence, where the heads allow
TC_MIN_SUB = TC_WARPS * TC_ROWS   # fewest rows a bf16 partial's sub-shard takes: a tile a warp
# the wide bf16 body on the tensor cores (csrc/flash_decode.cu
# decode_wide_kernel): WD_WARPS warps a block, each holding its run of D's
# and Dv's 16-value chunks; WD_ROWS key rows a tile; WD_NST ring slots a
# warp; WD_HEADS query heads a block (the 16 rows of both products)
WD_WARPS = 8
WD_ROWS = 16
WD_NST = 4
WD_HEADS = 16
WD_FILL = 32           # blocks a sequence the wide plan aims at
WD_MIN_SHARD = 64      # fewest rows a wide shard takes


def decode_shard_rows(s_len: int) -> int:
    """Rows per shard of :func:`flash_decode` and :func:`flash_paged_decode`
    over a cache of ``s_len`` rows: SHARD_ROWS, doubled until the cache has
    at most MAX_SHARDS shards.  It depends on the cache's row count alone,
    never on the batch, so a sequence's shards (and its result) are the same
    at batch 4 as at batch 1."""
    shard = SHARD_ROWS
    while -(-s_len // shard) > MAX_SHARDS:
        shard *= 2
    return shard


def _tc_shards(s_len: int, units: int, least: int = TC_ROWS):
    """(shard rows, shards) of the narrow body over ``s_len`` rows for
    ``units`` clusters a sequence: the most of 1, 2, 4 and TC_CLUSTER shards
    that keeps the sequence's blocks (units x shards) within TC_FILL and
    gives each about ``least`` rows or more (a TC_ROWS tile for the decode),
    each shard a multiple of TC_ROWS rows, the fewest that cover the rows in
    that many."""
    shards = TC_CLUSTER
    while shards > 1 and (units * shards > TC_FILL or shards * least >= s_len + least):
        shards //= 2
    shard = -(-max(s_len, 1) // shards)
    shard = -(-shard // TC_ROWS) * TC_ROWS
    return shard, -(-max(s_len, 1) // shard)


def _wd_shards(s_len: int, units: int):
    """(shard rows, shards) of the wide body over ``s_len`` rows for
    ``units`` blocks a shard index a sequence: WD_FILL // units shards, each
    a multiple of WD_ROWS rows and at least WD_MIN_SHARD, the fewest that
    cover the rows in that many."""
    shards = max(1, WD_FILL // units)
    shard = -(-max(s_len, 1) // shards)
    shard = max(WD_MIN_SHARD, -(-shard // WD_ROWS) * WD_ROWS)
    return shard, -(-max(s_len, 1) // shard)


@functools.lru_cache(maxsize=None)
def decode_plan_bf16(s_len: int, hq: int, hk: int):
    """(shard rows, shards, head groups) of the narrow bf16 body over a cache
    of ``s_len`` rows: head groups of up to TC_HEADS query heads of one kv
    head; shards, one block each in a cluster a (sequence, kv head, group),
    the most of 1, 2, 4 and TC_CLUSTER that keeps a sequence's blocks (kv
    heads x groups x shards) within TC_FILL and gives each at least one
    TC_ROWS tile; each shard a multiple of TC_ROWS rows, the fewest that
    cover the cache in that many.  A block pays a fixed cost (q, the
    merges, the cluster's barriers) besides its rows, so many kv heads take
    fewer, longer shards.  It reads the cache's rows and the head counts
    alone, never the batch, so a sequence's tiles, shards and merge order
    (and its bits) are the same at batch 4 as at batch 1."""
    groups = -(-(hq // hk) // TC_HEADS)
    return (*_tc_shards(s_len, hk * groups), groups)


@functools.lru_cache(maxsize=None)
def decode_plan_wide_bf16(s_len: int, hq: int, hk: int):
    """(shard rows, shards, head groups) of the wide bf16 body over a cache
    of ``s_len`` rows: head groups of up to WD_HEADS query heads of one kv
    head; WD_FILL // (kv heads x groups) shards a (sequence, kv head,
    group), so that a batch of a few sequences still spreads over the
    card's 132 SMs, each shard a multiple of WD_ROWS rows and at least
    WD_MIN_SHARD (a block's fixed cost: q, the partial it writes), the
    fewest that cover the cache in that many.  The partials go through the
    workspace to the combine kernel, which merges them in shard order.  It
    reads the cache's rows and the head counts alone, never the batch, so a
    sequence's tiles, shards and merge order (and its bits) are the same at
    batch 4 as at batch 1."""
    groups = -(-(hq // hk) // WD_HEADS)
    return (*_wd_shards(s_len, hk * groups), groups)


@functools.lru_cache(maxsize=None)
def decode_plan_partial_bf16(part: int, hq: int, hk: int, n_splits: int, wide: bool):
    """(sub-shard rows, sub-shards a caller shard, head groups) of the bf16
    partial over caller shards of ``part`` rows (S / n_splits): the decode
    plans' rule (:func:`decode_plan_bf16` for the narrow body, ``wide``
    False; :func:`decode_plan_wide_bf16` for D or Dv > 256) on ``part``
    rows, with a sequence's n_splits caller shards counted in its fill (so a
    call with many caller shards cuts each into fewer, and one with few
    caller shards, the tree decode's 1, still spreads over the card); a
    narrow sub-shard takes about TC_MIN_SUB rows or more, a tile for each
    warp (shorter ones measured slower on the card: gemma3-1b's global
    decode at n_splits 8 and 16).  Each sub-shard is whole TC_ROWS /
    WD_ROWS tiles; together they cover [0, part), and the kernels stop each
    at its caller shard's end.  It reads the rows, the head counts and
    n_splits, never the batch, so a sequence's partials have the same bits
    at batch 4 as at batch 1."""
    if wide:
        groups = -(-(hq // hk) // WD_HEADS)
        return (*_wd_shards(part, n_splits * hk * groups), groups)
    groups = -(-(hq // hk) // TC_HEADS)
    return (*_tc_shards(part, n_splits * hk * groups, TC_MIN_SUB), groups)


def _wd_chunks(w: int) -> int:
    """A warp's run of a width's 16-value chunks (csrc wd_chunks)."""
    return -(-(-(-w // 16)) // WD_WARPS)


def decode_wide_smem_bytes(d: int, dv: int) -> int:
    """Dynamic shared memory of one block of the wide bf16 body
    (csrc/flash_decode.cu decode_wide_smem_bytes): q's WD_HEADS rows in
    bf16 (a row padded to 16 values and 8 more); two buffers each of the
    warps' fp32 partial scores of a tile, of P's hi and lo rows in bf16 and
    of the heads' rescales; then each warp's WD_NST slots of WD_ROWS K rows
    cut to its chunks of D and V rows cut to its chunks of Dv, in bf16,
    padded by 8."""
    kq, vq = 16 * _wd_chunks(d) + 8, 16 * _wd_chunks(dv) + 8
    return (2 * WD_HEADS * (-(-d // 16) * 16 + 8) + 4 * 2 * WD_WARPS * WD_HEADS * WD_ROWS
            + 2 * 2 * 2 * WD_HEADS * (WD_ROWS + 8) + 4 * 2 * WD_HEADS
            + 2 * WD_WARPS * WD_NST * WD_ROWS * (kq + vq))


def decode_tc_smem_bytes(d: int, dv: int) -> int:
    """Dynamic shared memory of one block of the narrow bf16 body
    (csrc/flash_decode.cu decode_tc_smem_bytes): q's TC_HEADS rows, then each
    warp's TC_NST slots of TC_ROWS K and V rows, in bf16, a row padded to
    16 values and 8 more (ldmatrix without bank conflicts); or, where it
    takes more, the fp32 merge that reuses the rings (each warp's and the
    block's m, l and acc of TC_HEADS rows of Dv padded to 16, and the
    weights of the warps and of the cluster's blocks)."""
    ks, vs = -(-d // 16) * 16 + 8, -(-dv // 16) * 16 + 8
    ring = 2 * TC_WARPS * TC_NST * TC_ROWS * (ks + vs)
    merge = 4 * ((TC_WARPS + 1) * TC_HEADS * (2 + -(-dv // 16) * 16)
                 + (TC_WARPS + TC_CLUSTER + 1) * TC_HEADS)
    return 2 * TC_HEADS * ks + max(ring, merge)


def decode_smem_bytes(d: int, dv: int, *, bf16: bool = False) -> int:
    """Dynamic shared memory of one block (csrc/flash_decode.cu
    decode_smem_floats): the pre-scaled queries of GROUP_HEADS heads, then
    each warp's ring of RING tiles of BLOCK_KV K and V rows, widths padded
    to a multiple of 4.  It does not depend on the group size or the batch.
    ``bf16`` (decode_smem_bytes_bf16): the rings at 2 bytes a value, or the
    warps' fp32 partials of the merge where those take more: the fp32 body
    on bf16 rings, which only the yardsticks :func:`flash_decode_bf16_ffma`
    and :func:`flash_decode_partial_bf16_ffma` run (the bf16 entries:
    :func:`decode_tc_smem_bytes`, :func:`decode_wide_smem_bytes`)."""
    d4, dv4 = -(-d // 4) * 4, -(-dv // 4) * 4
    if bf16:
        ring = 2 * WARPS * RING * BLOCK_KV * (d4 + dv4)
        return 4 * GROUP_HEADS * d4 + max(ring, 4 * WARPS * GROUP_HEADS * (2 + dv4))
    return 4 * (GROUP_HEADS * d4 + WARPS * RING * BLOCK_KV * (d4 + dv4))


@functools.lru_cache(maxsize=None)
def decode_fits(hq: int, hk: int, d: int, dv: int, *, bf16: bool = False) -> bool:
    """Whether the dense kernel (:func:`flash_decode`,
    :func:`flash_decode_partial`) takes these head counts and widths: whole
    GQA groups (any size: a block takes up to GROUP_HEADS of them, 4 in the
    wide layout), D <= MAX_WIDE_D and Dv <= MAX_WIDE_DV (the wide layout
    past 256, chosen by the widths alone: MLA's absorbed decode is D 576,
    Dv 512), and the block's shared memory within the H100's 227 KB (which
    caps D at 596 when Dv is 512 in fp32).  ``bf16``: the bf16 entries
    (:func:`flash_decode` and :func:`flash_decode_partial` run the same
    tensor-core bodies): the narrow body's block :func:`decode_tc_smem_bytes`
    at D, Dv <= 256 (206,976 B at 256 / 256), the wide body's
    :func:`decode_wide_smem_bytes` past that (202,112 B at 576 / 512), so
    every width up to MAX_WIDE_D and MAX_WIDE_DV fits."""
    if hk < 1 or hq % hk or not (0 < d <= MAX_WIDE_D and 0 < dv <= MAX_WIDE_DV):
        return False
    if not bf16:
        return decode_smem_bytes(d, dv) <= _cuda.MAX_SMEM_BYTES
    narrow = max(d, dv) <= _cuda.MAX_HEAD_DIM
    smem = decode_tc_smem_bytes(d, dv) if narrow else decode_wide_smem_bytes(d, dv)
    return smem <= _cuda.MAX_SMEM_BYTES


def paged_decode_fits(hq: int, hk: int, d: int, dv: int) -> bool:
    """Whether the paged kernel takes these head counts and widths: the
    narrow layout only (D and Dv <= 256; no served path pages a wider
    head).  It stages the same tiles as the dense one, so its shared memory
    does not depend on the page size."""
    return (decode_fits(hq, hk, d, dv) and d <= _cuda.MAX_HEAD_DIM
            and dv <= _cuda.MAX_HEAD_DIM)


def _workspace(n_shards: int, b: int, hq: int, dv: int, device):
    """The shards' partials acc (n_shards, B, Hq, Dv), m and l (n_shards,
    B, Hq), written by the shard kernel and read by the combine: views of
    one allocation."""
    rows = n_shards * b * hq
    buf = torch.empty(rows * (dv + 2), dtype=torch.float32, device=device)
    return (buf[:rows * dv].view(n_shards, b, hq, dv),
            buf[rows * dv:rows * (dv + 1)].view(n_shards, b, hq),
            buf[rows * (dv + 1):].view(n_shards, b, hq))


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       lengths: torch.Tensor, scale: float) -> torch.Tensor:
    """The kernel's function in plain PyTorch (fp32 on the upcast inputs,
    rounded to q's dtype): masked softmax whose masked entries weigh
    exactly 0, finished as acc / max(l, 1e-30)."""
    dtype = q.dtype
    q, k, v = q.float(), k.float(), v.float()
    b, hq, d = q.shape
    s_len, hk = k.shape[1], k.shape[2]
    g = hq // hk
    qg = (q * scale).reshape(b, hk, g, d)
    s = torch.einsum("bhgd,bshd->bhgs", qg, k)
    valid = (torch.arange(s_len, device=q.device)[None, :]
             < lengths.to(q.device).long()[:, None])[:, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgs,bshd->bhgd", p, v) / torch.clamp(l, min=1e-30)
    return o.reshape(b, hq, v.shape[3]).to(dtype)


def _check_dense(fn: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor, scale: Optional[float], bf16_ok: bool = False) -> float:
    """Validate a dense-cache decode call (q, k, v all float32, or with
    ``bf16_ok`` all bfloat16); returns the resolved scale."""
    if q.dim() != 3 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{fn}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, hq, d = q.shape
    s_len, hk = k.shape[1], k.shape[2]
    dv = v.shape[3]
    if k.shape != (b, s_len, hk, d) or v.shape[:3] != (b, s_len, hk):
        raise ValueError(f"{fn}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    ok = (torch.float32, torch.bfloat16) if bf16_ok else (torch.float32,)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in ok or t.dtype != q.dtype:
            raise TypeError(f"{fn}: {name} must be {' or '.join(str(x)[6:] for x in ok)} "
                            f"(q, k and v alike), got {t.dtype}")
    if not decode_fits(hq, hk, d, dv, bf16=q.dtype == torch.bfloat16):
        raise ValueError(f"{fn}: unsupported heads/widths Hq={hq} Hk={hk} D={d} Dv={dv} "
                         f"for {q.dtype}")
    if lengths.shape != (b,) or lengths.dtype != torch.int32:
        raise ValueError(f"{fn}: lengths must be ({b},) int32, got "
                         f"{tuple(lengths.shape)} {lengths.dtype}")
    return (1.0 / math.sqrt(d)) if scale is None else float(scale)


def _on_card(fn: str, tensors) -> bool:
    """False for CPU tensors (the plain version runs); True for tensors on
    one CUDA device, contiguous (the kernel runs); raises otherwise."""
    q = tensors[0]
    if not q.is_cuda and all(t.device.type == "cpu" for t in tensors):
        return False
    dev = q.get_device()   # -1 off the card; no device objects on the launch path
    if not q.is_cuda or any(t.get_device() != dev for t in tensors):
        raise ValueError(f"{fn}: all inputs must be on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{fn}: inputs must be contiguous")
    return True


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor, *,
                 scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Hq, D), k (B, S, Hk, D), v (B, S, Hk, Dv), lengths (B,) int32
    -> (B, Hq, Dv) in q's dtype, softmax-normalised over positions <
    lengths[b]; q, k and v all float32 or all bfloat16."""
    scale = _check_dense("flash_decode", q, k, v, lengths, scale, bf16_ok=True)
    if not _on_card("flash_decode", (q, k, v, lengths)):
        return flash_decode_plain(q, k, v, lengths, scale)
    b, hq, d = q.shape
    s_len, hk, dv = k.shape[1], k.shape[2], v.shape[3]
    out = torch.empty((b, hq, dv), dtype=q.dtype, device=q.device)
    if b == 0 or s_len == 0:
        return out.zero_()
    bf16 = q.dtype == torch.bfloat16
    lib = _cuda.library()
    if bf16 and d <= _cuda.MAX_HEAD_DIM and dv <= _cuda.MAX_HEAD_DIM:
        # the tensor-core body: one launch, merged in the cluster, no workspace
        err = lib.flash_decode_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), None, None, None,
            out.data_ptr(), b, hq, hk, s_len, d, dv, decode_plan_bf16(s_len, hq, hk)[0], scale,
            _cuda.stream_of(q))
        _cuda.check(err, "flash_decode")
        flash_decode.bf16.launches += 1
        return out
    # the wide tensor-core body (bf16) or the fp32 body: shards into the
    # workspace, then the combine
    shard = decode_plan_wide_bf16(s_len, hq, hk)[0] if bf16 else decode_shard_rows(s_len)
    acc, m, l = _workspace(-(-s_len // shard), b, hq, dv, q.device)
    err = (lib.flash_decode_bf16 if bf16 else lib.flash_decode_f32)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), acc.data_ptr(),
        m.data_ptr(), l.data_ptr(), out.data_ptr(), b, hq, hk, s_len, d, dv, shard, scale,
        _cuda.stream_of(q))
    _cuda.check(err, "flash_decode")
    if bf16:
        flash_decode.bf16.launches += 1
        combine_partials.bf16.launches += 1
    else:
        flash_decode.launches += 1
        combine_partials.launches += 1
    return out


flash_decode.launches = 0
flash_decode.bf16 = _cuda.LaunchCount("flash_decode_bf16")


def flash_decode_bf16_ffma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lengths: torch.Tensor, *,
                           scale: Optional[float] = None) -> torch.Tensor:
    """The former wide bf16 body (the fp32 body's wide layout on bf16 rings,
    upcast as read, FFMA; shards of :func:`decode_shard_rows`, then the
    combine) on bf16 CUDA tensors with D or Dv > 256: the yardstick that
    ``chip_smoke.py`` times the tensor-core body against.  No path calls it,
    and it counts no launch."""
    scale = _check_dense("flash_decode_bf16_ffma", q, k, v, lengths, scale, bf16_ok=True)
    b, hq, d = q.shape
    s_len, hk, dv = k.shape[1], k.shape[2], v.shape[3]
    if (q.dtype != torch.bfloat16 or max(d, dv) <= _cuda.MAX_HEAD_DIM
            or not _on_card("flash_decode_bf16_ffma", (q, k, v, lengths)) or b * s_len == 0):
        raise ValueError("flash_decode_bf16_ffma takes non-empty bf16 calls on the card "
                         "with D or Dv > 256")
    out = torch.empty((b, hq, dv), dtype=q.dtype, device=q.device)
    shard = decode_shard_rows(s_len)
    acc, m, l = _workspace(-(-s_len // shard), b, hq, dv, q.device)
    _cuda.check(_cuda.library().flash_decode_bf16_ffma(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), acc.data_ptr(),
        m.data_ptr(), l.data_ptr(), out.data_ptr(), b, hq, hk, s_len, d, dv, shard, scale,
        _cuda.stream_of(q)), "flash_decode_bf16_ffma")
    return out


def combine_partials(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor, *,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Merge flash partials over their leading shard axis: acc (NS, ..., Dv),
    m and l (NS, ...) fp32 -> (..., Dv) in ``dtype`` (float32, or bfloat16
    rounded once), the shards in index order (the combine kernel of
    csrc/flash_decode.cu on CUDA tensors, ``ref.combine_partials_ref`` on
    CPU tensors).  An empty shard (acc 0, m -1e30, l 0) weighs 0; a row
    whose shards are all empty gives 0."""
    fn = "combine_partials"
    if acc.dim() < 2 or m.shape != acc.shape[:-1] or l.shape != m.shape:
        raise ValueError(f"{fn}: acc {tuple(acc.shape)}, m {tuple(m.shape)}, l {tuple(l.shape)}")
    for name, t in (("acc", acc), ("m", m), ("l", l)):
        if t.dtype != torch.float32:
            raise TypeError(f"{fn}: {name} must be float32, got {t.dtype}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{fn}: the output must be float32 or bfloat16, got {dtype}")
    if not _on_card(fn, (acc, m, l)):
        return combine_partials_ref(acc, m, l).to(dtype)
    ns, dv = acc.shape[0], acc.shape[-1]
    if not 1 <= ns <= MAX_COMBINE_SHARDS:
        raise ValueError(f"{fn}: {ns} shards, the kernel takes 1 to {MAX_COMBINE_SHARDS}")
    out = torch.empty(acc.shape[1:], dtype=dtype, device=acc.device)
    rows = m[0].numel()
    if rows == 0 or dv == 0:
        return out
    bf16 = dtype == torch.bfloat16
    lib = _cuda.library()
    err = (lib.combine_partials_bf16 if bf16 else lib.combine_partials_f32)(
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), out.data_ptr(), ns, rows, dv,
        _cuda.stream_of(acc))
    _cuda.check(err, fn)
    if bf16:
        combine_partials.bf16.launches += 1
    else:
        combine_partials.launches += 1
    return out


combine_partials.launches = 0
combine_partials.bf16 = _cuda.LaunchCount("combine_partials_bf16")


def flash_decode_partial_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               lengths: torch.Tensor, scale: float, n_splits: int = 1):
    """The partial kernel's function in plain PyTorch, fp32 on the upcast
    inputs: for each shard i of S / n_splits rows, with length clip(len -
    i * part, 0, part), the running max m of the masked scores (-1e30 for
    an empty shard), the sum l of exp(s - m) over the valid rows, and acc =
    sum of exp(s - m) * v.  Returns acc (n_splits, B, Hq, Dv) in q's dtype
    (rounded once), m and l (n_splits, B, Hq) fp32: JAX's partial."""
    dtype = q.dtype
    q, k, v = q.float(), k.float(), v.float()
    b, hq, d = q.shape
    s_len, hk = k.shape[1], k.shape[2]
    g, part = hq // hk, s_len // n_splits
    qg = (q * scale).reshape(b, hk, g, d)
    lengths = lengths.to(q.device).long().clamp(0, s_len)
    accs, ms, ls = [], [], []
    for i in range(n_splits):
        ks, vs = k[:, i * part:(i + 1) * part], v[:, i * part:(i + 1) * part]
        n_i = (lengths - i * part).clamp(0, part)
        s = torch.einsum("bhgd,bshd->bhgs", qg, ks)
        valid = (torch.arange(part, device=q.device)[None, :] < n_i[:, None])[:, None, None, :]
        s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
        accs.append(torch.einsum("bhgs,bshd->bhgd", p, vs).reshape(b, hq, v.shape[3]))
        ms.append(m.reshape(b, hq))
        ls.append(p.sum(dim=-1).reshape(b, hq))
    return torch.stack(accs).to(dtype), torch.stack(ms), torch.stack(ls)


def merge_partial_groups_plain(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                               group: int):
    """The combine kernel's partial mode in plain PyTorch: the partials of
    ``n * group`` shards, acc (n * group, ..., Dv), m and l (n * group, ...)
    fp32, merged ``group`` at a time into the unnormalised partials of n
    shards (acc not divided by l, m the groups' max, natural units), all
    fp32; a group whose shards are all empty gives exactly (0, -1e30, 0)."""
    n = acc.shape[0] // group
    acc, m, l = (t.reshape(n, group, *t.shape[1:]) for t in (acc, m, l))
    m_max = m.amax(dim=1)
    w = torch.exp(m - m_max[:, None])
    return (acc * w[..., None]).sum(dim=1), m_max, (l * w).sum(dim=1)


def flash_decode_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor, *, scale: Optional[float] = None,
                         n_splits: int = 1):
    """Unnormalised flash partials of each of ``n_splits`` KV shards (rows
    [i * S / n_splits, (i + 1) * S / n_splits)): q (B, Hq, D), k (B, S, Hk,
    D), v (B, S, Hk, Dv), lengths (B,) int32 -> acc (n_splits, B, Hq, Dv) in
    q's dtype, m (n_splits, B, Hq) and l (n_splits, B, Hq) fp32; q, k and v
    all float32 or all bfloat16.  With ``n_splits=1`` it is JAX's
    ``flash_decode_partial`` over the whole cache (with a leading axis of
    1).  fp32: the fp32 body, one launch over the caller's shards.  bf16:
    the tensor-core bodies, each caller shard cut into the sub-shards of
    :func:`decode_plan_partial_bf16` and merged back into its partial (D,
    Dv <= 256: one launch, merged in a cluster; wider: the wide body into a
    workspace, then the combine kernel's partial mode).  Combine with
    :func:`combine_partials` (``acc.float()`` at bf16)."""
    fn = "flash_decode_partial"
    scale = _check_dense(fn, q, k, v, lengths, scale, bf16_ok=True)
    b, hq, d = q.shape
    s_len, hk, dv = k.shape[1], k.shape[2], v.shape[3]
    if n_splits < 1 or s_len % n_splits:
        raise ValueError(f"{fn}: n_splits={n_splits} must be >= 1 and divide S={s_len}")
    if not _on_card(fn, (q, k, v, lengths)):
        return flash_decode_partial_plain(q, k, v, lengths, scale, n_splits)
    bf16 = q.dtype == torch.bfloat16
    if bf16:    # acc rounded once to bf16; m and l fp32, as JAX's partial
        acc = torch.empty((n_splits, b, hq, dv), dtype=q.dtype, device=q.device)
        m = torch.empty((n_splits, b, hq), dtype=torch.float32, device=q.device)
        l = torch.empty((n_splits, b, hq), dtype=torch.float32, device=q.device)
    else:
        acc, m, l = _workspace(n_splits, b, hq, dv, q.device)
    if b == 0:
        return acc, m, l
    if s_len == 0:
        return acc.zero_(), m.fill_(_NEG_INF), l.zero_()
    lib = _cuda.library()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), acc.data_ptr(),
            m.data_ptr(), l.data_ptr())
    if not bf16:
        _cuda.check(lib.flash_decode_partial_f32(*ptrs, b, hq, hk, s_len, d, dv, n_splits, scale,
                                                 _cuda.stream_of(q)), fn)
        flash_decode_partial.launches += 1
        return acc, m, l
    wide = d > _cuda.MAX_HEAD_DIM or dv > _cuda.MAX_HEAD_DIM
    sub, nsub, _ = decode_plan_partial_bf16(s_len // n_splits, hq, hk, n_splits, wide)
    if wide:    # the sub-shards' fp32 partials, for the combine
        ws = _workspace(n_splits * nsub, b, hq, dv, q.device)
        ws_ptrs = (ws[0].data_ptr(), ws[1].data_ptr(), ws[2].data_ptr())
    else:       # the narrow body merges in its cluster and takes none
        ws_ptrs = (None, None, None)
    _cuda.check(lib.flash_decode_partial_bf16(*ptrs, *ws_ptrs, b, hq, hk, s_len, d, dv, n_splits,
                                              sub, scale, _cuda.stream_of(q)), fn)
    flash_decode_partial.bf16.launches += 1
    if wide:
        combine_partials.bf16.launches += 1
    return acc, m, l


flash_decode_partial.launches = 0
flash_decode_partial.bf16 = _cuda.LaunchCount("flash_decode_partial_bf16")


def flash_decode_partial_bf16_ffma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   lengths: torch.Tensor, *, scale: Optional[float] = None,
                                   n_splits: int = 1):
    """The former bf16 partial (the fp32 body on bf16 rings, upcast as read,
    FFMA; the caller's n_splits shards, each shard's acc rounded once, m
    and l the fp32 entry's bit for bit) on bf16 CUDA tensors: the yardstick
    that ``chip_smoke.py`` times the tensor-core bodies against.  No path
    calls it, and it counts no launch."""
    fn = "flash_decode_partial_bf16_ffma"
    scale = _check_dense(fn, q, k, v, lengths, scale, bf16_ok=True)
    b, hq, d = q.shape
    s_len, hk, dv = k.shape[1], k.shape[2], v.shape[3]
    if (q.dtype != torch.bfloat16 or not _on_card(fn, (q, k, v, lengths)) or b * s_len == 0
            or n_splits < 1 or s_len % n_splits):
        raise ValueError(f"{fn} takes non-empty bf16 calls on the card, n_splits dividing S")
    acc = torch.empty((n_splits, b, hq, dv), dtype=q.dtype, device=q.device)
    m, l = torch.empty((2, n_splits, b, hq), dtype=torch.float32, device=q.device)
    _cuda.check(_cuda.library().flash_decode_partial_bf16_ffma(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), acc.data_ptr(),
        m.data_ptr(), l.data_ptr(), b, hq, hk, s_len, d, dv, n_splits, scale,
        _cuda.stream_of(q)), fn)
    return acc, m, l


def gather_pages(pages: torch.Tensor, tables: torch.Tensor,
                 scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, P, H, D) pages + (B, MP) int32 tables -> the dense (B, MP*P, H, D)
    cache they describe, table entries clipped to [0, N-1].  With ``scales``
    ((N, H) float32) the pages are int8 and come back dequantized as
    ``float(x) * scale[block, h]`` — the JAX package's ``_gather_pages`` and
    ``_gather_pages_q``."""
    n, p = pages.shape[0], pages.shape[1]
    idx = tables.to(pages.device).long().clamp(0, n - 1)
    g = pages[idx]                                        # (B, MP, P, H, D)
    if scales is not None:
        g = g.float() * scales[idx][:, :, None, :, None]
    return g.reshape(tables.shape[0], tables.shape[1] * p, *pages.shape[2:])


def flash_paged_decode_plain(q: torch.Tensor, pages_k: torch.Tensor,
                             pages_v: torch.Tensor, block_tables: torch.Tensor,
                             lengths: torch.Tensor, scale: float,
                             k_scales: Optional[torch.Tensor] = None,
                             v_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The paged kernel's function in plain PyTorch: gather (and dequantize)
    the pages into a dense cache, then :func:`flash_decode_plain`."""
    return flash_decode_plain(q, gather_pages(pages_k, block_tables, k_scales),
                              gather_pages(pages_v, block_tables, v_scales),
                              lengths, scale)


def check_paged(fn: str, q: torch.Tensor, pages_k: torch.Tensor, pages_v: torch.Tensor,
                block_tables: torch.Tensor, k_scales: Optional[torch.Tensor],
                v_scales: Optional[torch.Tensor]) -> bool:
    """Validate the page pool, tables and scales a paged attention wrapper
    was given; returns whether the pages are int8 (both scales given)."""
    quant = k_scales is not None
    if quant != (v_scales is not None):
        raise ValueError(f"{fn}: need both k_scales and v_scales, or neither")
    if pages_k.dim() != 4 or pages_v.dim() != 4 or pages_k.shape[:3] != pages_v.shape[:3]:
        raise ValueError(f"{fn}: pages_k {tuple(pages_k.shape)}, pages_v {tuple(pages_v.shape)}")
    n, _, hk, d = pages_k.shape
    if n < 1 or d != q.shape[-1]:
        raise ValueError(f"{fn}: q {tuple(q.shape)}, pages_k {tuple(pages_k.shape)}")
    if q.dtype != torch.float32:
        raise TypeError(f"{fn}: q must be float32, got {q.dtype}")
    want = torch.int8 if quant else torch.float32
    for name, t in (("pages_k", pages_k), ("pages_v", pages_v)):
        if t.dtype != want:
            raise TypeError(f"{fn}: {name} must be {want}, got {t.dtype}")
    if quant:
        for name, t in (("k_scales", k_scales), ("v_scales", v_scales)):
            if t.shape != (n, hk) or t.dtype != torch.float32:
                raise ValueError(f"{fn}: {name} must be ({n}, {hk}) float32, got "
                                 f"{tuple(t.shape)} {t.dtype}")
    if (block_tables.dim() != 2 or block_tables.shape[0] != q.shape[0]
            or block_tables.dtype != torch.int32):
        raise ValueError(f"{fn}: block_tables must be ({q.shape[0]}, MP) int32, got "
                         f"{tuple(block_tables.shape)} {block_tables.dtype}")
    return quant


def flash_paged_decode(q: torch.Tensor, pages_k: torch.Tensor, pages_v: torch.Tensor,
                       block_tables: torch.Tensor, lengths: torch.Tensor, *,
                       k_scales: Optional[torch.Tensor] = None,
                       v_scales: Optional[torch.Tensor] = None,
                       scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Hq, D), pages_k (N, P, Hk, D), pages_v (N, P, Hk, Dv),
    block_tables (B, MP) int32, lengths (B,) int32 -> (B, Hq, Dv).

    Logical position ``pi * P + r`` of sequence b is row r of block
    ``block_tables[b, pi]`` (clipped to [0, N-1]); positions >= lengths[b]
    are masked, so table entries past the length may hold any block id.
    With ``k_scales``/``v_scales`` ((N, Hk) float32) the pages are int8,
    dequantized per (page, kv head) as ``float(x) * scale``."""
    fn = "flash_paged_decode"
    if q.dim() != 3:
        raise ValueError(f"{fn}: q {tuple(q.shape)}")
    quant = check_paged(fn, q, pages_k, pages_v, block_tables, k_scales, v_scales)
    b, hq, d = q.shape
    n, page, hk = pages_k.shape[0], pages_k.shape[1], pages_k.shape[2]
    dv, mp = pages_v.shape[3], block_tables.shape[1]
    if not paged_decode_fits(hq, hk, d, dv):
        raise ValueError(f"{fn}: unsupported heads/widths Hq={hq} Hk={hk} D={d} Dv={dv}")
    if lengths.shape != (b,) or lengths.dtype != torch.int32:
        raise ValueError(f"{fn}: lengths must be ({b},) int32, got "
                         f"{tuple(lengths.shape)} {lengths.dtype}")
    scale = (1.0 / math.sqrt(d)) if scale is None else float(scale)
    tensors = (q, pages_k, pages_v, block_tables, lengths) + (
        (k_scales, v_scales) if quant else ())
    if all(t.device.type == "cpu" for t in tensors):
        return flash_paged_decode_plain(q, pages_k, pages_v, block_tables, lengths,
                                        scale, k_scales, v_scales)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError(f"{fn}: all inputs must be on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{fn}: inputs must be contiguous")
    out = torch.empty((b, hq, dv), dtype=torch.float32, device=q.device)
    if b == 0 or mp * page == 0:
        return out.zero_()
    shard = decode_shard_rows(mp * page)
    acc, m, l = _workspace(-(-(mp * page) // shard), b, hq, dv, q.device)
    lib = _cuda.library()
    parts = (acc.data_ptr(), m.data_ptr(), l.data_ptr(), out.data_ptr())
    dims = (b, hq, hk, n, page, mp, d, dv, shard, scale, _cuda.stream_of(q))
    if quant:
        err = lib.flash_paged_decode_i8(
            q.data_ptr(), pages_k.data_ptr(), k_scales.data_ptr(), pages_v.data_ptr(),
            v_scales.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(), *parts, *dims)
    else:
        err = lib.flash_paged_decode_f32(
            q.data_ptr(), pages_k.data_ptr(), pages_v.data_ptr(), block_tables.data_ptr(),
            lengths.data_ptr(), *parts, *dims)
    _cuda.check(err, fn)
    flash_paged_decode.launches += 1
    combine_partials.launches += 1
    return out


flash_paged_decode.launches = 0
