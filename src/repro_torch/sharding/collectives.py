"""Collectives of tensor-parallel serving and sharded training —
counterpart of :mod:`repro.sharding.collectives`, on ``torch.distributed``.

Every function takes the rank's own tensors and a
:class:`~repro_torch.launch.mesh.ProcessMesh` (of
:func:`~repro_torch.launch.mesh.make_mesh`, or the 1-D serving mesh of
:func:`~repro_torch.launch.mesh.make_serving_mesh`, whose axis is the whole
process group), on which a collective over an axis runs in that axis's
group (``mesh.group(axis)``; a point-to-point peer is turned into its
global rank).  Over an axis of one rank none runs, so a layout-only mesh
of such an axis needs no group:

* :func:`all_gather_axis` / :func:`all_reduce_axis` — the gather of every
  rank's slice along one dim, and the all-reduce, over an axis (or a tuple
  of axes: the data axes ``("pod", "data")``);
* :class:`GlobalBatch` — the data-parallel ranks over which a training
  loss sums its global-batch terms (the CE's valid-label count, the MoE
  router's expert counts and token count);
* :func:`all_gather_heads` — the exact all-gather that hands a head-sharded
  attention output back to the replicated rest of a Program: each rank's
  slice, gathered into a list (``dist.all_gather``) and concatenated in
  rank order.  Pure data movement, so bitwise exact.
* :func:`tree_decode_attention` — sequence-parallel decode: each rank holds
  its slice of the KV cache along the length dim, runs the partial kernel
  (``decode_attention_partial``; on the card ``flash_decode_partial_f32``,
  or at bf16 ``flash_decode_partial_bf16`` of ``csrc/flash_decode.cu``, the
  tensor-core bodies with the rank's rows cut into sub-shards) over it
  and the ranks combine with an ``all_reduce(MAX)`` and two
  ``all_reduce(SUM)`` in fp32 — exact up to the order of float additions
  (at bf16, also up to the rounding of each rank's acc, as in JAX).
* :func:`ring_allgather_matmul` — ``allgather(x) @ w`` with the gather
  pipelined against the products: at step t each rank multiplies the chunk
  it holds (the port's ``gemm`` kernel) while sending it on to the next
  rank (``dist.batch_isend_irecv``).
* :func:`allgather_bytes` — the cost-model accounting of a gather's
  traffic.

gloo takes ``all_gather`` and ``all_reduce`` on CUDA tensors but no
point-to-point op, so :func:`ring_allgather_matmul` over gloo stages its
CUDA chunks through host memory: a transport detail, not a compute
fallback.  ``shard_map_compat`` and ``replicate`` of the JAX package
wrap GSPMD under ``jit`` and have no eager counterpart: a rank calls its
local function directly and :func:`all_gather_heads` is the replication
point.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["all_gather_heads", "all_gather_axis", "all_reduce_axis",
           "GlobalBatch", "tree_decode_attention", "ring_allgather_matmul",
           "allgather_bytes", "agree_status"]


def allgather_bytes(nbytes: float, degree: int) -> float:
    """Traffic one device moves all-gathering an ``nbytes`` global array
    sharded ``degree`` ways: each device receives the (degree-1) shards it
    doesn't hold."""
    return float(nbytes) * (degree - 1) / max(degree, 1)


def _on_axis(mesh: Any, axis: Any) -> Tuple[Any, int, int]:
    """(process group, size, this rank's index) of ``axis`` (one axis name
    or several); ``(None, 1, 0)`` for an axis of one rank."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    if math.prod(mesh.shape[a] for a in axes) == 1:
        return None, 1, 0
    return mesh.group(axis), mesh.axis_size(axis), mesh.axis_index(axis)


def _peer(group: Any, index: int) -> int:
    """The global rank of group rank ``index`` (point-to-point ops take it)."""
    return index if group is None else dist.get_global_rank(group, index)


# the HLO op name of each counted kind (tools/roofline.py prices them)
_OP = {"gathered": "all-gather", "reduced": "all-reduce"}


def _count(mesh: Any, kind: str, t: torch.Tensor, n: int) -> None:
    """Add a collective's result ``t`` over a group of ``n`` ranks to the
    mesh's counters: its bytes to ``mesh.traffic[kind]``, and one call and
    its bytes to ``mesh.collectives[(op, n)]`` (``op`` the HLO name,
    ``"all-gather"`` or ``"all-reduce"``), which the roofline's ring costs
    read (:func:`repro_torch.tools.roofline.collective_bytes_from_records`)."""
    nbytes = t.numel() * t.element_size()
    traffic = getattr(mesh, "traffic", None)
    if traffic is not None:
        traffic[kind] += nbytes
    records = getattr(mesh, "collectives", None)
    if records is not None:
        rec = records.setdefault((_OP[kind], n), [0, 0])
        rec[0] += 1
        rec[1] += nbytes


def all_gather_axis(x: torch.Tensor, mesh: Any, axis: Any, dim: int) -> torch.Tensor:
    """Every rank's ``x`` along ``axis`` concatenated along ``dim`` in the
    axis's rank order (``x`` itself when the axis has one rank)."""
    group, n, _ = _on_axis(mesh, axis)
    if n == 1:
        return x
    src = x.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    _count(mesh, "gathered", out, n)
    return out


def all_reduce_axis(x: torch.Tensor, mesh: Any, axis: Any,
                    op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``op`` of every rank's ``x`` along ``axis``, in a new tensor (``x``
    itself when the axis has one rank)."""
    group, n, _ = _on_axis(mesh, axis)
    if n == 1:
        return x
    buf = x.clone()
    dist.all_reduce(buf, op=op, group=group)
    _count(mesh, "reduced", buf, n)
    return buf


def all_gather_heads(x: torch.Tensor, mesh: Any, dim: int) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim`` in rank order over the
    "model" axis (the whole tensor on every rank; ``x`` itself when the
    axis has one rank)."""
    return all_gather_axis(x, mesh, "model", dim)


class GlobalBatch:
    """The data-parallel ranks of a ProcessMesh (its axes "pod" and "data";
    the ranks that share them hold the same rows), over which a training
    loss sums the terms of the global batch, so that a rank's loss share
    differentiates to its part of the single-device gradient.  Values only:
    nothing here carries a gradient."""

    def __init__(self, mesh: Any):
        from repro_torch.sharding.specs import data_axes
        self.mesh, self.axes = mesh, data_axes(mesh)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the data-parallel ranks."""
        if not self.axes:
            return x.detach()
        return all_reduce_axis(x.detach(), self.mesh, self.axes)

    def total_rows(self, n: int) -> int:
        """The global count of a per-rank count ``n`` that every data rank
        has the same of (its rows of an evenly split batch)."""
        return n * (self.mesh.axis_size(self.axes) if self.axes else 1)

    def before(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the sum of ``x`` over the lower data-parallel ranks, its sum over
        all of them), from one all-gather: the global rows of the batch are
        the ranks' rows in rank order."""
        x = x.detach()
        if not self.axes:
            return torch.zeros_like(x), x
        parts = all_gather_axis(x[None], self.mesh, self.axes, 0)
        idx = self.mesh.axis_index(self.axes)
        return parts[:idx].sum(0), parts.sum(0)


def agree_status(mesh: Any, code: int) -> int:
    """The largest of every rank's ``code`` (``all_reduce(MAX)`` of one
    integer): how a tensor-parallel engine agrees a tick's outcome."""
    dev = mesh.device if getattr(mesh, "backend", None) == "nccl" else torch.device("cpu")
    buf = torch.tensor([code], dtype=torch.int32, device=dev)
    dist.all_reduce(buf, op=dist.ReduceOp.MAX)
    return int(buf.item())


def tree_decode_attention(mesh: Any, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lengths: torch.Tensor, *, scale: Optional[float] = None,
                          axis: Any = "model", backend: str = "cuda") -> torch.Tensor:
    """q (B, Hq, D) whole on every rank; k / v (B, S / n, Hk, D) this rank's
    rows ``[rank * S / n, (rank + 1) * S / n)`` of the cache along ``axis``
    (one axis name or several); lengths (B,) the global valid counts.
    Returns (B, Hq, Dv) on every rank.

    A rank whose rows lie past a sequence's length has ``local_len`` 0: the
    port's partial (kernel and plain version) gives it acc 0, m -1e30 and
    l 0, which weighs 0 in the merge; a row that is empty on every rank
    gives 0, as ``flash_decode`` does.  (The JAX package's ``ref`` partial
    gives l = S there; the merged result agrees wherever a rank holds a
    valid row.)

    JAX's dtypes and formula (``repro.sharding.collectives``): acc comes in
    q's dtype and m, l in float32; m_glob, alpha, the l sum and the acc sum
    are float32, and the result is rounded once to q's dtype."""
    from repro_torch.kernels.ops import decode_attention_partial
    _, n, index = _on_axis(mesh, axis)
    s_loc = k.shape[1]
    local_len = (lengths.to(torch.int64) - index * s_loc).clamp(0, s_loc).to(torch.int32)
    acc, m, l = decode_attention_partial(q, k, v, local_len.to(q.device), scale=scale,
                                         backend=backend)
    m_glob = all_reduce_axis(m, mesh, axis, dist.ReduceOp.MAX)
    alpha = torch.exp(m - m_glob)
    l_part = all_reduce_axis(l * alpha, mesh, axis)
    acc_part = all_reduce_axis(acc.float() * alpha[..., None], mesh, axis)
    return (acc_part / torch.clamp(l_part, min=1e-30)[..., None]).to(q.dtype)


def ring_allgather_matmul(mesh: Any, x: torch.Tensor, w: torch.Tensor, *,
                          axis: str = "model") -> torch.Tensor:
    """``allgather(x, axis) @ w`` on every rank: x (M / n, K) this rank's
    rows, w (K, N) whole.  At step t a rank multiplies the chunk it holds —
    rank ``(rank - t) mod n``'s rows — while the chunk travels on to rank
    ``rank + 1`` (posted before the product, waited for after it)."""
    from repro_torch.kernels.gemm import gemm
    group, n, rank = _on_axis(mesh, axis)
    m_loc = x.shape[0]
    out = torch.empty((n, m_loc, w.shape[1]), dtype=torch.float32, device=x.device)
    # gloo takes no point-to-point op on CUDA tensors: send through the host
    staged = getattr(mesh, "backend", None) == "gloo" and x.device.type == "cuda"
    chunk = x.contiguous()
    for t in range(n):
        works, nxt = [], None
        if t + 1 < n:
            send = chunk.cpu() if staged else chunk
            nxt = torch.empty_like(send)
            works = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, send, _peer(group, (rank + 1) % n), group),
                dist.P2POp(dist.irecv, nxt, _peer(group, (rank - 1) % n), group)])
        out[(rank - t) % n] = gemm(chunk.float(), w.float())
        for work in works:
            work.wait()
        if nxt is not None:
            chunk = nxt.to(x.device) if staged else nxt
    return out.reshape(n * m_loc, w.shape[1]).to(x.dtype)
