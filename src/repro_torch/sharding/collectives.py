"""Collectives of tensor-parallel serving — counterpart of
:mod:`repro.sharding.collectives`, on ``torch.distributed``.

Every function takes the rank's own tensors and a mesh from
:func:`repro_torch.launch.mesh.make_serving_mesh` (one process a rank):

* :func:`all_gather_heads` — the exact all-gather that hands a head-sharded
  attention output back to the replicated rest of a Program: each rank's
  slice, gathered into a list (``dist.all_gather``) and concatenated in
  rank order.  Pure data movement, so bitwise exact.
* :func:`tree_decode_attention` — sequence-parallel decode: each rank holds
  its slice of the KV cache along the length dim, runs the partial kernel
  (``decode_attention_partial``; on the card ``flash_decode_partial_f32``
  of ``csrc/flash_decode.cu``) over it and the ranks combine with an
  ``all_reduce(MAX)`` and two ``all_reduce(SUM)`` — exact up to the order
  of float additions.
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

from typing import Any, Optional

import torch
import torch.distributed as dist

__all__ = ["all_gather_heads", "all_reduce", "tree_decode_attention",
           "ring_allgather_matmul", "allgather_bytes", "agree_status"]


def allgather_bytes(nbytes: float, degree: int) -> float:
    """Traffic one device moves all-gathering an ``nbytes`` global array
    sharded ``degree`` ways: each device receives the (degree-1) shards it
    doesn't hold."""
    return float(nbytes) * (degree - 1) / max(degree, 1)


def all_gather_heads(x: torch.Tensor, mesh: Any, dim: int) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim`` in rank order (the
    whole tensor on every rank; ``x`` itself when the mesh has one rank)."""
    tp = mesh.shape["model"]
    if tp == 1:
        return x
    src = x.contiguous()
    parts = [torch.empty_like(src) for _ in range(tp)]
    dist.all_gather(parts, src)
    return torch.cat(parts, dim=dim)


def all_reduce(x: torch.Tensor, op) -> torch.Tensor:
    """``op`` of every rank's ``x`` over the default process group, in a
    new tensor (``x`` is left as it is)."""
    buf = x.clone()
    dist.all_reduce(buf, op=op)
    return buf


def agree_status(mesh: Any, code: int) -> int:
    """The largest of every rank's ``code`` (``all_reduce(MAX)`` of one
    integer): how a tensor-parallel engine agrees a tick's outcome."""
    dev = mesh.device if getattr(mesh, "backend", None) == "nccl" else torch.device("cpu")
    buf = torch.tensor([code], dtype=torch.int32, device=dev)
    dist.all_reduce(buf, op=dist.ReduceOp.MAX)
    return int(buf.item())


def tree_decode_attention(mesh: Any, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lengths: torch.Tensor, *, scale: Optional[float] = None,
                          axis: str = "model", backend: str = "cuda") -> torch.Tensor:
    """q (B, Hq, D) whole on every rank; k / v (B, S / n, Hk, D) this rank's
    rows ``[rank * S / n, (rank + 1) * S / n)`` of the cache; lengths (B,)
    the global valid counts.  Returns (B, Hq, Dv) on every rank.

    A rank whose rows lie past a sequence's length has ``local_len`` 0: the
    port's partial (kernel and plain version) gives it acc 0, m -1e30 and
    l 0, which weighs 0 in the merge; a row that is empty on every rank
    gives 0, as ``flash_decode`` does.  (The JAX package's ``ref`` partial
    gives l = S there; the merged result agrees wherever a rank holds a
    valid row.)"""
    from repro_torch.kernels.ops import decode_attention_partial
    n = mesh.shape[axis]
    s_loc = k.shape[1]
    offset = mesh.rank * s_loc if n > 1 else 0
    local_len = (lengths.to(torch.int64) - offset).clamp(0, s_loc).to(torch.int32)
    acc, m, l = decode_attention_partial(q, k, v, local_len.to(q.device), scale=scale,
                                         backend=backend)
    if n == 1:
        m_glob = m
    else:
        m_glob = all_reduce(m, dist.ReduceOp.MAX)
    alpha = torch.exp(m - m_glob)
    l_part, acc_part = l * alpha, acc.float() * alpha[..., None]
    if n > 1:
        l_part = all_reduce(l_part, dist.ReduceOp.SUM)
        acc_part = all_reduce(acc_part, dist.ReduceOp.SUM)
    return (acc_part / torch.clamp(l_part, min=1e-30)[..., None]).to(q.dtype)


def ring_allgather_matmul(mesh: Any, x: torch.Tensor, w: torch.Tensor, *,
                          axis: str = "model") -> torch.Tensor:
    """``allgather(x, axis) @ w`` on every rank: x (M / n, K) this rank's
    rows, w (K, N) whole.  At step t a rank multiplies the chunk it holds —
    rank ``(rank - t) mod n``'s rows — while the chunk travels on to rank
    ``rank + 1`` (posted before the product, waited for after it)."""
    from repro_torch.kernels.gemm import gemm
    n = mesh.shape[axis]
    rank = mesh.rank if n > 1 else 0
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
                dist.P2POp(dist.isend, send, (rank + 1) % n),
                dist.P2POp(dist.irecv, nxt, (rank - 1) % n)])
        out[(rank - t) % n] = gemm(chunk.float(), w.float())
        for work in works:
            work.wait()
        if nxt is not None:
            chunk = nxt.to(x.device) if staged else nxt
    return out.reshape(n * m_loc, w.shape[1]).to(x.dtype)
