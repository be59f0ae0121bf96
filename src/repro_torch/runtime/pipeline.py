"""Pipeline parallelism over the "pod" axis (GPipe-style microbatching) —
counterpart of :mod:`repro.runtime.pipeline`, on ``torch.distributed``.

The multi-pod mesh maps "pod" to data-parallel by default (only gradient
all-reduces cross the DCN).  When activations are smaller than gradients —
long-seq training of narrow models — pipelining the pods is the better
trade: each pod owns a contiguous block of layers and only (microbatch,
seq, d_model) activations cross pods.

``pipeline_apply`` is the schedule primitive: stage s computes microbatch m
at tick t = s + m; activations hop stage -> stage + 1 each tick.  Bubble
fraction = (S-1)/(M+S-1), the GPipe bound.  One process a rank: a rank is
the stage at its coordinate along the axis (the ranks that differ on other
axes run pipelines of their own, in their own axis groups), and the hop is
one ``batch_isend_irecv`` a tick in the axis's group — the send to stage
s + 1 and the receive from stage s - 1 posted together, so no rank waits on
a rank that waits on it.  gloo takes no point-to-point op on CUDA tensors,
so over gloo the activations and the final broadcast go through host
memory: a transport detail, not a compute fallback.  The result is the
forward pass; no gradient crosses the hops.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.core.tree import tree_map

__all__ = ["pipeline_apply"]


def pipeline_apply(mesh: Any, stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x: torch.Tensor, *, axis: str = "pod") -> torch.Tensor:
    """Run ``n_stages = mesh.shape[axis]`` pipeline stages over microbatches
    (``mesh`` a :class:`~repro_torch.launch.mesh.ProcessMesh`).

    stage_params: tree whose leaves are stacked (n_stages, ...) — stage s
    uses leaf[s].
    x: (n_micro, mb, ...) microbatched input, the same on every rank.
    Returns (n_micro, mb, ...) outputs of the last stage on every rank."""
    group, n, s = mesh.group(axis), mesh.axis_size(axis), mesh.axis_index(axis)
    m, mb_shape = x.shape[0], x.shape[1:]
    params = tree_map(lambda a: a[s], stage_params)
    staged = mesh.backend == "gloo" and x.device.type == "cuda"
    host = torch.device("cpu") if staged else x.device
    outputs = torch.zeros((m, *mb_shape), dtype=x.dtype, device=host)
    inbox = None
    for t in range(m + n - 1):
        ops, recv = [], None
        if s <= t < s + m:                          # microbatch t - s is here
            act = stage_fn(params, x[t] if s == 0 else inbox)
            if s == n - 1:
                outputs[t - s] = act.to(host)
            else:
                ops.append(dist.P2POp(dist.isend, act.to(host).contiguous(),
                                      dist.get_global_rank(group, s + 1), group))
        if s > 0 and s - 1 <= t < s - 1 + m:        # stage s - 1 sends this tick
            recv = torch.empty(mb_shape, dtype=x.dtype, device=host)
            ops.append(dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, s - 1),
                                  group))
        for work in dist.batch_isend_irecv(ops) if ops else ():
            work.wait()
        if recv is not None:
            inbox = recv.to(x.device)
    dist.broadcast(outputs, src=dist.get_global_rank(group, n - 1), group=group)
    return outputs.to(x.device)
