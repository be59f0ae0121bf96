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
so over gloo the activations, their gradients and the final broadcast go
through host memory: a transport detail, not a compute fallback.

**The backward pass.**  The result is differentiable with respect to
``x`` and every leaf of ``stage_params``, as JAX's is.  Three autograd
Functions carry it, chained by a zero-size token so that each rank's
backward runs the hops in reverse tick order, whatever gradients the
caller asks for:

* ``_Start`` begins the chain; its backward broadcasts stage 0's gradient
  of ``x`` to every stage (only stage 0 reads ``x``);
* ``_Hop``, one a tick, is the tick's send and receive; its backward posts
  the reverse pair in one ``batch_isend_irecv``: the gradient of what it
  received goes to stage s - 1, and the gradient of what it sent comes from
  stage s + 1;
* ``_Broadcast`` hands the last stage's outputs to every stage.

**Convention:** the output is one replicated value, so every rank is
expected to backpropagate the same (replicated) loss of it.  The
broadcast's backward keeps the last stage's copy of the incoming gradient
and drops the other stages' copies; it does not sum them, which would make
the gradient ``n_stages`` times too large.  So each rank's gradient of its
stage's params (the slice ``leaf[s]``; the other slices get zero) and of
``x`` (the same on every rank) is the gradient of that loss, as
``jax.grad`` gives it.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

from repro_torch.core.tree import tree_leaves, tree_unflatten

__all__ = ["pipeline_apply"]


class _Link:
    """The stage's place in its pipeline: the axis group, the stage count
    ``n``, this stage ``s``, and the device transfers go through."""

    def __init__(self, mesh: Any, axis: str, device: torch.device):
        self.group, self.n, self.s = mesh.group(axis), mesh.axis_size(axis), mesh.axis_index(axis)
        self.device = device
        staged = mesh.backend == "gloo" and device.type == "cuda"
        self.host = torch.device("cpu") if staged else device

    def peer(self, stage: int) -> int:
        return dist.get_global_rank(self.group, stage)

    def exchange(self, send: Optional[torch.Tensor], to: int,
                 recv_like: Optional[torch.Tensor], frm: int) -> Optional[torch.Tensor]:
        """Send ``send`` to stage ``to`` and receive a tensor shaped like
        ``recv_like`` from stage ``frm``, both posted in one batch."""
        ops, recv = [], None
        if send is not None:
            ops.append(dist.P2POp(dist.isend, send.to(self.host).contiguous(), self.peer(to),
                                  self.group))
        if recv_like is not None:
            recv = torch.empty(recv_like.shape, dtype=recv_like.dtype, device=self.host)
            ops.append(dist.P2POp(dist.irecv, recv, self.peer(frm), self.group))
        for work in dist.batch_isend_irecv(ops) if ops else ():
            work.wait()
        return None if recv is None else recv.to(self.device)

    def broadcast(self, x: torch.Tensor, src: int) -> torch.Tensor:
        buf = x.to(self.host).contiguous()
        dist.broadcast(buf, src=self.peer(src), group=self.group)
        return buf.to(self.device)


class _Start(torch.autograd.Function):
    """Forward: ``x`` and the token that chains the hops.  Backward: stage
    0's gradient of ``x``, broadcast to every stage."""

    @staticmethod
    def forward(ctx, x, link, *params):
        ctx.link = link
        return x.view_as(x), x.new_zeros((0,))

    @staticmethod
    def backward(ctx, g_x, _g_token):
        link = ctx.link
        g = link.broadcast(g_x, 0) if ctx.needs_input_grad[0] else None
        return (g, None) + (None,) * (len(ctx.needs_input_grad) - 2)


class _Hop(torch.autograd.Function):
    """One tick's hop: ``act`` (or None) to stage s + 1, a tensor shaped
    like ``recv_like`` (or None) from stage s - 1.  Backward: the reverse
    pair, posted together."""

    @staticmethod
    def forward(ctx, token, act, link, recv_like):
        ctx.link = link
        ctx.act_meta = None if act is None else torch.empty(act.shape, dtype=act.dtype,
                                                            device="meta")
        recv = link.exchange(act, link.s + 1, recv_like, link.s - 1)
        return token.view_as(token), recv

    @staticmethod
    def backward(ctx, g_token, g_recv):
        link = ctx.link
        g_act = link.exchange(g_recv, link.s - 1, ctx.act_meta, link.s + 1)
        return g_token, g_act, None, None


class _Broadcast(torch.autograd.Function):
    """Forward: the last stage's ``outputs`` on every stage.  Backward: the
    last stage keeps its incoming gradient, the others drop theirs (the
    module docstring's convention)."""

    @staticmethod
    def forward(ctx, token, outputs, link):
        ctx.link = link
        return link.broadcast(outputs, link.n - 1)

    @staticmethod
    def backward(ctx, g):
        last = ctx.link.s == ctx.link.n - 1
        return g.new_zeros((0,)), (g if last else None), None


def pipeline_apply(mesh: Any, stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x: torch.Tensor, *, axis: str = "pod") -> torch.Tensor:
    """Run ``n_stages = mesh.shape[axis]`` pipeline stages over microbatches
    (``mesh`` a :class:`~repro_torch.launch.mesh.ProcessMesh`).

    stage_params: tree whose leaves are stacked (n_stages, ...) — stage s
    uses leaf[s].
    x: (n_micro, mb, ...) microbatched input, the same on every rank.
    Returns (n_micro, mb, ...) outputs of the last stage on every rank,
    differentiable (the module docstring's convention)."""
    link = _Link(mesh, axis, x.device)
    n, s = link.n, link.s
    m = x.shape[0]
    leaves = tree_leaves(stage_params)
    mine = [a[s] for a in leaves]
    params = tree_unflatten(stage_params, mine)
    x, token = _Start.apply(x, link, *mine)
    mb_like = torch.empty(x.shape[1:], dtype=x.dtype, device="meta")
    banked: List[torch.Tensor] = []
    inbox = None
    for t in range(m + n - 1):
        act = None
        if s <= t < s + m:                          # microbatch t - s is here
            act = stage_fn(params, x[t] if s == 0 else inbox)
            if s == n - 1:
                banked.append(act)
                act = None
        receives = s > 0 and s - 1 <= t < s - 1 + m  # stage s - 1 sends this tick
        if act is not None or receives:
            token, inbox = _Hop.apply(token, act, link, mb_like if receives else None)
    outputs = torch.stack(banked) if banked else x.new_zeros(x.shape)
    return _Broadcast.apply(token, outputs, link)
