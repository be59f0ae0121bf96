"""Train-step factory — counterpart of :mod:`repro.runtime.train`.

``make_train_step`` builds

    step(params, opt_state, batch) -> (params, opt_state, metrics)

with JAX's metrics (``ce``, ``aux``, ``grad_norm``, ``lr``, ``loss``, each
a 0-d tensor): the loss of ``model.train_loss`` differentiated by
``torch.autograd`` with respect to every leaf of ``params`` (the trainable
tree, :func:`repro_torch.models.lm.strip_derived`; a leaf the loss does
not reach gets a zero gradient, as in JAX), then one
:func:`repro_torch.optim.adamw.update`.

``donate=False`` leaves its inputs untouched and returns new trees;
``donate=True`` (JAX's donated buffers) writes the new params and
optimizer state into the input tensors and returns them, so a step holds
no second copy of the state.  Both give the same bits.

The step is deterministic: its forward and backward passes
(:func:`value_and_grad`) run under
``torch.use_deterministic_algorithms(True)``, so the backward passes of
the gathers (the embedding rows, the MoE dispatch, the CE's label picks)
sum with the sort-based kernels instead of float atomics, and the same
step on the same inputs gives the same bits on the card (a resumed run
repeats the uninterrupted one).  The mode is restored when the step
returns.  cuBLAS products on one stream are deterministic; the mode's
warning that it cannot vouch for them without ``CUBLAS_WORKSPACE_CONFIG``
is the one it is allowed to give (``warn_only``), and is silenced.

**On a mesh** (``make_train_step(mesh=..., batch_example=...)``, ``mesh`` a
:class:`~repro_torch.launch.mesh.ProcessMesh` of
:func:`~repro_torch.launch.mesh.make_mesh`, one process a rank): every
state leaf on a rank holds exactly the slice that JAX's spec
(:func:`train_state_shardings`) gives the rank's coordinates — params by
``param_specs`` (Megatron column / row and experts on "model", replicated
where a dim does not divide), ``master`` / ``mu`` / ``nu`` by
``opt_state_specs`` (ZeRO-1: one more dim over "data").  The step takes the
**global** batch, as JAX's does, and keeps the rows ``batch_specs`` give
the rank; then:

1. it gathers its params over "model" through one ``torch.autograd.Function``
   whose backward keeps the rank's slice of the incoming gradient and does
   not sum it: the ranks that share a data coordinate see the same rows, so
   their full gradients are equal;
2. it runs ``train_loss`` on its rows with the whole weights, on the global
   batch's terms (:class:`~repro_torch.sharding.collectives.GlobalBatch`:
   the CE over the global valid-label count, the MoE router's terms over
   the global batch), so each rank's loss is its share;
3. it all-reduces the grad slices (SUM) over the data axes, which makes
   them the single-device gradients' slices;
4. AdamW updates its ZeRO-1 slice of ``master``, ``mu`` and ``nu`` and
   all-gathers the fresh param slice over "data"
   (:func:`repro_torch.optim.adamw.update`).

The metrics are the global batch's and equal on every rank.  The layers
run as on one device: the whole weights live on each rank during its step,
and the memory saved is the state's.  GSPMD's split of the products over
"model" is a speed property of XLA's partitioner, not of the step's
result, and is not reproduced.  A mesh with no process group behind it
(``make_test_mesh``) raises.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import to_tensor
from repro_torch.core.tree import tree_leaves, tree_unflatten
from repro_torch.launch.mesh import ProcessMesh
from repro_torch.models.lm import check_trainable, strip_derived
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.sharding.collectives import GlobalBatch, all_gather_axis, all_reduce_axis
from repro_torch.sharding.specs import (P, batch_specs, opt_state_specs, param_specs,
                                        shard_tree, spec_axes, spec_leaves)

__all__ = ["make_train_step", "train_state_shardings", "value_and_grad"]


@contextlib.contextmanager
def _deterministic():
    """``torch.use_deterministic_algorithms(True)`` for the block, then the
    caller's mode again."""
    was = torch.are_deterministic_algorithms_enabled()
    was_warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*CuBLAS.*")
            yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=was_warn)


class _GatherModel(torch.autograd.Function):
    """Forward: the param slice all-gathered over "model" along ``dims``.
    Backward: the rank's slice of the incoming gradient, not summed."""

    @staticmethod
    def forward(ctx, x, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        for d in dims:
            x = all_gather_axis(x, mesh, "model", d)
        return x

    @staticmethod
    def backward(ctx, g):
        n, i = ctx.mesh.axis_size("model"), ctx.mesh.axis_index("model")
        for d in ctx.dims:
            size = g.shape[d] // n
            g = g.narrow(d, i * size, size)
        return g.clone(memory_format=torch.contiguous_format), None, None


def _gather_dims(spec) -> tuple:
    """The dims a param spec shards (over "model", the only axis the
    param rules use: see _GatherModel's backward)."""
    dims = tuple(d for d, e in enumerate(spec) if spec_axes(e))
    if any(set(spec_axes(spec[d])) != {"model"} for d in dims):
        raise ValueError(f"param spec {spec}: a param may shard over 'model' only")
    return dims


def value_and_grad(model, params, batch: Dict[str, Any], *, mesh: Any = None,
                   specs: Any = None, **loss_kw):
    """(loss, metrics, grads) of ``model.train_loss(params, batch,
    **loss_kw)``, deterministic, with ``grads`` a tree like ``params`` (a
    zero gradient where the loss does not reach a leaf, as in JAX).  The
    batch's arrays go to the params' device.

    With ``mesh`` (a ProcessMesh) ``params`` is this rank's tree of slices
    by the param ``specs``, ``batch`` the global batch: the loss and metrics
    are the global batch's and ``grads`` this rank's slices of the
    single-device gradients (steps 1-3 of the module docstring)."""
    leaves = tree_leaves(params)
    dev = leaves[0].device
    batch = {k: to_tensor(v, dev) for k, v in batch.items()}
    dp = None
    if mesh is not None:
        dp = GlobalBatch(mesh)
        b_spec = batch_specs(batch, mesh)
        if dp.axes and mesh.axis_size(dp.axes) > 1 and any(s == P() for s in b_spec.values()):
            raise ValueError(f"the global batch's rows must split over the data axes "
                             f"{dp.axes} ({mesh.axis_size(dp.axes)} ranks): {b_spec}")
        batch = shard_tree(batch, b_spec, mesh)
        loss_kw["dp"] = dp
        dims = [_gather_dims(sp) for sp in spec_leaves(params, specs)]
    with _deterministic():
        diff = [x.detach().requires_grad_(True) for x in leaves]
        with torch.enable_grad():
            full = diff if mesh is None else [
                _GatherModel.apply(x, mesh, d) if d else x for x, d in zip(diff, dims)]
            loss, metrics = model.train_loss(tree_unflatten(params, full), batch, **loss_kw)
            grads = torch.autograd.grad(loss, diff, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    loss = loss.detach()
    if dp is not None and dp.axes:
        grads = [all_reduce_axis(g, mesh, dp.axes) for g in grads]
        loss = dp.sum(loss)
    return loss, metrics, tree_unflatten(params, grads)


def train_state_shardings(model, cfg: ArchConfig, mesh: Any, batch_example: Dict[str, Any],
                          opt_cfg: AdamWConfig):
    """JAX's ``(param, opt, batch)`` spec trees for ``mesh``, as :class:`P`
    trees: params by ``param_specs``, ``mu`` / ``nu`` / ``master`` by
    ``opt_state_specs`` (ZeRO-1), ``step`` replicated, the batch by
    ``batch_specs``.  The param shapes come from ``model.init_params`` run
    on fake tensors: nothing is allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        p_shape = strip_derived(model.init_params(0, device="cpu"))
    p_spec = param_specs(p_shape, cfg, mesh)
    m_spec = opt_state_specs(p_shape, p_spec, mesh)
    o_spec = {"step": P(), "mu": m_spec, "nu": m_spec}
    if opt_cfg.master_fp32:
        o_spec["master"] = m_spec
    return p_spec, o_spec, batch_specs(batch_example, mesh)


def make_train_step(model, cfg: ArchConfig, opt_cfg: AdamWConfig,
                    mesh: Optional[Any] = None,
                    batch_example: Optional[Dict[str, Any]] = None,
                    donate: bool = True) -> Callable:
    """Build the step (see the module docstring).  ``cfg`` must put every op
    on a backend with a backward pass.  With ``mesh`` the step's trees are
    this rank's slices by :func:`train_state_shardings` (its batch the
    global batch), and ``batch_example`` gives the batch's shapes."""
    check_trainable(cfg)
    sharded: Dict[str, Any] = {}
    if mesh is not None:
        if not isinstance(mesh, ProcessMesh):
            raise ValueError(f"make_train_step: {mesh!r} has no process group behind it; build "
                             f"it with repro_torch.launch.mesh.make_mesh (one process a rank)")
        if batch_example is None:
            raise ValueError("make_train_step(mesh=...) needs batch_example, as JAX's does")
        p_spec, o_spec, _ = train_state_shardings(model, cfg, mesh, batch_example, opt_cfg)
        sharded = {"mesh": mesh, "param_specs": p_spec, "moment_specs": o_spec["mu"]}

    def step(params, opt_state, batch):
        loss, metrics, grads = value_and_grad(model, params, batch, mesh=mesh,
                                              specs=sharded.get("param_specs"))
        new_params, new_opt, opt_metrics = adamw.update(grads, opt_state, params, opt_cfg,
                                                        inplace=donate, **sharded)
        return new_params, new_opt, {**metrics, **opt_metrics, "loss": loss}

    return step
