"""Train-step factory — counterpart of :mod:`repro.runtime.train`, on one
device.

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

The mesh half of training — ``train_state_shardings`` and
``make_train_step(mesh=...)`` with TP on "model", DP over "data" and
ZeRO-1 moments — is ROADMAP Queue 1 item 13f-ii; a mesh raises here.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import to_tensor
from repro_torch.core.tree import tree_leaves, tree_unflatten
from repro_torch.models.lm import check_trainable
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig

__all__ = ["make_train_step", "value_and_grad"]


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


def value_and_grad(model, params, batch: Dict[str, Any], **loss_kw):
    """(loss, metrics, grads) of ``model.train_loss(params, batch,
    **loss_kw)``, deterministic, with ``grads`` a tree like ``params`` (a
    zero gradient where the loss does not reach a leaf, as in JAX).  The
    batch's arrays go to the params' device."""
    leaves = tree_leaves(params)
    dev = leaves[0].device
    batch = {k: to_tensor(v, dev) for k, v in batch.items()}
    with _deterministic():
        diff = [x.detach().requires_grad_(True) for x in leaves]
        with torch.enable_grad():
            loss, metrics = model.train_loss(tree_unflatten(params, diff), batch, **loss_kw)
            grads = torch.autograd.grad(loss, diff, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_unflatten(params, grads)


def make_train_step(model, cfg: ArchConfig, opt_cfg: AdamWConfig,
                    mesh: Optional[Any] = None,
                    batch_example: Optional[Dict[str, Any]] = None,
                    donate: bool = True) -> Callable:
    """Build the step (see the module docstring).  ``cfg`` must put every op
    on a backend with a backward pass; ``batch_example`` is for the mesh
    half, as in JAX."""
    if mesh is not None:
        raise NotImplementedError(
            "make_train_step(mesh=...): sharded training (TP on 'model', DP over 'data', "
            "ZeRO-1 moments) is ROADMAP Queue 1 item 13f-ii; the port trains on one device")
    check_trainable(cfg)

    def step(params, opt_state, batch):
        loss, metrics, grads = value_and_grad(model, params, batch)
        new_params, new_opt, opt_metrics = adamw.update(grads, opt_state, params, opt_cfg,
                                                        inplace=donate)
        return new_params, new_opt, {**metrics, **opt_metrics, "loss": loss}

    return step
