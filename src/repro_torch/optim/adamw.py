"""AdamW from scratch, with mixed-precision master params — counterpart of
:mod:`repro.optim.adamw`.

State layout, JAX's: ``{"step", "mu", "nu", "master"}``: ``step`` a 0-d
int32 tensor, ``mu`` / ``nu`` the f32 moments, ``master`` (with
``master_fp32``) f32 copies of the params, which the update reads and the
params are cast from.  ``master`` is a copy even where the params are f32
already: an in-place update through a master that aliased its param would
apply the step twice.

The arithmetic is JAX's, in float32 tensors on the params' device: the
bias corrections from the step tensor, the clip scale as ``min(1, clip /
max(norm, 1e-9))`` (1 when ``grad_clip`` is 0), and every division by a
tensor on that device (CUDA divides by a CPU scalar as a product with its
reciprocal).  :func:`global_norm` adds the per-leaf sums of squares in
``jax.tree.leaves`` order; each leaf's own sum is a library reduction in
another order than ``jnp.sum``'s, so the port agrees with JAX within a
tolerance, not bit for bit (tests/test_torch_optim.py states it).

``update(..., inplace=True)`` writes the new moments, masters, step and
params into the tensors it was given (the donated step of
:func:`repro_torch.runtime.train.make_train_step`), with the same
arithmetic as the functional update, so the two give the same bits.
ZeRO-1 sharding of the moments comes with the mesh half of training
(ROADMAP Queue 1 item 13f-ii).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["AdamWConfig", "init", "global_norm", "update"]

Params = Any
State = Dict[str, Any]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    master_fp32: bool = True
    schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None  # step -> lr


def init(params: Params, cfg: AdamWConfig) -> State:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    f32 = lambda p: torch.zeros_like(p, dtype=torch.float32)
    state: State = {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "mu": tree_map(f32, params),
        "nu": tree_map(f32, params),
    }
    if cfg.master_fp32:
        state["master"] = tree_map(lambda p: p.detach().to(torch.float32, copy=True), params)
    return state


def global_norm(tree: Params) -> torch.Tensor:
    total = None
    for x in tree_leaves(tree):
        s = torch.sum(torch.square(x.to(torch.float32)))
        total = s if total is None else total + s
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(total)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(float(x), dtype=torch.float32, device=like.device)


def update(grads: Params, state: State, params: Params, cfg: AdamWConfig, *,
           inplace: bool = False) -> Tuple[Params, State, Dict[str, torch.Tensor]]:
    """One AdamW step -> (new_params, new_state, {"grad_norm", "lr"}).  With
    ``inplace`` the returned trees are ``params`` and ``state``, updated."""
    step = state["step"] + 1
    lr = cfg.schedule(step) if cfg.schedule is not None else cfg.lr

    gnorm = global_norm(grads).to(step.device)
    if cfg.grad_clip:
        scale = torch.clamp(_f32(cfg.grad_clip, gnorm) / torch.clamp(gnorm, min=1e-9), max=1.0)
    else:
        scale = _f32(1.0, gnorm)

    one = _f32(1.0, step)
    b1c = one - torch.pow(_f32(cfg.b1, step), step.to(torch.float32))
    b2c = one - torch.pow(_f32(cfg.b2, step), step.to(torch.float32))

    masters = state.get("master", params)

    def upd(g, mu, nu, master, p):
        g = g.to(torch.float32) * scale
        mu_n = cfg.b1 * mu + (1.0 - cfg.b1) * g
        nu_n = cfg.b2 * nu + (1.0 - cfg.b2) * g * g
        mhat = mu_n / b1c
        nhat = nu_n / b2c
        m32 = master.to(torch.float32)
        step_v = mhat / (torch.sqrt(nhat) + cfg.eps) + cfg.weight_decay * m32
        new_master = m32 - lr * step_v
        if inplace:
            mu.copy_(mu_n)
            nu.copy_(nu_n)
            if master is not p:
                master.copy_(new_master)
            p.copy_(new_master)
            return mu, nu, master, p
        # the new params never alias the new master (f32 params cast to f32)
        return mu_n, nu_n, new_master, new_master.to(p.dtype, copy=True)

    with torch.no_grad():
        flat = [upd(*xs) for xs in zip(*(tree_leaves(t) for t in (
            grads, state["mu"], state["nu"], masters, params)))]
        if inplace:
            state["step"].copy_(step)
    metrics = {"grad_norm": gnorm,
               "lr": lr.to(torch.float32) if torch.is_tensor(lr) else _f32(lr, step)}
    if inplace:
        return params, state, metrics
    pick = lambda i: tree_unflatten(params, [t[i] for t in flat])
    new_state: State = {"step": step, "mu": pick(0), "nu": pick(1)}
    if "master" in state:
        new_state["master"] = pick(2)
    return pick(3), new_state, metrics
