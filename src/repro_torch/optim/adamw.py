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

ZeRO-1 (``update(..., mesh=, param_specs=, moment_specs=)``, the sharded
step): each rank holds the slice of every leaf that the specs give its
coordinates on a :class:`~repro_torch.launch.mesh.ProcessMesh`.  The grads
and params are its "model" slices (the grads already summed over the data
ranks); ``mu``, ``nu`` and ``master`` are those slices split once more over
"data" along the dim :func:`repro_torch.sharding.specs.opt_state_specs`
picks.  The rank updates its moment slice with the same elementwise
arithmetic and all-gathers the fresh param slice over "data".
:func:`global_norm` over shards all-reduces over "model" the sums of squares
of the model-sharded leaves and counts each replicated leaf once, so the
norm, and the clip scale, are the same on every rank.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.sharding.collectives import all_gather_axis, all_reduce_axis
from repro_torch.sharding.specs import spec_axes, spec_leaves

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


def _model_sharded(spec) -> bool:
    return any("model" in spec_axes(e) for e in spec)


def global_norm(tree: Params, mesh: Any = None, specs: Any = None) -> torch.Tensor:
    """The L2 norm over every leaf; with ``mesh`` and ``specs`` of a tree
    of this rank's slices, the whole tree's (see the module docstring)."""
    sums = [torch.sum(torch.square(x.to(torch.float32))) for x in tree_leaves(tree)]
    if not sums:
        return torch.zeros((), dtype=torch.float32)
    if mesh is not None:
        sharded = [_model_sharded(sp) for sp in spec_leaves(tree, specs)]
        if any(sharded):
            part = all_reduce_axis(torch.stack([s * sh for s, sh in zip(sums, sharded)]),
                                   mesh, "model")
            sums = [part[i] if sh else s for i, (s, sh) in enumerate(zip(sums, sharded))]
    total = sums[0]
    for s in sums[1:]:
        total = total + s
    return torch.sqrt(total)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(float(x), dtype=torch.float32, device=like.device)


def _adam(g, mu, nu, master, scale, b1c, b2c, lr, cfg: AdamWConfig):
    """(new mu, new nu, new master) of one leaf, elementwise."""
    g = g.to(torch.float32) * scale
    mu_n = cfg.b1 * mu + (1.0 - cfg.b1) * g
    nu_n = cfg.b2 * nu + (1.0 - cfg.b2) * g * g
    mhat = mu_n / b1c
    nhat = nu_n / b2c
    m32 = master.to(torch.float32)
    step_v = mhat / (torch.sqrt(nhat) + cfg.eps) + cfg.weight_decay * m32
    return mu_n, nu_n, m32 - lr * step_v


def _zero_dim(spec) -> Optional[int]:
    """The dim a moment spec splits over "data" (ZeRO-1), if any."""
    return next((d for d, e in enumerate(spec) if "data" in spec_axes(e)), None)


def update(grads: Params, state: State, params: Params, cfg: AdamWConfig, *,
           inplace: bool = False, mesh: Any = None, param_specs: Any = None,
           moment_specs: Any = None) -> Tuple[Params, State, Dict[str, torch.Tensor]]:
    """One AdamW step -> (new_params, new_state, {"grad_norm", "lr"}).  With
    ``inplace`` the returned trees are ``params`` and ``state``, updated.
    With ``mesh`` the trees are this rank's slices (ZeRO-1, the module
    docstring)."""
    step = state["step"] + 1
    lr = cfg.schedule(step) if cfg.schedule is not None else cfg.lr

    gnorm = global_norm(grads, mesh, param_specs).to(step.device)
    if cfg.grad_clip:
        scale = torch.clamp(_f32(cfg.grad_clip, gnorm) / torch.clamp(gnorm, min=1e-9), max=1.0)
    else:
        scale = _f32(1.0, gnorm)

    one = _f32(1.0, step)
    b1c = one - torch.pow(_f32(cfg.b1, step), step.to(torch.float32))
    b2c = one - torch.pow(_f32(cfg.b2, step), step.to(torch.float32))

    masters = state.get("master", params)
    zero_dims = ([None] * len(tree_leaves(params)) if mesh is None else
                 [_zero_dim(sp) for sp in spec_leaves(params, moment_specs)])

    def upd(g, mu, nu, master, p, dim):
        if dim is not None:                 # this rank's ZeRO-1 slice of g (and p)
            n, i = mesh.shape["data"], mesh.coords["data"]
            size = g.shape[dim] // n
            g = g.narrow(dim, i * size, size)
            if master is p:
                master = p.narrow(dim, i * size, size)
        mu_n, nu_n, new_master = _adam(g, mu, nu, master, scale, b1c, b2c, lr, cfg)
        if inplace and dim is None:
            new_p = new_master              # copied into p below; nothing keeps it
        else:
            # the new params never alias the new master (f32 params cast to f32)
            new_p = new_master.to(p.dtype, copy=True)
            if dim is not None:
                new_p = all_gather_axis(new_p, mesh, "data", dim)
        if inplace:
            mu.copy_(mu_n)
            nu.copy_(nu_n)
            if "master" in state:
                master.copy_(new_master)
            p.copy_(new_p)
            return mu, nu, master, p
        return mu_n, nu_n, new_master, new_p

    with torch.no_grad():
        flat = [upd(*xs) for xs in zip(*(tree_leaves(t) for t in (
            grads, state["mu"], state["nu"], masters, params)), zero_dims)]
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
