"""Distributed serve-step factories: prefill and decode — counterpart of
:mod:`repro.runtime.serve`, on a
:class:`~repro_torch.launch.mesh.ProcessMesh` (one process a rank).

``make_decode_step`` is what the decode_* dry-run shapes lower: one new
token per sequence against the sharded KV cache.  Each rank holds the
slice of every cache leaf that :func:`repro_torch.sharding.specs.cache_specs`
gives its coordinates (what JAX's ``device_put`` onto the cache shardings
leaves on a device) and the batch rows of the data axes; the steps take the
**global** tokens, lengths and prompts, as JAX's jitted steps do, keep the
rank's rows and return the global logits on every rank (one all-gather
over the data axes).  Decode, leaf kind by leaf kind (:class:`ServeShard`
tells the layers which dims of their cache a rank holds):

* k / v with the KV heads over "model": the rank projects its query and
  KV heads only, attends over its heads and all-gathers the heads' outputs
  over "model" before ``wo``, as the tensor-parallel engine does;
* k / v (rolling window buffers included), ``ckv`` / ``kpe`` with the
  length over "model" (``seq_shard_fallback``: the KV heads do not divide
  "model") or over "data" (batch 1): the new row is written only on the
  rank that owns its slot, and attention is
  :func:`~repro_torch.sharding.collectives.tree_decode_attention` over that
  axis (each rank's partial over its rows — on the card the partial kernel,
  ``flash_decode_partial_f32`` or at bf16 ``flash_decode_partial_bf16``,
  whose acc is rounded to bf16 as JAX's partial rounds it — merged in fp32
  by an all-reduce(MAX) and two all-reduce(SUM));
* ``ssm`` and ``conv_x`` with the heads over "model": each rank steps its
  own heads and all-gathers the gated output before the norm (which spans
  the whole inner width);
* a leaf sharded along a dim no layer can serve sharded raises: nothing is
  replicated silently.

Prefill runs the rank's rows at full length and keeps the rank's slice of
each cache.  MoE layers route the rank's rows.  Under ``dispatch="global"``
with the rows split, they get a
:class:`~repro_torch.sharding.collectives.GlobalBatch` over the data axes,
as sharded training does: the capacity counts the global batch's tokens and
a token's position within its expert is offset by the lower data ranks'
counts, so the same tokens drop as in JAX's GSPMD step (one pool over the
global batch).  ``"local"`` dispatch pools per row and needs nothing more.

**Port-only design:** the params are whole on every rank (a rank's tree is
``gather_tree`` of its ``param_specs`` slices, gathered once), as sharded
training gathers them whole for its layers (ROADMAP N13); only the caches
and the batch are sharded.  So the steps' FLOPs a rank exceed JAX's
per-chip FLOPs wherever GSPMD splits a product over "model".
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.lowering import KERNEL_ROUTES
from repro_torch.sharding.collectives import GlobalBatch, all_gather_axis, tree_decode_attention
from repro_torch.sharding.specs import (P, _map_specs, cache_specs, data_axes, param_specs,
                                        shard_tree, spec_axes)

__all__ = ["make_prefill_step", "make_decode_step", "serve_shardings", "ServeShard"]

# the dims of each cache leaf (after a stack's period axis) a layer can
# serve sharded; dim 0, the batch, is the step's
_SERVABLE = {"k": (0, 1, 2), "v": (0, 1, 2), "ckv": (0, 1), "kpe": (0, 1),
             "ssm": (0, 1), "conv_x": (0, 2), "conv_B": (0,), "conv_C": (0,)}


class ServeShard:
    """Which dims of a block's cache leaves this rank holds a slice of: the
    cache spec tree of :func:`serve_shardings` walked down to one block
    (:meth:`child`), read by the decode layers through :meth:`split`,
    :meth:`heads`, :meth:`local_slot`, :meth:`attend` and
    :meth:`gather`."""

    def __init__(self, mesh: Any, specs: Any, lead: int = 0):
        self.mesh, self.specs, self.lead = mesh, specs, lead

    def child(self, *keys: Any) -> "ServeShard":
        specs, lead = self.specs, self.lead
        for k in keys:
            specs = specs[k]
            lead = max(lead, 1 if k == "period" else 0)
        return ServeShard(self.mesh, specs, lead)

    def axes(self, name: str, dim: int) -> Tuple[str, ...]:
        """The mesh axes dim ``dim`` of leaf ``name`` (period axis dropped)
        is split over; raises for a dim no layer serves sharded."""
        spec = tuple(self.specs[name])[self.lead:]
        for d, entry in enumerate(spec):
            if spec_axes(entry) and d not in _SERVABLE.get(name, ()):
                raise ValueError(f"cache leaf {name!r} is sharded on dim {d} ({P(*spec)}): "
                                 f"no decode step serves that sharded")
        return spec_axes(spec[dim]) if dim < len(spec) else ()

    def split(self, name: str, dim: int) -> Tuple[int, int]:
        """(n, i): dim ``dim`` of leaf ``name`` splits n ways and this rank
        holds block i."""
        axes = self.axes(name, dim)
        return self.mesh.block(axes, self.mesh.coords) if axes else (1, 0)

    def heads(self, name: str, hq: int, hk: int) -> Optional[Tuple[slice, slice]]:
        """The rank's (query heads, KV heads) when leaf ``name``'s head dim
        (dim 2) is sharded, else None."""
        n, i = self.split(name, 2)
        if n == 1:
            return None
        return slice(i * hq // n, (i + 1) * hq // n), slice(i * hk // n, (i + 1) * hk // n)

    def local_slot(self, name: str, slot: torch.Tensor, local_cap: int) -> torch.Tensor:
        """Global cache rows ``slot`` as rows of this rank's slice of the
        length dim (dim 1); a row another rank holds becomes ``local_cap``,
        which a write drops."""
        n, i = self.split(name, 1)
        if n == 1:
            return slot
        local = slot - i * local_cap
        return torch.where((local >= 0) & (local < local_cap), local,
                           torch.full_like(local, local_cap))

    def attend(self, q, k, v, lengths, name: str, *, scale=None, backend: str = "ref"):
        """Decode attention of ``q`` over this rank's cache rows ``k`` /
        ``v``: the tree decode over the length dim's axes when it is split
        (its partials on the partial kernel when ``backend`` launches
        kernels, else on the plain version), else ``decode_attention`` on
        ``backend``."""
        from repro_torch.kernels import ops as kops
        axes = self.axes(name, 1)
        if not axes:
            return kops.decode_attention(q, k, v, lengths, scale=scale, backend=backend)
        return tree_decode_attention(self.mesh, q, k, v, lengths, scale=scale, axis=axes,
                                     backend="cuda" if backend in KERNEL_ROUTES else "ref")

    def gather(self, x: torch.Tensor, name: str, dim: int, x_dim: int) -> torch.Tensor:
        """``x`` all-gathered along ``x_dim`` over the axes leaf ``name``'s
        dim ``dim`` is split over (``x`` itself when it is not)."""
        axes = self.axes(name, dim)
        return all_gather_axis(x, self.mesh, axes, x_dim) if axes else x


def serve_shardings(model, cfg: ArchConfig, mesh: Any, batch: int, cache_cap: int,
                    enc_len: int = 0, seq_shard_fallback: bool = True):
    """JAX's (param, cache) spec trees for ``mesh``, as :class:`P` trees;
    the shapes come from ``init_params`` / ``init_caches`` on fake tensors
    (nothing allocated).  The steps here take the params whole (the module
    docstring's port-only design); the param specs say how a rank's slices
    would lie."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        p_shape = model.init_params(0, device="cpu")
        c_shape = (model.init_caches(batch, cache_cap, enc_len, device="cpu") if enc_len
                   else model.init_caches(batch, cache_cap, device="cpu"))
    return (param_specs(p_shape, cfg, mesh),
            cache_specs(c_shape, cfg, mesh, batch, seq_shard_fallback=seq_shard_fallback))


def _row_axes(mesh: Any, batch: int) -> Tuple[str, ...]:
    """The data axes the batch rows split over (cache_specs' rule for dim 0)."""
    dp = data_axes(mesh)
    size = mesh.axis_size(dp) if dp else 1
    return dp if size > 1 and batch % size == 0 else ()


def _rows(x: torch.Tensor, mesh: Any, axes: Tuple[str, ...]) -> torch.Tensor:
    """This rank's rows of ``x`` (dim 0) over ``axes``."""
    if not axes:
        return x
    n, i = mesh.block(axes, mesh.coords)
    size = x.shape[0] // n
    return x[i * size:(i + 1) * size]


def _gather_rows(x: torch.Tensor, mesh: Any, axes: Tuple[str, ...]) -> torch.Tensor:
    return all_gather_axis(x, mesh, axes, 0) if axes else x


def _moe_batch(cfg: ArchConfig, mesh: Any, rows: Tuple[str, ...]) -> Optional[GlobalBatch]:
    """The global batch a global-dispatch MoE layer pools its capacity over
    when the rows are split (the module docstring), else None."""
    if rows and cfg.moe is not None and cfg.moe.dispatch == "global":
        return GlobalBatch(mesh)
    return None


def _without_rows(c_spec: Any) -> Any:
    """``c_spec`` with each leaf's batch entry replicated: the slicing left
    once a rank holds only its rows."""
    def drop(path, spec):
        lead = 1 if "period" in path else 0
        entries = list(spec)
        if len(entries) > lead:
            entries[lead] = None
        return P(*entries)
    return _map_specs(drop, c_spec)


def _check_mesh(mesh: Any, what: str) -> None:
    from repro_torch.launch.mesh import ProcessMesh
    if not isinstance(mesh, ProcessMesh):
        raise ValueError(f"{what}: {mesh!r} has no process group behind it; build it with "
                         f"repro_torch.launch.mesh.make_mesh (one process a rank)")


def make_decode_step(model, cfg: ArchConfig, mesh: Optional[Any] = None, batch: int = 1,
                     cache_cap: int = 1024, enc_len: int = 0,
                     seq_shard_fallback: bool = True) -> Callable:
    """(params, tokens (B,), caches, lengths (B,)) -> (logits (B, V),
    new_caches).  With ``mesh`` the caches are this rank's slices by
    :func:`serve_shardings` (and so are the new ones); tokens, lengths and
    logits are global."""
    def step(params, tokens, caches, lengths, shard=None, dp=None):
        if enc_len:
            return model.decode_step(params, tokens, caches, lengths,
                                     torch.full_like(lengths, enc_len), shard=shard, dp=dp)
        return model.decode_step(params, tokens, caches, lengths, shard=shard, dp=dp)

    if mesh is None:
        return step
    _check_mesh(mesh, "make_decode_step")
    _, c_spec = serve_shardings(model, cfg, mesh, batch, cache_cap, enc_len,
                                seq_shard_fallback=seq_shard_fallback)
    shard = ServeShard(mesh, c_spec)
    rows = _row_axes(mesh, batch)
    dp = _moe_batch(cfg, mesh, rows)

    def sharded(params, tokens, caches, lengths):
        logits, new = step(params, _rows(tokens, mesh, rows), caches,
                           _rows(lengths, mesh, rows), shard=shard, dp=dp)
        return _gather_rows(logits, mesh, rows), new

    return sharded


def make_prefill_step(model, cfg: ArchConfig, mesh: Optional[Any] = None, batch: int = 1,
                      seq: int = 1024, cache_cap: Optional[int] = None, enc_len: int = 0,
                      seq_shard_fallback: bool = True) -> Callable:
    """(params, inputs) -> (last_logits (B, V), caches, lengths (B,)).  With
    ``mesh`` the inputs are global, the caches this rank's slices by
    :func:`serve_shardings` (``enc_len`` the encoder length of an
    encoder-decoder's cross caches), the logits and lengths global."""
    cap = cache_cap or seq

    def step(params, inputs, dp=None):
        return model.prefill(params, inputs, cache_cap=cap, dp=dp)

    if mesh is None:
        return step
    _check_mesh(mesh, "make_prefill_step")
    _, c_spec = serve_shardings(model, cfg, mesh, batch, cap, enc_len,
                                seq_shard_fallback=seq_shard_fallback)
    local = _without_rows(c_spec)
    rows = _row_axes(mesh, batch)
    dp = _moe_batch(cfg, mesh, rows)

    def sharded(params, inputs: Dict[str, torch.Tensor]):
        logits, caches, lengths = step(params, {k: _rows(v, mesh, rows)
                                                for k, v in inputs.items()}, dp=dp)
        return (_gather_rows(logits, mesh, rows), shard_tree(caches, local, mesh),
                _gather_rows(lengths, mesh, rows))

    return sharded
