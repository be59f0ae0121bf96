"""Per-architecture partition rules (DP / TP / EP / SP) — counterpart of
:mod:`repro.sharding.specs`, rule for rule.

A "mesh" here is anything with ``axis_names`` and ``shape`` (a mapping from
axis name to size): the serving mesh of :mod:`repro_torch.launch.mesh`, the
2-D layout of ``make_test_mesh`` or a ``types.SimpleNamespace``.  The rules
read nothing else, so they need no process group.  A spec is a :class:`P`,
a tuple of per-dimension entries (``None``, an axis name or a tuple of axis
names), whose JSON form (:func:`partition_spec_to_json`) is the one an OXF
bundle's ``program.json`` records.

``param_specs`` walks a nested dict (or list) of arrays or shapes by key
path and assigns a spec per leaf from name-based rules, guarded by
divisibility against the mesh (a dim that does not divide falls back to
replication).

Megatron pattern for transformer blocks:
  wq/wk/wv, w_gate/w_up  column-parallel  P(None, "model")
  wo, w_down             row-parallel     P("model", None)
  embed                  P("model", None)  (vocab-sharded)
  lm_head                P(None, "model")
  MoE experts            P("model", None, None)  (expert-parallel)
  Mamba streams          wz/wx column over d_inner; wdt over H;
                         out_proj row; B/C streams replicated (G*N small)
  norms / biases / A_log / D  replicated

Batch/activation rules: batch dim over ("pod","data"); for batch==1
long-context decode the KV-cache sequence dim is sharded over "data"
instead (sequence parallelism — the tree-decode path).

``ambient_mesh``, ``constrain`` and ``named_shardings`` bind specs to GSPMD
under ``jit`` and have no eager counterpart: they are not ported.  In their
place, :func:`shard` / :func:`shard_tree` give a rank of a
:class:`~repro_torch.launch.mesh.ProcessMesh` its slice of a tensor or of
every leaf (what ``device_put`` onto a ``NamedSharding`` leaves on its
device) and :func:`gather` / :func:`gather_tree` put the whole tensors back
together on every rank.  A
dim named by several axes splits row-major over them, as GSPMD splits it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

__all__ = ["P", "param_specs", "batch_specs", "cache_specs", "data_axes",
           "opt_state_specs", "serving_value_role", "graph_partition_specs",
           "mesh_axes", "check_mesh_compat", "partition_spec_to_json",
           "partition_spec_from_json", "SERVING_REPLICATED", "shard", "gather", "shard_tree",
           "gather_tree", "spec_leaves", "spec_axes"]


def _entry(e: Any) -> Any:
    if isinstance(e, (tuple, list)):
        return e[0] if len(e) == 1 else tuple(e)
    return e


class P(tuple):
    """A partition spec: one entry per dimension, ``None`` (replicated), an
    axis name, or a tuple of axis names (one name alone is that name, as
    JAX's ``PartitionSpec`` has it); trailing dimensions it does not name
    are replicated.  ``P()`` is fully replicated."""

    def __new__(cls, *entries: Any) -> "P":
        return super().__new__(cls, tuple(_entry(e) for e in entries))

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


def partition_spec_to_json(spec: Sequence[Any]) -> List[Any]:
    """Spec -> JSON dim entries (None | axis name | [axis names])."""
    return [list(e) if isinstance(e, (tuple, list)) else e for e in spec]


def partition_spec_from_json(entries: Sequence[Any]) -> P:
    return P(*[tuple(e) if isinstance(e, list) else e for e in entries])


def data_axes(mesh: Any) -> Tuple[str, ...]:
    """The data-parallel axes: ("pod","data") on multi-pod, ("data",)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def _div(n: int, mesh: Any, axis: str) -> bool:
    return axis in mesh.axis_names and n % mesh.shape[axis] == 0 and n > 0


def _shape_of(leaf: Any) -> Tuple[int, ...]:
    return tuple(int(d) for d in (leaf.shape if hasattr(leaf, "shape") else leaf))


def _is_leaf(x: Any) -> bool:
    if hasattr(x, "shape"):
        return True
    return isinstance(x, tuple) and all(isinstance(d, (int, np.integer)) for d in x)


def _map_with_path(fn: Callable[[Tuple[str, ...], Any], Any], tree: Any,
                   path: Tuple[str, ...] = ()) -> Any:
    """``tree_map_with_path`` over nested dicts / lists / tuples whose leaves
    are arrays, tensors, objects with a ``shape`` or shape tuples; the path
    holds dict keys and sequence indices as strings."""
    if _is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    raise TypeError(f"unsupported leaf {type(tree).__name__} at {'/'.join(path)}")


def _param_rule(names: Tuple[str, ...], shape: Tuple[int, ...],
                cfg: Any, mesh: Any) -> P:
    leaf = names[-1] if names else ""
    nd = len(shape)

    def col() -> P:  # column-parallel (shard last dim)
        if _div(shape[-1], mesh, "model"):
            return P(*([None] * (nd - 1) + ["model"]))
        return P()

    def row() -> P:  # row-parallel (shard first dim)
        if _div(shape[0], mesh, "model"):
            return P(*(["model"] + [None] * (nd - 1)))
        return P()

    # --- embeddings ---
    if leaf == "embed":
        return row()          # vocab-sharded
    if leaf == "lm_head":
        return col()
    # --- attention (megatron) ---
    if leaf in ("wq", "w_gate", "w_up", "w_in", "wz", "wx", "wuk", "wuv"):
        return col()
    if leaf in ("wk", "wv"):
        # shard kv heads only if they divide; else replicate (GQA small-kv)
        if _div(cfg.n_kv_heads, mesh, "model"):
            return col()
        return P()
    if leaf in ("wo", "w_down", "w_out", "out_proj"):
        return row()
    if leaf == "wdt":
        return col()
    if leaf in ("wdkv", "wkpe", "wB", "wC", "fuse"):
        return col() if leaf == "fuse" else P()
    if leaf == "router":
        return P()
    # --- mamba conv / scalars / norms ---
    if leaf.startswith("conv_x") or leaf == "conv_bx":
        return col() if _div(shape[-1], mesh, "model") else P()
    return P()


def _moe_aware_rule(names: Tuple[str, ...], shape: Tuple[int, ...],
                    cfg: Any, mesh: Any) -> P:
    """Expert tensors are 3-D (E, ·, ·): shard the expert dim (EP)."""
    leaf = names[-1] if names else ""
    if len(shape) == 3 and leaf in ("w_gate", "w_up", "w_down"):
        if _div(shape[0], mesh, "model"):
            return P("model", None, None)
        return P()
    return _param_rule(names, shape, cfg, mesh)


def param_specs(params_shape: Any, cfg: Any, mesh: Any) -> Any:
    """Spec tree matching ``params_shape`` (nested dicts of arrays or
    shapes).  Stacked period params have a leading n_periods axis -> the
    spec gets an extra leading None."""
    def assign(names, leaf):
        shape = _shape_of(leaf)
        # stacked period params: (n_periods, ...) and shared: (2, ...)
        lead = 1 if "period" in names or ("shared" in names and "stack" in names) else 0
        spec = _moe_aware_rule(names, shape[lead:], cfg, mesh)
        return P(*([None] * lead + list(spec)))

    return _map_with_path(assign, params_shape)


def batch_specs(batch_shape: Any, mesh: Any) -> Any:
    """Shard the leading batch dim over ("pod","data") when divisible."""
    dp = data_axes(mesh)
    dp_size = int(np.prod([mesh.shape[a] for a in dp])) if dp else 1

    def assign(names, leaf):
        shape = _shape_of(leaf)
        if shape and shape[0] % dp_size == 0 and dp_size > 1:
            return P(dp, *([None] * (len(shape) - 1)))
        return P()

    return _map_with_path(assign, batch_shape)


def cache_specs(cache_shape: Any, cfg: Any, mesh: Any, batch: int,
                seq_shard_fallback: bool = True) -> Any:
    """Decode-cache sharding.  Batch dim over DP axes when divisible; for
    batch==1 (long-context) the sequence/capacity dim is sharded over
    "data" instead (sequence parallelism).  KV head dims shard on "model"
    when divisible.  ``seq_shard_fallback``: when a cache's kv-head dim does
    not divide the model axis, shard its length dim over "model" instead
    of replicating it (repro's perf iteration 1)."""
    dp = data_axes(mesh)
    dp_size = int(np.prod([mesh.shape[a] for a in dp])) if dp else 1

    def assign(names, leaf):
        shape = _shape_of(leaf)
        lead = 1 if "period" in names else 0   # stacked (n_periods, ...)
        core = list(shape[lead:])
        spec: list = [None] * len(core)
        leaf_name = names[-1]
        paged_kv = (leaf_name in ("pages_k", "pages_v")
                    or (leaf_name in ("k", "v") and len(core) == 4 and core[0] != batch))
        if paged_kv and len(core) == 4:
            # paged pool (N_pages, page, Hk, D): rows are block-addressed
            # through tables, so only the kv-head dim carries TP, with full
            # replication as the GQA-small fallback
            if _div(core[2], mesh, "model"):
                spec[2] = "model"
            return P(*([None] * lead + spec))
        if leaf_name.endswith("_scale") and len(core) == 2:
            # (N_pages, Hk) dequant sidecar: mirrors its pool's head shard
            if _div(core[1], mesh, "model"):
                spec[1] = "model"
            return P(*([None] * lead + spec))
        if core and core[0] == batch and batch % dp_size == 0 and dp_size > 1:
            spec[0] = dp
        elif core and batch == 1 and len(core) >= 2:
            # sequence-parallel: shard the cache length dim over "data"
            if leaf_name in ("k", "v", "ckv", "kpe") and _div(core[1], mesh, "data"):
                spec[1] = "data"
        if leaf_name in ("k", "v") and len(core) == 4:
            if _div(core[2], mesh, "model"):
                spec[2] = "model"
            elif seq_shard_fallback and _div(core[1], mesh, "model") and spec[1] is None:
                spec[1] = "model"
        if leaf_name in ("ckv", "kpe") and len(core) == 3 and seq_shard_fallback \
                and spec[1] is None and _div(core[1], mesh, "model"):
            spec[1] = "model"      # MLA latent cache: shard length over TP
        if leaf_name == "ssm" and len(core) == 4 and _div(core[1], mesh, "model"):
            spec[1] = "model"
        if leaf_name == "conv_x" and len(core) == 3 and _div(core[2], mesh, "model"):
            spec[2] = "model"
        return P(*([None] * lead + spec))

    return _map_with_path(assign, cache_shape)


def opt_state_specs(params_shape: Any, param_spec: Any, mesh: Any,
                    zero1: bool = True) -> Any:
    """Adam moment sharding.  With ZeRO-1 each moment additionally shards
    its largest not-yet-sharded dim over the "data" axis (when divisible)."""
    if not zero1 or "data" not in mesh.axis_names:
        return param_spec
    dsize = mesh.shape["data"]
    flat_specs: Dict[Tuple[str, ...], P] = {}

    def collect(names, spec):
        flat_specs[names] = spec
        return spec

    # a spec is a tuple of entries, not a container of leaves
    _map_specs(collect, param_spec)

    def widen(names, leaf):
        shape = _shape_of(leaf)
        spec = flat_specs[names]
        entries = list(spec) + [None] * (len(shape) - len(spec))
        best, best_dim = -1, -1
        for i, (n, s) in enumerate(zip(shape, entries)):
            if s is None and n % dsize == 0 and n > best:
                best, best_dim = n, i
        if best_dim >= 0 and best >= dsize:
            entries[best_dim] = "data"
        return P(*entries)

    return _map_with_path(widen, params_shape)


def _map_specs(fn, tree: Any, path: Tuple[str, ...] = ()) -> Any:
    if isinstance(tree, P):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v, path + (str(k),)) for k, v in tree.items()}
    return type(tree)(_map_specs(fn, v, path + (str(i),)) for i, v in enumerate(tree))


def spec_axes(entry: Any) -> Tuple[str, ...]:
    """The axes one entry of a spec names (``()`` for ``None``)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _zip_specs(fn, tree: Any, specs: Any) -> Any:
    """``fn(leaf, spec)`` over a tree and its spec tree (the same structure,
    :class:`P` leaves)."""
    if isinstance(specs, P):
        return fn(tree, specs)
    if isinstance(specs, dict):
        return {k: _zip_specs(fn, tree[k], specs[k]) for k in tree}
    return [_zip_specs(fn, t, sp) for t, sp in zip(tree, specs)]


def spec_leaves(tree: Any, specs: Any) -> List[P]:
    """The spec of each leaf of ``tree``, in its leaf order (JAX's)."""
    from repro_torch.core.tree import leaves_with_paths
    out = []
    for path, _ in leaves_with_paths(tree):
        spec = specs
        for k in path:
            spec = spec[k]
        out.append(spec)
    return out


def shard(x: Any, spec: Sequence[Any], mesh: Any) -> Any:
    """This rank's slice of ``x`` (at ``mesh.coords``) that ``spec`` gives:
    along every dim it names, block ``i`` of ``n`` by ``mesh.block`` of the
    named axes.  A copy (of a replicated tensor too), so the state it holds
    is the rank's own."""
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        if not axes:
            continue
        n, idx = mesh.block(axes, mesh.coords)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split {n} ways ({spec})")
        size = x.shape[dim] // n
        x = x.narrow(dim, idx * size, size)
    return x.clone(memory_format=torch.contiguous_format)


def gather(x: Any, spec: Sequence[Any], mesh: Any) -> Any:
    """The whole tensor of this rank's slice ``x``, on every rank of
    ``mesh`` (a ProcessMesh; collective: every rank calls it): each dim
    ``spec`` names all-gathered over its axes' group, in :func:`shard`'s
    order.  Pure data movement, so bitwise the tensor that was sharded."""
    from repro_torch.sharding.collectives import all_gather_axis
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        if axes:
            x = all_gather_axis(x, mesh, axes, dim)
    return x


def shard_tree(tree: Any, specs: Any, mesh: Any) -> Any:
    """:func:`shard` of every leaf by its spec."""
    return _zip_specs(lambda x, spec: shard(x, spec, mesh), tree, specs)


def gather_tree(shards: Any, specs: Any, mesh: Any) -> Any:
    """:func:`gather` of every leaf by its spec (collective)."""
    return _zip_specs(lambda x, spec: gather(x, spec, mesh), shards, specs)


# --------------------------------------------------------------------------- #
# Serving-graph partitioning — the rules behind compile(mesh=...)'s
# `partition` pass.  Every Program input / param / output gets a spec from
# its name and shape; divisibility guards fall back to replication (the
# GQA-small fallback), never crash.
# --------------------------------------------------------------------------- #

# scalar/bookkeeping serving inputs that must stay replicated: token ids,
# write cursors, and block tables (host-computed int32 indices)
SERVING_REPLICATED = ("tokens", "start", "n_new", "kvlen", "block_tables")


def serving_value_role(name: str, shape: Tuple[int, ...], *,
                       paged: bool = False) -> str:
    """Classify one serving-graph value into a partition role.

    Roles: ``replicated`` (tokens, cursors, tables, norms, logits, and —
    deliberately — the row-parallel candidates wo/wd/embed/head_w),
    ``col`` (column-parallel projection weight), ``kv_col``
    (column-parallel iff whole kv heads divide the model axis),
    ``dense_cache`` ((B, S, Hk, D) cache), ``paged_pool``
    ((N_pages, page, Hk, D) pool), ``kv_scale`` ((N_pages, Hk) sidecar).

    wo/wd (and embed/head_w) stay replicated rather than row-parallel: a
    row-parallel product splits the contraction and sums partial products
    across ranks, in another order than the single-device reduction, which
    breaks the engine's token identity."""
    base = name[4:] if name.startswith("new_") else name
    leaf = base.rsplit(".", 1)[-1]
    if base in SERVING_REPLICATED or base.startswith("tokens."):
        return "replicated"
    if base.startswith("cache_k") or base.startswith("cache_v"):
        if base.endswith("_scale"):
            return "kv_scale" if len(shape) == 2 else "replicated"
        if len(shape) == 4:
            return "paged_pool" if paged else "dense_cache"
        return "replicated"
    if leaf in ("wq", "wg", "wu"):
        return "col"
    if leaf in ("wk", "wv"):
        return "kv_col"
    return "replicated"


def graph_partition_specs(graph: Any, mesh: Any) -> Dict[str, P]:
    """A spec for every input, param and output of a serving graph.

    Caches and paged pools shard the kv-head dim on "model" when it
    divides, scale sidecars mirror their pool, q/gate/up projections go
    column-parallel, wk/wv go column-parallel only when whole kv heads land
    on each rank (GQA-small fallback: replicate); everything else — tokens,
    cursors, block tables, norms, wo/wd, embed, head_w, logits — is
    replicated.  Outputs mirror the input they update (``new_<name>``
    strips to ``<name>``); unknown names replicate."""
    paged = "block_tables" in graph.inputs
    kv_heads = 0
    for n, ts in graph.inputs.items():
        if (n.startswith("cache_k") or n.startswith("cache_v")) \
                and not n.endswith("_scale") and len(ts.shape) == 4:
            kv_heads = int(ts.shape[2])
            break

    def spec_for(name: str, shape: Tuple[int, ...]) -> P:
        role = serving_value_role(name, shape, paged=paged)
        nd = len(shape)
        if role == "col" and nd >= 1 and _div(shape[-1], mesh, "model"):
            return P(*([None] * (nd - 1) + ["model"]))
        if role == "kv_col":
            # packed (d_model, Hk*dh): shard only on whole kv heads
            if kv_heads and _div(kv_heads, mesh, "model") \
                    and nd >= 1 and _div(shape[-1], mesh, "model"):
                return P(*([None] * (nd - 1) + ["model"]))
            return P()
        if role in ("dense_cache", "paged_pool") and nd == 4 \
                and _div(shape[2], mesh, "model"):
            return P(None, None, "model", None)
        if role == "kv_scale" and nd == 2 and _div(shape[1], mesh, "model"):
            return P(None, "model")
        return P()

    specs: Dict[str, P] = {}
    for name, ts in graph.inputs.items():
        specs[name] = spec_for(name, tuple(ts.shape))
    for name, arr in graph.params.items():
        specs[name] = spec_for(name, tuple(arr.shape))
    for name in graph.outputs:
        base = name[4:] if name.startswith("new_") else None
        if base is not None and base in specs:
            specs[name] = specs[base]    # cache outputs mirror their input
        else:
            try:
                shape = tuple(graph.spec_of(name).shape)
            except Exception:
                specs[name] = P()        # shape unknown -> replicate
                continue
            specs[name] = spec_for(name, shape)
    return specs


def mesh_axes(mesh: Any) -> Dict[str, int]:
    """``{axis_name: size}`` — the serialisable identity of a mesh."""
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def check_mesh_compat(recorded: Dict[str, int], mesh: Any) -> None:
    """Raise ValueError unless ``mesh`` matches a recorded axis layout:
    the same axis names with the same sizes (order-free)."""
    actual = mesh_axes(mesh)
    if actual != dict(recorded):
        raise ValueError(
            f"partitioned Program was saved for mesh axes {dict(recorded)} "
            f"but is being loaded onto {actual}; reload on a mesh with the "
            f"same axis names and sizes, or load with mesh=None and "
            f"re-partition via compile(mesh=...)")
