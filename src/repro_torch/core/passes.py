"""Graph simplification passes — counterpart of :mod:`repro.core.passes`.

Passes are pure functions ``Graph -> Graph`` (input untouched), registered
by name in the :mod:`repro_torch.core.pipeline` registry.  The port has
the passes the serving graphs go through:

    infer_shapes -> fold_constants -> fuse_elementwise
                 -> eliminate_common_subexpr -> eliminate_dead -> infer_shapes

``fold_batchnorm`` and ``fuse_bias_act`` (the CNN path) are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core.device import to_tensor
from repro_torch.core.ir import Graph, GraphError, Node, TensorSpec, topological_order
from repro_torch.core.pipeline import register_pass
from repro_torch.core.registry import get_impl, get_op

__all__ = [
    "infer_shapes",
    "fold_constants",
    "fuse_elementwise",
    "eliminate_dead",
    "eliminate_common_subexpr",
]


@register_pass("infer_shapes")
def infer_shapes(graph: Graph) -> Graph:
    """Populate ``value_info`` for every intermediate value."""
    g = graph.clone()
    g.validate()
    info: Dict[str, TensorSpec] = {}

    def spec(v: str) -> TensorSpec:
        if v in info:
            return info[v]
        return g.spec_of(v)

    for node in topological_order(g):
        in_specs = [spec(v) for v in node.inputs]
        try:
            out_specs = get_op(node.op).shape_fn(in_specs, node.attrs)
        except Exception as e:  # annotate which node failed
            raise GraphError(f"shape inference failed at {node.name} ({node.op}): {e}") from e
        if len(out_specs) != len(node.outputs):
            raise GraphError(
                f"{node.name}: shape_fn returned {len(out_specs)} specs for "
                f"{len(node.outputs)} outputs")
        for v, s in zip(node.outputs, out_specs):
            info[v] = s
    g.value_info = info
    return g


@register_pass("fold_constants")
def fold_constants(graph: Graph, max_bytes: int = 1 << 27) -> Graph:
    """Evaluate nodes whose inputs are all params with the ``ref`` backend
    and promote the results to params (as tensors on the inputs' device).
    ``max_bytes`` caps the size of a folded result."""
    g = infer_shapes(graph)
    const = set(g.params)
    new_nodes: List[Node] = []
    for node in topological_order(g):
        if all(v in const for v in node.inputs) and node.op != "identity_barrier":
            out_specs = [g.value_info[v] for v in node.outputs]
            if sum(s.nbytes for s in out_specs) <= max_bytes:
                fn = get_impl(node.op, "ref")
                with torch.no_grad():
                    vals = fn([to_tensor(g.params[v]) for v in node.inputs], node.attrs)
                for v, val in zip(node.outputs, vals):
                    g.params[v] = val
                    const.add(v)
                continue
        new_nodes.append(node)
    g.nodes = new_nodes
    return eliminate_dead(g)


# Unary elementwise ops that can be collapsed into one fused_elementwise node.
_EW_CHAIN = {"relu", "relu6", "gelu", "silu", "sigmoid", "tanh", "identity"}


def _chain_ops(node: Node) -> Tuple[str, ...]:
    if node.op == "fused_elementwise":
        return tuple(node.attrs["ops"])
    return (node.op,)


@register_pass("fuse_elementwise")
def fuse_elementwise(graph: Graph) -> Graph:
    """Collapse chains of unary elementwise ops into a single
    ``fused_elementwise`` node whose ``ops`` attr lists the stages.  Only
    fires when the intermediate value has a single consumer and is not a
    graph output."""
    g = graph.clone()
    changed = True
    while changed:
        changed = False
        producers = g.producers()
        consumers = g.consumers()
        for node in g.nodes:
            if node.op not in _EW_CHAIN and node.op != "fused_elementwise":
                continue
            src = node.inputs[0]
            prev = producers.get(src)
            if prev is None or (prev.op not in _EW_CHAIN
                                and prev.op != "fused_elementwise"):
                continue
            if len(consumers.get(src, [])) != 1 or src in g.outputs:
                continue
            fused = Node(name=f"{prev.name}.ew", op="fused_elementwise",
                         inputs=list(prev.inputs), outputs=list(node.outputs),
                         attrs={"ops": _chain_ops(prev) + _chain_ops(node)},
                         backend=node.backend or prev.backend)
            g.nodes = [n for n in g.nodes if n.name not in (prev.name, node.name)]
            g.nodes.append(fused)
            g.nodes = topological_order(g)
            changed = True
            break
    if g.value_info:
        g = infer_shapes(g)
    return g


@register_pass("eliminate_dead")
def eliminate_dead(graph: Graph) -> Graph:
    """Drop nodes (and params) that do not contribute to graph outputs."""
    g = graph.clone()
    producers = g.producers()
    live_vals: set = set(g.outputs)
    live_nodes: set = set()
    stack = list(g.outputs)
    while stack:
        v = stack.pop()
        node = producers.get(v)
        if node is None or node.name in live_nodes:
            continue
        live_nodes.add(node.name)
        for u in node.inputs:
            if u not in live_vals:
                live_vals.add(u)
                stack.append(u)
    g.nodes = [n for n in g.nodes if n.name in live_nodes]
    g.params = {k: v for k, v in g.params.items() if k in live_vals}
    g.value_info = {k: v for k, v in g.value_info.items()
                    if k in live_vals or k in g.inputs}
    return g


def _node_key(node: Node) -> Tuple:
    def freeze(x: Any):
        if isinstance(x, dict):
            return tuple(sorted((k, freeze(v)) for k, v in x.items()))
        if isinstance(x, (list, tuple)):
            return tuple(freeze(v) for v in x)
        if isinstance(x, np.ndarray):
            return ("ndarray", x.shape, str(x.dtype), x.tobytes())
        return x

    return (node.op, tuple(node.inputs), freeze(node.attrs))


@register_pass("eliminate_common_subexpr")
def eliminate_common_subexpr(graph: Graph) -> Graph:
    """Merge structurally identical nodes (same op, inputs, attrs)."""
    g = graph.clone()
    seen: Dict[Tuple, Node] = {}
    rename: Dict[str, str] = {}
    new_nodes: List[Node] = []
    for node in topological_order(g):
        node = node.clone(inputs=[rename.get(v, v) for v in node.inputs])
        key = _node_key(node)
        if key in seen:
            keep = seen[key]
            for old, new in zip(node.outputs, keep.outputs):
                rename[old] = new
        else:
            seen[key] = node
            new_nodes.append(node)
    g.nodes = new_nodes
    g.outputs = [rename.get(v, v) for v in g.outputs]
    return eliminate_dead(g)
