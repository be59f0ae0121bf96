"""Graph simplification passes — counterpart of :mod:`repro.core.passes`.

Passes are pure functions ``Graph -> Graph`` (input untouched), registered
by name in the :mod:`repro_torch.core.pipeline` registry.  The standard
pipeline (:func:`simplify`, also ``pipeline.default_pipeline()``) runs:

    infer_shapes -> fold_constants -> fold_batchnorm -> fuse_bias_act
                 -> fuse_elementwise -> eliminate_common_subexpr
                 -> eliminate_dead -> infer_shapes
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.device import to_tensor
from repro_torch.core.ir import Graph, GraphError, Node, TensorSpec, topological_order
from repro_torch.core.pipeline import PassManager, register_pass
from repro_torch.core.registry import get_impl, get_op

__all__ = [
    "infer_shapes",
    "fold_constants",
    "fold_batchnorm",
    "fuse_bias_act",
    "fuse_elementwise",
    "eliminate_dead",
    "eliminate_common_subexpr",
    "simplify",
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


def _host(x: Any) -> np.ndarray:
    """A param as a numpy array (a tensor is copied to the host)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@register_pass("fold_batchnorm")
def fold_batchnorm(graph: Graph) -> Graph:
    """Fold inference batchnorm into a preceding conv2d when the conv weight
    and all BN stats are graph params:  w' = w * s,  b' = (bias - mean*s)
    with s = scale / sqrt(var + eps), broadcast over output channels (in
    float64 on the host, as ``repro`` does, so the folded params are
    bitwise its own).

    Produces a ``conv2d_fused`` node (bias folded in, act 'none') so a later
    activation can still fuse into it."""
    g = infer_shapes(graph)
    producers = g.producers()
    consumers = g.consumers()
    replaced: Dict[str, Node] = {}
    drop: set = set()
    for node in g.nodes:
        if node.op != "batchnorm":
            continue
        x = node.inputs[0]
        prev = producers.get(x)
        if prev is None or prev.op != "conv2d" or len(consumers.get(x, [])) != 1:
            continue
        wname = prev.inputs[1]
        stats = node.inputs[1:]
        if wname not in g.params or any(s not in g.params for s in stats):
            continue
        w0 = _host(g.params[wname])
        w = w0.astype(np.float64)
        scale, bias, mean, var = (_host(g.params[s]).astype(np.float64) for s in stats)
        eps = float(node.attrs.get("eps", 1e-5))
        s = scale / np.sqrt(var + eps)
        new_w = f"{prev.name}.folded_w"
        new_b = f"{prev.name}.folded_b"
        g.params[new_w] = (w * s[None, None, None, :]).astype(w0.dtype)
        g.params[new_b] = (bias - mean * s).astype(w0.dtype)
        fused = Node(name=f"{prev.name}.bnfold", op="conv2d_fused",
                     inputs=[prev.inputs[0], new_w, new_b],
                     outputs=list(node.outputs),
                     attrs={**prev.attrs, "act": "none"},
                     backend=prev.backend)
        replaced[prev.name] = fused
        drop.add(node.name)
    if not replaced:
        return g
    g.nodes = [replaced.get(n.name, n) for n in g.nodes if n.name not in drop]
    return eliminate_dead(infer_shapes(g))


_ACTS = {"relu", "relu6", "gelu", "silu", "sigmoid", "tanh"}
_FUSABLE = {"conv2d": "conv2d_fused", "conv2d_fused": "conv2d_fused",
            "dense": "dense_fused", "dense_fused": "dense_fused"}


@register_pass("fuse_bias_act")
def fuse_bias_act(graph: Graph) -> Graph:
    """Pattern-fuse  (conv2d|dense) [-> bias_add] [-> activation]  into the
    corresponding fused op.  Only fires when the intermediate value has a
    single consumer and is not a graph output."""
    g = infer_shapes(graph)
    changed = True
    while changed:
        changed = False
        consumers = g.consumers()

        def sole_consumer(v: str) -> Optional[Node]:
            cs = consumers.get(v, [])
            return cs[0] if len(cs) == 1 and v not in g.outputs else None

        for node in list(g.nodes):
            if node.op not in _FUSABLE:
                continue
            out = node.outputs[0]
            nxt = sole_consumer(out)
            if nxt is None:
                continue
            fused: Optional[Node] = None
            if nxt.op == "bias_add" and nxt.inputs[0] == out and node.op in ("conv2d", "dense"):
                fused = Node(name=f"{node.name}.fb", op=_FUSABLE[node.op],
                             inputs=list(node.inputs) + [nxt.inputs[1]],
                             outputs=list(nxt.outputs),
                             attrs={**node.attrs, "act": "none"}, backend=node.backend)
            elif nxt.op in _ACTS and node.op in ("conv2d_fused", "dense_fused") \
                    and node.attrs.get("act", "none") in ("none", None):
                fused = node.clone(name=f"{node.name}.fa",
                                   outputs=list(nxt.outputs),
                                   attrs={**node.attrs, "act": nxt.op})
            if fused is not None:
                g.nodes = [n for n in g.nodes if n.name not in (node.name, nxt.name)]
                g.nodes.append(fused)
                g.nodes = topological_order(g)
                g = infer_shapes(g)
                changed = True
                break
    return g


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


def simplify(graph: Graph, *, fold_bn: bool = True, fuse: bool = True,
             fold_const: bool = True, cse: bool = True,
             fuse_ew: bool = True) -> Graph:
    """The standard simplification pipeline as one call; drop a flag to
    skip the corresponding pass, or build a PassManager for full control."""
    names = ["infer_shapes"]
    if fold_const:
        names.append("fold_constants")
    if fold_bn:
        names.append("fold_batchnorm")
    if fuse:
        names.append("fuse_bias_act")
    if fuse_ew:
        names.append("fuse_elementwise")
    if cse:
        names.append("eliminate_common_subexpr")
    names += ["eliminate_dead", "infer_shapes"]
    return PassManager(names, name="simplify").run(graph)
