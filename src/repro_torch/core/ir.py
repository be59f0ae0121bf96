"""GraphIR — the port's computation-graph intermediate representation.

Counterpart of :mod:`repro.core.ir`, kept as its own copy so that the port
never imports the JAX package.  The one behavioural difference is
:meth:`Graph.spec_of` on a parameter: it reads shape and dtype from the
tensor itself, so a 15 GB CUDA weight set is never copied to the host just
to learn its dtype.

* Values are identified by string names (SSA-ish: each value produced once).
* ``Graph.params`` holds weights as numpy arrays or torch tensors, keyed by
  value name; graph *inputs* are the runtime-fed tensors.
* ``value_info`` carries inferred ``TensorSpec`` metadata for every value,
  filled by :func:`repro_torch.core.passes.infer_shapes`.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "TensorSpec",
    "Node",
    "Graph",
    "GraphError",
    "topological_order",
    "dtype_name",
]


class GraphError(ValueError):
    """Raised for malformed graphs (cycles, missing values, duplicate defs)."""


def dtype_name(arr: Any) -> str:
    """numpy-style dtype name ("float32", "int32", ...) of a tensor or array,
    read without touching its data."""
    if isinstance(arr, torch.Tensor):
        return str(arr.dtype).replace("torch.", "")
    return str(np.asarray(arr).dtype)


@dataclass(frozen=True)
class TensorSpec:
    """Shape/dtype metadata for a value in the graph."""

    shape: Tuple[int, ...]
    dtype: str = "float32"

    @property
    def nelems(self) -> int:
        n = 1
        for d in self.shape:
            n *= int(d)
        return n

    @property
    def nbytes(self) -> int:
        return self.nelems * np.dtype(self.dtype).itemsize

    def __repr__(self) -> str:  # compact: f32[1,3,224,224]
        short = {"float32": "f32", "float16": "f16", "bfloat16": "bf16",
                 "int32": "i32", "int8": "i8", "bool": "pred"}.get(self.dtype, self.dtype)
        return f"{short}[{','.join(str(d) for d in self.shape)}]"


@dataclass
class Node:
    """One operator application.

    ``backend`` is an optional per-node override; when ``None`` the
    :class:`~repro_torch.core.selector.BackendPolicy` decides."""

    name: str
    op: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, Any] = field(default_factory=dict)
    backend: Optional[str] = None

    def clone(self, **overrides: Any) -> "Node":
        kw = dict(
            name=self.name,
            op=self.op,
            inputs=list(self.inputs),
            outputs=list(self.outputs),
            attrs=dict(self.attrs),
            backend=self.backend,
        )
        kw.update(overrides)
        return Node(**kw)


@dataclass
class Graph:
    """A named operator graph with parameters (weights) attached."""

    name: str
    inputs: Dict[str, TensorSpec]
    outputs: List[str]
    nodes: List[Node]
    params: Dict[str, Any] = field(default_factory=dict)
    value_info: Dict[str, TensorSpec] = field(default_factory=dict)

    def producers(self) -> Dict[str, Node]:
        """Map value name -> producing node. Raises on duplicate definition."""
        out: Dict[str, Node] = {}
        for node in self.nodes:
            for v in node.outputs:
                if v in out:
                    raise GraphError(f"value {v!r} defined twice ({out[v].name}, {node.name})")
                if v in self.inputs or v in self.params:
                    raise GraphError(f"value {v!r} shadows a graph input/param")
                out[v] = node
        return out

    def consumers(self) -> Dict[str, List[Node]]:
        out: Dict[str, List[Node]] = {}
        for node in self.nodes:
            for v in node.inputs:
                out.setdefault(v, []).append(node)
        return out

    def spec_of(self, value: str) -> TensorSpec:
        if value in self.value_info:
            return self.value_info[value]
        if value in self.inputs:
            return self.inputs[value]
        if value in self.params:
            arr = self.params[value]
            return TensorSpec(tuple(int(d) for d in arr.shape), dtype_name(arr))
        raise GraphError(f"no spec known for value {value!r}; run infer_shapes first")

    def validate(self) -> None:
        """Check well-formedness: every input defined before use, no cycles,
        outputs produced, no duplicate node names."""
        self.producers()
        names = set()
        for node in self.nodes:
            if node.name in names:
                raise GraphError(f"duplicate node name {node.name!r}")
            names.add(node.name)
        available = set(self.inputs) | set(self.params)
        for node in topological_order(self):
            for v in node.inputs:
                if v not in available:
                    raise GraphError(f"node {node.name!r} uses undefined value {v!r}")
            available.update(node.outputs)
        for v in self.outputs:
            if v not in available:
                raise GraphError(f"graph output {v!r} is never produced")

    def clone(self) -> "Graph":
        return Graph(
            name=self.name,
            inputs=dict(self.inputs),
            outputs=list(self.outputs),
            nodes=[n.clone() for n in self.nodes],
            params=dict(self.params),
            value_info=dict(self.value_info),
        )

    def __repr__(self) -> str:
        return (f"Graph({self.name!r}, {len(self.nodes)} nodes, "
                f"{len(self.inputs)} inputs, {len(self.params)} params)")


def topological_order(graph: Graph) -> List[Node]:
    """Kahn's algorithm over value dependencies. Raises GraphError on cycles.

    Nodes already in a valid order pass through stably (the ready queue is
    seeded in graph order), which keeps pass output deterministic."""
    produced_by: Dict[str, Node] = {}
    for node in graph.nodes:
        for v in node.outputs:
            produced_by[v] = node

    indegree: Dict[str, int] = {}
    dependents: Dict[str, List[Node]] = {}
    roots: List[Node] = []
    base = set(graph.inputs) | set(graph.params)
    for node in graph.nodes:
        deps = {v for v in node.inputs if v not in base}
        for v in deps:
            if v not in produced_by:
                raise GraphError(f"node {node.name!r} uses undefined value {v!r}")
        indegree[node.name] = len(deps)
        for v in deps:
            dependents.setdefault(produced_by[v].name, []).append(node)
        if not deps:
            roots.append(node)

    order: List[Node] = []
    queue = deque(roots)
    seen = set()
    while queue:
        node = queue.popleft()
        if node.name in seen:
            continue
        seen.add(node.name)
        order.append(node)
        for dep in dependents.get(node.name, []):
            indegree[dep.name] -= 1
            if indegree[dep.name] == 0:
                queue.append(dep)
    if len(order) != len(graph.nodes):
        missing = [n.name for n in graph.nodes if n.name not in seen]
        raise GraphError(f"cycle detected involving nodes {missing[:5]}")
    return order
