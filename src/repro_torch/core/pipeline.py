"""Staged compilation pipeline: a named pass registry + PassManager.

Counterpart of :mod:`repro.core.pipeline`.  Passes stay pure
``Graph -> Graph`` functions (declared in :mod:`repro_torch.core.passes`);
the :class:`PassManager` decides which run, in what order, whether the
graph is re-validated between passes, and whether the list is iterated to
a fixpoint.  Every pass execution is timed into a :class:`PassStats`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core.ir import Graph, GraphError

__all__ = [
    "PassStats",
    "PassManager",
    "PipelineError",
    "register_pass",
    "get_pass",
    "registered_passes",
    "default_pipeline",
    "DEFAULT_PASSES",
    "make_partition_pass",
]

PassFn = Callable[[Graph], Graph]


class PipelineError(RuntimeError):
    """Raised for unknown pass names or passes that corrupt the graph."""


@dataclass(frozen=True)
class PassStats:
    """One pass execution: node delta + wall time."""

    name: str
    nodes_before: int
    nodes_after: int
    seconds: float
    iteration: int = 0
    changed: bool = False


_PASSES: Dict[str, PassFn] = {}


def register_pass(name: str, fn: Optional[PassFn] = None):
    """Register ``fn`` under ``name`` (usable as a decorator).
    Re-registration replaces the previous pass."""
    if fn is None:
        def deco(f: PassFn) -> PassFn:
            _PASSES[name] = f
            return f
        return deco
    _PASSES[name] = fn
    return fn


def get_pass(name: str) -> PassFn:
    try:
        return _PASSES[name]
    except KeyError:
        raise PipelineError(
            f"unknown pass {name!r}; registered: {sorted(_PASSES)}") from None


def registered_passes() -> List[str]:
    return sorted(_PASSES)


@register_pass("partition")
def partition(graph: Graph) -> Graph:
    """Stamp mesh partition specs onto the graph (no-op without a mesh).

    The registry entry documents the stage; the working variant is the
    closure from :func:`make_partition_pass`, which ``compile(mesh=...)``
    appends as the *last* pass — rewrite passes rebuild Graph objects and
    would drop the stamped attributes, so partitioning always runs on the
    final graph."""
    return graph


def make_partition_pass(mesh) -> PassFn:
    """Bind ``mesh`` into a `partition` pass instance: it derives a spec for
    every graph input, param and output from the serving rules of
    :mod:`repro_torch.sharding.specs` and stores them as
    ``graph.partition_specs`` (name -> spec) plus ``graph.partition_mesh``
    ({axis: size}), which :class:`~repro_torch.core.program.Program`
    freezes into its ``partition`` and serialises through OXF."""
    def partition(graph: Graph) -> Graph:
        """Stamp partition specs for a bound mesh onto the final graph."""
        from repro_torch.sharding.specs import graph_partition_specs, mesh_axes
        missing = [o for o in graph.outputs
                   if o not in graph.value_info and o not in graph.inputs]
        if missing:  # pipeline=() loads arrive without value_info
            graph = get_pass("infer_shapes")(graph)
        graph.partition_specs = graph_partition_specs(graph, mesh)
        graph.partition_mesh = mesh_axes(mesh)
        return graph
    return partition


def _freeze(x):
    if isinstance(x, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(_freeze(v) for v in x)
    if hasattr(x, "tobytes"):  # ndarray-valued attr
        return ("nd", getattr(x, "shape", None), x.tobytes())
    return x


def _structure(graph: Graph) -> Tuple:
    """Structural signature for change detection: node identity, wiring,
    attrs and backend pins (value_info is ignored)."""
    return tuple((n.name, n.op, tuple(n.inputs), tuple(n.outputs),
                  _freeze(n.attrs), n.backend)
                 for n in graph.nodes)


class PassManager:
    """Runs a configurable list of passes over a graph, recording PassStats.

    ``passes`` are pass names (looked up at ``run`` time) and/or callables;
    ``validate`` re-runs ``Graph.validate()`` after every pass; ``fixpoint``
    iterates the list until the structure stops changing (at most
    ``max_iters`` times)."""

    def __init__(self, passes: Sequence[Union[str, PassFn]], *,
                 validate: bool = False, fixpoint: bool = False,
                 max_iters: int = 10, name: str = "pipeline"):
        self.name = name
        self.validate = validate
        self.fixpoint = fixpoint
        self.max_iters = max_iters
        self._passes: List[Union[str, PassFn]] = list(passes)
        self.stats: List[PassStats] = []

    def pass_names(self) -> List[str]:
        return [p if isinstance(p, str) else getattr(p, "__name__", repr(p))
                for p in self._passes]

    def _resolved(self) -> List[Tuple[str, PassFn]]:
        out = []
        for p in self._passes:
            if isinstance(p, str):
                out.append((p, get_pass(p)))
            else:
                out.append((getattr(p, "__name__", repr(p)), p))
        return out

    def run(self, graph: Graph) -> Graph:
        """Apply the pipeline; ``graph`` is left untouched.  Stats from the
        run replace ``self.stats``."""
        passes = self._resolved()
        self.stats = []
        g = graph
        n_iters = self.max_iters if self.fixpoint else 1
        for it in range(n_iters):
            sig_before_iter = _structure(g)
            for pname, fn in passes:
                before = len(g.nodes)
                sig_before = _structure(g)
                t0 = time.perf_counter()
                try:
                    g2 = fn(g)
                except GraphError as e:
                    raise PipelineError(f"pass {pname!r} failed: {e}") from e
                dt = time.perf_counter() - t0
                if not isinstance(g2, Graph):
                    raise PipelineError(
                        f"pass {pname!r} returned {type(g2).__name__}, not Graph")
                if self.validate:
                    try:
                        g2.validate()
                    except GraphError as e:
                        raise PipelineError(
                            f"pass {pname!r} produced a malformed graph: {e}") from e
                self.stats.append(PassStats(
                    name=pname, nodes_before=before, nodes_after=len(g2.nodes),
                    seconds=dt, iteration=it,
                    changed=_structure(g2) != sig_before))
                g = g2
            if not self.fixpoint or _structure(g) == sig_before_iter:
                break
        return g

    def total_seconds(self) -> float:
        return sum(s.seconds for s in self.stats)

    def summary(self) -> str:
        """Human-readable per-pass table of the last ``run``."""
        lines = [f"{'pass':28s} {'nodes':>12s} {'time':>9s}  it"]
        for s in self.stats:
            lines.append(f"{s.name:28s} {s.nodes_before:5d} ->{s.nodes_after:4d} "
                         f"{s.seconds*1e3:7.2f}ms  {s.iteration}")
        lines.append(f"{'total':28s} {'':12s} {self.total_seconds()*1e3:7.2f}ms")
        return "\n".join(lines)

    def __repr__(self) -> str:
        return (f"PassManager({self.name!r}, passes={self.pass_names()}, "
                f"validate={self.validate}, fixpoint={self.fixpoint})")


DEFAULT_PASSES: Tuple[str, ...] = (
    "infer_shapes",
    "fold_constants",
    "fold_batchnorm",
    "fuse_bias_act",
    "fuse_elementwise",
    "eliminate_common_subexpr",
    "eliminate_dead",
    "infer_shapes",
)


def default_pipeline(*, validate: bool = False, fixpoint: bool = False) -> PassManager:
    """The standard simplify pipeline as a PassManager (what ``compile()``
    uses when no pipeline is given)."""
    from repro_torch.core import passes as _passes  # noqa: F401  (registers passes)
    return PassManager(list(DEFAULT_PASSES), validate=validate,
                       fixpoint=fixpoint, name="default")
