"""DEPRECATED thin shim over :mod:`repro_torch.core.program` — counterpart
of :mod:`repro.core.executor`.

The old monolithic ``Executor`` mixed pass running, backend assignment and
execution in one class.  That split into the staged pipeline
(:func:`repro_torch.core.compile` -> immutable
:class:`~repro_torch.core.program.Program`); this module keeps the old
construction-site API working:

    Executor(graph, policy)   ==   compile(graph, policy, pipeline=())

(i.e. no simplification passes are run, matching the old behaviour —
callers were expected to ``simplify()`` first).  New code should call
``compile``.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.device import DeviceLike
from repro_torch.core.ir import Graph, Node
from repro_torch.core.program import NodeReport
from repro_torch.core.program import compile as _compile
from repro_torch.core.registry import Cost
from repro_torch.core.selector import BackendPolicy, FixedPolicy

__all__ = ["Executor", "NodeReport"]


class Executor:
    """Deprecated: use ``repro_torch.core.compile(graph, policy=...)``."""

    def __init__(self, graph: Graph, policy: Optional[BackendPolicy] = None, *,
                 device: DeviceLike = None):
        warnings.warn(
            "Executor is deprecated; use repro_torch.core.compile(graph, policy=...) "
            "which returns an immutable Program",
            DeprecationWarning, stacklevel=2)
        self.policy = policy or FixedPolicy()
        self.program = _compile(graph, policy=self.policy, pipeline=(), device=device)
        self.graph = self.program.graph

    # ------------------------------------------------------------------ #
    @property
    def assignment(self) -> Dict[str, str]:
        return self.program.assignment

    def costs(self) -> List[Tuple[Node, str, Cost]]:
        return self.program.costs()

    def compile(self) -> Callable[..., Tuple[Any, ...]]:
        return self.program.bind()

    def __call__(self, **inputs: Any) -> Tuple[Any, ...]:
        return self.program(**inputs)

    def lower(self, **input_specs: Any):
        return self.program.lower(**input_specs)

    def run_instrumented(self, **inputs: Any):
        return self.program.run_instrumented(**inputs)
