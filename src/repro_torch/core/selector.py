"""Backend selection policies — counterpart of :mod:`repro.core.selector`.

Only the preference-list policies are ported so far.  ``CostModelPolicy``
and ``AutotunePolicy`` wait for an H100 ``HardwareProfile``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Sequence

from repro_torch.core.ir import Node, TensorSpec
from repro_torch.core.registry import backends_for

__all__ = ["BackendPolicy", "FixedPolicy"]


class BackendPolicy:
    """Base: always ``ref``."""

    def choose(self, node: Node, in_specs: Sequence[TensorSpec]) -> str:
        avail = backends_for(node.op, in_specs, node.attrs)
        if not avail:
            raise ValueError(f"no supported backend for {node.op} {in_specs}")
        return "ref" if "ref" in avail else avail[0]

    def resolve(self, node: Node, in_specs: Sequence[TensorSpec]) -> str:
        """A per-node explicit ``backend`` pin always wins."""
        if node.backend is not None:
            avail = backends_for(node.op, in_specs, node.attrs)
            if node.backend not in avail:
                raise ValueError(
                    f"node {node.name}: pinned backend {node.backend!r} not "
                    f"supported here (available: {avail})")
            return node.backend
        return self.choose(node, in_specs)


@dataclass
class FixedPolicy(BackendPolicy):
    """Preference-ordered selection. ``prefer`` is global; ``per_op`` and
    ``per_node`` override it for specific ops / node names.  The default
    ``("cuda", "ref")`` is the port's counterpart of ``repro``'s
    ``("xla", "ref")`` plus the kernel slot that ``pallas`` fills there."""

    prefer: Sequence[str] = ("cuda", "ref")
    per_op: Dict[str, Sequence[str]] = field(default_factory=dict)
    per_node: Dict[str, Sequence[str]] = field(default_factory=dict)

    def choose(self, node: Node, in_specs: Sequence[TensorSpec]) -> str:
        avail = backends_for(node.op, in_specs, node.attrs)
        for pref in (self.per_node.get(node.name), self.per_op.get(node.op),
                     self.prefer):
            if not pref:
                continue
            for b in pref:
                if b in avail:
                    return b
        if avail:
            return avail[0]
        raise ValueError(f"no supported backend for {node.op}")
