"""Backend registry of the port — every op declared once, many backends.

Counterpart of :mod:`repro.core.registry`, with a registry of its own: the
port never registers into ``repro``'s.  Backends used in the port:

* ``ref``  — plain PyTorch, the port's own oracle (always sorted first).
* ``cuda`` — hand-written CUDA C++ kernels for Hopper (``csrc/``), in the
  slot that ``pallas`` fills in ``repro``.  On a CPU tensor a ``cuda``
  backend runs its kernel's plain PyTorch version; on a CUDA tensor it
  launches the kernel or raises.
* ``torch`` — one PyTorch library call, in the slot of ``repro``'s
  ``xla``; where ``repro`` has an ``xla`` backend and the port none, the
  port folded it into ``ref`` (:mod:`repro_torch.core.importer` maps the
  names of an OXF bundle).

A backend that cannot run in this environment says so by raising
``NotImplementedError`` before it launches anything;
:class:`~repro_torch.core.selector.AutotunePolicy` records such a backend
as ``inf``.  Any other exception, a failure to build, load or launch a
kernel among them, propagates: a backend that ``supports`` a node must run.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.core.ir import TensorSpec

__all__ = [
    "Cost",
    "OpImpl",
    "OpDef",
    "defop",
    "impl",
    "get_op",
    "get_impl",
    "backends_for",
    "registered_ops",
    "RegistryError",
]


class RegistryError(KeyError):
    pass


@dataclass(frozen=True)
class Cost:
    """Analytic per-call cost: floating-point ops and HBM bytes moved."""

    flops: float = 0.0
    bytes: float = 0.0

    def __add__(self, other: "Cost") -> "Cost":
        return Cost(self.flops + other.flops, self.bytes + other.bytes)

    def arithmetic_intensity(self) -> float:
        return self.flops / max(self.bytes, 1.0)


ShapeFn = Callable[[Sequence[TensorSpec], Dict[str, Any]], List[TensorSpec]]
CostFn = Callable[[Sequence[TensorSpec], Dict[str, Any]], Cost]
ImplFn = Callable[[Sequence[Any], Dict[str, Any]], Sequence[Any]]
SupportsFn = Callable[[Sequence[TensorSpec], Dict[str, Any]], bool]


@dataclass
class OpImpl:
    op: str
    backend: str
    fn: ImplFn
    supports: SupportsFn
    note: str = ""
    cost_fn: Optional[CostFn] = None

    def __call__(self, inputs: Sequence[Any], attrs: Dict[str, Any]) -> Sequence[Any]:
        return self.fn(inputs, attrs)

    def cost(self, specs: Sequence[TensorSpec], attrs: Dict[str, Any]) -> Cost:
        fn = self.cost_fn or get_op(self.op).cost_fn
        return fn(specs, attrs)


@dataclass
class OpDef:
    name: str
    shape_fn: ShapeFn
    cost_fn: CostFn
    impls: Dict[str, OpImpl] = field(default_factory=dict)
    doc: str = ""
    # repro's ``xla`` cost, where the port folded ``xla`` into ``ref`` and
    # that cost is not the op's: what an OXF bundle's cost table records
    # for an ``xla`` node (core/importer.py)
    xla_cost: Optional[CostFn] = None


_OPS: Dict[str, OpDef] = {}


def defop(name: str, shape_fn: ShapeFn, cost_fn: CostFn, doc: str = "") -> OpDef:
    """Declare an operator, exactly once."""
    if name in _OPS:
        raise RegistryError(f"op {name!r} already declared")
    op = OpDef(name=name, shape_fn=shape_fn, cost_fn=cost_fn, doc=doc)
    _OPS[name] = op
    return op


def impl(op: str, backend: str, *, supports: Optional[SupportsFn] = None,
         note: str = "", cost_fn: Optional[CostFn] = None) -> Callable[[ImplFn], ImplFn]:
    """Decorator registering ``fn`` as the ``backend`` implementation of
    ``op``.  Re-registration replaces the previous impl."""

    def wrap(fn: ImplFn) -> ImplFn:
        if op not in _OPS:
            raise RegistryError(f"op {op!r} not declared; call defop first")
        _OPS[op].impls[backend] = OpImpl(
            op=op, backend=backend, fn=fn,
            supports=supports or (lambda specs, attrs: True), note=note,
            cost_fn=cost_fn)
        return fn

    return wrap


def get_op(name: str) -> OpDef:
    try:
        return _OPS[name]
    except KeyError:
        raise RegistryError(f"unknown op {name!r}; known: {sorted(_OPS)}") from None


def get_impl(name: str, backend: str) -> OpImpl:
    op = get_op(name)
    try:
        return op.impls[backend]
    except KeyError:
        raise RegistryError(
            f"op {name!r} has no backend {backend!r}; available: {sorted(op.impls)}"
        ) from None


def backends_for(name: str, specs: Optional[Sequence[TensorSpec]] = None,
                 attrs: Optional[Dict[str, Any]] = None) -> List[str]:
    """Backends registered for ``name``; filtered by ``supports`` when specs
    are given. ``ref`` sorts first."""
    op = get_op(name)
    names = sorted(op.impls, key=lambda b: (b != "ref", b))
    if specs is None:
        return names
    attrs = attrs or {}
    return [b for b in names if op.impls[b].supports(specs, attrs)]


def registered_ops() -> List[str]:
    return sorted(_OPS)
