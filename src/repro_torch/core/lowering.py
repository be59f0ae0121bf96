"""Lowering a step on fake tensors: what one call costs, with nothing
allocated on a device and no kernel launched — the port's counterpart of
JAX's ``jit(...).lower(...).compile()`` followed by ``cost_analysis()``,
``memory_analysis()`` and the collectives parsed out of the HLO text.

:func:`lower_call` runs ``fn(*args)`` once under
``torch._subclasses.fake_tensor.FakeTensorMode`` (every argument a
``FakeTensor`` on the CPU, so a kernel wrapper takes its plain path and
launches nothing) and returns a :class:`Lowered` record:

* ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count (matmuls,
  convolutions and attention; elementwise ops count 0, where XLA's cost
  analysis counts them too);
* ``bytes_accessed``: each aten op's tensor inputs and outputs, summed by a
  dispatch mode (:class:`ByteCounter`; views move nothing and count 0).  The
  count is **unfused**: every intermediate is written and read back, as no
  fusing compiler would do;
* ``arg_bytes``: the bytes of each argument tree, and ``bytes_per_device``
  their sum on this rank.  No temporary peak is measured
  (``peak_measured`` is False), where JAX's ``memory_analysis`` has one;
* ``collectives``: the mesh's collective records of the call ((HLO op,
  group size) -> [calls, result bytes]), which
  :func:`repro_torch.tools.roofline.collective_bytes_from_records` prices;
* ``extra_cost``: the (FLOPs, bytes) of the ops run on a kernel route
  (``cuda``, ``cuda_split``, ``tp``), from the registry's cost models —
  their plain paths' counts are taken out (:meth:`Counters.replace`), as
  JAX's roofline adds its Pallas kernels' cost (``analyze(extra_cost=)``).
"""

from __future__ import annotations

import time
from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["KERNEL_ROUTES", "ByteCounter", "Counters", "Lowered", "fake_mode", "fake_tensor",
           "tree_bytes", "lower_call"]

# the backends whose ops launch hand-written kernels on the card
KERNEL_ROUTES = ("cuda", "cuda_split", "tp")

BYTES_NOTE = ("unfused: each aten op's tensor inputs and outputs, summed (views count 0); "
              "no temporary peak measured")


def fake_mode():
    """A FakeTensorMode for a lowering (shape-only tensors, no allocation)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=False)


def fake_tensor(mode, shape: Sequence[int], dtype: torch.dtype) -> torch.Tensor:
    """A fake tensor of ``shape`` / ``dtype`` on the CPU, under ``mode``."""
    with mode:
        return torch.empty(tuple(int(d) for d in shape), dtype=dtype, device="cpu")


def tree_bytes(tree: Any) -> int:
    """Bytes of every tensor leaf of ``tree``."""
    return int(sum(x.numel() * x.element_size() for x in tree_flatten(tree)[0]
                   if isinstance(x, torch.Tensor)))


class ByteCounter(TorchDispatchMode):
    """Sums the bytes of each aten op's tensor inputs and outputs (views,
    which move nothing, and ops of other namespaces, such as c10d's
    collectives, count 0)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "aten" and not func.is_view:
            self.ops += 1
            self.bytes += tree_bytes((args, kwargs, out))
        return out


class Counters:
    """The FLOP and byte counters of a lowering, entered together."""

    def __init__(self):
        from torch.utils.flop_counter import FlopCounterMode
        self.flop_mode = FlopCounterMode(display=False)
        self.byte_mode = ByteCounter()
        self.extra = [0.0, 0.0]

    def __enter__(self):
        self.flop_mode.__enter__()
        self.byte_mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.byte_mode.__exit__(*exc)
        self.flop_mode.__exit__(*exc)

    @property
    def flops(self) -> float:
        return float(self.flop_mode.get_total_flops())

    def replace(self, run: Callable[[], Any], flops: float, nbytes: float) -> Any:
        """``run()``, with the FLOPs and bytes counted while it ran taken
        back out and ``(flops, nbytes)`` (a registry cost model's) added to
        ``extra``."""
        counts = self.flop_mode.flop_counts
        snap = {mod: dict(c) for mod, c in counts.items()}
        b0 = self.byte_mode.bytes
        out = run()
        for mod in list(counts):
            counts[mod].clear()
            counts[mod].update(snap.get(mod, {}))
        self.byte_mode.bytes = b0
        self.extra[0] += flops
        self.extra[1] += nbytes
        return out


@dataclass
class Lowered:
    """What one call of a step costs on this rank (module docstring)."""

    flops: float
    bytes_accessed: float
    arg_bytes: Dict[str, int]
    bytes_per_device: float
    output_bytes: int
    collectives: Dict[Tuple[str, int], Any] = field(default_factory=dict)
    extra_cost: Tuple[float, float] = (0.0, 0.0)
    seconds: float = 0.0
    aten_ops: int = 0
    flops_by_op: Dict[str, float] = field(default_factory=dict)
    bytes_note: str = BYTES_NOTE
    peak_measured: bool = False

    def cost(self) -> Dict[str, float]:
        """``cost_analysis()``'s two keys, the kernel routes' cost included."""
        return {"flops": self.flops + self.extra_cost[0],
                "bytes accessed": self.bytes_accessed + self.extra_cost[1]}

    def to_json(self) -> Dict[str, Any]:
        d = asdict(self)
        d["collectives"] = [[op, n, calls, b] for (op, n), (calls, b) in
                            sorted(self.collectives.items())]
        return d


def lower_call(fn: Callable[..., Any], args: Dict[str, Any], *, mode=None, mesh: Any = None,
               counters: Optional[Counters] = None) -> Lowered:
    """Run ``fn(**args)`` once under ``mode`` (a FakeTensorMode whose fake
    tensors ``args`` holds) with the counters on, and return its
    :class:`Lowered` record.  ``mesh``'s collective records of the call are
    kept (the mesh's own are restored after).  ``counters`` lets ``fn``
    replace a kernel route's count (:meth:`Counters.replace`)."""
    mode = mode or fake_mode()
    counters = counters or Counters()
    saved = dict(getattr(mesh, "collectives", {}) or {})
    if mesh is not None:
        mesh.collectives.clear()
    t0 = time.perf_counter()
    try:
        with mode, counters:
            out = fn(**args)
        records = dict(mesh.collectives) if mesh is not None else {}
    finally:
        if mesh is not None:
            mesh.collectives.clear()
            mesh.collectives.update(saved)
    arg_bytes = {k: tree_bytes(v) for k, v in args.items()}
    return Lowered(flops=counters.flops, bytes_accessed=float(counters.byte_mode.bytes),
                   arg_bytes=arg_bytes, bytes_per_device=float(sum(arg_bytes.values())),
                   output_bytes=tree_bytes(out), collectives=records,
                   extra_cost=(counters.extra[0], counters.extra[1]),
                   seconds=time.perf_counter() - t0, aten_ops=counters.byte_mode.ops,
                   flops_by_op={str(op): float(n) for op, n in
                                counters.flop_mode.flop_counts["Global"].items() if n})
