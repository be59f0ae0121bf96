"""Compiled Program artifact + the top-level ``compile`` entrypoint.

Counterpart of :mod:`repro.core.program`:

* :func:`compile` — run a pass pipeline, resolve a backend per node under
  a :class:`~repro_torch.core.selector.BackendPolicy`, freeze the result.
* :class:`Program` — the simplified graph, the frozen backend assignment
  and the analytic cost table.  There is no ``jit``: a Program runs its
  nodes in topological order, eagerly, on its ``device``.
  :meth:`Program.run_instrumented` times each node alone (the paper's
  per-layer evaluation).

Weights are placed on the device once per Program, and a parameter that is
already a tensor on that device is shared, never copied — the serving
engine builds four Programs over one 15 GB weight set.

``compile(..., quantize="int8")`` adds post-training quantization as a
stage after the simplify pipeline (:mod:`repro_torch.core.quant`).

:meth:`Program.save` / :meth:`Program.load` write and read OXF bundles
(:mod:`repro_torch.core.importer`), with the assignment pinned into each
node in the format's backend names, so a Program compiled by either
package deploys in the other with its assignment::

    prog = compile(graph, device="cuda")
    prog.save("model_dir")                 # pins "pallas" where prog ran "cuda"
    prog2 = Program.load("model_dir")      # same assignment, no re-tuning

``compile(..., mesh=...)`` runs the `partition` pass last and freezes its
specs into :attr:`Program.partition`, which bundles carry in
``program.json``.  Under an active serving mesh of tp > 1 ranks
(:func:`repro_torch.kernels.serving_ops.serving_mesh`), a Program whose
partition shards the KV heads runs on the rank's slice of its caches: its
cache writes take the rank's heads of the whole new rows
(``serving_ops.tp_write_slices``), and its attention nodes run the ``tp``
backends.  The weights stay whole on every rank.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from itertools import repeat
from types import MappingProxyType
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.device import DeviceLike, resolve_device, to_tensor
from repro_torch.core.importer import (bundle_backend, bundle_cost, graph_from_dict,
                                       read_bundle, save_graph)
from repro_torch.core.ir import Graph, Node, TensorSpec, topological_order
from repro_torch.core.pipeline import PassManager, PassStats, default_pipeline
from repro_torch.core.registry import Cost, get_impl
from repro_torch.core.selector import BackendPolicy, FixedPolicy

__all__ = ["Program", "NodeReport", "compile"]


def _freeze_partition(mesh: Mapping[str, int], specs: Mapping[str, Any]
                      ) -> Dict[str, Mapping[str, Any]]:
    return {"mesh": MappingProxyType({a: int(n) for a, n in mesh.items()}),
            "specs": MappingProxyType(dict(specs))}


@dataclass
class NodeReport:
    name: str
    op: str
    backend: str
    seconds: float
    cost: Cost
    out_spec: TensorSpec


class Program:
    """A compiled inference program: graph + frozen backend assignment,
    run eagerly on ``device`` (``None`` means ``"cuda"``)."""

    def __init__(self, graph: Graph, assignment: Mapping[str, str],
                 pass_stats: Sequence[PassStats] = (), *,
                 device: DeviceLike = None):
        from repro_torch.core.passes import infer_shapes
        self.device = resolve_device(device)
        # freeze the layout the `partition` pass stamped before a Graph
        # rebuild below can drop the dynamic attributes
        part_specs = getattr(graph, "partition_specs", None)
        self._partition: Optional[Dict[str, Mapping[str, Any]]] = (
            None if part_specs is None
            else _freeze_partition(getattr(graph, "partition_mesh", {}) or {}, part_specs))
        self._graph = graph if graph.value_info else infer_shapes(graph)
        self._order = topological_order(self._graph)
        missing = [n.name for n in self._order if n.name not in assignment]
        if missing:
            raise ValueError(f"assignment missing nodes: {missing[:5]}")
        self._assignment: Mapping[str, str] = MappingProxyType(dict(assignment))
        self._pass_stats: Tuple[PassStats, ...] = tuple(pass_stats)
        table: Dict[str, Tuple[str, Cost]] = {}
        for node in self._order:
            b = self._assignment[node.name]
            in_specs = [self._graph.spec_of(v) for v in node.inputs]
            table[node.name] = (b, get_impl(node.op, b).cost(in_specs, node.attrs))
        self._cost_table: Mapping[str, Tuple[str, Cost]] = MappingProxyType(table)
        self._impls = [(node, get_impl(node.op, self._assignment[node.name]))
                       for node in self._order]
        self._row_slices: Optional[List[Optional[Tuple[int, int]]]] = None
        self._stored: Optional[Dict[str, torch.Tensor]] = None
        # node -> backend name as read from an OXF bundle (Program.load)
        self._bundle_names: Mapping[str, str] = MappingProxyType({})

    @property
    def graph(self) -> Graph:
        return self._graph

    @property
    def assignment(self) -> Dict[str, str]:
        """node name -> chosen backend (copy; the Program's own is frozen)."""
        return dict(self._assignment)

    @property
    def pass_stats(self) -> Tuple[PassStats, ...]:
        return self._pass_stats

    @property
    def cost_table(self) -> Mapping[str, Tuple[str, Cost]]:
        return self._cost_table

    @property
    def partition(self) -> Optional[Dict[str, Mapping[str, Any]]]:
        """Frozen partition layout, or None for unpartitioned Programs:
        ``{"mesh": {axis: size}, "specs": {value name: spec}}`` with a spec
        for every graph input, param and output — stamped by
        ``compile(mesh=...)``'s `partition` pass, carried through OXF, and
        read by the serving engine to give each rank its slice of the
        caches."""
        return self._partition

    def _set_partition(self, partition: Optional[Dict[str, Mapping[str, Any]]]) -> None:
        self._partition = partition
        self._row_slices = None

    def _tp_rows(self) -> Tuple[Any, Optional[List[Optional[Tuple[int, int]]]]]:
        """(mesh, per-node row slice) when this call runs on one rank of a
        tp > 1 serving mesh and the partition shards the KV heads of a
        cache this Program writes, else (None, None).  The slice is the
        (input, head dim) of a cache write's whole new rows."""
        if self._partition is None:
            return None, None
        from repro_torch.kernels.serving_ops import _tp_state, tp_write_slices
        mesh, tp = _tp_state()
        if mesh is None:
            return None, None
        if self._row_slices is None:
            self._row_slices = tp_write_slices([node for node, _ in self._impls],
                                               self._partition["specs"])
        if not any(self._row_slices):
            return None, None
        want = self._partition["mesh"].get("model")
        if want != tp:
            raise ValueError(f"Program partitioned for model={want} called on a serving "
                             f"mesh of model={tp}")
        return mesh, self._row_slices

    def costs(self) -> List[Tuple[Node, str, Cost]]:
        return [(node, *self._cost_table[node.name]) for node in self._order]

    def total_cost(self) -> Cost:
        total = Cost()
        for _, cost in self._cost_table.values():
            total = total + cost
        return total

    def _stored_params(self) -> Dict[str, torch.Tensor]:
        """The graph params as tensors on ``device``, built once and shared
        by ``__call__`` and every ``bind()``.  Params already on the device
        are the same tensors (no copy)."""
        if self._stored is None:
            self._stored = {k: to_tensor(v, self.device)
                            for k, v in self._graph.params.items()}
        return self._stored

    def _run(self, params: Mapping[str, Any], inputs: Mapping[str, Any]) -> Tuple[Any, ...]:
        from repro_torch.kernels.serving_ops import tp_slice
        env: Dict[str, Any] = dict(params)
        for k, v in inputs.items():
            env[k] = to_tensor(v, self.device)
        mesh, rows = self._tp_rows()
        with torch.no_grad():
            for (node, fn), row in zip(self._impls, rows or repeat(None)):
                args = [env[v] for v in node.inputs]
                if row is not None:
                    args[row[0]] = tp_slice(args[row[0]], row[1], mesh)
                outs = fn(args, node.attrs)
                for v, val in zip(node.outputs, outs):
                    env[v] = val
        return tuple(env[v] for v in self._graph.outputs)

    def __call__(self, **inputs: Any) -> Tuple[Any, ...]:
        missing = set(self._graph.inputs) - set(inputs)
        if missing:
            raise ValueError(f"missing graph inputs: {sorted(missing)}")
        return self._run(self._stored_params(), inputs)

    def run_instrumented(self, **inputs: Any) -> Tuple[Tuple[Any, ...], List[NodeReport]]:
        """Node-by-node execution with each node timed alone — the paper's
        individual-layer evaluation.  Each node runs once to warm up, then
        once timed on the host clock with the device synchronised before
        and after (on the card: the node's kernels, launch included)."""
        missing = set(self._graph.inputs) - set(inputs)
        if missing:
            raise ValueError(f"missing graph inputs: {sorted(missing)}")
        from repro_torch.kernels.serving_ops import tp_slice
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else (lambda: None))
        env: Dict[str, Any] = dict(self._stored_params())
        for k, v in inputs.items():
            env[k] = to_tensor(v, self.device)
        reports: List[NodeReport] = []
        mesh, rows = self._tp_rows()
        with torch.no_grad():
            for (node, fn), row in zip(self._impls, rows or repeat(None)):
                args = [env[v] for v in node.inputs]
                if row is not None:
                    args[row[0]] = tp_slice(args[row[0]], row[1], mesh)
                fn(args, node.attrs)                     # warm
                sync()
                t0 = time.perf_counter()
                outs = fn(args, node.attrs)
                sync()
                dt = time.perf_counter() - t0
                backend, cost = self._cost_table[node.name]
                reports.append(NodeReport(
                    name=node.name, op=node.op, backend=backend, seconds=dt, cost=cost,
                    out_spec=self._graph.spec_of(node.outputs[0])))
                for v, val in zip(node.outputs, outs):
                    env[v] = val
        return tuple(env[v] for v in self._graph.outputs), reports

    def bind(self, *names: str,
             donate: Sequence[str] = ()) -> Callable[..., Tuple[Any, ...]]:
        """Positional fast-call path: ``bind("x", "y")`` returns
        ``f(x, y) -> outputs`` with stored params closed over and input names
        validated once, here.  With no names, inputs bind in the graph's
        declared order.

        ``donate`` names inputs the caller will not reuse.  In the port it
        is a hint only: every op is functional (a cache update returns a new
        tensor), so a donated input is never written in place."""
        order: Tuple[str, ...] = names or tuple(self._graph.inputs)
        unknown = set(order) - set(self._graph.inputs)
        if unknown:
            raise ValueError(f"not graph inputs: {sorted(unknown)}")
        if set(order) != set(self._graph.inputs):
            missing = set(self._graph.inputs) - set(order)
            raise ValueError(f"bind() must cover every input; missing {sorted(missing)}")
        bad_donate = set(donate) - set(order)
        if bad_donate:
            raise ValueError(f"donate names not inputs: {sorted(bad_donate)}")
        stored = self._stored_params()

        def fast(*args: Any) -> Tuple[Any, ...]:
            return self._run(stored, dict(zip(order, args)))

        return fast

    def lower(self, **input_specs: Any):
        """One call's cost on fake tensors, for dry-run / cost analysis (JAX:
        ``jax.jit(...).lower(...)``): a
        :class:`~repro_torch.core.lowering.Lowered` record, with nothing
        allocated.  ``input_specs`` maps input names to anything with a
        shape and a dtype (a TensorSpec, a tensor); by default the graph's
        own.  A node on a kernel route (``cuda``, ``cuda_split``, ``tp``)
        runs its plain path on fake CPU tensors, launching nothing, and its
        FLOPs and bytes are the cost table's (``extra_cost``)."""
        from repro_torch.core.lowering import (KERNEL_ROUTES, Counters, fake_mode,
                                               fake_tensor, lower_call)
        if self._tp_rows()[1] is not None:
            raise ValueError("lower: a Program that writes head-sharded caches on a serving "
                             "mesh is lowered outside the mesh")
        mode, counters = fake_mode(), Counters()
        specs = {**self._graph.inputs, **input_specs}
        inputs = {k: fake_tensor(mode, s.shape, _torch_dtype(s.dtype)) for k, s in specs.items()}
        params = {k: fake_tensor(mode, tuple(v.shape), _torch_dtype(v.dtype))
                  for k, v in self._graph.params.items()}

        def run(params, inputs):
            env = {**params, **inputs}
            for node, fn in self._impls:
                args = [env[v] for v in node.inputs]
                backend, cost = self._cost_table[node.name]
                if backend in KERNEL_ROUTES:
                    outs = counters.replace(lambda: fn(args, node.attrs), cost.flops, cost.bytes)
                else:
                    outs = fn(args, node.attrs)
                env.update(zip(node.outputs, outs))
            return tuple(env[v] for v in self._graph.outputs)

        with torch.no_grad():
            return lower_call(run, {"params": params, "inputs": inputs}, mode=mode,
                              counters=counters)

    # ------------------------------------------------------------------ #
    # Persistence (OXF bundle: model.json + weights.npz + program.json)
    # ------------------------------------------------------------------ #
    def bundle_assignment(self) -> Dict[str, str]:
        """node name -> backend in the format's names: the name read from
        the bundle this Program was loaded from, else the format's name
        for the port backend (``cuda`` -> ``pallas``, ``torch`` -> ``xla``)."""
        return {name: self._bundle_names.get(name, bundle_backend(b))
                for name, b in self._assignment.items()}

    def save(self, path: str) -> None:
        """Serialize graph, weights and the frozen assignment.

        Each node's ``backend`` is pinned in model.json in the format's
        names (:meth:`bundle_assignment`); ``program.json`` records the
        assignment, each node's cost on that backend as ``repro`` computes
        it, and whether the graph is quantized.  The weights written are
        the graph's params (device tensors are copied to the host one at a
        time), never a second device copy."""
        from repro_torch.core.quant import is_quantized
        names = self.bundle_assignment()
        pinned = self._graph.clone()
        for node in pinned.nodes:
            node.backend = names[node.name]
        save_graph(pinned, path)
        costs = {}
        for node in self._order:
            backend, c = self._cost_table[node.name]
            if bundle_backend(backend) != names[node.name]:
                # a folded name (repro's xla run by ref): repro's own cost
                specs = [self._graph.spec_of(v) for v in node.inputs]
                c = bundle_cost(node.op, names[node.name], specs, node.attrs)
            costs[node.name] = {"backend": names[node.name], "flops": c.flops,
                                "bytes": c.bytes}
        meta = {"assignment": names, "cost_table": costs,
                "quantized": is_quantized(self._graph)}
        if self._partition is not None:
            # written only for partitioned Programs: unpartitioned bundles
            # keep their bytes
            from repro_torch.sharding.specs import partition_spec_to_json
            meta["partition"] = {
                "mesh": dict(self._partition["mesh"]),
                "specs": {name: partition_spec_to_json(spec)
                          for name, spec in self._partition["specs"].items()}}
        with open(os.path.join(path, "program.json"), "w") as f:
            json.dump(meta, f, indent=1, sort_keys=True)

    @classmethod
    def load(cls, path: str, policy: Optional[BackendPolicy] = None,
             mesh: Optional[Any] = None, device: DeviceLike = None) -> "Program":
        """Rebuild a Program from an OXF bundle on ``device`` (``None``
        means ``"cuda"``), with no pass run (a quantized bundle loads as it
        is).  The pinned per-node backends, mapped to the port's names, win
        over ``policy``, which only fills gaps (bundles written by a plain
        ``save_graph``); the names read from the bundle are remembered, so
        :meth:`save` writes them back unchanged.

        A partitioned bundle restores its recorded specs verbatim; a given
        ``mesh`` is checked against the recorded axes (``ValueError`` on a
        mismatch).  A bundle with no partition is partitioned fresh for
        ``mesh`` by the `partition` pass."""
        part = None
        meta_path = os.path.join(path, "program.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                part = json.load(f).get("partition")
        d, params = read_bundle(path)
        graph = graph_from_dict(d, params)
        if part is None:
            prog = compile(graph, policy=policy, pipeline=(), mesh=mesh, device=device)
        else:
            from repro_torch.sharding.specs import check_mesh_compat, partition_spec_from_json
            if mesh is not None:
                check_mesh_compat(part["mesh"], mesh)
            prog = compile(graph, policy=policy, pipeline=(), device=device)
            prog._set_partition(_freeze_partition(
                part["mesh"], {n: partition_spec_from_json(e)
                               for n, e in part["specs"].items()}))
        prog._bundle_names = MappingProxyType(
            {nd["name"]: nd["backend"] for nd in d["nodes"] if nd.get("backend")})
        return prog


def _torch_dtype(dtype: Any) -> torch.dtype:
    """A torch dtype from a torch or numpy dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(getattr(dtype, "name", dtype)))


def compile(graph: Graph, policy: Optional[BackendPolicy] = None,
            pipeline: Optional[Union[PassManager, Sequence]] = None,
            *, validate: bool = False, quantize: Optional[str] = None,
            calib_data: Any = None,
            calib_ranges: Optional[Mapping[str, Any]] = None,
            mesh: Optional[Any] = None, device: DeviceLike = None) -> Program:
    """Graph -> Program.

    ``policy`` defaults to :class:`FixedPolicy` (cuda-then-ref); per-node
    ``Node.backend`` pins always win.  ``pipeline`` is ``None`` for the
    standard simplify pipeline, a :class:`PassManager`, or a sequence of
    pass names/callables (empty: no rewriting, shape inference only).
    ``device`` is where the Program runs; ``None`` means ``"cuda"``.

    ``quantize="int8"`` runs post-training quantization after the pipeline:
    calibration on ``device`` when ``calib_data`` is given (a dict of
    inputs, a sequence of them, or a bare array for a single-input graph),
    then :func:`repro_torch.core.quant.quantize_graph`.  ``calib_ranges``
    (``calibrate``'s output) is used instead of calibrating here, so that
    several shape variants of one model share one set of activation
    scales; it excludes ``calib_data``.  Without either, quantization is
    weight-only and the ``ref`` backend scales activations per batch.

    ``mesh`` (anything with ``axis_names`` and ``shape``) runs the
    `partition` pass as the last stage, after every rewrite, and freezes
    its specs into ``Program.partition``."""
    from repro_torch.core.passes import infer_shapes
    dev = resolve_device(device)
    if pipeline is None:
        pipeline = default_pipeline(validate=validate)
    elif not isinstance(pipeline, PassManager):
        pipeline = PassManager(list(pipeline), validate=validate, name="custom")
    g = pipeline.run(graph)
    if quantize is not None:
        from repro_torch.core import quant
        if quantize != "int8":
            raise ValueError(f"unsupported quantize mode {quantize!r} (only 'int8')")
        if calib_data is not None and calib_ranges is not None:
            raise ValueError("pass calib_data or calib_ranges, not both")
        if calib_ranges is not None:
            ranges: Any = calib_ranges
        else:
            ranges = (quant.calibrate(g, calib_data, device=dev)
                      if calib_data is not None else None)
        g = quant.quantize_graph(g, ranges)
    if not g.value_info:
        g = infer_shapes(g)
    pass_stats = tuple(pipeline.stats)
    if mesh is not None:
        from repro_torch.core.pipeline import make_partition_pass
        pmesh = PassManager([make_partition_pass(mesh)], name="partition")
        g = pmesh.run(g)
        pass_stats += tuple(pmesh.stats)
    policy = policy or FixedPolicy()
    assignment: Dict[str, str] = {}
    for node in topological_order(g):
        in_specs = [g.spec_of(v) for v in node.inputs]
        assignment[node.name] = policy.resolve(node, in_specs)
    return Program(g, assignment, pass_stats=pass_stats, device=dev)
