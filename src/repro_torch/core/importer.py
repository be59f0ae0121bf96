"""OXF — the Orpheus eXchange Format, read and written by the port
(counterpart of :mod:`repro.core.importer`; the format is
``docs/oxf-format.md``).

A bundle is a directory:

    model.json        graph topology: inputs, outputs, nodes, attrs, pins
    weights.npz       parameters, keyed by value name
    program.json      written by ``Program.save``: assignment, cost table

The bytes are the format's own: the same JSON (``indent=1``,
``sort_keys=True``, the ``__ndarray__`` / ``__tuple__`` attr encoding) and
the same npz entries in the dtype ``repro`` writes, so a bundle saved by
either package loads in the other.  An attr or a param held as a
``torch.Tensor`` is written as the numpy array it holds, copied off its
device one param at a time.  Loaded params stay numpy until a Program
places them on its device.

Backend names.  A bundle names backends in the format's vocabulary, which
is ``repro``'s; the port translates at this boundary, both ways:

    in the bundle               in the port
    pallas                      cuda
    pallas_split                cuda_split
    xla                         torch where the port registers torch for
                                the op; otherwise ref (the port folded
                                repro's xla variant into ref)
    ref, winograd, chunked, tp  the same name

There is no fallback: a pin the port cannot honour fails when the Program
is compiled, and never runs another backend quietly.
"""

from __future__ import annotations

import json
import os
import zipfile
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch.core.ir import Graph, GraphError, Node, TensorSpec
from repro_torch.core.registry import Cost, get_impl, get_op

__all__ = ["save_graph", "load_graph", "load_program",
           "graph_to_dict", "graph_from_dict",
           "bundle_backend", "port_backend", "bundle_cost"]

_FORMAT_VERSION = 1

# port backend -> the format's name; every other port name is the format's
_TO_BUNDLE = {"cuda": "pallas", "cuda_split": "pallas_split", "torch": "xla"}
_FROM_BUNDLE = {"pallas": "cuda", "pallas_split": "cuda_split"}


def bundle_backend(backend: str) -> str:
    """The format's name for a port backend (identity on the format's own
    names, so applying it twice is harmless)."""
    return _TO_BUNDLE.get(backend, backend)


def port_backend(op: str, name: str) -> str:
    """The port backend that runs a bundle's backend ``name`` for ``op``."""
    if name == "xla":
        return "torch" if "torch" in get_op(op).impls else "ref"
    return _FROM_BUNDLE.get(name, name)


def bundle_cost(op: str, name: str, specs, attrs: Mapping[str, Any]) -> Cost:
    """The cost the format records for ``op`` on the bundle backend
    ``name``: the port backend's where the port runs that name under its
    own backend; for ``xla`` folded into ``ref``, ``repro``'s cost of
    ``xla`` (``OpDef.xla_cost``, else the op's)."""
    backend = port_backend(op, name)
    if bundle_backend(backend) == name:
        return get_impl(op, backend).cost(specs, dict(attrs))
    opdef = get_op(op)
    return (opdef.xla_cost or opdef.cost_fn)(specs, dict(attrs))


def _host(v: Any) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _spec_to_json(spec: TensorSpec) -> Dict[str, Any]:
    return {"shape": list(spec.shape), "dtype": spec.dtype}


def _spec_from_json(d: Dict[str, Any]) -> TensorSpec:
    return TensorSpec(tuple(int(x) for x in d["shape"]), str(d["dtype"]))


def _jsonable_attrs(attrs: Mapping[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in attrs.items():
        if isinstance(v, (np.ndarray, torch.Tensor)):
            a = _host(v)
            out[k] = {"__ndarray__": a.tolist(), "dtype": str(a.dtype)}
        elif isinstance(v, tuple):
            out[k] = {"__tuple__": [_jsonable_attrs({"v": x})["v"] for x in v]}
        elif isinstance(v, np.integer):
            out[k] = int(v)
        elif isinstance(v, np.floating):
            out[k] = float(v)
        else:
            out[k] = v
    return out


def _attrs_from_json(attrs: Mapping[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in attrs.items():
        if isinstance(v, dict) and "__ndarray__" in v:
            out[k] = np.asarray(v["__ndarray__"], dtype=v["dtype"])
        elif isinstance(v, dict) and "__tuple__" in v:
            out[k] = tuple(_attrs_from_json({"v": x})["v"] for x in v["__tuple__"])
        elif isinstance(v, list):
            out[k] = tuple(_attrs_from_json({"v": x})["v"] for x in v)
        else:
            out[k] = v
    return out


def graph_to_dict(graph: Graph) -> Dict[str, Any]:
    """``model.json``'s content; node pins in the format's names."""
    return {
        "format_version": _FORMAT_VERSION,
        "name": graph.name,
        "inputs": {k: _spec_to_json(v) for k, v in graph.inputs.items()},
        "outputs": list(graph.outputs),
        "nodes": [
            {
                "name": n.name,
                "op": n.op,
                "inputs": list(n.inputs),
                "outputs": list(n.outputs),
                "attrs": _jsonable_attrs(n.attrs),
                **({"backend": bundle_backend(n.backend)} if n.backend else {}),
            }
            for n in graph.nodes
        ],
    }


def graph_from_dict(d: Dict[str, Any], params: Dict[str, Any]) -> Graph:
    """A port Graph from ``model.json``'s content; pins become the port's
    backend names (``port_backend``)."""
    if int(d.get("format_version", -1)) != _FORMAT_VERSION:
        raise GraphError(f"unsupported OXF version {d.get('format_version')!r}")
    g = Graph(
        name=str(d["name"]),
        inputs={k: _spec_from_json(v) for k, v in d["inputs"].items()},
        outputs=list(d["outputs"]),
        nodes=[
            Node(
                name=nd["name"],
                op=nd["op"],
                inputs=list(nd["inputs"]),
                outputs=list(nd["outputs"]),
                attrs=_attrs_from_json(nd.get("attrs", {})),
                backend=port_backend(nd["op"], nd["backend"]) if nd.get("backend") else None,
            )
            for nd in d["nodes"]
        ],
        params=dict(params),
    )
    g.validate()
    return g


def _write_npz(path: str, params: Mapping[str, Any]) -> None:
    """``np.savez``'s archive (stored .npy entries), written one param at a
    time: a param on the device is copied to host memory only while its
    entry is written, so a Program's weights never sit in host memory
    twice."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for name, value in params.items():
            with zf.open(f"{name}.npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, _host(value), allow_pickle=False)


def save_graph(graph: Graph, path: str) -> None:
    """Serialize ``graph`` to directory ``path`` (model.json + weights.npz)."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "model.json"), "w") as f:
        json.dump(graph_to_dict(graph), f, indent=1, sort_keys=True)
    _write_npz(os.path.join(path, "weights.npz"), graph.params)


def read_bundle(path: str) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """``model.json``'s content and the weights, as numpy arrays."""
    with open(os.path.join(path, "model.json")) as f:
        d = json.load(f)
    with np.load(os.path.join(path, "weights.npz")) as z:
        params = {k: z[k] for k in z.files}
    return d, params


def load_graph(path: str) -> Graph:
    return graph_from_dict(*read_bundle(path))


def load_program(path: str, policy: Any = None, mesh: Any = None,
                 device: Any = None) -> "Any":
    """Load an OXF bundle straight into an executable
    :class:`~repro_torch.core.program.Program` on ``device`` (``None``
    means ``"cuda"``).  Pins written by ``Program.save`` win over
    ``policy``; ``mesh`` checks (or, for a bundle without one, makes) the
    partition.  (Late import: program depends on this module.)"""
    from repro_torch.core.program import Program
    return Program.load(path, policy=policy, mesh=mesh, device=device)
