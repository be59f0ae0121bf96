"""Post-training INT8 quantization as a compile stage — counterpart of
:mod:`repro.core.quant`.

* :func:`calibrate` — the observer pass: run representative inputs through
  the graph eagerly on the ``ref`` backends, on a device, and record every
  value's (min, max) and per-channel mean.
* :func:`quantize_graph` — the rewrite: ``dense`` / ``conv2d`` (and their
  fused variants) become ``*_q`` nodes whose weight param is int8 and
  whose attrs carry the per-output-channel ``w_scale``, the calibrated
  ``x_scale`` and ``zero_point``.  Registered as the ``"quantize"`` pass.
* The four quantized ops, each with two backends:

  - ``ref`` — the integer oracle: int8 activations times int8 weights,
    accumulated exactly, then dequantized.  torch has no general integer
    GEMM on CUDA (``matmul`` of integer CUDA tensors raises, and
    ``torch._int_mm`` needs M > 16 and multiples of 8, where the engine's
    decode has M = 4), so the products accumulate in float64.  That is
    exact: every product and partial sum is an integer of magnitude at most
    K * 127**2 (1.3e8 at K = 8192), far below 2**53, so any summation order
    gives the int32 result, and the final float32 cast equals JAX's
    ``acc.astype(float32)``.  (float32 would be exact only up to K of about
    1040.)  The convolution is ``F.conv2d`` in float64, exact for the same
    reason.  The result does not depend on the batch, so the serving engine
    stays token-exact against its batch-1 reference.
  - ``torch`` — the counterpart of ``repro``'s ``xla``: the int8 weights
    dequantized to float32, then one float32 product (TF32 off on every
    card a Program resolves).  cuBLAS picks its algorithm by shape, so this
    backend is not batch-invariant.

The numpy half (``weight_scales``, ``quantize_weight``, ``activation_scale``,
``ValueRange``, ``_bias_correction``, ``quantize_graph``) is ``repro``'s
copied as is; weights that are torch tensors (the serving engine's, on the
card) take the same steps in torch on their device, so the int8 weights,
``w_scale`` and bias corrections equal ``repro``'s bit for bit given the
same ranges.  On CUDA, ``tensor / python_scalar`` multiplies by the
scalar's reciprocal (one bit off a true division), so every division here
divides by a tensor on the same device.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.device import DeviceLike, resolve_device, to_tensor
from repro_torch.core.ir import Graph, Node, TensorSpec, topological_order
from repro_torch.core.pipeline import register_pass
from repro_torch.core.registry import Cost, defop, get_impl, impl

__all__ = [
    "QMAX",
    "QUANTIZABLE_OPS",
    "weight_scales",
    "quantize_weight",
    "activation_scale",
    "ValueRange",
    "calibrate",
    "quantize_graph",
    "is_quantized",
]

Attrs = Dict[str, Any]

QMAX = 127  # symmetric int8: values live in [-127, 127] (-128 unused)

# fp op -> (quantized op, out-channel axis of the weight array)
QUANTIZABLE_OPS: Dict[str, Tuple[str, int]] = {
    "dense": ("dense_q", 1),          # w: (in, out)
    "dense_fused": ("dense_fused_q", 1),
    "conv2d": ("conv2d_q", 3),        # w: HWIO
    "conv2d_fused": ("conv2d_fused_q", 3),
}


def _full(value: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 0-d tensor on ``like``'s device (a divisor that keeps the
    division true on CUDA)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


# --------------------------------------------------------------------------- #
# Weight quantization (per-output-channel, symmetric)
# --------------------------------------------------------------------------- #

def weight_scales(w: Any, channel_axis: int) -> Any:
    """Per-output-channel symmetric scales: ``max|W|`` over all other axes,
    divided by ``QMAX``.  All-zero channels get scale 1 (quantize to 0).
    A tensor gives a float32 tensor on its device, computed in the same
    steps."""
    if isinstance(w, torch.Tensor):
        w = w.float()
        reduce_axes = tuple(a for a in range(w.dim()) if a != channel_axis % w.dim())
        amax = w.abs().amax(dim=reduce_axes)
        amax = torch.where(amax > 0, amax, torch.ones_like(amax))
        return amax / _full(QMAX, amax)
    w = np.asarray(w, dtype=np.float32)
    reduce_axes = tuple(a for a in range(w.ndim) if a != channel_axis % w.ndim)
    amax = np.max(np.abs(w), axis=reduce_axes)
    amax = np.where(amax > 0, amax, 1.0)
    return (amax / QMAX).astype(np.float32)


def quantize_weight(w: Any, channel_axis: int) -> Tuple[Any, Any]:
    """``(W_q int8, scales f32)`` such that ``W ~= W_q * scales`` broadcast
    along ``channel_axis``; tensors in, tensors out (same device)."""
    if isinstance(w, torch.Tensor):
        w = w.float()
        scales = weight_scales(w, channel_axis)
        shape = [1] * w.dim()
        shape[channel_axis % w.dim()] = -1
        q = torch.clamp(torch.round(w / scales.reshape(shape)), -QMAX, QMAX)
        return q.to(torch.int8), scales
    w = np.asarray(w, dtype=np.float32)
    scales = weight_scales(w, channel_axis)
    shape = [1] * w.ndim
    shape[channel_axis % w.ndim] = -1
    q = np.clip(np.round(w / scales.reshape(shape)), -QMAX, QMAX)
    return q.astype(np.int8), scales


def activation_scale(lo: float, hi: float) -> float:
    """Symmetric per-tensor scale from a calibrated (min, max) range."""
    amax = max(abs(float(lo)), abs(float(hi)), 1e-12)
    return amax / QMAX


# --------------------------------------------------------------------------- #
# Calibration — the observer pass
# --------------------------------------------------------------------------- #

def _as_batches(graph: Graph, calib_data: Any) -> List[Dict[str, Any]]:
    """Normalise calibration data to a list of input dicts.  Accepts a dict
    of arrays, a sequence of such dicts, or — for single-input graphs — a
    bare array / sequence of arrays (numpy or torch)."""
    if isinstance(calib_data, (str, bytes)):
        raise TypeError(f"calib_data must be arrays, not {type(calib_data).__name__} "
                        f"({calib_data[:40]!r}); load the file first")
    if isinstance(calib_data, Mapping):
        return [dict(calib_data)]
    if isinstance(calib_data, (np.ndarray, torch.Tensor)):
        if len(graph.inputs) != 1:
            raise ValueError(
                f"bare-array calib_data needs a single-input graph; "
                f"{graph.name!r} has inputs {sorted(graph.inputs)}")
        (name,) = graph.inputs
        return [{name: calib_data}]
    if isinstance(calib_data, Iterable):
        batches = []
        for item in calib_data:
            batches.extend(_as_batches(graph, item))
        if not batches:
            raise ValueError("empty calibration data")
        return batches
    raise TypeError(f"cannot interpret calib_data of type {type(calib_data).__name__}")


class ValueRange(tuple):
    """Observed statistics for one graph value.

    Behaves as the ``(lo, hi)`` tuple the activation-scale computation
    needs, and additionally carries ``channel_mean`` — the calibration mean
    over every axis but the last (channels) — which
    :func:`quantize_graph` uses for bias correction."""

    channel_mean: Optional[np.ndarray]

    def __new__(cls, lo: float, hi: float,
                channel_mean: Optional[np.ndarray] = None) -> "ValueRange":
        self = super().__new__(cls, (float(lo), float(hi)))
        self.channel_mean = channel_mean
        return self

    @property
    def lo(self) -> float:
        return self[0]

    @property
    def hi(self) -> float:
        return self[1]

    def __repr__(self) -> str:
        return f"ValueRange({self[0]:.4g}, {self[1]:.4g})"


def calibrate(graph: Graph, calib_data: Any, *, backend: str = "ref",
              device: DeviceLike = None) -> Dict[str, ValueRange]:
    """Run representative inputs through ``graph`` and record the observed
    (min, max) of every value — graph inputs, params and intermediates —
    plus the per-channel mean used for bias correction.

    Execution is eager, node by node, on the ``backend`` implementations
    (default ``ref``, the oracle) on ``device`` (``None`` means ``"cuda"``).
    The statistics stay on the device until the end: one transfer for the
    whole pass, not one per value."""
    dev = resolve_device(device)
    batches = _as_batches(graph, calib_data)
    stats: Dict[str, List] = {}  # name -> [lo, hi, mean_sum, n_batches], tensors

    def observe(name: str, val: torch.Tensor) -> None:
        lo, hi = val.min().double(), val.max().double()
        axes = tuple(range(val.dim() - 1)) if val.dim() > 1 else ()
        mean = val.double().mean(dim=axes) if axes else val.double()
        if name in stats:
            s = stats[name]
            s[0] = torch.minimum(s[0], lo)
            s[1] = torch.maximum(s[1], hi)
            s[2] = s[2] + mean
            s[3] += 1
        else:
            stats[name] = [lo, hi, mean, 1]

    order = topological_order(graph)
    params = {k: to_tensor(v, dev) for k, v in graph.params.items()}
    with torch.no_grad():
        for batch in batches:
            missing = set(graph.inputs) - set(batch)
            if missing:
                raise ValueError(f"calibration batch missing inputs {sorted(missing)}")
            env: Dict[str, Any] = dict(params)
            env.update({k: to_tensor(batch[k], dev) for k in graph.inputs})
            for name in (*graph.inputs, *graph.params):
                observe(name, env[name])
            for node in order:
                fn = get_impl(node.op, backend)
                outs = fn([env[v] for v in node.inputs], node.attrs)
                for v, val in zip(node.outputs, outs):
                    env[v] = val
                    observe(v, val)
    names = list(stats)
    bounds = torch.stack([torch.stack(stats[n][:2]) for n in names]).cpu().tolist() \
        if names else []
    return {name: ValueRange(lo, hi, (stats[name][2] / stats[name][3]).float().cpu().numpy())
            for name, (lo, hi) in zip(names, bounds)}


# --------------------------------------------------------------------------- #
# The quantize graph rewrite
# --------------------------------------------------------------------------- #

def _bias_correction(w: np.ndarray, w_q: np.ndarray, scales: np.ndarray,
                     ch_axis: int, mu: np.ndarray, op: str,
                     attrs: Attrs) -> Optional[np.ndarray]:
    """Expected output shift ``E[x @ W] - E[x @ (W_q * s)]`` from the
    calibrated per-channel input mean ``mu`` — folded into the bias so the
    quantized layer is unbiased on the calibration distribution.  (For conv
    this assumes the input mean is spatially uniform, the standard PTQ
    approximation.)  Returns None when ``mu`` doesn't match the layout."""
    shape = [1] * w.ndim
    shape[ch_axis % w.ndim] = -1
    dw = (w - w_q.astype(np.float32) * scales.reshape(shape)).astype(np.float64)
    mu = np.asarray(mu, dtype=np.float64)
    if op.startswith("dense"):
        if mu.ndim != 1 or mu.shape[0] != dw.shape[0]:
            return None
        return (mu @ dw).astype(np.float32)
    kh, kw, ci_g, co = dw.shape
    groups = int(attrs.get("groups", 1))
    if mu.ndim != 1 or mu.shape[0] != ci_g * groups or co % groups:
        return None
    if groups == 1:
        return np.einsum("hwio,i->o", dw, mu).astype(np.float32)
    # grouped conv: output channels are group-major, input block g feeds them
    dwg = dw.reshape(kh, kw, ci_g, groups, co // groups)
    mug = mu.reshape(groups, ci_g)
    return np.einsum("hwigo,gi->go", dwg, mug).reshape(co).astype(np.float32)


def _host(x: Any) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def quantize_graph(graph: Graph,
                   ranges: Optional[Mapping[str, Tuple[float, float]]] = None,
                   *, dtype: str = "int8",
                   ops: Optional[Sequence[str]] = None) -> Graph:
    """Rewrite quantizable nodes into their ``*_q`` forms.

    Weights must be graph params; each gets a per-output-channel int8 twin
    stored as ``<name>.q8`` (a tensor on the weight's device when the
    weight is a tensor) plus a ``w_scale`` attr on the node.  With
    calibration ``ranges`` the input activation's symmetric scale is frozen
    into ``x_scale`` (static quantization); without, ``x_scale`` is omitted
    and the ``ref`` backend quantizes dynamically per batch.
    ``zero_point`` is always recorded (0 — the scheme is symmetric).

    ``ops`` restricts which fp ops are rewritten (default: all of
    :data:`QUANTIZABLE_OPS`).  The input graph is left untouched.
    """
    if dtype != "int8":
        raise ValueError(f"unsupported quantization dtype {dtype!r} (only 'int8')")
    targets = set(ops if ops is not None else QUANTIZABLE_OPS)
    unknown = targets - set(QUANTIZABLE_OPS)
    if unknown:
        raise ValueError(f"not quantizable: {sorted(unknown)}")
    g = graph.clone()
    new_nodes: List[Node] = []
    for node in g.nodes:
        if node.op not in targets:
            new_nodes.append(node)
            continue
        qop, ch_axis = QUANTIZABLE_OPS[node.op]
        wname = node.inputs[1]
        if wname not in g.params:
            new_nodes.append(node)  # weight is a computed value: leave fp32
            continue
        w = g.params[wname]
        if not isinstance(w, torch.Tensor):
            w = np.asarray(w)
        w_q, scales = quantize_weight(w, ch_axis)
        qname = f"{wname}.q8"
        g.params[qname] = w_q
        attrs = dict(node.attrs)
        attrs["w_scale"] = scales
        attrs["zero_point"] = 0
        inputs = [node.inputs[0], qname, *node.inputs[2:]]
        if ranges is not None and node.inputs[0] in ranges:
            vr = ranges[node.inputs[0]]
            attrs["x_scale"] = activation_scale(vr[0], vr[1])
            mu = getattr(vr, "channel_mean", None)
            if mu is not None and len(inputs) > 2 and inputs[2] in g.params:
                db = _bias_correction(_host(w).astype(np.float32), _host(w_q),
                                      _host(scales), ch_axis, mu, node.op, node.attrs)
                if db is not None:
                    b = g.params[inputs[2]]
                    bname = f"{node.name}.qbias"
                    if isinstance(b, torch.Tensor):
                        g.params[bname] = (b.float() + torch.from_numpy(db).to(b.device)
                                           ).to(b.dtype)
                    else:
                        b = np.asarray(b)
                        g.params[bname] = (b.astype(np.float32) + db).astype(b.dtype)
                    inputs[2] = bname
        new_nodes.append(node.clone(op=qop, inputs=inputs, attrs=attrs))
    g.nodes = new_nodes
    from repro_torch.core.passes import eliminate_dead, infer_shapes
    return infer_shapes(eliminate_dead(g))


@register_pass("quantize")
def quantize_pass(graph: Graph) -> Graph:
    """Weight-only int8 quantization as a plain registered pass (dynamic
    activation scales).  ``compile(graph, quantize="int8", calib_data=...)``
    additionally threads calibrated static ranges through
    :func:`quantize_graph`."""
    return quantize_graph(graph)


def is_quantized(graph: Graph) -> bool:
    """True if any node runs a quantized op."""
    qops = {q for q, _ in QUANTIZABLE_OPS.values()}
    return any(n.op in qops for n in graph.nodes)


# --------------------------------------------------------------------------- #
# Quantized operator declarations (shape and cost functions are repro's)
# --------------------------------------------------------------------------- #

def _q_out_dtype(specs: Sequence[TensorSpec]) -> str:
    return specs[0].dtype if specs[0].dtype != "int8" else "float32"


def _dense_q_shape(specs: Sequence[TensorSpec], attrs: Attrs) -> List[TensorSpec]:
    x, w = specs[0], specs[1]
    if x.shape[-1] != w.shape[0]:
        raise ValueError(f"dense_q mismatch {x.shape} x {w.shape}")
    return [TensorSpec(x.shape[:-1] + (w.shape[1],), _q_out_dtype(specs))]


def _bytes_of(specs: Sequence[TensorSpec]) -> float:
    return float(sum(s.nbytes for s in specs))


def _dense_q_cost(specs: Sequence[TensorSpec], attrs: Attrs) -> Cost:
    x, w = specs[0], specs[1]
    batch = x.nelems // x.shape[-1]
    flops = 2.0 * batch * w.shape[0] * w.shape[1]
    out = _dense_q_shape(specs[:2], attrs)[0]
    # quantize-in + dequantize-out are elementwise; weight bytes come from
    # the int8 spec
    extra = float(x.nelems + out.nelems)
    return Cost(flops=flops + extra, bytes=_bytes_of(specs) + out.nbytes)


def _conv2d_q_geometry(specs, attrs):
    from repro_torch.core.nnops import _conv_geometry
    return _conv_geometry(specs, attrs)


def _conv2d_q_shape(specs: Sequence[TensorSpec], attrs: Attrs) -> List[TensorSpec]:
    n, _, _, ci, co, groups, _, _, _, (oh, ow) = _conv2d_q_geometry(specs[:2], attrs)
    kh, kw, ci_g, _ = specs[1].shape
    if ci_g * groups != ci:
        raise ValueError(f"conv2d_q channel mismatch: x has {ci}, w expects {ci_g}*{groups}")
    return [TensorSpec((n, oh, ow, co), _q_out_dtype(specs))]


def _conv2d_q_cost(specs: Sequence[TensorSpec], attrs: Attrs) -> Cost:
    n, _, (kh, kw), ci, co, groups, _, _, _, (oh, ow) = _conv2d_q_geometry(specs[:2], attrs)
    flops = 2.0 * n * oh * ow * co * kh * kw * (ci // groups)
    out = _conv2d_q_shape(specs[:2], attrs)[0]
    extra = float(specs[0].nelems + out.nelems)
    return Cost(flops=flops + extra, bytes=_bytes_of(specs) + out.nbytes)


def _fused_q_cost(base_cost):
    def fn(specs, attrs):
        base = base_cost(specs[:2], attrs)
        bias = specs[2].nbytes if len(specs) > 2 else 0.0
        return Cost(base.flops, base.bytes + bias)
    return fn


defop("dense_q", _dense_q_shape, _dense_q_cost,
      doc="int8-weight dense: x @ dequant(w_q). attrs: w_scale, x_scale?, zero_point")
defop("dense_fused_q", lambda s, a: _dense_q_shape(s[:2], a),
      _fused_q_cost(_dense_q_cost),
      doc="int8-weight dense + bias + activation; inputs (x, w_q, b)")
defop("conv2d_q", _conv2d_q_shape, _conv2d_q_cost,
      doc="int8-weight conv2d, NHWC x HWIO(int8). attrs of conv2d + w_scale, x_scale?, zero_point")
defop("conv2d_fused_q", lambda s, a: _conv2d_q_shape(s[:2], a),
      _fused_q_cost(_conv2d_q_cost),
      doc="int8-weight conv2d + bias + activation; inputs (x, w_q, b)")


# --------------------------------------------------------------------------- #
# Implementations
# --------------------------------------------------------------------------- #

def _quantize_act(x: torch.Tensor, attrs: Attrs) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8-valued activation + its float32 scale (a 0-d tensor on x's
    device).  Static when calibration froze ``x_scale`` into the attrs,
    dynamic (per-batch amax) otherwise.  Rounds half to even, as
    ``jnp.round``."""
    scale = attrs.get("x_scale")
    if scale is None:
        scale = torch.clamp(x.abs().amax(), min=1e-12).float() / _full(QMAX, x)
    else:
        scale = _full(float(scale), x)
    q = torch.clamp(torch.round(x / scale), -QMAX, QMAX)
    return q, scale


def _wscale(attrs: Attrs, device: torch.device) -> torch.Tensor:
    s = attrs["w_scale"]
    if isinstance(s, torch.Tensor):
        return s.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(s, dtype=np.float32), device=device)


def _finish(y: torch.Tensor, inputs: Sequence[Any], attrs: Attrs, fused: bool) -> List[Any]:
    from repro_torch.core.nnops import _act
    if fused:
        y = y + inputs[2]
        y = _act(y, attrs.get("act", "none"))
    return [y]


def _dense_q_int8(inputs, attrs, fused):
    x, w_q = inputs[0], inputs[1]
    x_q, x_scale = _quantize_act(x, attrs)
    # exact integer accumulation in float64 (see the module docstring)
    acc = torch.matmul(x_q.double(), w_q.double())
    y = acc.float() * (x_scale * _wscale(attrs, x.device))
    return _finish(y.to(x.dtype), inputs, attrs, fused)


def _dense_q_dequant(inputs, attrs, fused):
    x, w_q = inputs[0], inputs[1]
    w = w_q.to(x.dtype) * _wscale(attrs, x.device)[None, :].to(x.dtype)
    y = torch.matmul(x, w).to(x.dtype)
    return _finish(y, inputs, attrs, fused)


def _conv2d_q_int8(inputs, attrs, fused):
    from repro_torch.core.nnops import _conv2d_torch
    x, w_q = inputs[0], inputs[1]
    x_q, x_scale = _quantize_act(x, attrs)
    # symmetric scheme: zero_point == 0, so SAME zero-padding is exact; the
    # float64 convolution of int8 values is exact (see the module docstring)
    (acc,) = _conv2d_torch([x_q.double(), w_q.double()], attrs)
    y = acc.float() * (x_scale * _wscale(attrs, x.device)[None, None, None, :])
    return _finish(y.to(x.dtype), inputs, attrs, fused)


def _conv2d_q_dequant(inputs, attrs, fused):
    from repro_torch.core.nnops import _conv2d_torch
    x, w_q = inputs[0], inputs[1]
    w = w_q.to(x.dtype) * _wscale(attrs, x.device)[None, None, None, :].to(x.dtype)
    (y,) = _conv2d_torch([x, w], attrs)
    return _finish(y.to(x.dtype), inputs, attrs, fused)


_INT8_NOTE = ("true int8 x int8 products accumulated exactly (float64), then "
              "dequantized (integer-edge oracle; batch-invariant)")
_DEQ_NOTE = "int8 weights dequantized to float32, then one float32 product (TF32 off)"

impl("dense_q", "ref", note=_INT8_NOTE)(
    lambda inputs, attrs: _dense_q_int8(inputs, attrs, fused=False))
impl("dense_q", "torch", note=_DEQ_NOTE)(
    lambda inputs, attrs: _dense_q_dequant(inputs, attrs, fused=False))
impl("dense_fused_q", "ref", note=_INT8_NOTE)(
    lambda inputs, attrs: _dense_q_int8(inputs, attrs, fused=True))
impl("dense_fused_q", "torch", note=_DEQ_NOTE)(
    lambda inputs, attrs: _dense_q_dequant(inputs, attrs, fused=True))
impl("conv2d_q", "ref", note=_INT8_NOTE)(
    lambda inputs, attrs: _conv2d_q_int8(inputs, attrs, fused=False))
impl("conv2d_q", "torch", note=_DEQ_NOTE)(
    lambda inputs, attrs: _conv2d_q_dequant(inputs, attrs, fused=False))
impl("conv2d_fused_q", "ref", note=_INT8_NOTE)(
    lambda inputs, attrs: _conv2d_q_int8(inputs, attrs, fused=True))
impl("conv2d_fused_q", "torch", note=_DEQ_NOTE)(
    lambda inputs, attrs: _conv2d_q_dequant(inputs, attrs, fused=True))
