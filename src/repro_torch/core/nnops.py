"""Standard graph operators of the port — counterpart of
:mod:`repro.core.nnops`: declarations (shape and cost functions match
``repro``'s) and their plain PyTorch backends.

Layout conventions, as in ``repro``: activations NHWC, conv kernels HWIO.

Backends registered here:

* ``ref`` — plain PyTorch, the oracle.  The ``ref`` conv2d IS the paper's
  GEMM (im2col) convolution; a grouped convolution (MobileNetV1's depthwise
  layers have up to 1024 groups) is one batched product over the group axis,
  the counterpart of JAX's ``vmap``.
* ``torch`` — one ``F.conv2d`` call (NHWC to NCHW and back; TF32 is off on
  every card a Program resolves, ``core/device.py``): the
  paper's "direct / third-party library" convolution, in the slot that
  ``xla`` (``lax.conv_general_dilated``) fills in ``repro``.  It is not the
  port of a kernel, and no default policy prefers it.
* ``winograd`` — F(2x2, 3x3) Winograd, 3x3 stride-1 ungrouped convolutions
  only: the paper's alternative conv algorithm.

The ``cuda`` backends of ``dense``, ``conv2d`` and ``conv2d_fused`` (the
hand-written GEMM kernel, im2col for the convolutions) are registered by
:mod:`repro_torch.kernels.ops`.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.ir import TensorSpec
from repro_torch.core.registry import Cost, defop, get_impl, impl

Attrs = Dict[str, Any]

# --------------------------------------------------------------------------- #
# helpers
# --------------------------------------------------------------------------- #


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return int(v[0]), int(v[1])
    return int(v), int(v)


def _conv_pads(padding, in_hw, k_hw, stride, dilation) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Resolve 'SAME'/'VALID'/explicit padding to ((ph0,ph1),(pw0,pw1))."""
    if isinstance(padding, str):
        pads = []
        for i in range(2):
            eff_k = (k_hw[i] - 1) * dilation[i] + 1
            if padding.upper() == "VALID":
                pads.append((0, 0))
            elif padding.upper() == "SAME":
                out = -(-in_hw[i] // stride[i])
                total = max((out - 1) * stride[i] + eff_k - in_hw[i], 0)
                pads.append((total // 2, total - total // 2))
            else:
                raise ValueError(f"bad padding {padding!r}")
        return tuple(pads)  # type: ignore[return-value]
    (a, b), (c, d) = padding
    return (int(a), int(b)), (int(c), int(d))


def _conv_out_hw(in_hw, k_hw, stride, pads, dilation) -> Tuple[int, int]:
    out = []
    for i in range(2):
        eff_k = (k_hw[i] - 1) * dilation[i] + 1
        out.append((in_hw[i] + pads[i][0] + pads[i][1] - eff_k) // stride[i] + 1)
    return out[0], out[1]


def _conv_args(x, w, attrs: Attrs):
    """(stride, dilation, groups, pads) of a conv of ``x`` (NHWC) by ``w``
    (HWIO), each a tensor or a :class:`TensorSpec`."""
    stride = _pair(attrs.get("stride", 1))
    dilation = _pair(attrs.get("dilation", 1))
    groups = int(attrs.get("groups", 1))
    pads = _conv_pads(attrs.get("padding", "SAME"), tuple(x.shape[1:3]), tuple(w.shape[:2]),
                      stride, dilation)
    return stride, dilation, groups, pads


def _conv_geometry(specs: Sequence[TensorSpec], attrs: Attrs):
    x, w = specs[0], specs[1]
    n, h, wd, ci = x.shape
    kh, kw, ci_g, co = w.shape
    stride, dilation, groups, pads = _conv_args(x, w, attrs)
    oh, ow = _conv_out_hw((h, wd), (kh, kw), stride, pads, dilation)
    return n, (h, wd), (kh, kw), ci, co, groups, stride, pads, dilation, (oh, ow)


def _pad_hw(x: torch.Tensor, pads, value: float = 0.0) -> torch.Tensor:
    """Pad an NHWC tensor's H and W by ((top, bottom), (left, right))."""
    return F.pad(x, (0, 0, pads[1][0], pads[1][1], pads[0][0], pads[0][1]), value=value)


def _act(x: torch.Tensor, name: str) -> torch.Tensor:
    if name in (None, "", "none", "identity", "linear"):
        return x
    if name == "relu":
        return torch.relu(x)
    if name == "relu6":
        return torch.clamp(x, 0, 6)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")      # jax.nn.gelu's default
    if name == "silu":
        return F.silu(x)
    if name == "sigmoid":
        return torch.sigmoid(x)
    if name == "tanh":
        return torch.tanh(x)
    raise ValueError(f"unknown activation {name!r}")


def _bytes_of(specs: Sequence[TensorSpec]) -> float:
    return float(sum(s.nbytes for s in specs))


def _ew_shape(specs, attrs):
    return [specs[0]]


def _ew_cost(specs, attrs):
    out = specs[0]
    return Cost(flops=float(out.nelems), bytes=_bytes_of(specs) + out.nbytes)


# --------------------------------------------------------------------------- #
# conv2d  (inputs: x NHWC, w HWIO)   — the paper's flagship op
# --------------------------------------------------------------------------- #

def _conv2d_shape(specs, attrs):
    n, _, _, ci, co, groups, _, _, _, (oh, ow) = _conv_geometry(specs, attrs)
    kh, kw, ci_g, _ = specs[1].shape
    if ci_g * groups != ci:
        raise ValueError(f"conv2d channel mismatch: x has {ci}, w expects {ci_g}*{groups}")
    return [TensorSpec((n, oh, ow, co), specs[0].dtype)]


def _conv2d_cost(specs, attrs):
    n, _, (kh, kw), ci, co, groups, _, _, _, (oh, ow) = _conv_geometry(specs, attrs)
    flops = 2.0 * n * oh * ow * co * kh * kw * (ci // groups)
    out_bytes = n * oh * ow * co * np.dtype(specs[0].dtype).itemsize
    return Cost(flops=flops, bytes=_bytes_of(specs) + out_bytes)


defop("conv2d", _conv2d_shape, _conv2d_cost,
      doc="2-D convolution, NHWC x HWIO. attrs: stride, padding, dilation, groups")


def _im2col(x: torch.Tensor, k_hw, stride, pads, dilation) -> torch.Tensor:
    """Extract conv patches -> (N, OH, OW, KH*KW*CI), each patch ordered
    (kh, kw, c) as the HWIO kernel's rows."""
    n, h, w, ci = x.shape
    kh, kw = k_hw
    x = _pad_hw(x, pads)
    oh, ow = _conv_out_hw((h, w), (kh, kw), stride, pads, dilation)
    dev = x.device
    i = (torch.arange(oh, device=dev)[:, None] * stride[0]
         + torch.arange(kh, device=dev)[None, :] * dilation[0])
    j = (torch.arange(ow, device=dev)[:, None] * stride[1]
         + torch.arange(kw, device=dev)[None, :] * dilation[1])
    patches = x[:, i]                            # (N, OH, KH, Wp, C)
    patches = patches[:, :, :, j]                # (N, OH, KH, OW, KW, C)
    patches = patches.permute(0, 1, 3, 2, 4, 5)  # (N, OH, OW, KH, KW, C)
    return patches.reshape(n, oh, ow, kh * kw * ci)


@impl("conv2d", "ref", note="GEMM (im2col) convolution in plain PyTorch — the paper's GEMM "
                            "backend")
def _conv2d_ref(inputs, attrs):
    x, w = inputs
    kh, kw, ci_g, co = w.shape
    stride, dilation, groups, pads = _conv_args(x, w, attrs)
    cols = _im2col(x, (kh, kw), stride, pads, dilation)
    n, oh, ow, _ = cols.shape
    if groups == 1:
        return [torch.matmul(cols, w.reshape(kh * kw * ci_g, co))]
    # grouped: one batched product over the group axis (JAX vmaps the dense
    # conv over it); channel c of x is group c // ci_g, column o of w group
    # o // (co // groups)
    cols = cols.reshape(n * oh * ow, kh * kw, groups, ci_g).permute(2, 0, 1, 3)
    cols = cols.reshape(groups, n * oh * ow, kh * kw * ci_g)
    wg = w.reshape(kh * kw * ci_g, groups, co // groups).permute(1, 0, 2)
    out = torch.bmm(cols, wg)                    # (G, N*OH*OW, cog)
    return [out.permute(1, 0, 2).reshape(n, oh, ow, co)]


@impl("conv2d", "torch", note="one F.conv2d call (NCHW view, TF32 off) — the direct / "
                              "third-party library convolution")
def _conv2d_torch(inputs, attrs):
    x, w = inputs
    stride, dilation, groups, pads = _conv_args(x, w, attrs)
    xc = x.permute(0, 3, 1, 2)
    (top, bottom), (left, right) = pads
    if top == bottom and left == right:
        padding = (top, left)
    else:
        xc, padding = F.pad(xc, (left, right, top, bottom)), (0, 0)
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride, padding=padding,
                 dilation=dilation, groups=groups)
    return [y.permute(0, 2, 3, 1)]


def _winograd_supported(specs, attrs):
    kh, kw, _, _ = specs[1].shape
    stride = _pair(attrs.get("stride", 1))
    dilation = _pair(attrs.get("dilation", 1))
    groups = int(attrs.get("groups", 1))
    return (kh, kw) == (3, 3) and stride == (1, 1) and dilation == (1, 1) and groups == 1


def _winograd_cost(specs, attrs):
    base = _conv2d_cost(specs, attrs)
    # F(2x2,3x3): 16 multiplies per 4 outputs vs 36 -> 4/9 of the MACs, plus
    # transform-domain intermediates (~2x bytes) — repro's model as is
    return Cost(flops=base.flops * 4.0 / 9.0, bytes=base.bytes * 2.0)


@impl("conv2d", "winograd", supports=_winograd_supported, cost_fn=_winograd_cost,
      note="Winograd F(2x2,3x3): 2.25x fewer multiplies; 3x3 s1 only")
def _conv2d_winograd(inputs, attrs):
    """F(2x2, 3x3) Winograd in fp32."""
    x, w = inputs
    dt, dev = x.dtype, x.device
    pads = _conv_pads(attrs.get("padding", "SAME"), tuple(x.shape[1:3]), (3, 3), (1, 1),
                      (1, 1))
    n, h, wd, _ = x.shape
    co = w.shape[3]
    oh, ow = _conv_out_hw((h, wd), (3, 3), (1, 1), pads, (1, 1))
    # tile grid of 2x2 outputs, each needs a 4x4 input tile
    th, tw = -(-oh // 2), -(-ow // 2)
    hp, wp = 2 * th + 2, 2 * tw + 2
    xp = _pad_hw(x, ((pads[0][0], max(hp - h - pads[0][0], 0)),
                     (pads[1][0], max(wp - wd - pads[1][0], 0)))).float()
    f32 = dict(dtype=torch.float32, device=dev)
    Bm = torch.tensor([[1, 0, -1, 0], [0, 1, 1, 0], [0, -1, 1, 0], [0, 1, 0, -1]], **f32)
    G = torch.tensor([[1, 0, 0], [0.5, 0.5, 0.5], [0.5, -0.5, 0.5], [0, 0, 1]], **f32)
    A = torch.tensor([[1, 0], [1, 1], [1, -1], [0, -1]], **f32)
    wf = torch.einsum("ab,bcio,cd->adio", G, w.float(), G.T)          # (4,4,ci,co)
    idx_h = torch.arange(th, device=dev)[:, None] * 2 + torch.arange(4, device=dev)[None, :]
    idx_w = torch.arange(tw, device=dev)[:, None] * 2 + torch.arange(4, device=dev)[None, :]
    tiles = xp[:, idx_h][:, :, :, idx_w]                               # (N,th,4,tw,4,ci)
    tiles = tiles.permute(0, 1, 3, 2, 4, 5)                            # (N,th,tw,4,4,ci)
    tf = torch.einsum("ab,nxybci,cd->nxyadi", Bm, tiles, Bm.T)         # B @ tile @ B^T
    m = torch.einsum("nxyabi,abio->nxyabo", tf, wf)
    y = torch.einsum("pa,nxyabo,bq->nxypqo", A.T, m, A)                # (N,th,tw,2,2,co)
    y = y.permute(0, 1, 3, 2, 4, 5).reshape(n, 2 * th, 2 * tw, co)
    return [y[:, :oh, :ow, :].to(dt)]


# --------------------------------------------------------------------------- #
# conv2d_fused = conv2d + bias + activation (created by the fusion passes)
# --------------------------------------------------------------------------- #

def _conv2d_fused_shape(specs, attrs):
    return _conv2d_shape(specs[:2], attrs)


def _conv2d_fused_cost(specs, attrs):
    base = _conv2d_cost(specs[:2], attrs)
    out = _conv2d_fused_shape(specs, attrs)[0]
    return Cost(flops=base.flops + 2.0 * out.nelems, bytes=base.bytes + specs[2].nbytes)


defop("conv2d_fused", _conv2d_fused_shape, _conv2d_fused_cost,
      doc="conv2d + bias + activation; inputs (x, w, b); attrs of conv2d + act")


def fused_from(conv_backend):
    """conv2d_fused from a conv2d backend: the conv, then bias and
    activation in plain PyTorch (the epilogue, as in JAX)."""
    def fn(inputs, attrs):
        x, w, b = inputs
        (y,) = conv_backend([x, w], attrs)
        return [_act(y + b, attrs.get("act", "none"))]
    return fn


impl("conv2d_fused", "ref")(fused_from(_conv2d_ref))
impl("conv2d_fused", "torch")(fused_from(_conv2d_torch))
impl("conv2d_fused", "winograd",
     supports=lambda specs, attrs: _winograd_supported(specs[:2], attrs))(
         fused_from(_conv2d_winograd))


# --------------------------------------------------------------------------- #
# dense / dense_fused
# --------------------------------------------------------------------------- #

def _dense_shape(specs, attrs):
    x, w = specs[0], specs[1]
    if x.shape[-1] != w.shape[0]:
        raise ValueError(f"dense mismatch {x.shape} x {w.shape}")
    return [TensorSpec(x.shape[:-1] + (w.shape[1],), x.dtype)]


def _dense_cost(specs, attrs):
    x, w = specs[0], specs[1]
    batch = x.nelems // x.shape[-1]
    flops = 2.0 * batch * w.shape[0] * w.shape[1]
    out_b = batch * w.shape[1] * np.dtype(x.dtype).itemsize
    return Cost(flops=flops, bytes=_bytes_of(specs) + out_b)


defop("dense", _dense_shape, _dense_cost, doc="x @ w")


@impl("dense", "ref")
def _dense_ref(inputs, attrs):
    x, w = inputs
    return [torch.matmul(x, w)]


def _dense_fused_shape(specs, attrs):
    return _dense_shape(specs[:2], attrs)


def _dense_fused_cost(specs, attrs):
    base = _dense_cost(specs[:2], attrs)
    out = _dense_fused_shape(specs, attrs)[0]
    return Cost(base.flops + 2.0 * out.nelems, base.bytes + specs[2].nbytes)


defop("dense_fused", _dense_fused_shape, _dense_fused_cost,
      doc="dense + bias + activation; inputs (x, w, b)")


@impl("dense_fused", "ref")
def _dense_fused_ref(inputs, attrs):
    x, w, b = inputs
    (y,) = _dense_ref([x, w], attrs)
    return [_act(y + b, attrs.get("act", "none"))]


# --------------------------------------------------------------------------- #
# elementwise / activations
# --------------------------------------------------------------------------- #

def _binop_shape(specs, attrs):
    a, b = specs
    shape = np.broadcast_shapes(a.shape, b.shape)
    return [TensorSpec(tuple(int(d) for d in shape), a.dtype)]


defop("add", _binop_shape, _ew_cost)
defop("mul", _binop_shape, _ew_cost)
defop("bias_add", _binop_shape, _ew_cost, doc="x + b broadcast on last dim")


@impl("add", "ref")
def _add_ref(inputs, attrs):
    return [inputs[0] + inputs[1]]


@impl("mul", "ref")
def _mul_ref(inputs, attrs):
    return [inputs[0] * inputs[1]]


@impl("bias_add", "ref")
def _bias_add_ref(inputs, attrs):
    return [inputs[0] + inputs[1]]


def _act_impl(name: str):
    act = "none" if name == "identity" else name

    def fn(inputs, attrs):
        return [_act(inputs[0], act)]
    return fn


for _name in ("relu", "relu6", "gelu", "silu", "sigmoid", "tanh", "identity"):
    defop(_name, _ew_shape, _ew_cost)
    impl(_name, "ref")(_act_impl(_name))


# fused_elementwise: a chain of unary elementwise ops collapsed into one node
# (created by passes.fuse_elementwise); attrs["ops"] lists the stages in
# application order, e.g. ("relu", "tanh").

def _fused_ew_cost(specs, attrs):
    # one read + one write for the whole chain
    x = specs[0]
    n_stages = max(len(tuple(attrs.get("ops", ()))), 1)
    return Cost(flops=float(n_stages * x.nelems), bytes=2.0 * x.nbytes)


defop("fused_elementwise", _ew_shape, _fused_ew_cost,
      doc="chain of unary elementwise ops; attrs: ops (tuple of op names)")


@impl("fused_elementwise", "ref", note="composes the ref impl of each stage")
def _fused_ew_ref(inputs, attrs):
    (x,) = inputs
    for op_name in tuple(attrs.get("ops", ())):
        (x,) = get_impl(op_name, "ref")([x], {})
    return [x]


defop("softmax", _ew_shape,
      lambda specs, attrs: Cost(5.0 * specs[0].nelems, 2.0 * specs[0].nbytes))


@impl("softmax", "ref")
def _softmax_ref(inputs, attrs):
    return [torch.softmax(inputs[0], dim=int(attrs.get("axis", -1)))]


# --------------------------------------------------------------------------- #
# pooling
# --------------------------------------------------------------------------- #

def _pool_geometry(in_hw, attrs):
    k = _pair(attrs.get("window", 2))
    s = _pair(attrs.get("stride", attrs.get("window", 2)))
    pads = _conv_pads(attrs.get("padding", "VALID"), in_hw, k, s, (1, 1))
    return k, s, pads


def _pool_shape(specs, attrs):
    x = specs[0]
    n, h, w, c = x.shape
    k, s, pads = _pool_geometry((h, w), attrs)
    oh, ow = _conv_out_hw((h, w), k, s, pads, (1, 1))
    return [TensorSpec((n, oh, ow, c), x.dtype)]


def _pool_cost(specs, attrs):
    out = _pool_shape(specs, attrs)[0]
    k = _pair(attrs.get("window", 2))
    return Cost(flops=float(out.nelems * k[0] * k[1]),
                bytes=_bytes_of(specs) + out.nbytes)


defop("maxpool2d", _pool_shape, _pool_cost)
defop("avgpool2d", _pool_shape, _pool_cost)


def _pool(x: torch.Tensor, attrs: Attrs, avg: bool) -> torch.Tensor:
    """JAX's reduce_window: the window over the input padded with the
    reduction's identity (-inf for max, 0 for the sum), the sum divided by
    the whole window (padding included)."""
    k, s, pads = _pool_geometry(tuple(x.shape[1:3]), attrs)
    xc = _pad_hw(x, pads, value=0.0 if avg else float("-inf")).permute(0, 3, 1, 2)
    y = F.avg_pool2d(xc, k, s) if avg else F.max_pool2d(xc, k, s)
    return y.permute(0, 2, 3, 1)


@impl("maxpool2d", "ref")
def _maxpool_ref(inputs, attrs):
    return [_pool(inputs[0], attrs, avg=False)]


@impl("avgpool2d", "ref")
def _avgpool_ref(inputs, attrs):
    return [_pool(inputs[0], attrs, avg=True)]


def _gap_shape(specs, attrs):
    n, h, w, c = specs[0].shape
    return [TensorSpec((n, c), specs[0].dtype)]


defop("global_avgpool", _gap_shape,
      lambda specs, attrs: Cost(float(specs[0].nelems), specs[0].nbytes))


@impl("global_avgpool", "ref")
def _gap_ref(inputs, attrs):
    return [inputs[0].mean(dim=(1, 2))]


# --------------------------------------------------------------------------- #
# batchnorm (inference) — folds to scale/shift
# --------------------------------------------------------------------------- #

defop("batchnorm", _ew_shape,
      lambda specs, attrs: Cost(2.0 * specs[0].nelems, 2.0 * specs[0].nbytes),
      doc="inference BN; inputs (x, scale, bias, mean, var)")


@impl("batchnorm", "ref")
def _bn_ref(inputs, attrs):
    x, scale, bias, mean, var = inputs
    eps = float(attrs.get("eps", 1e-5))
    inv = scale * torch.rsqrt(var + eps)
    return [x * inv + (bias - mean * inv)]


# --------------------------------------------------------------------------- #
# shape plumbing
# --------------------------------------------------------------------------- #

def _flatten_shape(specs, attrs):
    x = specs[0]
    return [TensorSpec((x.shape[0], x.nelems // x.shape[0]), x.dtype)]


defop("flatten", _flatten_shape, lambda s, a: Cost(0.0, 0.0))


@impl("flatten", "ref")
def _flatten_ref(inputs, attrs):
    x = inputs[0]
    return [x.reshape(x.shape[0], -1)]


def _reshape_shape(specs, attrs):
    x = specs[0]
    shape = tuple(int(d) for d in attrs["shape"])
    if -1 in shape:
        known = -int(np.prod(shape))
        shape = tuple(d if d != -1 else x.nelems // known for d in shape)
    if int(np.prod(shape)) != x.nelems:
        raise ValueError(f"reshape {x.shape} -> {shape} size mismatch")
    return [TensorSpec(shape, x.dtype)]


defop("reshape", _reshape_shape, lambda s, a: Cost(0.0, 0.0))


@impl("reshape", "ref")
def _reshape_ref(inputs, attrs):
    return [inputs[0].reshape(tuple(int(d) for d in attrs["shape"]))]


def _transpose_shape(specs, attrs):
    x = specs[0]
    perm = tuple(int(d) for d in attrs["perm"])
    return [TensorSpec(tuple(x.shape[p] for p in perm), x.dtype)]


defop("transpose", _transpose_shape, lambda s, a: Cost(0.0, 2.0 * s[0].nbytes))


@impl("transpose", "ref")
def _transpose_ref(inputs, attrs):
    return [inputs[0].permute(tuple(int(d) for d in attrs["perm"]))]


def _concat_shape(specs, attrs):
    axis = int(attrs.get("axis", -1))
    base = list(specs[0].shape)
    ax = axis % len(base)
    base[ax] = sum(s.shape[ax] for s in specs)
    return [TensorSpec(tuple(base), specs[0].dtype)]


defop("concat", _concat_shape, lambda s, a: Cost(0.0, 2.0 * sum(x.nbytes for x in s)))


@impl("concat", "ref")
def _concat_ref(inputs, attrs):
    return [torch.cat(list(inputs), dim=int(attrs.get("axis", -1)))]
