"""The paper's five evaluation CNNs (Fig. 2) as GraphIR builders:
WRN-40-2, MobileNetV1, ResNet-18, Inception-v3, ResNet-50 — counterpart of
:mod:`repro.models.cnn`, a copy of its numpy-only builders on the port's
:mod:`repro_torch.core.ir`, so the graphs and the seeded weights are the
JAX package's node for node and bit for bit.

Built the way an ONNX import would land: conv / batchnorm / relu / pool /
dense nodes with weights as graph params, so the simplification pipeline
(BN folding, bias+act fusion) and the backend comparison (GEMM vs direct
vs winograd vs the cuda GEMM conv) run on the structures the paper
measured.  Weights are seeded-random (inference timing doesn't care).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.ir import Graph, Node, TensorSpec

__all__ = ["build_cnn", "CNN_MODELS"]


class _GB:
    """Tiny graph builder."""

    def __init__(self, name: str, input_shape: Tuple[int, ...], seed: int = 0):
        self.g = Graph(name=name, inputs={"x": TensorSpec(input_shape)},
                       outputs=[], nodes=[], params={})
        self.rng = np.random.default_rng(seed)
        self.n = 0

    def _name(self, op: str) -> str:
        self.n += 1
        return f"{op}_{self.n}"

    def _param(self, name: str, shape, scale=None) -> str:
        fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else shape[0]
        scale = scale if scale is not None else (1.0 / max(fan_in, 1)) ** 0.5
        self.g.params[name] = (self.rng.standard_normal(shape) * scale
                               ).astype(np.float32)
        return name

    def _node(self, op: str, inputs: List[str], attrs=None) -> str:
        name = self._name(op)
        out = f"{name}.out"
        self.g.nodes.append(Node(name, op, inputs, [out], attrs or {}))
        return out

    # ------------------------------------------------------------------ #
    def conv(self, x: str, ci: int, co: int, k: int, stride: int = 1,
             padding: str = "SAME", groups: int = 1) -> str:
        w = self._param(self._name("w"), (k, k, ci // groups, co))
        return self._node("conv2d", [x, w],
                          {"stride": stride, "padding": padding, "groups": groups})

    def bn(self, x: str, c: int) -> str:
        pre = self._name("bn")
        names = [self._param(f"{pre}.{s}", (c,), scale=1.0) for s in
                 ("scale", "bias", "mean")]
        var = f"{pre}.var"
        self.g.params[var] = np.abs(self.rng.standard_normal((c,))
                                    ).astype(np.float32) + 0.5
        return self._node("batchnorm", [x] + names + [var], {"eps": 1e-5})

    def relu(self, x: str) -> str:
        return self._node("relu", [x])

    def add(self, a: str, b: str) -> str:
        return self._node("add", [a, b])

    def maxpool(self, x: str, k: int, s: int, padding="SAME") -> str:
        return self._node("maxpool2d", [x], {"window": k, "stride": s,
                                             "padding": padding})

    def avgpool(self, x: str, k: int, s: int, padding="SAME") -> str:
        return self._node("avgpool2d", [x], {"window": k, "stride": s,
                                             "padding": padding})

    def gap(self, x: str) -> str:
        return self._node("global_avgpool", [x])

    def concat(self, xs: List[str]) -> str:
        return self._node("concat", xs, {"axis": -1})

    def head(self, x: str, ci: int, classes: int = 1000) -> str:
        w = self._param(self._name("w"), (ci, classes))
        b = self._param(self._name("b"), (classes,), scale=0.0)
        h = self._node("dense", [x, w])
        return self._node("bias_add", [h, b])

    def cbr(self, x: str, ci: int, co: int, k: int, stride: int = 1,
            padding="SAME", groups: int = 1, act: bool = True) -> str:
        h = self.bn(self.conv(x, ci, co, k, stride, padding, groups), co)
        return self.relu(h) if act else h

    def done(self, out: str) -> Graph:
        self.g.outputs = [out]
        self.g.validate()
        return self.g


# --------------------------------------------------------------------------- #

def resnet18(batch: int = 1) -> Graph:
    b = _GB("resnet18", (batch, 224, 224, 3), seed=18)
    h = b.cbr("x", 3, 64, 7, 2)
    h = b.maxpool(h, 3, 2)
    c = 64
    for stage, (co, blocks) in enumerate([(64, 2), (128, 2), (256, 2), (512, 2)]):
        for i in range(blocks):
            stride = 2 if (i == 0 and stage > 0) else 1
            sc = h if (stride == 1 and c == co) else b.cbr(h, c, co, 1, stride, act=False)
            y = b.cbr(h, c, co, 3, stride)
            y = b.cbr(y, co, co, 3, 1, act=False)
            h = b.relu(b.add(y, sc))
            c = co
    return b.done(b.head(b.gap(h), 512))


def resnet50(batch: int = 1) -> Graph:
    b = _GB("resnet50", (batch, 224, 224, 3), seed=50)
    h = b.cbr("x", 3, 64, 7, 2)
    h = b.maxpool(h, 3, 2)
    c = 64
    for stage, (w, blocks) in enumerate([(64, 3), (128, 4), (256, 6), (512, 3)]):
        co = w * 4
        for i in range(blocks):
            stride = 2 if (i == 0 and stage > 0) else 1
            sc = h if (stride == 1 and c == co) else b.cbr(h, c, co, 1, stride, act=False)
            y = b.cbr(h, c, w, 1, 1)
            y = b.cbr(y, w, w, 3, stride)
            y = b.cbr(y, w, co, 1, 1, act=False)
            h = b.relu(b.add(y, sc))
            c = co
    return b.done(b.head(b.gap(h), 2048))


def wrn_40_2(batch: int = 1) -> Graph:
    """Wide ResNet 40-2 (CIFAR): n=(40-4)/6=6 blocks/group, widen 2."""
    b = _GB("wrn40_2", (batch, 32, 32, 3), seed=40)
    h = b.cbr("x", 3, 16, 3, 1)
    c = 16
    for stage, co in enumerate([32, 64, 128]):
        for i in range(6):
            stride = 2 if (i == 0 and stage > 0) else 1
            sc = h if (stride == 1 and c == co) else b.cbr(h, c, co, 1, stride, act=False)
            y = b.cbr(h, c, co, 3, stride)
            y = b.cbr(y, co, co, 3, 1, act=False)
            h = b.relu(b.add(y, sc))
            c = co
    return b.done(b.head(b.gap(h), 128, classes=10))


def mobilenet_v1(batch: int = 1) -> Graph:
    b = _GB("mobilenet_v1", (batch, 224, 224, 3), seed=1)
    h = b.cbr("x", 3, 32, 3, 2)
    c = 32
    plan = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
            (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
            (1024, 1)]
    for co, stride in plan:
        h = b.cbr(h, c, c, 3, stride, groups=c)    # depthwise
        h = b.cbr(h, c, co, 1, 1)                  # pointwise
        c = co
    return b.done(b.head(b.gap(h), 1024))


def _inception_a(b: _GB, x: str, ci: int, pool_ch: int) -> Tuple[str, int]:
    b1 = b.cbr(x, ci, 64, 1)
    b2 = b.cbr(b.cbr(x, ci, 48, 1), 48, 64, 5)
    b3 = b.cbr(b.cbr(b.cbr(x, ci, 64, 1), 64, 96, 3), 96, 96, 3)
    b4 = b.cbr(b.avgpool(x, 3, 1), ci, pool_ch, 1)
    return b.concat([b1, b2, b3, b4]), 64 + 64 + 96 + pool_ch


def _inception_b(b: _GB, x: str, ci: int, c7: int) -> Tuple[str, int]:
    b1 = b.cbr(x, ci, 192, 1)
    h = b.cbr(x, ci, c7, 1)
    h = b.cbr(h, c7, c7, 1)   # 1x7 simplified to 1x1+3x3 pair cost-equivalent
    b2 = b.cbr(h, c7, 192, 3)
    h = b.cbr(x, ci, c7, 1)
    h = b.cbr(h, c7, c7, 3)
    b3 = b.cbr(h, c7, 192, 3)
    b4 = b.cbr(b.avgpool(x, 3, 1), ci, 192, 1)
    return b.concat([b1, b2, b3, b4]), 192 * 4


def _inception_c(b: _GB, x: str, ci: int) -> Tuple[str, int]:
    b1 = b.cbr(x, ci, 320, 1)
    h = b.cbr(x, ci, 384, 1)
    b2 = b.concat([b.cbr(h, 384, 384, 3), b.cbr(h, 384, 384, 3)])
    h = b.cbr(x, ci, 448, 1)
    h = b.cbr(h, 448, 384, 3)
    b3 = b.concat([b.cbr(h, 384, 384, 3), b.cbr(h, 384, 384, 3)])
    b4 = b.cbr(b.avgpool(x, 3, 1), ci, 192, 1)
    return b.concat([b1, b2, b3, b4]), 320 + 768 + 768 + 192


def inception_v3(batch: int = 1) -> Graph:
    """Inception-v3 (299x299); 1x7/7x1 factorised convs approximated by
    cost-equivalent 3x3s (documented simplification — the backend comparison
    is about conv algorithm choice, not exact Inception kernels)."""
    b = _GB("inception_v3", (batch, 299, 299, 3), seed=3)
    h = b.cbr("x", 3, 32, 3, 2, padding="VALID")
    h = b.cbr(h, 32, 32, 3, 1, padding="VALID")
    h = b.cbr(h, 32, 64, 3, 1)
    h = b.maxpool(h, 3, 2, padding="VALID")
    h = b.cbr(h, 64, 80, 1)
    h = b.cbr(h, 80, 192, 3, 1, padding="VALID")
    h = b.maxpool(h, 3, 2, padding="VALID")
    ci = 192
    for pool_ch in (32, 64, 64):
        h, ci = _inception_a(b, h, ci, pool_ch)
    # reduction A
    r1 = b.cbr(h, ci, 384, 3, 2, padding="VALID")
    r2 = b.cbr(b.cbr(b.cbr(h, ci, 64, 1), 64, 96, 3), 96, 96, 3, 2, padding="VALID")
    r3 = b.maxpool(h, 3, 2, padding="VALID")
    h = b.concat([r1, r2, r3])
    ci = 384 + 96 + ci
    for c7 in (128, 160, 160, 192):
        h, ci = _inception_b(b, h, ci, c7)
    # reduction B
    r1 = b.cbr(b.cbr(h, ci, 192, 1), 192, 320, 3, 2, padding="VALID")
    r2 = b.cbr(b.cbr(b.cbr(h, ci, 192, 1), 192, 192, 3), 192, 192, 3, 2,
               padding="VALID")
    r3 = b.maxpool(h, 3, 2, padding="VALID")
    h = b.concat([r1, r2, r3])
    ci = 320 + 192 + ci
    for _ in range(2):
        h, ci = _inception_c(b, h, ci)
    return b.done(b.head(b.gap(h), ci))


CNN_MODELS = {
    "wrn-40-2": wrn_40_2,
    "mobilenet-v1": mobilenet_v1,
    "resnet-18": resnet18,
    "inception-v3": inception_v3,
    "resnet-50": resnet50,
}


def build_cnn(name: str, batch: int = 1) -> Graph:
    return CNN_MODELS[name](batch)
