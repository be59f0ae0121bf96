"""A decoder-only transformer LM expressed as GraphIR — the serving engine's
model.  Counterpart of :mod:`repro.models.graph_lm`, dense-cache branch.

The builders emit the same nodes, value names and attrs as ``repro``'s, so
a graph compiled in either package is node for node the same, and
:func:`init_lm_params` draws bit-identical weights from the same seed.
:func:`params_from_numpy` carries those weights over to the port (numpy ->
torch on a device); :func:`init_lm_params_torch` draws weights of the same
distributions directly on a device from a seeded ``torch.Generator`` (not
the same numbers), for full-width models whose 3.8 B normals would take
minutes to draw on the host.

State is functional: KV caches are graph *inputs* and *outputs*
(``cache_k{i}`` -> ``new_cache_k{i}``).

* decode:  tokens (B, 1)  — one token per slot, ``decode_attention``.
* prefill: tokens (B, T)  — one chunk per slot, ``chunk_attention``;
  ``n_new[b] <= T`` marks the valid prefix (0 = slot idle this step).

The graph LM has no positional encoding (no RoPE), like ``repro``'s.  The
paged, int8, verify and draft builders are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Mapping

import numpy as np
import torch

from repro_torch.core.device import DeviceLike, resolve_device, to_tensor
from repro_torch.core.ir import Graph, Node, TensorSpec

__all__ = ["GraphLMConfig", "init_lm_params", "init_lm_params_torch",
           "params_from_numpy", "build_decode_graph", "build_prefill_graph",
           "init_cache_inputs"]


@dataclass(frozen=True)
class GraphLMConfig:
    """Shape of the graph LM.  ``d_head = d_model // n_heads``; GQA when
    ``n_kv_heads < n_heads``."""

    vocab: int = 128
    d_model: int = 64
    n_layers: int = 2
    n_heads: int = 4
    n_kv_heads: int = 2
    d_ff: int = 128
    eps: float = 1e-6

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads


def _param_shapes(cfg: GraphLMConfig) -> Dict[str, tuple]:
    """Every parameter's shape, in ``init_lm_params``'s draw order."""
    dm, dh = cfg.d_model, cfg.d_head
    shapes: Dict[str, tuple] = {"embed": (cfg.vocab, dm), "final_norm": (dm,),
                                "head_w": (dm, cfg.vocab)}
    for i in range(cfg.n_layers):
        shapes.update({
            f"l{i}.norm1": (dm,), f"l{i}.wq": (dm, cfg.n_heads * dh),
            f"l{i}.wk": (dm, cfg.n_kv_heads * dh), f"l{i}.wv": (dm, cfg.n_kv_heads * dh),
            f"l{i}.wo": (cfg.n_heads * dh, dm), f"l{i}.norm2": (dm,),
            f"l{i}.wg": (dm, cfg.d_ff), f"l{i}.wu": (dm, cfg.d_ff),
            f"l{i}.wd": (cfg.d_ff, dm)})
    return shapes


def init_lm_params(cfg: GraphLMConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    """Deterministic random weights (numpy, float32), keyed by the value
    names the graph builders reference — bit-identical to
    ``repro.models.graph_lm.init_lm_params`` for the same seed."""
    rng = np.random.default_rng(seed)

    def dense(din: int, dout: int) -> np.ndarray:
        return (rng.standard_normal((din, dout)) / np.sqrt(din)).astype(np.float32)

    dm, dh = cfg.d_model, cfg.d_head
    p: Dict[str, np.ndarray] = {
        "embed": (rng.standard_normal((cfg.vocab, dm)) * 0.5).astype(np.float32),
        "final_norm": np.ones((dm,), np.float32),
        "head_w": dense(dm, cfg.vocab),
    }
    for i in range(cfg.n_layers):
        p[f"l{i}.norm1"] = np.ones((dm,), np.float32)
        p[f"l{i}.wq"] = dense(dm, cfg.n_heads * dh)
        p[f"l{i}.wk"] = dense(dm, cfg.n_kv_heads * dh)
        p[f"l{i}.wv"] = dense(dm, cfg.n_kv_heads * dh)
        p[f"l{i}.wo"] = dense(cfg.n_heads * dh, dm)
        p[f"l{i}.norm2"] = np.ones((dm,), np.float32)
        p[f"l{i}.wg"] = dense(dm, cfg.d_ff)
        p[f"l{i}.wu"] = dense(dm, cfg.d_ff)
        p[f"l{i}.wd"] = dense(cfg.d_ff, dm)
    return p


def init_lm_params_torch(cfg: GraphLMConfig, seed: int = 0, *,
                         device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Weights with :func:`init_lm_params`'s distributions (embed ~ N(0,
    0.25), dense ~ N(0, 1/din), norms 1), drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed``.  Not the same numbers as the
    numpy draw."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out: Dict[str, torch.Tensor] = {}
    for name, shape in _param_shapes(cfg).items():
        if len(shape) == 1:
            out[name] = torch.ones(shape, dtype=torch.float32, device=dev)
            continue
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
        out[name] = w.mul_(0.5) if name == "embed" else w.div_(float(np.sqrt(shape[0])))
    return out


def params_from_numpy(params: Mapping[str, Any],
                      device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The JAX package's parameters (numpy arrays) as the port's: torch
    tensors on ``device``, same values bit for bit.  Tensors already on the
    device pass through unchanged."""
    dev = resolve_device(device)
    return {k: to_tensor(v, dev) for k, v in params.items()}


def init_cache_inputs(cfg: GraphLMConfig, batch: int,
                      cache_cap: int) -> Dict[str, np.ndarray]:
    """Zeroed cache arrays matching the graph's cache input names."""
    shape = (batch, cache_cap, cfg.n_kv_heads, cfg.d_head)
    out: Dict[str, np.ndarray] = {}
    for i in range(cfg.n_layers):
        out[f"cache_k{i}"] = np.zeros(shape, np.float32)
        out[f"cache_v{i}"] = np.zeros(shape, np.float32)
    return out


def _lm_graph(cfg: GraphLMConfig, params: Dict[str, Any], *, batch: int,
              t: int, cache_cap: int, decode: bool) -> Graph:
    if t > cache_cap:
        raise ValueError(f"chunk {t} exceeds cache capacity {cache_cap}")
    dm, dh, hq, hk = cfg.d_model, cfg.d_head, cfg.n_heads, cfg.n_kv_heads
    inputs: Dict[str, TensorSpec] = {
        "tokens": TensorSpec((batch, t), "int32"),
        "start": TensorSpec((batch,), "int32"),
        "n_new": TensorSpec((batch,), "int32"),
    }
    for i in range(cfg.n_layers):
        spec = TensorSpec((batch, cache_cap, hk, dh), "float32")
        inputs[f"cache_k{i}"] = spec
        inputs[f"cache_v{i}"] = spec

    nodes: List[Node] = [Node("embed_lookup", "embedding",
                              ["tokens", "embed"], ["x0"])]
    if decode:
        nodes.append(Node("kv_len", "add", ["start", "n_new"], ["kvlen"]))
    x = "x0"
    eps = {"eps": cfg.eps}
    for i in range(cfg.n_layers):
        L = f"l{i}"
        nodes += [
            Node(f"{L}.attn_norm", "rmsnorm", [x, f"{L}.norm1"], [f"{L}.h1"], dict(eps)),
            Node(f"{L}.q_proj", "dense", [f"{L}.h1", f"{L}.wq"], [f"{L}.q"]),
            Node(f"{L}.k_proj", "dense", [f"{L}.h1", f"{L}.wk"], [f"{L}.k"]),
            Node(f"{L}.v_proj", "dense", [f"{L}.h1", f"{L}.wv"], [f"{L}.v"]),
            Node(f"{L}.k_heads", "reshape", [f"{L}.k"], [f"{L}.k4"],
                 {"shape": (batch, t, hk, dh)}),
            Node(f"{L}.v_heads", "reshape", [f"{L}.v"], [f"{L}.v4"],
                 {"shape": (batch, t, hk, dh)}),
            Node(f"{L}.k_write", "cache_update",
                 [f"cache_k{i}", f"{L}.k4", "start", "n_new"],
                 [f"new_cache_k{i}"]),
            Node(f"{L}.v_write", "cache_update",
                 [f"cache_v{i}", f"{L}.v4", "start", "n_new"],
                 [f"new_cache_v{i}"]),
        ]
        if decode:
            nodes += [
                Node(f"{L}.q_heads", "reshape", [f"{L}.q"],
                     [f"{L}.qd"], {"shape": (batch, hq, dh)}),
                Node(f"{L}.attn", "decode_attention",
                     [f"{L}.qd", f"new_cache_k{i}", f"new_cache_v{i}", "kvlen"],
                     [f"{L}.att"]),
            ]
        else:
            nodes += [
                Node(f"{L}.q_heads", "reshape", [f"{L}.q"],
                     [f"{L}.q4"], {"shape": (batch, t, hq, dh)}),
                Node(f"{L}.attn", "chunk_attention",
                     [f"{L}.q4", f"new_cache_k{i}", f"new_cache_v{i}", "start"],
                     [f"{L}.att"]),
            ]
        nodes += [
            Node(f"{L}.attn_flat", "reshape", [f"{L}.att"], [f"{L}.attn2"],
                 {"shape": (batch, t, hq * dh)}),
            Node(f"{L}.o_proj", "dense", [f"{L}.attn2", f"{L}.wo"], [f"{L}.proj"]),
            Node(f"{L}.attn_res", "add", [x, f"{L}.proj"], [f"{L}.xa"]),
            Node(f"{L}.mlp_norm", "rmsnorm", [f"{L}.xa", f"{L}.norm2"],
                 [f"{L}.h2"], dict(eps)),
            Node(f"{L}.gate_proj", "dense", [f"{L}.h2", f"{L}.wg"], [f"{L}.gate"]),
            Node(f"{L}.up_proj", "dense", [f"{L}.h2", f"{L}.wu"], [f"{L}.up"]),
            Node(f"{L}.swiglu", "swiglu", [f"{L}.gate", f"{L}.up"], [f"{L}.act"]),
            Node(f"{L}.down_proj", "dense", [f"{L}.act", f"{L}.wd"], [f"{L}.down"]),
            Node(f"{L}.mlp_res", "add", [f"{L}.xa", f"{L}.down"], [f"{L}.out"]),
        ]
        x = f"{L}.out"
    nodes.append(Node("final_norm_n", "rmsnorm", [x, "final_norm"],
                      ["final_h"], dict(eps)))
    if decode:
        nodes += [
            Node("lm_head", "dense", ["final_h", "head_w"], ["logits3"]),
            Node("logits_flat", "reshape", ["logits3"], ["logits"],
                 {"shape": (batch, cfg.vocab)}),
        ]
    else:
        nodes.append(Node("lm_head", "dense", ["final_h", "head_w"], ["logits"]))
    outputs = ["logits"]
    for i in range(cfg.n_layers):
        outputs += [f"new_cache_k{i}", f"new_cache_v{i}"]
    mode = "decode" if decode else "prefill"
    g = Graph(name=f"graph_lm_{mode}_b{batch}_t{t}", inputs=inputs,
              outputs=outputs, nodes=nodes, params=dict(params))
    g.validate()
    return g


def build_decode_graph(cfg: GraphLMConfig, params: Dict[str, Any], *,
                       batch: int, cache_cap: int) -> Graph:
    """One decode step for a fixed batch of slots: tokens (B, 1) + caches
    -> next-token logits (B, V) + updated caches.  ``n_new[b]`` in {0, 1}
    gates the cache write, so idle slots are untouched."""
    return _lm_graph(cfg, params, batch=batch, t=1, cache_cap=cache_cap,
                     decode=True)


def build_prefill_graph(cfg: GraphLMConfig, params: Dict[str, Any], *,
                        batch: int, chunk: int, cache_cap: int) -> Graph:
    """One prefill chunk: tokens (B, T) at absolute positions
    ``start .. start+n_new-1`` -> per-position logits (B, T, V) + updated
    caches.  Positions >= ``n_new[b]`` are padding (outputs ignored; their
    cache rows are never written)."""
    return _lm_graph(cfg, params, batch=batch, t=chunk, cache_cap=cache_cap,
                     decode=False)
