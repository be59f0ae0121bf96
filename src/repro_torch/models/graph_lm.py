"""A decoder-only transformer LM expressed as GraphIR — the serving engine's
model.  Counterpart of :mod:`repro.models.graph_lm`: the dense-cache and
paged-cache (fp32 or int8 pages) graphs.

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
* paged: the caches are one shared page pool per layer plus a
  ``block_tables`` input; writes and attention go through the ``paged_*``
  ops, and with ``kv_dtype="int8"`` through the ``*_q`` ops with
  ``cache_{k,v}{i}_scale`` sidecars.

The graph LM has no positional encoding (no RoPE), like ``repro``'s.  The
verify and draft builders are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.device import DeviceLike, resolve_device, to_tensor
from repro_torch.core.ir import Graph, Node, TensorSpec

__all__ = ["GraphLMConfig", "init_lm_params", "init_lm_params_torch",
           "params_from_numpy", "build_decode_graph", "build_prefill_graph",
           "init_cache_inputs", "init_paged_cache_inputs", "build_paged_decode_graph",
           "build_paged_prefill_graph"]


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


def init_paged_cache_inputs(cfg: GraphLMConfig, n_blocks: int,
                            page_size: int, *,
                            kv_dtype: str = "float32") -> Dict[str, np.ndarray]:
    """Zeroed page-pool arrays matching the paged graphs' cache input
    names.  Unlike the dense layout there is no batch dimension — one
    shared pool of ``n_blocks`` fixed-size pages per layer, indexed
    through per-sequence block tables.  With ``kv_dtype="int8"`` the
    pools are int8 and each gains a ``cache_{k,v}{i}_scale`` sidecar
    ((n_blocks, Hk) float32, all zeros = every page empty)."""
    if kv_dtype not in ("float32", "int8"):
        raise ValueError(f"unsupported kv_dtype {kv_dtype!r}")
    shape = (n_blocks, page_size, cfg.n_kv_heads, cfg.d_head)
    dt = np.int8 if kv_dtype == "int8" else np.float32
    out: Dict[str, np.ndarray] = {}
    for i in range(cfg.n_layers):
        out[f"cache_k{i}"] = np.zeros(shape, dt)
        out[f"cache_v{i}"] = np.zeros(shape, dt)
        if kv_dtype == "int8":
            sshape = (n_blocks, cfg.n_kv_heads)
            out[f"cache_k{i}_scale"] = np.zeros(sshape, np.float32)
            out[f"cache_v{i}_scale"] = np.zeros(sshape, np.float32)
    return out


def _lm_graph(cfg: GraphLMConfig, params: Dict[str, Any], *, batch: int,
              t: int, cache_cap: int, decode: bool,
              paged: Optional[Tuple[int, int, int]] = None,
              kv_dtype: str = "float32") -> Graph:
    if t > cache_cap:
        raise ValueError(f"chunk {t} exceeds cache capacity {cache_cap}")
    if kv_dtype not in ("float32", "int8"):
        raise ValueError(f"unsupported kv_dtype {kv_dtype!r}")
    kv8 = kv_dtype == "int8"
    if kv8 and paged is None:
        raise ValueError("kv_dtype='int8' requires the paged cache layout")
    dm, dh, hq, hk = cfg.d_model, cfg.d_head, cfg.n_heads, cfg.n_kv_heads
    inputs: Dict[str, TensorSpec] = {
        "tokens": TensorSpec((batch, t), "int32"),
        "start": TensorSpec((batch,), "int32"),
        "n_new": TensorSpec((batch,), "int32"),
    }
    if paged is None:
        for i in range(cfg.n_layers):
            spec = TensorSpec((batch, cache_cap, hk, dh), "float32")
            inputs[f"cache_k{i}"] = spec
            inputs[f"cache_v{i}"] = spec
    else:
        n_blocks, page_size, max_pages = paged
        inputs["block_tables"] = TensorSpec((batch, max_pages), "int32")
        for i in range(cfg.n_layers):
            spec = TensorSpec((n_blocks, page_size, hk, dh), kv_dtype)
            inputs[f"cache_k{i}"] = spec
            inputs[f"cache_v{i}"] = spec
            if kv8:
                sspec = TensorSpec((n_blocks, hk), "float32")
                inputs[f"cache_k{i}_scale"] = sspec
                inputs[f"cache_v{i}_scale"] = sspec

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
        ]
        if paged is None:
            nodes += [
                Node(f"{L}.k_write", "cache_update",
                     [f"cache_k{i}", f"{L}.k4", "start", "n_new"],
                     [f"new_cache_k{i}"]),
                Node(f"{L}.v_write", "cache_update",
                     [f"cache_v{i}", f"{L}.v4", "start", "n_new"],
                     [f"new_cache_v{i}"]),
            ]
        elif kv8:
            nodes += [
                Node(f"{L}.k_write", "paged_cache_update_q",
                     [f"cache_k{i}", f"cache_k{i}_scale", f"{L}.k4",
                      "block_tables", "start", "n_new"],
                     [f"new_cache_k{i}", f"new_cache_k{i}_scale"]),
                Node(f"{L}.v_write", "paged_cache_update_q",
                     [f"cache_v{i}", f"cache_v{i}_scale", f"{L}.v4",
                      "block_tables", "start", "n_new"],
                     [f"new_cache_v{i}", f"new_cache_v{i}_scale"]),
            ]
        else:
            nodes += [
                Node(f"{L}.k_write", "paged_cache_update",
                     [f"cache_k{i}", f"{L}.k4", "block_tables", "start", "n_new"],
                     [f"new_cache_k{i}"]),
                Node(f"{L}.v_write", "paged_cache_update",
                     [f"cache_v{i}", f"{L}.v4", "block_tables", "start", "n_new"],
                     [f"new_cache_v{i}"]),
            ]
        if decode:
            nodes.append(Node(f"{L}.q_heads", "reshape", [f"{L}.q"],
                              [f"{L}.qd"], {"shape": (batch, hq, dh)}))
            if paged is None:
                nodes.append(Node(
                    f"{L}.attn", "decode_attention",
                    [f"{L}.qd", f"new_cache_k{i}", f"new_cache_v{i}", "kvlen"],
                    [f"{L}.att"]))
            elif kv8:
                nodes.append(Node(
                    f"{L}.attn", "paged_decode_attention_q",
                    [f"{L}.qd", f"new_cache_k{i}", f"new_cache_k{i}_scale",
                     f"new_cache_v{i}", f"new_cache_v{i}_scale",
                     "block_tables", "kvlen"], [f"{L}.att"]))
            else:
                nodes.append(Node(
                    f"{L}.attn", "paged_decode_attention",
                    [f"{L}.qd", f"new_cache_k{i}", f"new_cache_v{i}",
                     "block_tables", "kvlen"], [f"{L}.att"]))
        else:
            nodes.append(Node(f"{L}.q_heads", "reshape", [f"{L}.q"],
                              [f"{L}.q4"], {"shape": (batch, t, hq, dh)}))
            if paged is None:
                nodes.append(Node(
                    f"{L}.attn", "chunk_attention",
                    [f"{L}.q4", f"new_cache_k{i}", f"new_cache_v{i}", "start"],
                    [f"{L}.att"]))
            elif kv8:
                nodes.append(Node(
                    f"{L}.attn", "paged_chunk_attention_q",
                    [f"{L}.q4", f"new_cache_k{i}", f"new_cache_k{i}_scale",
                     f"new_cache_v{i}", f"new_cache_v{i}_scale",
                     "block_tables", "start"], [f"{L}.att"]))
            else:
                nodes.append(Node(
                    f"{L}.attn", "paged_chunk_attention",
                    [f"{L}.q4", f"new_cache_k{i}", f"new_cache_v{i}",
                     "block_tables", "start"], [f"{L}.att"]))
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
        if kv8:
            outputs += [f"new_cache_k{i}_scale", f"new_cache_v{i}_scale"]
    mode = "decode" if decode else "prefill"
    tag = ("paged_kv8_" if kv8 else "paged_") if paged is not None else ""
    g = Graph(name=f"graph_lm_{tag}{mode}_b{batch}_t{t}", inputs=inputs,
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


def build_paged_decode_graph(cfg: GraphLMConfig, params: Dict[str, Any], *,
                             batch: int, n_blocks: int, page_size: int,
                             max_pages: int,
                             kv_dtype: str = "float32") -> Graph:
    """Paged decode step: the dense caches are replaced by one shared
    page pool per layer (``(n_blocks, page_size, Hk, D)``) plus an int32
    ``block_tables`` input ``(B, max_pages)`` mapping each slot's logical
    page to a physical block.  Every activation value name matches the
    dense variant.

    ``kv_dtype="int8"`` swaps the pools to int8 with per-(page, kv-head)
    float32 scale sidecars (``cache_{k,v}{i}_scale`` inputs ->
    ``new_...`` outputs) and routes writes/attention through the
    ``*_q`` serving ops."""
    return _lm_graph(cfg, params, batch=batch, t=1,
                     cache_cap=max_pages * page_size, decode=True,
                     paged=(n_blocks, page_size, max_pages),
                     kv_dtype=kv_dtype)


def build_paged_prefill_graph(cfg: GraphLMConfig, params: Dict[str, Any], *,
                              batch: int, chunk: int, n_blocks: int,
                              page_size: int, max_pages: int,
                              kv_dtype: str = "float32") -> Graph:
    """Paged prefill chunk — see :func:`build_paged_decode_graph` for the
    cache layout (and the ``kv_dtype`` knob); chunk semantics match
    :func:`build_prefill_graph`."""
    return _lm_graph(cfg, params, batch=batch, t=chunk,
                     cache_cap=max_pages * page_size, decode=False,
                     paged=(n_blocks, page_size, max_pages),
                     kv_dtype=kv_dtype)
