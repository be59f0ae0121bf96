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

* speculative decoding: the verify graphs (a chunk of T = spec_k + 1 rows
  through the ``*verify_attention*`` ops; for int8 pages, and in the port
  for int8 weights, the decode step unrolled T times), the int8
  spec-commit graph and the unrolled draft graph, whose step-suffixed value names :func:`expand_spec_ranges` maps a
  shared calibration onto.

The graph LM has no positional encoding (no RoPE), like ``repro``'s.
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
           "build_paged_prefill_graph", "build_verify_graph", "build_paged_verify_graph",
           "build_paged_verify_seq_graph", "build_verify_seq_graph",
           "build_spec_commit_graph", "build_draft_graph", "expand_spec_ranges",
           "partition_roles"]


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
              t: int, cache_cap: int, decode: bool, verify: bool = False,
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
            # kv8 VERIFY never writes pages: quantize-on-write scales only
            # grow, and a raise lossily requantizes the whole page, so a
            # rejected draft row would permanently perturb committed rows
            # sharing its page.  Attention reads the new rows from the
            # fp32 k4/v4 instead (two-source) and accepted rows commit via
            # the separate spec-commit Program.
            if not verify:
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
            # a verify step IS a prefill chunk of T = K+1 rows, but it runs
            # through the verify_attention op family so the selector can
            # pick a backend for the verify shape independently; value
            # names stay identical to the prefill variant, so one
            # calibration drives both
            if paged is None:
                op = "verify_attention" if verify else "chunk_attention"
                nodes.append(Node(
                    f"{L}.attn", op,
                    [f"{L}.q4", f"new_cache_k{i}", f"new_cache_v{i}", "start"],
                    [f"{L}.att"]))
            elif kv8:
                if verify:
                    nodes.append(Node(
                        f"{L}.attn", "paged_verify_attention_q",
                        [f"{L}.q4", f"cache_k{i}", f"cache_k{i}_scale",
                         f"cache_v{i}", f"cache_v{i}_scale",
                         "block_tables", "start", f"{L}.k4", f"{L}.v4"],
                        [f"{L}.att"]))
                else:
                    nodes.append(Node(
                        f"{L}.attn", "paged_chunk_attention_q",
                        [f"{L}.q4", f"new_cache_k{i}",
                         f"new_cache_k{i}_scale", f"new_cache_v{i}",
                         f"new_cache_v{i}_scale", "block_tables", "start"],
                        [f"{L}.att"]))
            else:
                op = ("paged_verify_attention" if verify
                      else "paged_chunk_attention")
                nodes.append(Node(
                    f"{L}.attn", op,
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
    if kv8 and verify:
        # no page writes happened; hand the fp32 K/V rows of this call's
        # speculative chunk back to the engine for the post-acceptance
        # spec-commit write
        for i in range(cfg.n_layers):
            outputs += [f"l{i}.k4", f"l{i}.v4"]
    else:
        for i in range(cfg.n_layers):
            outputs += [f"new_cache_k{i}", f"new_cache_v{i}"]
            if kv8:
                outputs += [f"new_cache_k{i}_scale",
                            f"new_cache_v{i}_scale"]
    mode = "decode" if decode else ("verify" if verify else "prefill")
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


def build_verify_graph(cfg: GraphLMConfig, params: Dict[str, Any], *,
                       batch: int, width: int, cache_cap: int) -> Graph:
    """Speculative-verify step: tokens (B, width) — the committed next
    token plus up to ``width - 1`` draft proposals per slot — scored
    against the dense cache in one call, returning per-position logits
    (B, width, V).  Structurally a prefill chunk of T = ``width`` rows
    (``n_new[b] <= width`` marks the valid prefix, 0 = idle), but the
    attention runs through ``verify_attention`` so backend selection for
    the verify shape is independent of the prefill chunk.  Value names
    match the prefill variant exactly — one calibration drives both, which
    is what keeps int8 speculative decode token-exact."""
    return _lm_graph(cfg, params, batch=batch, t=width, cache_cap=cache_cap,
                     decode=False, verify=True)


def build_paged_verify_graph(cfg: GraphLMConfig, params: Dict[str, Any], *,
                             batch: int, width: int, n_blocks: int,
                             page_size: int, max_pages: int,
                             kv_dtype: str = "float32") -> Graph:
    """Paged speculative-verify step — see :func:`build_verify_graph`;
    cache layout and ``kv_dtype`` as in :func:`build_paged_decode_graph`
    (``paged_verify_attention`` / ``paged_verify_attention_q``)."""
    return _lm_graph(cfg, params, batch=batch, t=width,
                     cache_cap=max_pages * page_size, decode=False,
                     verify=True, paged=(n_blocks, page_size, max_pages),
                     kv_dtype=kv_dtype)


def build_paged_verify_seq_graph(cfg: GraphLMConfig, params: Dict[str, Any],
                                 *, batch: int, width: int, n_blocks: int,
                                 page_size: int, max_pages: int) -> Graph:
    """The kv8 engine's verify Program: ``width`` single-row decode stages
    unrolled into ONE graph, threading the int8 page state stage to stage.

    Why not the chunk-shaped :func:`build_paged_verify_graph` here?
    Quantize-on-write makes int8 page bytes HISTORY-dependent (scales
    ratchet up; a raise requantizes the page), so a batched verify cannot
    reproduce plain decode's numerics bit-for-bit — and near-tied argmax
    rows would then flip tokens vs a non-speculative run.  This variant
    IS plain decode, stage by stage: stage ``j`` embeds its own token
    input (``tokens.s{j}``), quantize-writes that row in-graph, and runs
    ``paged_decode_attention_q`` at exactly the decode shapes — so every
    stage's logits are bit-identical to the decode Program at the same
    position, dispatched once instead of ``width`` times.  The threaded
    page state is DISCARDED (it includes later-rejected rows); instead
    each stage's fp32 ``k4``/``v4`` rows are returned so the spec-commit
    replay (:func:`build_spec_commit_graph`) can rebuild the accepted
    prefix of the very same write sequence against the live pages.

    Stage masks ``n_new.s{j}`` are 1 while ``j`` is inside the slot's fed
    width, else 0 (idle stage: no write, garbage logits, ignored); the
    ``spec.one`` ones-vector param advances ``start`` in-graph.

    Outputs: ``logits.s0 .. logits.s{width-1}`` then per stage, per
    layer, the fp32 ``l{i}.k4.s{j}`` / ``l{i}.v4.s{j}`` rows."""
    return _decode_seq_graph(cfg, params, batch=batch, width=width,
                             paged=(n_blocks, page_size, max_pages), kv8=True)


def build_verify_seq_graph(cfg: GraphLMConfig, params: Dict[str, Any], *, batch: int,
                           width: int, cache_cap: Optional[int] = None,
                           paged: Optional[Tuple[int, int, int]] = None) -> Graph:
    """The verify Program of an int8-WEIGHT engine over fp32 caches: the
    decode step unrolled ``width`` times in one graph, as
    :func:`build_paged_verify_seq_graph` does for int8 pages (the JAX package
    has no counterpart: its int8-weight engines verify with the chunk-shaped
    graph).

    Why: int8 weights quantize every dense node's input activation with a
    static scale, so an activation within one fp32 rounding of a .5 step
    rounds the other way when its attention sums in another order, and the
    error grows through the layers.  The chunk-shaped verify scores a
    position with the chunk attention kernel, plain decode with the decode
    kernel: at phi3-mini width that flipped a token (``chip_smoke.py``
    phase 14).  Stage ``j`` here IS plain decode at that position (its own
    ``tokens.s{j}``, the row written at ``start + j`` when ``n_new.s{j}`` is
    1, ``decode_attention`` at ``kvlen.s{j}``), so its logits are bitwise
    the decode Program's.  fp32 cache writes are exact and positional, so
    the threaded caches come out as the new caches: rows of rejected stages
    lie past the committed length and are overwritten (dense) or truncated
    from the pool (paged) as after the chunk-shaped verify.

    ``cache_cap`` for the dense cache, or ``paged=(n_blocks, page_size,
    max_pages)`` for fp32 pages.  Outputs: ``logits.s0 ..
    logits.s{width-1}`` then ``new_cache_k{i}``, ``new_cache_v{i}``.  Value
    names carry the ``.s{j}`` suffix (:func:`expand_spec_ranges`)."""
    if (cache_cap is None) == (paged is None):
        raise ValueError("pass cache_cap (dense) or paged=(n_blocks, page_size, max_pages)")
    return _decode_seq_graph(cfg, params, batch=batch, width=width, cache_cap=cache_cap,
                             paged=paged, kv8=False)


def _decode_seq_graph(cfg: GraphLMConfig, params: Dict[str, Any], *, batch: int, width: int,
                      cache_cap: Optional[int] = None,
                      paged: Optional[Tuple[int, int, int]] = None, kv8: bool) -> Graph:
    """The decode step unrolled ``width`` times over one cache layout: the
    dense cache, fp32 pages, or (``kv8``) int8 pages whose threaded state is
    discarded and whose per-stage fp32 rows are returned.  Node for node
    ``repro``'s ``build_paged_verify_seq_graph`` when ``kv8``."""
    if width < 1:
        raise ValueError(f"width must be >= 1, got {width}")
    dh, hq, hk = cfg.d_head, cfg.n_heads, cfg.n_kv_heads
    inputs: Dict[str, TensorSpec] = {"start": TensorSpec((batch,), "int32")}
    if paged is None:
        cache_spec = TensorSpec((batch, cache_cap, hk, dh), "float32")
    else:
        n_blocks, page_size, max_pages = paged
        inputs["block_tables"] = TensorSpec((batch, max_pages), "int32")
        cache_spec = TensorSpec((n_blocks, page_size, hk, dh), "int8" if kv8 else "float32")
    for j in range(width):
        inputs[f"tokens.s{j}"] = TensorSpec((batch, 1), "int32")
        inputs[f"n_new.s{j}"] = TensorSpec((batch,), "int32")
    caches = ("k", "v")
    for i in range(cfg.n_layers):
        inputs[f"cache_k{i}"] = cache_spec
        inputs[f"cache_v{i}"] = cache_spec
        if kv8:
            inputs[f"cache_k{i}_scale"] = TensorSpec((n_blocks, hk), "float32")
            inputs[f"cache_v{i}_scale"] = TensorSpec((n_blocks, hk), "float32")
    p = dict(params)
    p["spec.one"] = np.ones((batch,), np.int32)
    tables = [] if paged is None else ["block_tables"]
    if kv8:
        write_op, attn_op = "paged_cache_update_q", "paged_decode_attention_q"
    elif paged is None:
        write_op, attn_op = "cache_update", "decode_attention"
    else:
        write_op, attn_op = "paged_cache_update", "paged_decode_attention"
    nodes: List[Node] = []
    eps = {"eps": cfg.eps}
    for j in range(width):
        sfx = f".s{j}"
        last = j == width - 1
        if j == 0:
            start_name = "start"
        else:
            start_name = f"start{sfx}"
            prev = "start" if j == 1 else f"start.s{j - 1}"
            nodes.append(Node(f"step_pos{sfx}", "add", [prev, "spec.one"], [start_name]))
        nodes += [
            Node(f"embed_lookup{sfx}", "embedding", [f"tokens{sfx}", "embed"], [f"x0{sfx}"]),
            Node(f"kv_len{sfx}", "add", [start_name, f"n_new{sfx}"], [f"kvlen{sfx}"]),
        ]
        x = f"x0{sfx}"
        for i in range(cfg.n_layers):
            L = f"l{i}"
            state_in, state_out = {}, {}
            for c in caches:
                for base in ([f"cache_{c}{i}", f"cache_{c}{i}_scale"] if kv8
                             else [f"cache_{c}{i}"]):
                    state_in.setdefault(c, []).append(base if j == 0 else f"{base}{sfx}")
                    out = (f"{base}.sout{j}" if kv8 else f"new_{base}") if last \
                        else f"{base}.s{j + 1}"
                    state_out.setdefault(c, []).append(out)
            nodes += [
                Node(f"{L}.attn_norm{sfx}", "rmsnorm", [x, f"{L}.norm1"], [f"{L}.h1{sfx}"],
                     dict(eps)),
                Node(f"{L}.q_proj{sfx}", "dense", [f"{L}.h1{sfx}", f"{L}.wq"], [f"{L}.q{sfx}"]),
                Node(f"{L}.k_proj{sfx}", "dense", [f"{L}.h1{sfx}", f"{L}.wk"], [f"{L}.k{sfx}"]),
                Node(f"{L}.v_proj{sfx}", "dense", [f"{L}.h1{sfx}", f"{L}.wv"], [f"{L}.v{sfx}"]),
                Node(f"{L}.k_heads{sfx}", "reshape", [f"{L}.k{sfx}"], [f"{L}.k4{sfx}"],
                     {"shape": (batch, 1, hk, dh)}),
                Node(f"{L}.v_heads{sfx}", "reshape", [f"{L}.v{sfx}"], [f"{L}.v4{sfx}"],
                     {"shape": (batch, 1, hk, dh)}),
                *[Node(f"{L}.{c}_write{sfx}", write_op,
                       [*state_in[c], f"{L}.{c}4{sfx}", *tables, start_name, f"n_new{sfx}"],
                       state_out[c]) for c in caches],
                Node(f"{L}.q_heads{sfx}", "reshape", [f"{L}.q{sfx}"], [f"{L}.qd{sfx}"],
                     {"shape": (batch, hq, dh)}),
                Node(f"{L}.attn{sfx}", attn_op,
                     [f"{L}.qd{sfx}", *state_out["k"], *state_out["v"], *tables,
                      f"kvlen{sfx}"], [f"{L}.att{sfx}"]),
                Node(f"{L}.attn_flat{sfx}", "reshape", [f"{L}.att{sfx}"], [f"{L}.attn2{sfx}"],
                     {"shape": (batch, 1, hq * dh)}),
                Node(f"{L}.o_proj{sfx}", "dense", [f"{L}.attn2{sfx}", f"{L}.wo"],
                     [f"{L}.proj{sfx}"]),
                Node(f"{L}.attn_res{sfx}", "add", [x, f"{L}.proj{sfx}"], [f"{L}.xa{sfx}"]),
                Node(f"{L}.mlp_norm{sfx}", "rmsnorm", [f"{L}.xa{sfx}", f"{L}.norm2"],
                     [f"{L}.h2{sfx}"], dict(eps)),
                Node(f"{L}.gate_proj{sfx}", "dense", [f"{L}.h2{sfx}", f"{L}.wg"],
                     [f"{L}.gate{sfx}"]),
                Node(f"{L}.up_proj{sfx}", "dense", [f"{L}.h2{sfx}", f"{L}.wu"],
                     [f"{L}.up{sfx}"]),
                Node(f"{L}.swiglu{sfx}", "swiglu", [f"{L}.gate{sfx}", f"{L}.up{sfx}"],
                     [f"{L}.act{sfx}"]),
                Node(f"{L}.down_proj{sfx}", "dense", [f"{L}.act{sfx}", f"{L}.wd"],
                     [f"{L}.down{sfx}"]),
                Node(f"{L}.mlp_res{sfx}", "add", [f"{L}.xa{sfx}", f"{L}.down{sfx}"],
                     [f"{L}.out{sfx}"]),
            ]
            x = f"{L}.out{sfx}"
        nodes += [
            Node(f"final_norm_n{sfx}", "rmsnorm", [x, "final_norm"], [f"final_h{sfx}"],
                 dict(eps)),
            Node(f"lm_head{sfx}", "dense", [f"final_h{sfx}", "head_w"], [f"logits3{sfx}"]),
            Node(f"logits_flat{sfx}", "reshape", [f"logits3{sfx}"], [f"logits{sfx}"],
                 {"shape": (batch, cfg.vocab)}),
        ]
    outputs = [f"logits.s{j}" for j in range(width)]
    if kv8:
        # the threaded pages are discarded; the per-stage fp32 rows go to
        # the spec-commit replay
        for j in range(width):
            for i in range(cfg.n_layers):
                outputs += [f"l{i}.k4.s{j}", f"l{i}.v4.s{j}"]
        name = f"graph_lm_paged_kv8_verify_seq_b{batch}_t{width}"
    else:
        for i in range(cfg.n_layers):
            outputs += [f"new_cache_k{i}", f"new_cache_v{i}"]
        name = f"graph_lm_{'' if paged is None else 'paged_'}verify_seq_b{batch}_t{width}"
    g = Graph(name=name, inputs=inputs, outputs=outputs, nodes=nodes, params=p)
    g.validate()
    return g


def build_spec_commit_graph(cfg: GraphLMConfig, *, batch: int, width: int,
                            n_blocks: int, page_size: int,
                            max_pages: int) -> Graph:
    """The kv8 spec-commit step: REPLAY the accepted prefix of the verify
    call's write sequence against the live int8 pages.

    The kv8 verify (:func:`build_paged_verify_seq_graph`) threads its
    quantize-on-write page state internally but that state includes
    later-rejected rows (whose scale raises would lossily requantize
    committed neighbours), so the engine discards it.  This graph takes
    the verify call's per-stage fp32 rows back (``k_new{i}.s{j}``,
    (B, 1, Hk, D)) and re-applies the SAME single-row
    ``paged_cache_update_q`` writes in the SAME order, with stage masks
    ``n_new.s{j}`` zeroed from the first rejected stage on — determinism
    makes the replayed page states bit-identical to the ones the verify
    attention actually read, which in turn are bit-identical to plain
    decode's write history.  No model weights; just the write chain."""
    hk, dh = cfg.n_kv_heads, cfg.d_head
    inputs: Dict[str, TensorSpec] = {
        "start": TensorSpec((batch,), "int32"),
        "block_tables": TensorSpec((batch, max_pages), "int32"),
    }
    for j in range(width):
        inputs[f"n_new.s{j}"] = TensorSpec((batch,), "int32")
        for i in range(cfg.n_layers):
            inputs[f"k_new{i}.s{j}"] = TensorSpec((batch, 1, hk, dh),
                                                  "float32")
            inputs[f"v_new{i}.s{j}"] = TensorSpec((batch, 1, hk, dh),
                                                  "float32")
    for i in range(cfg.n_layers):
        inputs[f"cache_k{i}"] = TensorSpec((n_blocks, page_size, hk, dh),
                                           "int8")
        inputs[f"cache_v{i}"] = TensorSpec((n_blocks, page_size, hk, dh),
                                           "int8")
        inputs[f"cache_k{i}_scale"] = TensorSpec((n_blocks, hk), "float32")
        inputs[f"cache_v{i}_scale"] = TensorSpec((n_blocks, hk), "float32")
    p = {"spec.one": np.ones((batch,), np.int32)}
    nodes: List[Node] = []
    for j in range(width):
        sfx = f".s{j}"
        last = j == width - 1
        if j == 0:
            start_name = "start"
        else:
            start_name = f"start{sfx}"
            prev = "start" if j == 1 else f"start.s{j - 1}"
            nodes.append(Node(f"step_pos{sfx}", "add", [prev, "spec.one"],
                              [start_name]))
        for i in range(cfg.n_layers):
            ck_in = f"cache_k{i}" if j == 0 else f"cache_k{i}{sfx}"
            cv_in = f"cache_v{i}" if j == 0 else f"cache_v{i}{sfx}"
            cks_in = (f"cache_k{i}_scale" if j == 0
                      else f"cache_k{i}_scale{sfx}")
            cvs_in = (f"cache_v{i}_scale" if j == 0
                      else f"cache_v{i}_scale{sfx}")
            ck_out = f"new_cache_k{i}" if last else f"cache_k{i}.s{j + 1}"
            cv_out = f"new_cache_v{i}" if last else f"cache_v{i}.s{j + 1}"
            cks_out = (f"new_cache_k{i}_scale" if last
                       else f"cache_k{i}_scale.s{j + 1}")
            cvs_out = (f"new_cache_v{i}_scale" if last
                       else f"cache_v{i}_scale.s{j + 1}")
            nodes += [
                Node(f"l{i}.k_commit{sfx}", "paged_cache_update_q",
                     [ck_in, cks_in, f"k_new{i}{sfx}", "block_tables",
                      start_name, f"n_new{sfx}"], [ck_out, cks_out]),
                Node(f"l{i}.v_commit{sfx}", "paged_cache_update_q",
                     [cv_in, cvs_in, f"v_new{i}{sfx}", "block_tables",
                      start_name, f"n_new{sfx}"], [cv_out, cvs_out]),
            ]
    outputs: List[str] = []
    for i in range(cfg.n_layers):
        outputs += [f"new_cache_k{i}", f"new_cache_v{i}",
                    f"new_cache_k{i}_scale", f"new_cache_v{i}_scale"]
    g = Graph(name=f"graph_lm_spec_commit_b{batch}_t{width}", inputs=inputs,
              outputs=outputs, nodes=nodes, params=p)
    g.validate()
    return g


def build_draft_graph(cfg: GraphLMConfig, params: Dict[str, Any], *,
                      batch: int, cache_cap: int, spec_k: int) -> Graph:
    """The draft Program: ``spec_k`` autoregressive greedy steps unrolled
    into ONE graph, plus a final cache-write-only step.

    At serving scale the draft model is dispatch-dominated, so K separate
    decode calls would eat the speculation win; instead the greedy
    feedback loop runs in-graph via the ``greedy_token`` op.  Step ``s``
    embeds its input token (step 0: the ``tokens`` input — the committed
    next token; step s>0: step s-1's ``draft_tok``), runs the decoder over
    the step's dense caches, and emits ``draft_tok.s{s}``.  Position
    arithmetic is in-graph too: a ``spec.one`` ones-vector param advances
    ``start`` / ``kvlen`` per step, so the host passes the same
    (tokens, start, n_new) triple as a plain decode call.

    The final step (``s == spec_k``) writes its input token's cache row
    but computes no logits: after a full accept the draft cache then
    already holds every committed row, so the next draft call needs no
    catch-up.  Rows written for later-rejected proposals are simply
    overwritten by the next call — the draft caches are private per-slot
    dense buffers (capacity ``cache_cap`` = committed cap + spec_k + 1)
    and never roll back.

    Value names carry a ``.s{s}`` suffix; :func:`expand_spec_ranges` maps
    a shared calibration onto them so the draft quantizes with the same
    static activation scales as every other variant.

    Outputs: ``draft_tok.s0 .. draft_tok.s{spec_k-1}`` then the usual
    ``new_cache_k{i}`` / ``new_cache_v{i}`` (from the final step)."""
    if spec_k < 1:
        raise ValueError(f"spec_k must be >= 1, got {spec_k}")
    if spec_k + 1 > cache_cap:
        raise ValueError(f"spec_k {spec_k} + 1 exceeds cache cap {cache_cap}")
    dm, dh, hq, hk = cfg.d_model, cfg.d_head, cfg.n_heads, cfg.n_kv_heads
    inputs: Dict[str, TensorSpec] = {
        "tokens": TensorSpec((batch, 1), "int32"),
        "start": TensorSpec((batch,), "int32"),
        "n_new": TensorSpec((batch,), "int32"),
    }
    for i in range(cfg.n_layers):
        spec = TensorSpec((batch, cache_cap, hk, dh), "float32")
        inputs[f"cache_k{i}"] = spec
        inputs[f"cache_v{i}"] = spec
    p = dict(params)
    p["spec.one"] = np.ones((batch,), np.int32)
    nodes: List[Node] = []
    eps = {"eps": cfg.eps}
    for s in range(spec_k + 1):
        sfx = f".s{s}"
        last = s == spec_k
        tok = "tokens" if s == 0 else f"draft_tok.s{s - 1}"
        if s == 0:
            start_name = "start"
        else:
            start_name = f"start{sfx}"
            prev = "start" if s == 1 else f"start.s{s - 1}"
            nodes.append(Node(f"step_pos{sfx}", "add", [prev, "spec.one"],
                              [start_name]))
        nodes += [
            Node(f"embed_lookup{sfx}", "embedding", [tok, "embed"],
                 [f"x0{sfx}"]),
            Node(f"kv_len{sfx}", "add", [start_name, "n_new"],
                 [f"kvlen{sfx}"]),
        ]
        x = f"x0{sfx}"
        for i in range(cfg.n_layers):
            L = f"l{i}"
            ck_in = f"cache_k{i}" if s == 0 else f"cache_k{i}{sfx}"
            cv_in = f"cache_v{i}" if s == 0 else f"cache_v{i}{sfx}"
            ck_out = f"new_cache_k{i}" if last else f"cache_k{i}.s{s + 1}"
            cv_out = f"new_cache_v{i}" if last else f"cache_v{i}.s{s + 1}"
            nodes += [
                Node(f"{L}.attn_norm{sfx}", "rmsnorm", [x, f"{L}.norm1"],
                     [f"{L}.h1{sfx}"], dict(eps)),
                Node(f"{L}.q_proj{sfx}", "dense", [f"{L}.h1{sfx}", f"{L}.wq"],
                     [f"{L}.q{sfx}"]),
                Node(f"{L}.k_proj{sfx}", "dense", [f"{L}.h1{sfx}", f"{L}.wk"],
                     [f"{L}.k{sfx}"]),
                Node(f"{L}.v_proj{sfx}", "dense", [f"{L}.h1{sfx}", f"{L}.wv"],
                     [f"{L}.v{sfx}"]),
                Node(f"{L}.k_heads{sfx}", "reshape", [f"{L}.k{sfx}"],
                     [f"{L}.k4{sfx}"], {"shape": (batch, 1, hk, dh)}),
                Node(f"{L}.v_heads{sfx}", "reshape", [f"{L}.v{sfx}"],
                     [f"{L}.v4{sfx}"], {"shape": (batch, 1, hk, dh)}),
                Node(f"{L}.k_write{sfx}", "cache_update",
                     [ck_in, f"{L}.k4{sfx}", start_name, "n_new"], [ck_out]),
                Node(f"{L}.v_write{sfx}", "cache_update",
                     [cv_in, f"{L}.v4{sfx}", start_name, "n_new"], [cv_out]),
                Node(f"{L}.q_heads{sfx}", "reshape", [f"{L}.q{sfx}"],
                     [f"{L}.qd{sfx}"], {"shape": (batch, hq, dh)}),
                Node(f"{L}.attn{sfx}", "decode_attention",
                     [f"{L}.qd{sfx}", ck_out, cv_out, f"kvlen{sfx}"],
                     [f"{L}.att{sfx}"]),
                Node(f"{L}.attn_flat{sfx}", "reshape", [f"{L}.att{sfx}"],
                     [f"{L}.attn2{sfx}"], {"shape": (batch, 1, hq * dh)}),
                Node(f"{L}.o_proj{sfx}", "dense",
                     [f"{L}.attn2{sfx}", f"{L}.wo"], [f"{L}.proj{sfx}"]),
                Node(f"{L}.attn_res{sfx}", "add", [x, f"{L}.proj{sfx}"],
                     [f"{L}.xa{sfx}"]),
                Node(f"{L}.mlp_norm{sfx}", "rmsnorm",
                     [f"{L}.xa{sfx}", f"{L}.norm2"], [f"{L}.h2{sfx}"],
                     dict(eps)),
                Node(f"{L}.gate_proj{sfx}", "dense",
                     [f"{L}.h2{sfx}", f"{L}.wg"], [f"{L}.gate{sfx}"]),
                Node(f"{L}.up_proj{sfx}", "dense",
                     [f"{L}.h2{sfx}", f"{L}.wu"], [f"{L}.up{sfx}"]),
                Node(f"{L}.swiglu{sfx}", "swiglu",
                     [f"{L}.gate{sfx}", f"{L}.up{sfx}"], [f"{L}.act{sfx}"]),
                Node(f"{L}.down_proj{sfx}", "dense",
                     [f"{L}.act{sfx}", f"{L}.wd"], [f"{L}.down{sfx}"]),
                Node(f"{L}.mlp_res{sfx}", "add",
                     [f"{L}.xa{sfx}", f"{L}.down{sfx}"], [f"{L}.out{sfx}"]),
            ]
            x = f"{L}.out{sfx}"
        if not last:
            nodes += [
                Node(f"final_norm_n{sfx}", "rmsnorm", [x, "final_norm"],
                     [f"final_h{sfx}"], dict(eps)),
                Node(f"lm_head{sfx}", "dense", [f"final_h{sfx}", "head_w"],
                     [f"logits3{sfx}"]),
                Node(f"logits_flat{sfx}", "reshape", [f"logits3{sfx}"],
                     [f"logits{sfx}"], {"shape": (batch, cfg.vocab)}),
                Node(f"greedy{sfx}", "greedy_token", [f"logits{sfx}"],
                     [f"draft_tok{sfx}"]),
            ]
    outputs = [f"draft_tok.s{s}" for s in range(spec_k)]
    for i in range(cfg.n_layers):
        outputs += [f"new_cache_k{i}", f"new_cache_v{i}"]
    g = Graph(name=f"graph_lm_draft_b{batch}_k{spec_k}", inputs=inputs,
              outputs=outputs, nodes=nodes, params=p)
    g.validate()
    return g


def expand_spec_ranges(ranges: Dict[str, Any], spec_k: int) -> Dict[str, Any]:
    """Map a shared calibration onto the draft graph's step-suffixed value
    names: every base-name range is copied to ``<name>.s{0..spec_k}``.
    The draft's layers are a prefix of the target's, and its per-step
    activations are the same values the decode variant sees — so the
    expanded ranges give the quantized draft the same static activation
    scales as every other Program variant (names that stay unmatched fall
    back to the quantizer's dynamic per-batch scales, which is safe for
    the draft: its proposals are *checked*, never trusted)."""
    out = dict(ranges)
    for name, vr in ranges.items():
        for s in range(spec_k + 1):
            out[f"{name}.s{s}"] = vr
    return out


def partition_roles(graph: Graph) -> Dict[str, str]:
    """Serving-partition role of every value this graph exchanges with the
    engine: each graph input and output name -> ``"col"`` (column / head
    parallel weight), ``"kv_col"`` (column-parallel iff the KV-head count
    divides the TP degree), ``"dense_cache"`` / ``"paged_pool"`` /
    ``"kv_scale"`` (head-sharded serving state) or ``"replicated"``.

    A mesh-free view over :func:`repro_torch.sharding.specs.serving_value_role`,
    the rules the `partition` compile stage turns into specs: every value
    these builders emit is named by its role (``l{i}.wq``, ``cache_k{i}``,
    ``cache_k{i}_scale``, ``block_tables``, ``new_``-prefixed outputs)."""
    from repro_torch.core.pipeline import get_pass
    from repro_torch.sharding.specs import serving_value_role

    if any(o not in graph.value_info and o not in graph.inputs for o in graph.outputs):
        graph = get_pass("infer_shapes")(graph)
    paged = "block_tables" in graph.inputs
    names = list(graph.inputs) + [o for o in graph.outputs if o not in graph.inputs]
    return {name: serving_value_role(name, graph.spec_of(name).shape, paged=paged)
            for name in names}
