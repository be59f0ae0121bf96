"""Architecture/config schema for all assigned architectures.

An :class:`ArchConfig` fully describes one architecture: dims, the per-layer
block plan (prefix + scanned periods + suffix — heterogeneous stacks like
gemma3's 5 local : 1 global or zamba2's 6 mamba : 1 shared-attn compile as a
single scanned period, keeping HLO size O(period) instead of O(layers)), the
MoE / SSM / MLA sub-configs, and the assigned benchmark shapes.

Backend selection (the paper's technique) is carried per-arch in
``backends`` — op name -> registry backend — so a config IS a backend
assignment, swappable at launch (``--backend attention=pallas``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Tuple

__all__ = [
    "Block", "LayerPlan", "MoECfg", "SSMCfg", "MLACfg", "ShapeCfg",
    "ArchConfig", "round_up", "STANDARD_SHAPES",
]


def round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclass(frozen=True)
class Block:
    """One layer's composition: a sequence mixer + a channel mixer.
    ``cross=True`` inserts a cross-attention sublayer (enc-dec decoders)."""

    mixer: str   # attn | attn_local | mla | mamba | shared_attn
    ffn: str     # swiglu | mlp | moe | none
    cross: bool = False


@dataclass(frozen=True)
class LayerPlan:
    """prefix (unrolled) + period x n_periods (lax.scan) + suffix (unrolled)."""

    period: Tuple[Block, ...]
    n_periods: int
    prefix: Tuple[Block, ...] = ()
    suffix: Tuple[Block, ...] = ()

    @property
    def n_layers(self) -> int:
        return len(self.prefix) + self.n_periods * len(self.period) + len(self.suffix)

    def all_blocks(self) -> Tuple[Block, ...]:
        return self.prefix + self.period * self.n_periods + self.suffix


@dataclass(frozen=True)
class MoECfg:
    n_routed: int            # logical routed experts
    top_k: int
    d_expert: int            # per-expert FFN width
    n_shared: int = 0        # shared experts (always active)
    d_shared: int = 0        # total shared-expert FFN width
    n_routed_padded: int = 0 # padded for even EP sharding (0 = same as n_routed)
    capacity_factor: float = 1.25
    router_norm_topk: bool = True  # normalise top-k weights to sum 1
    # "global": one capacity pool over all tokens (baseline; the dispatch
    #   cumsum/sort/scatter spans the whole DP-sharded token axis).
    # "local": per-batch-row capacity pools — every routing/dispatch index
    #   op stays inside one DP shard, so the only cross-device traffic left
    #   is the unavoidable token->expert movement (EXPERIMENTS.md §Perf).
    dispatch: str = "global"

    @property
    def n_experts(self) -> int:
        return self.n_routed_padded or self.n_routed


@dataclass(frozen=True)
class SSMCfg:
    d_inner: int
    head_dim: int            # P
    state: int               # N
    n_groups: int = 1        # G (B/C shared per group)
    conv_kernel: int = 4
    chunk: int = 128
    dt_min: float = 0.001
    dt_max: float = 0.1

    @property
    def n_heads(self) -> int:
        assert self.d_inner % self.head_dim == 0
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.state


@dataclass(frozen=True)
class MLACfg:
    kv_lora_rank: int = 512
    rope_dim: int = 64
    nope_dim: int = 128
    v_dim: int = 128

    @property
    def qk_dim(self) -> int:
        return self.nope_dim + self.rope_dim


@dataclass(frozen=True)
class ShapeCfg:
    name: str
    kind: str        # train | prefill | decode
    seq_len: int
    global_batch: int


STANDARD_SHAPES: Tuple[ShapeCfg, ...] = (
    ShapeCfg("train_4k", "train", 4096, 256),
    ShapeCfg("prefill_32k", "prefill", 32768, 32),
    ShapeCfg("decode_32k", "decode", 32768, 128),
    ShapeCfg("long_500k", "decode", 524288, 1),
)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    plan: LayerPlan
    # attention details
    window: Optional[int] = None      # sliding window for attn_local
    rope_theta: float = 1e4
    attn_logit_softcap: Optional[float] = None
    # sub-configs
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    mla: Optional[MLACfg] = None
    # enc-dec (seamless): encoder stack prepended; plan describes the decoder
    n_encoder_layers: int = 0
    # frontends: tokens (LM) | embeds (vlm/audio stub provides embeddings)
    frontend: str = "tokens"
    act: str = "silu"                 # for ffn="mlp": relu/gelu
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"           # activation/compute dtype
    param_dtype: str = "bfloat16"     # serving param dtype (training: f32)
    remat: bool = True                # activation checkpointing over periods
    backends: Mapping[str, str] = field(default_factory=dict)
    skip_shapes: Tuple[str, ...] = ()
    shapes: Tuple[ShapeCfg, ...] = STANDARD_SHAPES
    notes: str = ""

    # ------------------------------------------------------------------ #
    @property
    def n_layers(self) -> int:
        return self.plan.n_layers + self.n_encoder_layers

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up so embedding/lm_head shard evenly on 16-way TP."""
        return round_up(self.vocab, 128)

    def backend(self, op: str, default: str = "ref") -> str:
        return self.backends.get(op, default)

    def shape(self, name: str) -> ShapeCfg:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.name}: unknown shape {name!r}")

    def runnable_shapes(self) -> Tuple[ShapeCfg, ...]:
        return tuple(s for s in self.shapes if s.name not in self.skip_shapes)

    def with_overrides(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # parameter count (embedding + blocks), used for MODEL_FLOPS and docs
    def param_count(self) -> Dict[str, float]:
        d, dff = self.d_model, self.d_ff
        hq, hkv, dh = self.n_heads, self.n_kv_heads, self.head_dim
        counts = {"embed": self.vocab_padded * d}
        if not self.tie_embeddings:
            counts["lm_head"] = self.vocab_padded * d
        total_blk = 0.0
        active_blk = 0.0
        shared_attn_counted = False
        for blk in self.plan.all_blocks():
            m = 0.0
            if blk.mixer in ("attn", "attn_local", "cross_attn"):
                m += d * (hq * dh) + 2 * d * (hkv * dh) + (hq * dh) * d
            elif blk.mixer == "mla":
                mla = self.mla
                m += d * (hq * mla.qk_dim)                       # q proj
                m += d * (mla.kv_lora_rank + mla.rope_dim)       # latent + k_pe
                m += mla.kv_lora_rank * hq * (mla.nope_dim + mla.v_dim)
                m += hq * mla.v_dim * d
            elif blk.mixer == "mamba":
                s = self.ssm
                m += d * (2 * s.d_inner + 2 * s.n_groups * s.state + s.n_heads)
                m += s.conv_kernel * s.conv_dim + 3 * s.n_heads + s.d_inner
                m += s.d_inner * d
            elif blk.mixer == "shared_attn":
                if not shared_attn_counted:   # params shared across periods
                    m += 2 * d * d            # concat fuse (2d -> d)
                    m += d * (hq * dh) + 2 * d * (hkv * dh) + (hq * dh) * d
                    m += 3 * d * dff          # shared block's own MLP
                    shared_attn_counted = True
            f = 0.0
            f_active = 0.0
            if blk.ffn == "swiglu":
                f = 3 * d * dff
                f_active = f
            elif blk.ffn == "mlp":
                f = 2 * d * dff
                f_active = f
            elif blk.ffn == "moe":
                mo = self.moe
                f = mo.n_experts * 3 * d * mo.d_expert + d * mo.n_experts
                if mo.n_shared:
                    f += 3 * d * mo.d_shared
                f_active = (mo.top_k * 3 * d * mo.d_expert + d * mo.n_experts
                            + (3 * d * mo.d_shared if mo.n_shared else 0))
            total_blk += m + f
            active_blk += m + f_active
        # encoder stack (attn + mlp per layer)
        enc = self.n_encoder_layers * (
            d * (hq * dh) + 2 * d * (hkv * dh) + (hq * dh) * d + 2 * d * dff)
        counts["blocks"] = total_blk + enc
        counts["total"] = sum(v for k, v in counts.items() if k != "total")
        # "active" = params that do matmul work per token (6·N·D convention):
        # block params (top-k experts only for MoE) + the LM head projection
        # (tied or not, the head matmul happens); the input-embedding GATHER
        # does no FLOPs and is excluded.
        counts["active"] = active_blk + enc + self.vocab_padded * d
        return counts
