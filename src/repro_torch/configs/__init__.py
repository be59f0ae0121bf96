"""Config registry: the 10 assigned architectures + reduced smoke variants.

A copy of :mod:`repro.configs` (jax-free dataclasses), kept in the port so
that it imports nothing of the JAX package; ``get_config`` and
``get_reduced`` give the same configs field for field.

``get_config(name)`` returns the exact assigned config;
``get_reduced(name)`` returns a structurally identical but tiny variant
(same LayerPlan block kinds, fewer periods, small dims) for CPU smoke tests.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.configs.base import (ArchConfig, Block, LayerPlan, MLACfg, MoECfg,
                                ShapeCfg, SSMCfg)

from repro_torch.configs.zamba2_7b import CONFIG as _zamba2
from repro_torch.configs.seamless_m4t_medium import CONFIG as _seamless
from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as _qwen2moe
from repro_torch.configs.deepseek_v2_lite_16b import CONFIG as _deepseek
from repro_torch.configs.phi3_mini_3_8b import CONFIG as _phi3
from repro_torch.configs.stablelm_12b import CONFIG as _stablelm
from repro_torch.configs.minitron_4b import CONFIG as _minitron
from repro_torch.configs.gemma3_1b import CONFIG as _gemma3
from repro_torch.configs.pixtral_12b import CONFIG as _pixtral
from repro_torch.configs.mamba2_370m import CONFIG as _mamba2

_CONFIGS: Dict[str, ArchConfig] = {c.name: c for c in [
    _zamba2, _seamless, _qwen2moe, _deepseek, _phi3, _stablelm, _minitron,
    _gemma3, _pixtral, _mamba2,
]}


def list_configs() -> List[str]:
    return sorted(_CONFIGS)


def get_config(name: str) -> ArchConfig:
    try:
        return _CONFIGS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {list_configs()}") from None


SMOKE_SHAPES = (
    ShapeCfg("smoke_train", "train", 32, 2),
    ShapeCfg("smoke_prefill", "prefill", 32, 2),
    ShapeCfg("smoke_decode", "decode", 32, 2),
)


def get_reduced(name: str) -> ArchConfig:
    """Tiny structurally-faithful variant: same block kinds & plan shape,
    n_periods <= 2, small dims, f32 (CPU numerics)."""
    cfg = get_config(name)
    kv = max(1, (4 * cfg.n_kv_heads) // max(cfg.n_heads, 1)) if cfg.n_heads > 1 else 1
    plan = LayerPlan(period=cfg.plan.period,
                     n_periods=min(2, cfg.plan.n_periods),
                     prefix=cfg.plan.prefix,
                     suffix=cfg.plan.suffix[:2])
    red = dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        d_model=64,
        n_heads=4 if cfg.n_heads > 1 else 1,
        n_kv_heads=kv,
        head_dim=16 if cfg.n_heads > 1 else 1,
        d_ff=128 if cfg.d_ff else 0,
        vocab=512,
        plan=plan,
        window=16 if cfg.window else None,
        n_encoder_layers=min(2, cfg.n_encoder_layers),
        # capacity_factor 8: no token drops at smoke scale, so decode-vs-
        # teacher-forcing consistency tests are exact (drops are the one
        # legitimate source of prefill/decode divergence in capacity MoE)
        moe=(MoECfg(n_routed=6, n_routed_padded=8, top_k=2, d_expert=32,
                    n_shared=(1 if cfg.moe.n_shared else 0), d_shared=64,
                    capacity_factor=8.0)
             if cfg.moe else None),
        ssm=(SSMCfg(d_inner=128, head_dim=16, state=16, n_groups=1,
                    conv_kernel=4, chunk=16) if cfg.ssm else None),
        mla=(MLACfg(kv_lora_rank=32, rope_dim=8, nope_dim=16, v_dim=16)
             if cfg.mla else None),
        dtype="float32",
        param_dtype="float32",
        shapes=SMOKE_SHAPES,
        skip_shapes=(),
    )
    return red
