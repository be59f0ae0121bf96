"""qwen2-moe-a2.7b [moe] — 24L, 60 routed experts top-4 + 4 shared experts.

Routed experts padded 60 -> 64 for even 16-way expert parallelism (padding
experts masked to -inf in the router; 6.7% extra expert storage, zero extra
active FLOPs).  Shared experts modelled as one SwiGLU of width 4x1408=5632.
[hf:Qwen/Qwen1.5-MoE-A2.7B]
"""

from repro_torch.configs.base import ArchConfig, Block, LayerPlan, MoECfg

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,               # per-expert width (assignment value)
    vocab=151936,
    plan=LayerPlan(period=(Block("attn", "moe"),), n_periods=24),
    moe=MoECfg(n_routed=60, n_routed_padded=64, top_k=4, d_expert=1408,
               n_shared=4, d_shared=5632,
               dispatch="local"),  # EXPERIMENTS.md §Perf-2 (baseline: global)
    skip_shapes=("long_500k",),
    notes="60->64 expert padding for even EP; shared experts fused to one 5632-wide SwiGLU.",
)
