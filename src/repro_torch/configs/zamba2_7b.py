"""zamba2-7b [hybrid] — Mamba2 blocks + shared-weight attention blocks.

81 blocks: 11 periods of (6 Mamba2 + 1 shared-attn application) + 4 trailing
Mamba2 = 70 Mamba2 + 11 shared-attn applications; the shared applications
alternate between TWO weight-shared attention blocks (Zamba2 pattern), each
taking concat(hidden, initial_embedding) through a fused projection.
[arXiv:2411.15242]
"""

from repro_torch.configs.base import ArchConfig, Block, LayerPlan, SSMCfg

M = Block("mamba", "none")
S = Block("shared_attn", "none")

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,            # 3584 / 32
    d_ff=14336,              # shared block's MLP width
    vocab=32000,
    plan=LayerPlan(period=(M, M, M, M, M, M, S), n_periods=11,
                   suffix=(M, M, M, M)),
    ssm=SSMCfg(d_inner=7168, head_dim=64, state=64, n_groups=1,
               conv_kernel=4, chunk=128),
    rope_theta=1e4,
    backends={"ssd": "chunked"},
    skip_shapes=(),          # hybrid: long_500k runs (SSM majority; 11 full-KV
                             # shared-attn applications, seq-sharded cache)
    notes="Zamba2 realised as 6:1 mamba:shared-attn periods; G=1 B/C groups.",
)
