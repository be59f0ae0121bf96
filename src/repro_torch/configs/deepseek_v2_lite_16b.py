"""deepseek-v2-lite-16b [moe] — MLA attention + 64 routed experts top-6
+ 2 shared experts.

The assignment header says "MoE 64e top-6"; its trailing note says "160
routed" — we follow the header (which matches the real DeepSeek-V2-Lite:
64 routed + 2 shared, top-6).  MLA: kv_lora_rank 512, per-head qk =
128 nope + 64 rope, v 128; decode uses the absorbed-matmul latent cache
(576 floats/token vs 8192 for full K+V — the MLA memory win).
Deviation noted in DESIGN.md: real model's layer-0 dense FFN is replaced
by MoE like all other layers. [arXiv:2405.04434]
"""

from repro_torch.configs.base import ArchConfig, Block, LayerPlan, MLACfg, MoECfg

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,           # nominal; MLA replaces K/V heads with the latent
    head_dim=128,
    d_ff=1408,               # per-expert width (assignment value)
    vocab=102400,
    plan=LayerPlan(period=(Block("mla", "moe"),), n_periods=27),
    moe=MoECfg(n_routed=64, top_k=6, d_expert=1408, n_shared=2, d_shared=2816,
               dispatch="local"),  # EXPERIMENTS.md §Perf-2 (baseline: global)
    mla=MLACfg(kv_lora_rank=512, rope_dim=64, nope_dim=128, v_dim=128),
    skip_shapes=("long_500k",),
    notes="MLA latent cache + absorbed decode; all 27 layers MoE.",
)
