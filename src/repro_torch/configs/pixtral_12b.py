"""pixtral-12b [vlm] — Mistral-Nemo-style text backbone; the Pixtral ViT
frontend is a stub (input_specs supplies precomputed patch+token embeddings,
per the assignment). 32H x 128 head_dim (q dim 4096 != d_model 5120).
[hf:mistralai/Pixtral-12B-2409]
"""

from repro_torch.configs.base import ArchConfig, Block, LayerPlan

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=131072,
    plan=LayerPlan(period=(Block("attn", "swiglu"),), n_periods=40),
    frontend="embeds",
    skip_shapes=("long_500k",),
)
