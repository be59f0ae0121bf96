"""phi3-mini-3.8b [dense] — RoPE + SwiGLU + GQA(kv=32 i.e. MHA). [arXiv:2404.14219]"""

from repro_torch.configs.base import ArchConfig, Block, LayerPlan

CONFIG = ArchConfig(
    name="phi3-mini-3.8b",
    family="dense",
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab=32064,
    plan=LayerPlan(period=(Block("attn", "swiglu"),), n_periods=32),
    skip_shapes=("long_500k",),
)
