"""stablelm-12b [dense] — 40L, GQA kv=8. [hf:stabilityai/stablelm-2-12b]"""

from repro_torch.configs.base import ArchConfig, Block, LayerPlan

CONFIG = ArchConfig(
    name="stablelm-12b",
    family="dense",
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=160,
    d_ff=13824,
    vocab=100352,
    plan=LayerPlan(period=(Block("attn", "swiglu"),), n_periods=40),
    skip_shapes=("long_500k",),
)
