"""minitron-4b [dense] — pruned Nemotron: 24H x 128, GQA kv=8, 2-matrix
ReLU MLP (squared-relu in the original; plain relu here — noted).
[arXiv:2407.14679]"""

from repro_torch.configs.base import ArchConfig, Block, LayerPlan

CONFIG = ArchConfig(
    name="minitron-4b",
    family="dense",
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab=256000,
    plan=LayerPlan(period=(Block("attn", "mlp"),), n_periods=32),
    act="relu",
    skip_shapes=("long_500k",),
)
