"""mamba2-370m [ssm] — 48 pure SSD blocks, attention-free; the flagship
long-context arch (long_500k decodes with O(1) state). [arXiv:2405.21060]"""

from repro_torch.configs.base import ArchConfig, Block, LayerPlan, SSMCfg

CONFIG = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    d_model=1024,
    n_heads=1,               # no attention heads
    n_kv_heads=1,
    head_dim=1,
    d_ff=0,
    vocab=50280,
    plan=LayerPlan(period=(Block("mamba", "none"),), n_periods=48),
    ssm=SSMCfg(d_inner=2048, head_dim=64, state=128, n_groups=1,
               conv_kernel=4, chunk=128),
    tie_embeddings=True,
    backends={"ssd": "chunked"},
    skip_shapes=(),
)
