"""seamless-m4t-medium [audio] — encoder-decoder backbone.

12 encoder + 12 decoder layers (the "12L" assignment read as symmetric
enc-dec, matching SeamlessM4T-medium's text model).  Audio frontend is a
stub: input_specs supplies precomputed frame embeddings (B, S_src, d).

Shape conventions (see DESIGN.md §4): train_4k splits seq_len into
src = tgt = 2048; prefill_32k encodes 32k frames + 1k decoder prefill;
decode_32k decodes against 32k cross-attention KV; long_500k skipped
(full attention). [arXiv:2308.11596]
"""

from repro_torch.configs.base import ArchConfig, Block, LayerPlan

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab=256206,
    plan=LayerPlan(period=(Block("attn", "mlp", cross=True),), n_periods=12),
    n_encoder_layers=12,
    act="relu",
    frontend="embeds",
    skip_shapes=("long_500k",),
    notes="enc-dec; audio frontend stubbed to precomputed embeddings.",
)
