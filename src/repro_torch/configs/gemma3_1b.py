"""gemma3-1b [dense] — 5 sliding-window : 1 global attention pattern,
MQA (kv=1), head_dim 256, window 512, tied embeddings, 262k vocab.

26 layers = 4 periods of (5 local + 1 global) + 2 trailing local.
long_500k RUNS: local layers cache only `window` entries (rolling buffer);
the 5 global layers' KV is sequence-sharded. [hf:google/gemma-3-1b-pt]
"""

from repro_torch.configs.base import ArchConfig, Block, LayerPlan

L = Block("attn_local", "swiglu")
G = Block("attn", "swiglu")

CONFIG = ArchConfig(
    name="gemma3-1b",
    family="dense",
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab=262144,
    plan=LayerPlan(period=(L, L, L, L, L, G), n_periods=4, suffix=(L, L)),
    window=512,
    tie_embeddings=True,
    rope_theta=1e6,          # global-layer theta; local layers share it (simpl.)
    skip_shapes=(),
    notes="TP note: 4 q heads / 1 kv head -> attention replicated on model axis; TP carried by FFN (6912=16x432) and vocab.",
)
