"""gemma3-27b [dense] — 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144; 5:1 local:global sliding-window attention, 128k context.
[hf:google/gemma-3-1b-pt; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b", family="dense", n_layers=62, d_model=5376,
    heads=32, kv_heads=16, head_dim=128, d_ff=21504, vocab=262144,
    qk_norm=True, rope_theta=1e6, act="gelu", gated=True,
    local_ratio=5, window=1024, embed_scale=True, tied_embeddings=True,
)

SMOKE = CONFIG.replace(
    name="gemma3-27b-smoke", n_layers=6, d_model=64, heads=4, kv_heads=2,
    head_dim=16, d_ff=128, vocab=512, window=16,
)
