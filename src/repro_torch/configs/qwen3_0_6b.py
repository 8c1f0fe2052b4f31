"""qwen3-0.6b [dense] — 28L d_model=1024 16H (GQA kv=8) d_ff=3072
vocab=151936; qk_norm, head_dim=128. [hf:Qwen/Qwen3-8B; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b", family="dense", n_layers=28, d_model=1024,
    heads=16, kv_heads=8, head_dim=128, d_ff=3072, vocab=151936,
    qk_norm=True, rope_theta=1e6, act="silu", gated=True,
    tied_embeddings=True,
)

SMOKE = CONFIG.replace(
    name="qwen3-0.6b-smoke", n_layers=2, d_model=64, heads=4, kv_heads=2,
    head_dim=16, d_ff=128, vocab=512,
)
