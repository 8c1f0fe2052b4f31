"""deepseek-7b [dense] — 30L d_model=4096 32H (GQA kv=32 = MHA) d_ff=11008
vocab=102400; llama-arch. [arXiv:2401.02954; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b", family="dense", n_layers=30, d_model=4096,
    heads=32, kv_heads=32, head_dim=128, d_ff=11008, vocab=102400,
    act="silu", gated=True, tied_embeddings=False,
)

SMOKE = CONFIG.replace(
    name="deepseek-7b-smoke", n_layers=2, d_model=64, heads=4, kv_heads=4,
    head_dim=16, d_ff=128, vocab=512,
)
