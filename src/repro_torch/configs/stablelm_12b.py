"""stablelm-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=13824
vocab=100352. [hf:stabilityai/stablelm-2-1_6b; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b", family="dense", n_layers=40, d_model=5120,
    heads=32, kv_heads=8, head_dim=160, d_ff=13824, vocab=100352,
    act="silu", gated=True, tied_embeddings=False,
)

SMOKE = CONFIG.replace(
    name="stablelm-12b-smoke", n_layers=2, d_model=64, heads=4, kv_heads=2,
    head_dim=16, d_ff=128, vocab=512,
)
