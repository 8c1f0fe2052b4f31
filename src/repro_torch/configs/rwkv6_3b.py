"""rwkv6-3b [ssm] — Finch: 32L d_model=2560 (attention-free) d_ff=8960
vocab=65536; data-dependent decay, head_dim=64 ⇒ 40 heads.
[arXiv:2404.05892; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="rwkv", n_layers=32, d_model=2560,
    heads=40, kv_heads=40, head_dim=64, d_ff=8960, vocab=65536,
    act="relu2", gated=False, tied_embeddings=False,
)

SMOKE = CONFIG.replace(
    name="rwkv6-3b-smoke", n_layers=2, d_model=64, heads=4, kv_heads=4,
    head_dim=16, d_ff=128, vocab=512,
)
