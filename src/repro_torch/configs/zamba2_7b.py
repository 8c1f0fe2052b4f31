"""zamba2-7b [hybrid] — 81 Mamba2 blocks, d_model=3584, ssm_state=64, with a
weight-shared attention block (32H GQA kv=32, d_ff=14336 MLP) applied every
6 blocks; vocab=32000. [arXiv:2411.15242; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid", n_layers=81, d_model=3584,
    heads=32, kv_heads=32, head_dim=112, d_ff=14336, vocab=32000,
    ssm_state=64, expand=2, mamba_head_dim=64, shared_attn_period=6,
    act="gelu", gated=True, tied_embeddings=True,
)

SMOKE = CONFIG.replace(
    name="zamba2-7b-smoke", n_layers=4, d_model=64, heads=4, kv_heads=4,
    head_dim=16, d_ff=128, vocab=512, ssm_state=8, mamba_head_dim=16,
    shared_attn_period=2,
)
