"""dbrx-132b [moe] — 40L d_model=6144 48H (GQA kv=8) d_ff=10752
vocab=100352, MoE 16 experts top-4 (fine-grained).
[hf:databricks/dbrx-base; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe", n_layers=40, d_model=6144,
    heads=48, kv_heads=8, head_dim=128, d_ff=10752, vocab=100352,
    experts=16, top_k=4, moe_every=1,
    act="silu", gated=True, tied_embeddings=False,
)

SMOKE = CONFIG.replace(
    name="dbrx-132b-smoke", n_layers=2, d_model=64, heads=4, kv_heads=2,
    head_dim=16, d_ff=128, vocab=512, experts=4, top_k=2,
)
