"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128 experts top-1, interleaved (every other
layer MoE, matching the 400B total / 17B active budget); early fusion.
Adafactor optimizer (400B × AdamW states does not fit 256 v5e chips).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe", n_layers=48,
    d_model=5120, heads=40, kv_heads=8, head_dim=128, d_ff=8192,
    vocab=202048, experts=128, top_k=1, moe_every=2,
    act="silu", gated=True, tied_embeddings=True, optimizer="adafactor",
)

SMOKE = CONFIG.replace(
    name="llama4-maverick-smoke", n_layers=2, d_model=64, heads=4,
    kv_heads=2, head_dim=16, d_ff=128, vocab=512, experts=4, top_k=1,
    moe_every=2,
)
