"""llava-next-34b [vlm] — 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 transformer backbone; anyres-tiled vision frontend is a STUB
(``input_specs`` supplies precomputed patch embeddings as a 576-token
prefix). [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm", n_layers=60, d_model=7168,
    heads=56, kv_heads=8, head_dim=128, d_ff=20480, vocab=64000,
    frontend="vision_stub", frontend_tokens=576,
    act="silu", gated=True, tied_embeddings=False,
)

SMOKE = CONFIG.replace(
    name="llava-next-34b-smoke", n_layers=2, d_model=64, heads=4, kv_heads=2,
    head_dim=16, d_ff=128, vocab=512, frontend_tokens=8,
)
