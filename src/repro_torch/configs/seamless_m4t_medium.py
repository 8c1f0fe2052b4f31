"""seamless-m4t-medium [audio] — enc-dec transformer backbone: 12L encoder +
12L decoder, d_model=1024 16H (GQA kv=16) d_ff=4096 vocab=256206; the speech
frontend is a STUB (``input_specs`` supplies precomputed frame embeddings to
the encoder). [arXiv:2308.11596; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec", n_layers=24,
    enc_layers=12, dec_layers=12, d_model=1024, heads=16, kv_heads=16,
    head_dim=64, d_ff=4096, vocab=256206, frontend="audio_stub",
    act="relu", gated=False, tied_embeddings=True,
)

SMOKE = CONFIG.replace(
    name="seamless-m4t-smoke", n_layers=4, enc_layers=2, dec_layers=2,
    d_model=64, heads=4, kv_heads=4, head_dim=16, d_ff=128, vocab=512,
)
