"""Config system: model configs, input-shape configs, registry.

Every assigned architecture ships one ``configs/<id>.py`` exporting CONFIG
(the exact published geometry) and SMOKE (a reduced same-family config for
CPU smoke tests).  ``--arch <id>`` resolves through :func:`get_config`.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Optional

ARCH_IDS = (
    "qwen3-0.6b", "stablelm-12b", "gemma3-27b", "deepseek-7b", "rwkv6-3b",
    "llama4-maverick-400b-a17b", "dbrx-132b", "zamba2-7b", "llava-next-34b",
    "seamless-m4t-medium",
)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | rwkv | hybrid | vlm | encdec
    n_layers: int
    d_model: int
    vocab: int
    heads: int = 0
    kv_heads: int = 0
    head_dim: int = 0           # 0 -> d_model // heads
    d_ff: int = 0
    qk_norm: bool = False
    rope_theta: float = 10000.0
    act: str = "silu"
    gated: bool = True
    # local:global attention (gemma3-style)
    local_ratio: int = 0        # N local layers per 1 global; 0 = all global
    window: int = 0
    # MoE
    experts: int = 0
    top_k: int = 0
    moe_every: int = 1          # MoE layer cadence (1 = every layer)
    pin_moe_layout: bool = False  # explicit a2a-boundary constraints (needed
                                  # only when weights replicate over data)
    # SSM / hybrid
    ssm_state: int = 0
    expand: int = 2
    mamba_head_dim: int = 64
    shared_attn_period: int = 0  # zamba2: shared attn block every k blocks
    # enc-dec
    enc_layers: int = 0
    dec_layers: int = 0
    # multimodal frontend stub
    frontend: str = "none"      # none | vision_stub | audio_stub
    frontend_tokens: int = 0    # prefix length supplied as embeddings
    # numerics / training
    tied_embeddings: bool = True
    embed_scale: bool = False
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    optimizer: str = "adamw"
    remat: str = "full"         # full | dots | dots_no_batch | none
    scan_unroll: int = 1

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.heads, 1))

    @property
    def padded_vocab(self) -> int:
        """Embedding rows padded to a multiple of 256 so the vocab dim always
        shards evenly over a 16-way model axis (and 16-way data FSDP).
        Logits in the padding region are masked to −inf before the loss."""
        return -(-self.vocab // 256) * 256

    @property
    def attention_free(self) -> bool:
        return self.family == "rwkv"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (see DESIGN.md §long_500k skips)."""
        return (self.family in ("rwkv", "hybrid")
                or (self.local_ratio > 0 and self.window > 0))

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6·N·D)."""
        e, f, v = self.d_model, self.d_ff, self.vocab
        h, k, d = self.heads, self.kv_heads, self.resolved_head_dim
        attn = e * (h + 2 * k) * d + h * d * e
        mlp = e * f * (3 if self.gated else 2)
        emb = v * e * (1 if self.tied_embeddings else 2)
        if self.family == "rwkv":
            tm = 5 * e * e + 2 * e * 64 + 2 * e
            cm = 2 * e * f + e * e
            return self.n_layers * (tm + cm) + emb
        if self.family == "hybrid":
            ei = self.expand * e
            blk = e * (2 * ei + 2 * self.ssm_state +
                       ei // self.mamba_head_dim) + ei * e
            shared = attn + mlp
            return self.n_layers * blk + shared + emb
        if self.family == "moe":
            moe = e * self.experts + self.experts * 3 * e * f
            n_moe = self.n_layers // self.moe_every
            n_dense = self.n_layers - n_moe
            return (self.n_layers * attn + n_moe * moe + n_dense * mlp + emb)
        layers = self.enc_layers + self.dec_layers or self.n_layers
        xattn = attn if self.family == "encdec" else 0
        return layers * (attn + mlp) + (self.dec_layers or 0) * xattn + emb

    def active_param_count(self) -> int:
        if self.family != "moe":
            return self.param_count()
        e, f = self.d_model, self.d_ff
        h, k, d = self.heads, self.kv_heads, self.resolved_head_dim
        attn = e * (h + 2 * k) * d + h * d * e
        act_moe = e * self.experts + self.top_k * 3 * e * f
        emb = self.vocab * e
        return self.n_layers * (attn + act_moe) + emb


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_').replace('.', '_')}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_').replace('.', '_')}")
    return mod.SMOKE


def shape_cells(cfg: ModelConfig):
    """The (arch × shape) cells this arch runs (long_500k gated on
    sub-quadratic support; see DESIGN.md)."""
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        cells.append("long_500k")
    return [SHAPES[c] for c in cells]
