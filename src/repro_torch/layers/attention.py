"""Attention layer family: projections, SDPA candidates, KV-cache decode.

The port of the reference's ``layers/attention.py``.  Two physical
realizations of the logical sdpa (the planner's candidates on this slice):

  * :func:`sdpa_full`  — full masked attention, materialized logits (the
    ``sdpa_xla`` impl), plain PyTorch;
  * :func:`sdpa_flash` — the flash-attention kernel (``attn_flash_pallas``),
    ``kernels/csrc/flash_attention.cu`` on the card.

``sdpa_banded`` and int8 KV quantization wait for the gemma3 slice.
"""
from __future__ import annotations

import torch

from ..kernels.flash_attention import flash_attention, flash_attention_plain
from .common import he_init, rmsnorm, rope


# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------

def init_attention(gen, cfg_attn, dtype=torch.float32):
    """cfg_attn: dict(embed, heads, kv_heads, head_dim, qk_norm)."""
    e = cfg_attn["embed"]
    h, k, d = cfg_attn["heads"], cfg_attn["kv_heads"], cfg_attn["head_dim"]
    p = {
        "wq": he_init(gen, (e, h * d), e, dtype),
        "wk": he_init(gen, (e, k * d), e, dtype),
        "wv": he_init(gen, (e, k * d), e, dtype),
        "wo": he_init(gen, (h * d, e), h * d, dtype),
    }
    if cfg_attn.get("qk_norm"):
        p["q_norm"] = torch.zeros((d,), dtype=dtype, device=gen.device)
        p["k_norm"] = torch.zeros((d,), dtype=dtype, device=gen.device)
    return p


# --------------------------------------------------------------------------
# projections
# --------------------------------------------------------------------------

def project_q(p, x, h, d):
    return torch.matmul(x, p["wq"].to(x.dtype)).reshape(
        x.shape[0], x.shape[1], h, d)


def project_kv(p, x, k, d):
    kk = torch.matmul(x, p["wk"].to(x.dtype)).reshape(
        x.shape[0], x.shape[1], k, d)
    vv = torch.matmul(x, p["wv"].to(x.dtype)).reshape(
        x.shape[0], x.shape[1], k, d)
    return kk, vv


def project_qkv_fused(p, x, h, k, d):
    """One gemm over the concatenated projection — the fused candidate.
    q, k and v are views into its one output."""
    w = torch.cat([p["wq"], p["wk"], p["wv"]], dim=-1).to(x.dtype)
    out = torch.matmul(x, w)
    q, kk, vv = torch.split(out, [h * d, k * d, k * d], dim=-1)
    b, s = x.shape[:2]
    return (q.reshape(b, s, h, d), kk.reshape(b, s, k, d),
            vv.reshape(b, s, k, d))


def qk_prep(p, q, k, positions, *, qk_norm=False, use_rope=True,
            rope_theta=10000.0):
    if qk_norm and "q_norm" in p:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    if use_rope:
        q = rope(q, positions, theta=rope_theta)
        k = rope(k, positions, theta=rope_theta)
    return q, k


def out_project(p, attn_out):
    b, s, h, d = attn_out.shape
    return torch.matmul(attn_out.reshape(b, s, h * d),
                        p["wo"].to(attn_out.dtype))


# --------------------------------------------------------------------------
# SDPA candidates
# --------------------------------------------------------------------------

def sdpa_full(q, k, v, *, causal=True, window=0):
    return flash_attention_plain(q, k, v, causal=causal, window=window)


def sdpa_flash(q, k, v, *, causal=True, window=0):
    return flash_attention(q, k, v, causal=causal, window=window)


# --------------------------------------------------------------------------
# KV-cache decode
# --------------------------------------------------------------------------

def decode_attend_gqa(q, cache_k, cache_v, valid_mask):
    """Repeat-free GQA attention for decode: q (B, 1, H, D) grouped as
    (B, KV, G, D) against the cache (B, S, KV, D) directly, under the
    (B, S) ``valid_mask``.  Float32 logits and softmax, output in q's
    dtype."""
    b, _, h, d = q.shape
    kv = cache_k.shape[2]
    qg = q.reshape(b, kv, h // kv, d)
    logits = torch.einsum("bkgd,bskd->bkgs", qg.float(),
                          cache_k.float()) * (d ** -0.5)
    logits = torch.where(valid_mask[:, None, None, :], logits,
                         torch.full((), -1e30, device=q.device))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, cache_v.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


def cache_update(cache_k, cache_v, new_k, new_v, index):
    """Write the new tokens' k/v at position ``index`` along axis 1, in
    place (the reference returns updated copies); returns the caches."""
    n = new_k.shape[1]
    cache_k[:, index:index + n] = new_k.to(cache_k.dtype)
    cache_v[:, index:index + n] = new_v.to(cache_v.dtype)
    return cache_k, cache_v
