"""Attention layer family: projections, SDPA candidates, KV-cache decode.

The port of the reference's ``layers/attention.py``.  Three physical
realizations of the logical sdpa (the planner's candidates):

  * :func:`sdpa_full`   — full masked attention, materialized logits (the
    ``sdpa_xla`` impl), plain PyTorch;
  * :func:`sdpa_banded` — O(S·W) chunked local-window attention (the
    ``sdpa_banded_xla`` impl), plain PyTorch;
  * :func:`sdpa_flash`  — the flash-attention kernel (``attn_flash_pallas``),
    ``kernels/csrc/flash_attention.cu`` on the card.

The decode side: :func:`decode_attend_gqa` (with the int8 caches' scales),
:func:`decode_attend`, :func:`quantize_kv` and :func:`cache_update`.
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


def attention_specs(cfg_attn) -> dict:
    """The dim names of :func:`init_attention`'s leaves."""
    s = {"wq": ("embed", "heads_flat"), "wk": ("embed", "kv_flat"),
         "wv": ("embed", "kv_flat"), "wo": ("heads_flat", "embed")}
    if cfg_attn.get("qk_norm"):
        s["q_norm"] = ("head_dim",)
        s["k_norm"] = ("head_dim",)
    return s


# --------------------------------------------------------------------------
# heads on a model axis
# --------------------------------------------------------------------------

def head_block(h: int, m: int, r: int) -> tuple:
    """Rank ``r``'s query heads ``[lo, hi)`` of ``h`` over ``m`` ranks:
    ``h / m`` each when ``m`` divides ``h``, else the first ``h mod m``
    ranks take one head more (rank 0 holds a largest block).  Refuses
    fewer heads than ranks."""
    if h < m:
        raise ValueError(f"{h} heads are fewer than the {m} ranks of the "
                         f"model axis")
    f, rem = divmod(h, m)
    lo = r * f + min(r, rem)
    return lo, lo + f + (r < rem)


def kv_heads_read(h: int, k: int, lo: int, hi: int) -> tuple:
    """``(klo, khi, index)``: the KV heads ``[klo, khi)`` that query heads
    ``[lo, hi)`` read (``h / k`` query heads a group), and ``index`` None
    when the query heads group over them in order (GQA), else the KV head
    (relative to ``klo``) of each query head: the K/V must then be
    expanded to one head per query head."""
    g = h // k
    klo, khi = lo // g, (hi - 1) // g + 1
    hl, kl = hi - lo, khi - klo
    rel = [i // g - klo for i in range(lo, hi)]
    if hl % kl == 0 and rel == [j // (hl // kl) for j in range(hl)]:
        return klo, khi, None
    return klo, khi, rel


def expand_heads(x, index):
    """``x`` (B, S, K, D) with its heads taken as ``index`` lists them (None:
    ``x`` itself)."""
    if index is None:
        return x
    return x[:, :, torch.tensor(index, device=x.device)]


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


def sdpa_banded(q, k, v, *, window, causal=True):
    """Chunked local attention: O(S·W) compute.  The sequence is cut into
    chunks of W; each query chunk attends to its own chunk and the previous
    one, masked to the sliding window — the reference's banding, op for
    op (``causal`` reaches only the full fallback, as there)."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    w = int(window)
    if w <= 0 or w >= s:
        return sdpa_full(q, k, v, causal=causal, window=window)
    groups = h // kh
    pad = (-s) % w
    sp = s + pad
    qp, kp, vp = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
                  for x in (q, k, v))
    nc = sp // w
    qc = qp.reshape(b, nc, w, h, d)
    kc = kp.reshape(b, nc, w, kh, d)
    vc = vp.reshape(b, nc, w, kh, d)
    # keys: previous chunk ++ own chunk (window <= W, so covered); the
    # first chunk's previous one is zeros
    prev = (0, 0, 0, 0, 0, 0, 1, 0)
    k2 = torch.cat([torch.nn.functional.pad(kc[:, :-1], prev), kc], dim=2)
    v2 = torch.cat([torch.nn.functional.pad(vc[:, :-1], prev), vc], dim=2)
    kr = k2.repeat_interleave(groups, dim=3)
    vr = v2.repeat_interleave(groups, dim=3)
    logits = torch.einsum("bcqhd,bckhd->bchqk", qc.float(),
                          kr.float()) * (d ** -0.5)
    dev = q.device
    qi = torch.arange(w, device=dev)[:, None] + w      # position in 2W axis
    ki = torch.arange(2 * w, device=dev)[None, :]
    mask = (ki <= qi) & (ki > qi - w)                   # causal and window
    # the first chunk's "previous" keys are padding
    first = (torch.arange(nc, device=dev) == 0).reshape(1, nc, 1, 1, 1)
    pad_keys = (ki < w)[None, None, None]
    mask = mask[None, None, None] & ~(first & pad_keys)
    logits = torch.where(mask, logits, torch.full((), -1e30, device=dev))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bchqk,bckhd->bcqhd", p, vr.float())
    return out.reshape(b, sp, h, d)[:, :s].to(q.dtype)


def sdpa_flash(q, k, v, *, causal=True, window=0):
    return flash_attention(q, k, v, causal=causal, window=window)


# --------------------------------------------------------------------------
# KV-cache decode
# --------------------------------------------------------------------------

def decode_attend_gqa(q, cache_k, cache_v, valid_mask, *, k_scale=None,
                      v_scale=None):
    """Repeat-free GQA attention for decode: q (B, 1, H, D) grouped as
    (B, KV, G, D) against the cache (B, S, KV, D) directly, under the
    (B, S) ``valid_mask``.  Float32 logits and softmax, output in q's
    dtype.  int8 caches pass their per-(position, head) scales
    ``k_scale`` / ``v_scale`` (B, S, KV, 1): the k-scale multiplies the
    logits, the v-scale the softmax weights."""
    b, _, h, d = q.shape
    kv = cache_k.shape[2]
    qg = q.reshape(b, kv, h // kv, d)
    logits = torch.einsum("bkgd,bskd->bkgs", qg.float(),
                          cache_k.float()) * (d ** -0.5)
    if k_scale is not None:                  # (B, S, KV, 1) -> (B, KV, 1, S)
        logits = logits * k_scale[..., 0].transpose(1, 2)[:, :, None, :] \
            .float()
    logits = torch.where(valid_mask[:, None, None, :], logits,
                         torch.full((), -1e30, device=q.device))
    p = torch.softmax(logits, dim=-1)
    if v_scale is not None:
        p = p * v_scale[..., 0].transpose(1, 2)[:, :, None, :].float()
    out = torch.einsum("bkgs,bskd->bkgd", p, cache_v.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


def quantize_kv(x, *, axis=-1):
    """abs-max int8 quantization along ``axis``: returns (int8 values,
    bfloat16 scales).  ``torch.round`` rounds half to even, as
    ``jnp.round``."""
    xf = x.float()
    amax = xf.abs().amax(dim=axis, keepdim=True)
    sc = amax.clamp(min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / sc), -127, 127)
    return q.to(torch.int8), sc.to(torch.bfloat16)


def decode_attend(q, cache_k, cache_v, index, *, window=0):
    """q: (B, 1, H, D); cache_k/v: (B, S_max, K, D); ``index``: the count
    of valid cache entries *including* the newly written position.  The
    reference's ``mha_reference`` under a key mask: keys repeated to the
    query heads, float32 logits and softmax, output in q's dtype."""
    b, _, h, d = q.shape
    s_max = cache_k.shape[1]
    keys = torch.arange(s_max, device=q.device)
    valid = keys < index
    if window and window > 0:
        valid = valid & (keys >= index - window)
    groups = h // cache_k.shape[2]
    kr = cache_k.repeat_interleave(groups, dim=2)
    vr = cache_v.repeat_interleave(groups, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          kr.float()) * (d ** -0.5)
    logits = torch.where(valid, logits, torch.full((), -1e30,
                                                   device=q.device))
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vr.float())
    return out.to(q.dtype)


def cache_update(cache_k, cache_v, new_k, new_v, index):
    """Write the new tokens' k/v at position ``index`` along axis 1, in
    place (the reference returns updated copies); returns the caches."""
    n = new_k.shape[1]
    cache_k[:, index:index + n] = new_k.to(cache_k.dtype)
    cache_v[:, index:index + n] = new_v.to(cache_v.dtype)
    return cache_k, cache_v
