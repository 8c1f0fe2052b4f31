"""Serving path: cache construction, single-token decode, the sequential
prefill, and seeding a cache from a ``prefill_kv`` plan's outputs.

The port of the reference's ``models/decode.py`` for attention (with an
mlp or a mixture-of-experts, and the encdec decoder's cross-attention),
rwkv and mamba blocks.  The cache is a dict ``{group: {leaf: (count, B,
...)}}``, the reference's layout: attention K/V ``b{i}_k``, ``b{i}_v``
(count, B, S, KV, D) in the model's dtype; an rwkv block's float32 WKV
state ``b{i}_state`` (count, B, H, D, D) and last inputs ``b{i}_last_tm``,
``b{i}_last_cm``; a mamba block's float32 SSD state ``b{i}_state`` (count,
B, heads, N, P) and conv inputs ``b{i}_conv`` (count, B, 3, inner + 2N); a
cross-attention block's K/V of the encoder's output ``b{i}_xk``,
``b{i}_xv`` (count, B, S, KV, D).  Unlike the reference, whose JAX arrays
are immutable, every function here writes the cache **in place** (``copy_``
into every leaf) and returns the same dict: a CUDA graph of the step
(:class:`DecodeGraph`) replays into the same buffers.

``init_cache`` builds the reference's three cache variants too:
``ring_local`` gives sliding-window layers a ring of ``window`` slots
(position p at slot ``p % window``; gemma3's local layers), ``quantize_kv``
int8 K/V with per-(position, head) bfloat16 abs-max scales ``b{i}_ksc`` /
``b{i}_vsc`` (count, B, S, KV, 1), ``kv_repeat_to`` K/V heads replicated
up to that count.  The decode step reads each layer's slot count off its
own leaf, so ring and full-length leaves mix in one step.

The encdec family decodes as the reference does: the encoder's groups are
skipped (their K/V leaves exist and stay untouched), and each decoder
block attends over its cross leaves under an all-valid mask.  Nothing
writes those leaves: ``init_cache`` makes them zeros, so the cross term
is ``out_project(0) = 0``.  Seeding them from the encoder's output is a
feature neither package has (ROADMAP §1).
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..core.executor import resolve_device
from ..layers import attention as A
from ..layers import embedding as E
from ..layers import mamba as M
from ..layers import mlp as F
from ..layers import moe as X
from ..layers import rwkv as R
from ..layers.common import layer_slice, rmsnorm, rope_apply, rope_tables
from .lm import LM, Block, _mamba_cfg


def _attn_dims(cfg: ModelConfig):
    return cfg.heads, cfg.kv_heads, cfg.resolved_head_dim


# --------------------------------------------------------------------------
# cache construction
# --------------------------------------------------------------------------

def init_cache(model: LM, batch: int, max_seq: int, *, device=None,
               ring_local: bool = False, kv_repeat_to: int = 0,
               quantize_kv: bool = False) -> dict:
    """Zeroed caches for every block, on ``device`` (the card unless the
    caller names another): K/V for attention blocks (a ring of ``window``
    slots for a sliding-window layer under ``ring_local``; int8 with
    bfloat16 scales under ``quantize_kv``; ``kv_repeat_to`` heads where
    that is more than the model's), the recurrent leaves for rwkv and
    mamba blocks, the cross-attention K/V (``max_seq`` slots) for an
    encdec decoder block."""
    dev = resolve_device(device)
    cfg = model.cfg
    _, kv, d = _attn_dims(cfg)
    if kv_repeat_to and kv_repeat_to > kv:
        if kv_repeat_to % kv:
            raise ValueError(f"kv_repeat_to {kv_repeat_to} is no multiple "
                             f"of the {kv} KV heads")
        kv = kv_repeat_to

    def zeros(shape, dtype=model.dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    cache: dict = {}
    for g in model.groups:
        gc: dict = {}
        for i, blk in enumerate(g.blocks):
            lead = (g.count, batch)
            if blk.kind in ("attn_mlp", "attn_moe", "shared_attn"):
                s_alloc = max_seq
                if ring_local and blk.window and blk.window < max_seq:
                    s_alloc = blk.window
                kv_dt = torch.int8 if quantize_kv else model.dtype
                gc[f"b{i}_k"] = zeros(lead + (s_alloc, kv, d), kv_dt)
                gc[f"b{i}_v"] = zeros(lead + (s_alloc, kv, d), kv_dt)
                if quantize_kv:
                    gc[f"b{i}_ksc"] = zeros(lead + (s_alloc, kv, 1),
                                            torch.bfloat16)
                    gc[f"b{i}_vsc"] = zeros(lead + (s_alloc, kv, 1),
                                            torch.bfloat16)
            if blk.kind in ("mamba", "shared_attn"):
                ei = cfg.expand * cfg.d_model
                gc[f"b{i}_state"] = zeros(
                    lead + (ei // cfg.mamba_head_dim, cfg.ssm_state,
                            cfg.mamba_head_dim), torch.float32)
                gc[f"b{i}_conv"] = zeros(
                    lead + (M.CONV_K - 1, ei + 2 * cfg.ssm_state))
            if blk.kind == "rwkv":
                hd = cfg.resolved_head_dim
                gc[f"b{i}_state"] = zeros(lead + (cfg.heads, hd, hd),
                                          torch.float32)
                gc[f"b{i}_last_tm"] = zeros(lead + (cfg.d_model,))
                gc[f"b{i}_last_cm"] = zeros(lead + (cfg.d_model,))
            if blk.cross:
                gc[f"b{i}_xk"] = zeros(lead + (max_seq, kv, d))
                gc[f"b{i}_xv"] = zeros(lead + (max_seq, kv, d))
        cache[g.name] = gc
    return cache


# --------------------------------------------------------------------------
# single-token decode
# --------------------------------------------------------------------------

def _decode_attn(p, x, ck, cv, cfg: ModelConfig, window: int, step: dict,
                 *, ring: bool = False, ksc=None, vsc=None):
    """x: (B, 1, E); ck/cv: one layer's (B, S, KV, D) cache, written in
    place at each row's own position ``step["pos"]`` — at slot ``pos % S``
    in a ring (``ring``), which holds the last S positions and needs no
    window mask.  With int8 caches, ``ksc`` / ``vsc`` (B, S, KV, 1) take
    the new entries' scales at the same slot.  S is this layer's own, read
    off its leaf: a ring and a full-length layer may share the step."""
    h, kvh, d = _attn_dims(cfg)
    q = A.project_q(p, x, h, d)
    k, v = A.project_kv(p, x, kvh, d)
    if cfg.qk_norm and "q_norm" in p:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    q = rope_apply(q, step["cos"], step["sin"])
    k = rope_apply(k, step["cos"], step["sin"])
    if ck.shape[2] > kvh:                   # a replicated-KV cache
        reps = ck.shape[2] // kvh
        k = k.repeat_interleave(reps, dim=2)
        v = v.repeat_interleave(reps, dim=2)
    rows, pos = step["rows"], step["pos"]
    s_alloc = ck.shape[1]
    slot = pos % s_alloc if ring else pos
    if ksc is not None:
        k, k_s = A.quantize_kv(k)
        v, v_s = A.quantize_kv(v)
        ksc[rows, slot] = k_s[:, 0]
        vsc[rows, slot] = v_s[:, 0]
    ck[rows, slot] = k[:, 0].to(ck.dtype)
    cv[rows, slot] = v[:, 0].to(cv.dtype)
    keys = step["keys"][s_alloc]
    valid = keys[None, :] < (pos + 1).clamp(max=s_alloc)[:, None]
    if window and window > 0 and not ring:
        valid = valid & (keys[None, :] > (pos - window)[:, None])
    return A.out_project(p, A.decode_attend_gqa(q, ck, cv, valid,
                                                k_scale=ksc, v_scale=vsc))


def _decode_block(cfg: ModelConfig, blk: Block, i: int, p, root, x, lc,
                  step, ring_local: bool = False):
    """One block of the decode step.  ``p`` holds the layer's parameters,
    ``root`` the whole tree (the hybrid's shared attention reads
    ``root["shared"]``); ``lc`` the layer's cache leaves, each written in
    place.  Under ``ring_local`` a windowed block whose leaf holds exactly
    ``window`` slots decodes as a ring, as the reference decides.  A cross
    block attends over its cross leaves, which it reads and never
    writes."""
    pre = f"b{i}"
    if blk.kind in ("attn_mlp", "attn_moe"):
        h = rmsnorm(x, p[f"{pre}_ln1"]["scale"])
        ring = bool(ring_local and blk.window
                    and lc[f"{pre}_k"].shape[1] == blk.window)
        x = x + _decode_attn(p[f"{pre}_attn"], h, lc[f"{pre}_k"],
                             lc[f"{pre}_v"], cfg, blk.window, step,
                             ring=ring, ksc=lc.get(f"{pre}_ksc"),
                             vsc=lc.get(f"{pre}_vsc"))
        if blk.cross:
            xp, xk = p[f"{pre}_xattn"], lc[f"{pre}_xk"]
            hq = A.project_q(xp, rmsnorm(x, p[f"{pre}_lnx"]["scale"]),
                             cfg.heads, cfg.resolved_head_dim)
            valid = torch.ones((x.shape[0], xk.shape[1]), dtype=torch.bool,
                               device=x.device)
            x = x + A.out_project(xp, A.decode_attend_gqa(
                hq, xk, lc[f"{pre}_xv"], valid))
        h = rmsnorm(x, p[f"{pre}_ln2"]["scale"])
        if blk.kind == "attn_moe":
            # capacity dispatch at s = 1: cap 8 a row, never drops
            return x + X.moe_dense(p[f"{pre}_moe"], h, top_k=cfg.top_k,
                                   experts=cfg.experts, act=cfg.act)
        return x + F.mlp_fused(p[f"{pre}_mlp"], h, gated=cfg.gated,
                               act=cfg.act)
    if blk.kind == "rwkv":
        h = rmsnorm(x, p[f"{pre}_ln1"]["scale"])
        tm, last, st = R.rwkv_time_mix(
            p[f"{pre}_tm"], h, heads=cfg.heads,
            head_dim=cfg.resolved_head_dim, last_x=lc[f"{pre}_last_tm"],
            state=lc[f"{pre}_state"])
        lc[f"{pre}_last_tm"].copy_(last)
        lc[f"{pre}_state"].copy_(st)
        x = x + tm
        h = rmsnorm(x, p[f"{pre}_ln2"]["scale"])
        cm, last_cm = R.rwkv_channel_mix(p[f"{pre}_cm"], h,
                                         last_x=lc[f"{pre}_last_cm"])
        lc[f"{pre}_last_cm"].copy_(last_cm)
        return x + cm
    if blk.kind in ("mamba", "shared_attn"):
        h = rmsnorm(x, p[f"{pre}_ln1"]["scale"])
        mb, st, conv = M.mamba2_block(p[f"{pre}_mamba"], h, _mamba_cfg(cfg),
                                      state=lc[f"{pre}_state"],
                                      conv_state=lc[f"{pre}_conv"])
        lc[f"{pre}_state"].copy_(st)
        lc[f"{pre}_conv"].copy_(conv)
        x = x + mb
        if blk.kind == "shared_attn":
            sp = root["shared"]
            h = rmsnorm(x, sp["ln1"]["scale"])
            x = x + _decode_attn(sp["attn"], h, lc[f"{pre}_k"],
                                 lc[f"{pre}_v"], cfg, 0, step,
                                 ksc=lc.get(f"{pre}_ksc"),
                                 vsc=lc.get(f"{pre}_vsc"))
            h = rmsnorm(x, sp["ln2"]["scale"])
            x = x + F.mlp_fused(sp["mlp"], h, gated=cfg.gated, act=cfg.act)
        return x
    raise ValueError(blk.kind)


@torch.inference_mode()
def decode_step_batched(model: LM, params, cache, tokens, indices, *,
                        ring_local: bool = False):
    """Continuous-batching decode: one token per batch slot at a per-slot
    position.  tokens: (B, 1) int; indices: (B,) int — slot b decodes
    position ``indices[b]``: its K/V land there (at ``indices[b] % W`` in a
    ring of W slots under ``ring_local``) and it attends to positions
    ``<= indices[b]``; its recurrent state advances one step.  Returns
    (logits (B, 1, V), cache), the cache updated in place.  The
    reference's ``vmap`` over ``decode_step`` becomes this batch dimension
    written out."""
    cfg = model.cfg
    pos = indices.to(device=tokens.device, dtype=torch.long)
    cos, sin = rope_tables(pos[:, None], cfg.resolved_head_dim,
                           theta=cfg.rope_theta)
    # key positions for each slot count the K/V leaves hold (a ring's
    # window, the full length)
    lens = {leaf.shape[2] for gc in cache.values()
            for key, leaf in gc.items() if key.endswith("_k")}
    step = {"pos": pos, "rows": torch.arange(pos.shape[0],
                                             device=tokens.device),
            "cos": cos, "sin": sin,
            "keys": {n: torch.arange(n, device=tokens.device)
                     for n in lens}}
    x = E.embed(params["embed"], tokens.long(),
                scale=cfg.embed_scale).to(model.dtype)
    for g in model.groups:
        if g.name.startswith("enc"):
            continue
        gp, gc = params[g.name], cache[g.name]
        for layer in range(g.count):
            lp, lc = layer_slice(gp, layer), layer_slice(gc, layer)
            for i, blk in enumerate(g.blocks):
                x = _decode_block(cfg, blk, i, lp, params, x, lc, step,
                                  ring_local)
    x = rmsnorm(x, params["final_norm"]["scale"])
    logits = E.mask_padded_logits(E.unembed(params["embed"], x), cfg.vocab)
    return logits, cache


class DecodeGraph:
    """:func:`decode_step_batched` on one fixed cache and batch width,
    captured once in a CUDA graph and replayed for every step — the
    counterpart of the reference's ``jax.jit`` of its decode step.  A step
    is some 1,800 small PyTorch operations at qwen3-0.6b's 28 layers;
    replayed, they cost their device time instead of their Python dispatch.
    Replay runs the kernels the eager step runs.

    Building it runs the step once on token 0 at position 0 of every row
    (the warm-up CUDA graphs need): that writes K/V at position 0 and
    advances every recurrent state one step.  Build it before any row is
    seeded (the runtime does so in its constructor), and overwrite or zero
    a row's recurrent leaves before use (``PagedKVPool.adopt`` writes all
    of a slot's leaves; the replay cache is zeroed per request).  The
    returned logits live in a static buffer that the next call
    overwrites."""

    def __init__(self, model: LM, params, cache, batch: int):
        dev = next(iter(next(iter(cache.values())).values())).device
        if dev.type != "cuda":
            raise ValueError(f"DecodeGraph needs a CUDA cache, got {dev}")
        self.tokens = torch.zeros((batch, 1), dtype=torch.long, device=dev)
        self.indices = torch.zeros((batch,), dtype=torch.long, device=dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):   # warm-up: cuBLAS handles, workspace
            decode_step_batched(model, params, cache, self.tokens,
                                self.indices)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.logits, _ = decode_step_batched(model, params, cache,
                                                 self.tokens, self.indices)

    def __call__(self, tokens, indices):
        """One step: (B, 1) tokens at (B,) positions; returns the logits
        (B, 1, V) and updates the cache in place, as the eager step."""
        self.tokens.copy_(tokens)
        self.indices.copy_(indices)
        self.graph.replay()
        return self.logits


def decode_step(model: LM, params, cache, tokens, index, *,
                ring_local: bool = False):
    """tokens: (B, 1) int; index: the position every row decodes.
    Returns (logits (B, 1, V), cache), the cache updated in place."""
    idx = torch.full((tokens.shape[0],), int(index), dtype=torch.long,
                     device=tokens.device)
    return decode_step_batched(model, params, cache, tokens, idx,
                               ring_local=ring_local)


def prefill(model: LM, params, tokens, max_seq: int, *,
            frontend_embeds=None, ring_local: bool = False):
    """Sequential prefill through the decode step, one position at a time
    (the reference's small-scale serving example; the throughput prefill
    is the planned forward).  tokens: (B, S) int on the cache's device.
    ``frontend_embeds`` is accepted and ignored, as the reference's
    (its decode step has no frontend input).  Returns (the last
    position's logits (B, 1, V), the cache)."""
    b, s = tokens.shape
    cache = init_cache(model, b, max_seq, device=tokens.device,
                       ring_local=ring_local)
    logits = None
    for t in range(s):
        logits, cache = decode_step(model, params, cache,
                                    tokens[:, t:t + 1], t,
                                    ring_local=ring_local)
    return logits, cache


def attn_block_indices(group) -> list:
    """Block indices within a group whose cache entries are attention K/V
    — the blocks a ``prefill_kv`` plan emits, in emission order."""
    return [i for i, blk in enumerate(group.blocks)
            if blk.kind in ("attn_mlp", "attn_moe")]


@torch.inference_mode()
def seed_cache_from_prefill(model: LM, cache, kv_groups, prompt_len: int, *,
                            slot=None):
    """Write a ``prefill_kv`` plan's K/V outputs into a decode cache, in
    place.  ``kv_groups``: one entry per model group, a tuple over emitting
    blocks of (K, V) stacked as (layers, B, bucket, KV, D).  With
    ``slot=None`` the prefill batch must match the cache batch and all rows
    are seeded; with an int ``slot`` the prefill must be batch-1 and lands
    in that cache row.  Returns the cache."""
    for g, kv_g in zip(model.groups, kv_groups):
        gc = cache[g.name]
        for bi, (k, v) in zip(attn_block_indices(g), kv_g):
            if f"b{bi}_ksc" in gc or gc[f"b{bi}_k"].shape[2] < prompt_len:
                raise ValueError(
                    "prefill_kv seeding needs full-length, unquantized "
                    "caches (no ring_local/quantize_kv)")
            for key, val in ((f"b{bi}_k", k), (f"b{bi}_v", v)):
                leaf = gc[key]
                val = val[:, :, :prompt_len].to(leaf.dtype)
                if slot is None:
                    leaf[:, :, :prompt_len] = val
                else:
                    leaf[:, slot, :prompt_len] = val[:, 0]
    return cache
