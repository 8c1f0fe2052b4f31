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

On a rank mesh (``mesh=``, a ``launch.mesh.RankMesh``) the step runs on
the rank's blocks of the parameters (their ``Sharding`` tree), of the
cache (:func:`cache_shardings`, the reference's ``dryrun.cache_shardings``,
with its two layouts for KV heads that do not divide ``model``: the cache
cut on its positions or on its channels) and of the rows:
:func:`decode_step_batched` documents the layout.

The encdec family decodes as the reference does: the encoder's groups are
skipped (their K/V leaves exist and stay untouched), and each decoder
block attends over its cross leaves under an all-valid mask.  Nothing
writes those leaves: ``init_cache`` makes them zeros, so the cross term
is ``out_project(0) = 0``.  Seeding them from the encoder's output is a
feature neither package has (ROADMAP §1).
"""
from __future__ import annotations

from types import SimpleNamespace

import torch

from ..configs.base import ModelConfig
from ..core import collectives as C
from ..core.executor import (Sharding, gather_params, layer_shardings,
                             resolve_device)
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
    caller names another; ``"meta"`` gives the shapes and dtypes alone):
    K/V for attention blocks (a ring of ``window``
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


def batch_spec(mesh, batch: int):
    """The axes a cache's or a decode batch's rows are cut over: ``(pod,
    data)`` when they divide the batch, else None (whole on every rank,
    as the reference's ``_batch_axes``)."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    n = 1
    for a in axes:
        n *= int(mesh.shape[a])
    if not axes or batch % n:
        return None
    return axes if len(axes) > 1 else axes[0]


def cache_shardings(mesh, model: LM, cache: dict, shape, *,
                    kv_shard_seq: bool = False,
                    kv_shard_dim: bool = False) -> dict:
    """The reference's rule for the decode caches (``dryrun.py``'s
    ``cache_shardings``), a tree of ``Sharding`` keyed as ``cache`` (global
    leaves, meta tensors will do): the batch over ``(pod, data)`` when it
    divides ``shape.global_batch``, else whole; the K/V heads of ``_k`` /
    ``_v`` / ``_xk`` / ``_xv`` (count, B, S, KV, D) over ``model`` when
    they divide, else, under ``kv_shard_dim``, the channels D (dim 4) when
    they divide (the channel-parallel cache), else, under
    ``kv_shard_seq``, the positions S (dim 2) when they divide (the
    sequence-parallel cache), else whole; a recurrent ``_state``'s heads
    (dim 2) and a ``_conv``'s channels (dim 3) over ``model`` when they
    divide.  Every other leaf (int8 scales, rwkv ``_last_*``) is cut on
    its batch only."""
    bspec = batch_spec(mesh, int(shape.global_batch))
    m = int(mesh.shape.get("model", 1))

    def one(name, leaf):
        r = leaf.dim()
        spec = [None] * r
        if r >= 2:
            spec[1] = bspec
        key = name.rsplit(".", 1)[-1]
        if key.endswith(("_k", "_v", "_xk", "_xv")) and r == 5:
            if leaf.shape[3] % m == 0:
                spec[3] = "model"
            elif kv_shard_dim and leaf.shape[4] % m == 0:
                spec[4] = "model"
            elif kv_shard_seq and leaf.shape[2] % m == 0:
                spec[2] = "model"
        elif key.endswith("_state") and r >= 4:
            if leaf.shape[2] % m == 0:
                spec[2] = "model"
        elif key.endswith("_conv") and r == 4:
            if leaf.shape[3] % m == 0:
                spec[3] = "model"
        return Sharding(mesh, tuple(spec), name)

    return {g: {k: one(f"{g}.{k}", v) for k, v in gc.items()}
            for g, gc in cache.items()}


# --------------------------------------------------------------------------
# single-token decode
# --------------------------------------------------------------------------

@torch.inference_mode()
def decode_step_batched(model: LM, params, cache, tokens, indices, *,
                        ring_local: bool = False, mesh=None, shardings=None,
                        cache_sh=None):
    """Continuous-batching decode: one token per batch slot at a per-slot
    position.  tokens: (B, 1) int; indices: (B,) int — slot b decodes
    position ``indices[b]``: its K/V land there (at ``indices[b] % W`` in a
    ring of W slots under ``ring_local``) and it attends to positions
    ``<= indices[b]``; its recurrent state advances one step.  Returns
    (logits (B, 1, V), cache), the cache updated in place.  The
    reference's ``vmap`` over ``decode_step`` becomes this batch dimension
    written out.

    On a rank mesh (``mesh``, with ``shardings`` the parameters'
    ``Sharding`` tree and ``cache_sh`` the cache's, :func:`cache_shardings`)
    ``params``, ``cache``, ``tokens`` and ``indices`` are the rank's
    blocks: the rows over ``(pod, data)`` when they divide, else whole.
    Each layer's ``data`` shards are gathered before it runs (FSDP, none
    under inference rules); over ``model`` the rank runs its query heads
    (``attention.head_block``) and the KV heads they read, its ffn
    columns, its experts, its rwkv / mamba heads when the recurrent state
    is cut over ``model`` (the whole block, weights gathered, when it is
    not), and every row-parallel output is summed over ``model``.  A K/V
    cache cut on its positions or channels (``cache_shardings``'
    ``kv_shard_seq`` / ``kv_shard_dim``, read off ``cache_sh``) is read by
    every query head on every rank, the softmax combined over ``model``.
    The logits come back as the rank's vocab block (B, 1, V / model).  A
    mesh step runs eagerly (``DecodeGraph`` is one rank's)."""
    if mesh is not None and (shardings is None or cache_sh is None):
        raise ValueError("a decode step on a mesh takes shardings= (the "
                         "parameters') and cache_sh= (cache_shardings)")
    cfg = model.cfg
    ctx = SimpleNamespace(axis=lambda name: (
        mesh.axis(name) if mesh is not None and name in mesh.axis_names
        and int(mesh.shape[name]) > 1 else None))
    axis = ctx.axis("model")

    def fsdp(p, sh):
        """``p`` with its ``data`` shards gathered (FSDP; ``sh`` its
        shardings, None on one rank)."""
        return gather_params(ctx, p, sh) if ctx.axis("data") else p

    shd = shardings or {}

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
    emb = fsdp(params["embed"], shd.get("embed"))
    ids = tokens.long()
    if axis is None:
        x = E.embed(emb, ids, scale=cfg.embed_scale).to(model.dtype)
    else:                                   # a vocab-parallel embedding
        rows = emb["table"].shape[0]
        local = ids - int(axis.rank) * rows
        inside = (local >= 0) & (local < rows)
        x = E.embed(emb, local.clamp(0, rows - 1),
                    scale=cfg.embed_scale).to(model.dtype)
        x = C.reduce_from(axis, torch.where(
            inside[..., None], x, torch.zeros((), dtype=x.dtype,
                                              device=x.device)))
    root = dict(params)
    if "shared" in params:
        root["shared"] = fsdp(params["shared"], shd.get("shared"))
    for g in model.groups:
        if g.name.startswith("enc"):
            continue
        gp, gc = params[g.name], cache[g.name]
        lsh = layer_sh = None
        if mesh is not None:
            lsh = layer_shardings(cache_sh[g.name])
            layer_sh = layer_shardings(shardings[g.name])
        for layer in range(g.count):
            lp = fsdp(layer_slice(gp, layer), layer_sh)
            lc = layer_slice(gc, layer)
            for i, blk in enumerate(g.blocks):
                x = _decode_block(cfg, blk, i, lp, root, x, lc, step,
                                  ring_local, axis, lsh)
    norm = fsdp(params["final_norm"], shd.get("final_norm"))
    x = rmsnorm(x, norm["scale"])
    logits = E.unembed(emb, x)
    lo = 0 if axis is None else int(axis.rank) * logits.shape[-1]
    return E.mask_padded_logits(logits, cfg.vocab - lo), cache


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
                ring_local: bool = False, mesh=None, shardings=None,
                cache_sh=None):
    """tokens: (B, 1) int; index: the position every row decodes (an int
    or a scalar tensor).  Returns (logits (B, 1, V), cache), the cache
    updated in place; on a rank mesh as :func:`decode_step_batched`."""
    if isinstance(index, torch.Tensor):
        idx = index.to(device=tokens.device, dtype=torch.long).expand(
            tokens.shape[0])
    else:
        idx = torch.full((tokens.shape[0],), int(index), dtype=torch.long,
                         device=tokens.device)
    return decode_step_batched(model, params, cache, tokens, idx,
                               ring_local=ring_local, mesh=mesh,
                               shardings=shardings, cache_sh=cache_sh)


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


# --------------------------------------------------------------------------
# the decode step's blocks, on one rank or a rank mesh
# --------------------------------------------------------------------------

def _cut(lsh, key: str, dim: int) -> bool:
    """Whether dim ``dim`` of the layer's cache leaf ``key`` is cut over
    ``model`` (``lsh``: the layer's cache shardings; None on one rank)."""
    return lsh is not None and "model" in lsh[key].axes(dim)


def _kv_cut(lsh, key: str):
    """How the layer's K/V leaf ``key`` (B, S, KV, D) is cut over
    ``model``: ``"heads"``, ``"seq"`` (``kv_shard_seq``), ``"dim"``
    (``kv_shard_dim``), or None (whole)."""
    for dim, how in ((2, "heads"), (1, "seq"), (3, "dim")):
        if _cut(lsh, key, dim):
            return how
    return None


def _axis_coords(axis) -> tuple:
    """``(ranks, rank)`` of a ``model`` axis; ``(1, 0)`` for one rank."""
    return (1, 0) if axis is None else (int(axis.world), int(axis.rank))


def _decode_attn(p, x, ck, cv, cfg: ModelConfig, window: int, step: dict,
                 axis=None, *, cut=None, ring: bool = False, ksc=None,
                 vsc=None):
    """x: (B, 1, E); ck/cv: one layer's (B, S, KV, D) cache, written in
    place at each row's own position ``step["pos"]`` — at slot ``pos % S``
    in a ring (``ring``), which holds the last S positions and needs no
    window mask.  With int8 caches, ``ksc`` / ``vsc`` (B, S, KV, 1) take
    the new entries' scales at the same slot.  S is this layer's own, read
    off its leaf: a ring and a full-length layer may share the step.  A
    cache of more KV heads than the model's (``kv_repeat_to``) gets each
    head's K/V repeated.

    On a ``model`` axis: the rank's query heads ``[lo, hi)``; K/V computed
    for the cache heads the rank writes (its block when ``cut`` is
    ``"heads"``; every head when the block is whole, or when int8 scales,
    whole over ``model``, are written) and read by its query heads; the out
    projection row-parallel, summed over ``axis``.  A cache cut on its
    positions or channels (``cut`` ``"seq"`` / ``"dim"``) goes to
    :func:`_decode_attn_split`."""
    if cut in ("seq", "dim"):
        return _decode_attn_split(p, x, ck, cv, cfg, window, step, axis,
                                  cut, ring, ksc, vsc)
    kv_cut = cut == "heads"
    h, kvh, d = _attn_dims(cfg)
    m, r = _axis_coords(axis)
    lo, hi = A.head_block(h, m, r)
    hc = ck.shape[2] * (m if kv_cut else 1)        # the cache's KV heads
    reps = hc // kvh
    clo, chi = (r * ck.shape[2], (r + 1) * ck.shape[2]) if kv_cut \
        else (0, hc)
    wlo, whi = (0, hc) if ksc is not None else (clo, chi)
    olo, ohi = wlo // reps, (whi - 1) // reps + 1  # the model's KV heads
    wq = C.span(axis, [p["wq"]], 1, lo * d, hi * d)[0]
    wk, wv = C.span(axis, [p["wk"], p["wv"]], 1, olo * d, ohi * d)
    q = A.project_q({"wq": wq}, x, hi - lo, d)
    k, v = A.project_kv({"wk": wk, "wv": wv}, x, ohi - olo, d)
    if cfg.qk_norm and "q_norm" in p:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    q = rope_apply(q, step["cos"], step["sin"])
    k = rope_apply(k, step["cos"], step["sin"])
    if reps > 1:
        k = k.repeat_interleave(reps, dim=2)
        v = v.repeat_interleave(reps, dim=2)
    base = olo * reps                               # cache head of k[:, :, 0]
    rows, pos = step["rows"], step["pos"]
    s_alloc = ck.shape[1]
    slot = pos % s_alloc if ring else pos
    if ksc is not None:
        k, k_s = A.quantize_kv(k)
        v, v_s = A.quantize_kv(v)
        ksc[rows, slot] = k_s[:, 0]
        vsc[rows, slot] = v_s[:, 0]
    ck[rows, slot] = k[:, 0, clo - base:chi - base].to(ck.dtype)
    cv[rows, slot] = v[:, 0, clo - base:chi - base].to(cv.dtype)
    alo, ahi, index = A.kv_heads_read(h, hc, lo, hi)
    keys = step["keys"][s_alloc]
    valid = keys[None, :] < (pos + 1).clamp(max=s_alloc)[:, None]
    if window and window > 0 and not ring:
        valid = valid & (keys[None, :] > (pos - window)[:, None])
    rk, rv = ck[:, :, alo - clo:ahi - clo], cv[:, :, alo - clo:ahi - clo]
    sk = None if ksc is None else ksc[:, :, alo:ahi]
    sv = None if vsc is None else vsc[:, :, alo:ahi]
    rk, rv = A.expand_heads(rk, index), A.expand_heads(rv, index)
    if index is not None and sk is not None:
        sk, sv = A.expand_heads(sk, index), A.expand_heads(sv, index)
    out = A.decode_attend_gqa(q, rk, rv, valid, k_scale=sk, v_scale=sv)
    wo = C.span(axis, [p["wo"]], 0, lo * d, hi * d)[0]
    return C.reduce_from(axis, A.out_project({"wo": wo}, out))


def _project_whole(axis, x, p, names, d) -> list:
    """``x @ p[n]`` whole for each leaf ``n`` of ``names`` (cut on dim 1
    over ``axis``): each rank projects onto its column block, and the
    outputs, far smaller than the weights, are gathered in one collective;
    each (B, 1, n, d)."""
    outs = [torch.matmul(x, p[n].to(x.dtype)) for n in names]
    outs = C.gather_leaves(axis, outs, [2] * len(outs), partial=False)
    return [o.reshape(x.shape[0], x.shape[1], -1, d) for o in outs]


def _attend_split(axis, cut, q, rk, rv, valid, sk=None, sv=None):
    """Every query head of ``q`` (B, 1, H, D) against the rank's part of a
    K/V cache cut over ``axis`` (GQA-grouped as
    ``attention.decode_attend_gqa``, float32 logits and softmax):

      * ``"seq"``: rk / rv (B, S/m, KV, D), the rank's positions of every
        head, ``valid`` (B, S/m) their mask.  The softmax is combined
        across ranks: the global max of each (row, head) (one max over
        ``axis``), then one sum over ``axis`` of the unnormalised P·V and
        of its denominator.  A rank whose positions are all masked adds
        zeros (its logits sit ~1e30 below the global max).
      * ``"dim"``: rk / rv (B, S, KV, D/m), the rank's channels of every
        head.  The logits are partial over the channels and summed over
        ``axis``; the softmax is whole on every rank; P·V over the rank's
        channels, gathered over ``axis``.

    int8 scales ``sk`` / ``sv`` (B, S', KV, 1) are those of the rank's
    positions (every position under ``"dim"``).  Returns (B, 1, H, D) in
    q's dtype, the same on every rank."""
    b, _, h, d = q.shape
    kv = rk.shape[2]
    qg = q.reshape(b, kv, h // kv, d).float()
    if cut == "dim":
        w = rk.shape[3]
        qg = qg[..., int(axis.rank) * w:(int(axis.rank) + 1) * w]
    logits = torch.einsum("bkgd,bskd->bkgs", qg, rk.float()) * (d ** -0.5)
    if cut == "dim":
        logits = C.reduce_from(axis, logits)
    if sk is not None:                       # (B, S, KV, 1) -> (B, KV, 1, S)
        logits = logits * sk[..., 0].transpose(1, 2)[:, :, None, :].float()
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.full((), -1e30, device=q.device))
    if cut == "dim":
        pr = torch.softmax(logits, dim=-1)
    else:
        top = C.all_max(axis, logits.amax(dim=-1, keepdim=True))
        pr = torch.exp(logits - top)
        den = pr.sum(dim=-1)
    if sv is not None:
        pr = pr * sv[..., 0].transpose(1, 2)[:, :, None, :].float()
    out = torch.einsum("bkgs,bskd->bkgd", pr, rv.float())
    if cut == "dim":
        out = C.gather(axis, out.contiguous(), 3, partial=False)
    else:
        n = out[0].numel()
        both = C.reduce_from(axis, torch.cat([out.reshape(b, n),
                                              den.reshape(b, -1)], dim=1))
        out = both[:, :n].reshape(out.shape) / both[:, n:].reshape(
            den.shape)[..., None]
    return out.reshape(b, 1, h, d).to(q.dtype)


def _decode_attn_split(p, x, ck, cv, cfg, window, step, axis, cut, ring,
                       ksc, vsc):
    """:func:`_decode_attn` over a cache cut on its positions (``"seq"``:
    ck / cv (B, S/m, KV, D), the rank holding global slots ``[r S/m,
    (r + 1) S/m)``) or its channels (``"dim"``: (B, S, KV, D/m), channels
    ``[r D/m, (r + 1) D/m)``) over ``axis``, the reference's
    ``kv_shard_seq`` / ``kv_shard_dim``.  Every rank projects q, K and V
    of every head (:func:`_project_whole`) and applies qk-norm, rope and
    int8 quantization to whole heads (rope pairs channel i with
    i + D/2; the norm and the abs-max read all of D) before it takes its
    part.  Under ``"seq"`` the new K/V entry lands only on the rank whose
    positions hold the row's slot (decided on the device from ``pos``);
    under ``"dim"`` every rank writes its channels.  The int8 scales are
    whole on every rank and written by all.  The keys are masked by their
    global positions.  Then :func:`_attend_split`, and the rank's query
    heads ``[lo, hi)`` into the row-parallel out projection, summed."""
    h, kvh, d = _attn_dims(cfg)
    m, r = _axis_coords(axis)
    lo, hi = A.head_block(h, m, r)
    hc = ck.shape[2]                               # whole heads
    q, k, v = _project_whole(axis, x, p, ("wq", "wk", "wv"), d)
    if cfg.qk_norm and "q_norm" in p:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    q = rope_apply(q, step["cos"], step["sin"])
    k = rope_apply(k, step["cos"], step["sin"])
    if hc > kvh:
        k = k.repeat_interleave(hc // kvh, dim=2)
        v = v.repeat_interleave(hc // kvh, dim=2)
    rows, pos = step["rows"], step["pos"]
    sl = ck.shape[1]                               # the rank's slots
    slots = sl * m if cut == "seq" else sl
    slot = pos % slots if ring else pos
    if ksc is not None:
        k, k_s = A.quantize_kv(k)
        v, v_s = A.quantize_kv(v)
        ksc[rows, slot] = k_s[:, 0]
        vsc[rows, slot] = v_s[:, 0]
    keys = step["keys"][sl]
    if cut == "seq":
        local = slot - r * sl
        mine = ((local >= 0) & (local < sl))[:, None, None]
        at = local.clamp(0, sl - 1)
        ck[rows, at] = torch.where(mine, k[:, 0].to(ck.dtype), ck[rows, at])
        cv[rows, at] = torch.where(mine, v[:, 0].to(cv.dtype), cv[rows, at])
        keys = keys + r * sl                       # global positions
        sk = None if ksc is None else ksc[:, r * sl:(r + 1) * sl]
        sv = None if vsc is None else vsc[:, r * sl:(r + 1) * sl]
    else:
        w = ck.shape[3]
        ck[rows, slot] = k[:, 0, :, r * w:(r + 1) * w].to(ck.dtype)
        cv[rows, slot] = v[:, 0, :, r * w:(r + 1) * w].to(cv.dtype)
        sk, sv = ksc, vsc
    valid = keys[None, :] < (pos + 1).clamp(max=slots)[:, None]
    if window and window > 0 and not ring:
        valid = valid & (keys[None, :] > (pos - window)[:, None])
    out = _attend_split(axis, cut, q, ck, cv, valid, sk, sv)
    wo = C.span(axis, [p["wo"]], 0, lo * d, hi * d)[0]
    return C.reduce_from(axis, A.out_project({"wo": wo},
                                             out[:, :, lo:hi]))


def _decode_cross(xp, x, xk, xv, cfg, axis, cut):
    """The decoder's cross attention over its cross leaves (read, never
    written) under an all-valid mask; on a ``model`` axis the rank's query
    heads against the KV heads they read (of its block when ``cut`` is
    ``"heads"``, or of the whole leaves), the out projection summed.
    Leaves cut on their positions or channels (``"seq"`` / ``"dim"``) are
    read by every query head (:func:`_attend_split`)."""
    h, kvh, d = _attn_dims(cfg)
    m, r = _axis_coords(axis)
    lo, hi = A.head_block(h, m, r)
    valid = torch.ones((x.shape[0], xk.shape[1]), dtype=torch.bool,
                       device=x.device)
    if cut in ("seq", "dim"):
        q = _project_whole(axis, x, xp, ("wq",), d)[0]
        out = _attend_split(axis, cut, q, xk, xv, valid)[:, :, lo:hi]
    else:
        clo = r * xk.shape[2] if cut == "heads" else 0
        alo, ahi, index = A.kv_heads_read(h, kvh, lo, hi)
        wq = C.span(axis, [xp["wq"]], 1, lo * d, hi * d)[0]
        q = A.project_q({"wq": wq}, x, hi - lo, d)
        rk = A.expand_heads(xk[:, :, alo - clo:ahi - clo], index)
        rv = A.expand_heads(xv[:, :, alo - clo:ahi - clo], index)
        out = A.decode_attend_gqa(q, rk, rv, valid)
    wo = C.span(axis, [xp["wo"]], 0, lo * d, hi * d)[0]
    return C.reduce_from(axis, A.out_project({"wo": wo}, out))


def _whole(axis, p, cols, rows=()):
    """``p`` with its leaves ``cols`` (cut on dim 1) and ``rows`` (dim 0)
    gathered whole over ``axis``: a block run whole on every rank."""
    names = list(cols) + list(rows)
    full = C.gather_leaves(axis, [p[k] for k in names],
                           [1] * len(cols) + [0] * len(rows))
    return {**p, **dict(zip(names, full))}


def _decode_block(cfg: ModelConfig, blk: Block, i: int, p, root, x, lc,
                  step, ring_local: bool = False, axis=None, lsh=None):
    """One block of the decode step.  ``p`` holds the layer's parameters,
    ``root`` the whole tree (the hybrid's shared attention reads
    ``root["shared"]``); ``lc`` the layer's cache leaves, each written in
    place.  Under ``ring_local`` a windowed block whose leaf holds exactly
    ``window`` slots decodes as a ring, as the reference decides.  A cross
    block attends over its cross leaves, which it reads and never writes.
    On a ``model`` axis (``axis``; ``lsh`` the layer's cache shardings)
    each part runs on the rank's heads, ffn columns or experts, summed
    over ``axis``; a recurrent block whose state is whole over ``model``
    runs whole, its weights gathered."""
    pre = f"b{i}"
    if blk.kind in ("attn_mlp", "attn_moe"):
        h = rmsnorm(x, p[f"{pre}_ln1"]["scale"])
        cut = _kv_cut(lsh, f"{pre}_k")
        slots = lc[f"{pre}_k"].shape[1] * (_axis_coords(axis)[0]
                                           if cut == "seq" else 1)
        ring = bool(ring_local and blk.window and slots == blk.window)
        x = x + _decode_attn(p[f"{pre}_attn"], h, lc[f"{pre}_k"],
                             lc[f"{pre}_v"], cfg, blk.window, step, axis,
                             cut=cut, ring=ring,
                             ksc=lc.get(f"{pre}_ksc"),
                             vsc=lc.get(f"{pre}_vsc"))
        if blk.cross:
            x = x + _decode_cross(p[f"{pre}_xattn"],
                                  rmsnorm(x, p[f"{pre}_lnx"]["scale"]),
                                  lc[f"{pre}_xk"], lc[f"{pre}_xv"], cfg,
                                  axis, _kv_cut(lsh, f"{pre}_xk"))
        h = rmsnorm(x, p[f"{pre}_ln2"]["scale"])
        if blk.kind == "attn_moe":
            # capacity dispatch at s = 1: cap 8 a row, never drops
            return x + X.moe_dense(p[f"{pre}_moe"], h, top_k=cfg.top_k,
                                   experts=cfg.experts, act=cfg.act,
                                   experts_axis=axis)
        return x + C.reduce_from(axis, F.mlp_fused(
            p[f"{pre}_mlp"], h, gated=cfg.gated, act=cfg.act))
    if blk.kind == "rwkv":
        h = rmsnorm(x, p[f"{pre}_ln1"]["scale"])
        tp, tax = p[f"{pre}_tm"], axis
        if axis is not None and not _cut(lsh, f"{pre}_state", 1):
            tp, tax = _whole(axis, tp, ("wr", "wk", "wv", "wg"), ("wo",)), None
        tm, last, st = R.rwkv_time_mix(
            tp, h, heads=cfg.heads, head_dim=cfg.resolved_head_dim,
            last_x=lc[f"{pre}_last_tm"], state=lc[f"{pre}_state"], axis=tax)
        lc[f"{pre}_last_tm"].copy_(last)
        lc[f"{pre}_state"].copy_(st)
        x = x + tm
        h = rmsnorm(x, p[f"{pre}_ln2"]["scale"])
        cm, last_cm = R.rwkv_channel_mix(p[f"{pre}_cm"], h,
                                         last_x=lc[f"{pre}_last_cm"],
                                         axis=axis)
        lc[f"{pre}_last_cm"].copy_(last_cm)
        return x + cm
    if blk.kind in ("mamba", "shared_attn"):
        h = rmsnorm(x, p[f"{pre}_ln1"]["scale"])
        mp, conv, max_ = p[f"{pre}_mamba"], lc[f"{pre}_conv"], axis
        conv_cut = _cut(lsh, f"{pre}_conv", 2)
        if axis is not None and not _cut(lsh, f"{pre}_state", 1):
            mp, max_ = _whole(axis, mp, ("w_in", "conv"), ("w_out",)), None
            if conv_cut:
                conv = C.gather(axis, conv.contiguous(), 2, partial=False)
        mb, st, new_conv = M.mamba2_block(mp, h, _mamba_cfg(cfg), state=lc[
            f"{pre}_state"], conv_state=conv, axis=max_)
        if max_ is None and conv_cut:
            n = lc[f"{pre}_conv"].shape[-1]
            new_conv = new_conv[..., int(axis.rank) * n:
                                (int(axis.rank) + 1) * n]
        lc[f"{pre}_state"].copy_(st)
        lc[f"{pre}_conv"].copy_(new_conv)
        x = x + mb
        if blk.kind == "shared_attn":
            sp = root["shared"]
            h = rmsnorm(x, sp["ln1"]["scale"])
            x = x + _decode_attn(sp["attn"], h, lc[f"{pre}_k"],
                                 lc[f"{pre}_v"], cfg, 0, step, axis,
                                 cut=_kv_cut(lsh, f"{pre}_k"),
                                 ksc=lc.get(f"{pre}_ksc"),
                                 vsc=lc.get(f"{pre}_vsc"))
            h = rmsnorm(x, sp["ln2"]["scale"])
            x = x + C.reduce_from(axis, F.mlp_fused(
                sp["mlp"], h, gated=cfg.gated, act=cfg.act))
        return x
    raise ValueError(blk.kind)
