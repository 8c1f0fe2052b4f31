"""Mixture-of-Experts family — the planner's three dispatch candidates:

  * ``moe_dense_onehot`` — capacity-2.0 scatter dispatch (≈ no drops at
    typical balance);
  * ``moe_dropping``     — capacity-1.0 dispatch (overflow tokens fall back
    to the residual path); half the expert flops;
  * ``moe_gmm``          — capacity dispatch + the grouped-matmul kernel.

The port of the reference's ``layers/moe.py``.  Dispatch is scatter-based:
each (token, k) assignment gets a rank within its expert via a one-hot
cumsum, then tokens scatter into the (E, C, D) expert buffer and gather
back after the expert MLP.  Capacity is per batch row: ``cap = max(8,
int(S·k·cf / E))`` slots an expert in each row, and a row's assignments
rank in token order, so a right-padded row's pad tokens never take a slot
from its prompt.  Every op runs on the device without a host sync (no
``nonzero``, ``.item()`` or boolean indexing; the one-hot is a comparison
with ``arange``), so the decode step, which calls :func:`moe_dense`, can be
captured in a CUDA graph.  ``constrain`` (the reference's sharding
constraints at the all-to-all boundary) is accepted and not applied: one
card has no mesh.
"""
from __future__ import annotations

import torch

from ..kernels.moe_gmm import grouped_matmul
from .common import he_init
from .mlp import _ACTS


def init_moe(gen, cfg, dtype=torch.float32):
    e, f, x = cfg["embed"], cfg["ffn"], cfg["experts"]
    return {
        "router": he_init(gen, (e, x), e, dtype),
        "wi": he_init(gen, (x, e, f), e, dtype),
        "wg": he_init(gen, (x, e, f), e, dtype),
        "wo": he_init(gen, (x, f, e), f, dtype),
    }


def _route(p, x, top_k):
    """float32 router logits, the top-k experts of each token and the
    softmax over their k logits.  ``lax.top_k`` puts tied logits lowest
    expert first; ``torch.topk`` promises no order, a stable descending
    sort does."""
    logits = torch.einsum("bse,ex->bsx", x.float(), p["router"].float())
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return torch.softmax(vals[..., :top_k], dim=-1), idx[..., :top_k]


def capacity_slots(flat_i, experts: int, cap: int):
    """Each assignment's slot in its row's expert buffer.  flat_i (B, A):
    the expert of each (token, k) assignment in token order.  Returns
    ``keep`` (B, A), the assignment ranks below ``cap`` within its expert,
    and ``dest`` (B, A), its slot ``expert * cap + rank`` or the overflow
    row ``experts * cap`` when dropped."""
    onehot = (flat_i[..., None] == torch.arange(
        experts, device=flat_i.device)).to(torch.int32)      # (B, A, E)
    rank = (torch.cumsum(onehot, dim=1) * onehot).sum(-1) - 1
    keep = rank < cap
    dest = torch.where(keep, flat_i * cap + rank,
                       torch.full_like(flat_i, experts * cap))
    return keep, dest


def moe_capacity_dispatch(p, x, *, top_k, experts, capacity_factor=2.0,
                          act="silu", use_gmm=False, constrain=None):
    """Row-grouped capacity dispatch: x (B, S, D) -> (B, S, D).  The
    expert matmuls take the weights cast to x's dtype; with ``use_gmm``
    they are the grouped-matmul kernel (:func:`grouped_matmul`), else
    einsums.  ``h = act(gate) * up``, the routing-weight scaling and the
    combine run in x's dtype, as the reference's."""
    b, s, e = x.shape
    cap = max(8, int(s * top_k * capacity_factor / experts))
    weights, idx = _route(p, x, top_k)                    # (B, S, K)
    flat_w = weights.reshape(b, s * top_k)                # (B, A)
    flat_i = idx.reshape(b, s * top_k)
    tok_of = torch.arange(s * top_k, device=x.device) // top_k
    keep, dest = capacity_slots(flat_i, experts, cap)

    # dispatch: kept slots are unique within a row, every dropped
    # assignment lands (as zeros) in the overflow row, dropped after
    src = x[:, tok_of] * keep[..., None].to(x.dtype)      # (B, A, D)
    buf = x.new_zeros((b, experts * cap + 1, e))
    buf.scatter_add_(1, dest[..., None].expand(b, s * top_k, e), src)
    # (B, E, C, D) -> (E, B*C, D): the reference's all-to-all boundary
    expert_in = buf[:, :-1].reshape(b, experts, cap, e).movedim(1, 0) \
        .reshape(experts, b * cap, e)

    wi, wg, wo = (p[k].to(x.dtype) for k in ("wi", "wg", "wo"))
    if use_gmm:
        up = grouped_matmul(expert_in, wi)
        gate = grouped_matmul(expert_in, wg)
        h = _ACTS[act](gate) * up
        out = grouped_matmul(h, wo)
    else:
        up = torch.einsum("xce,xef->xcf", expert_in, wi)
        gate = torch.einsum("xce,xef->xcf", expert_in, wg)
        h = _ACTS[act](gate) * up
        out = torch.einsum("xcf,xfe->xce", h, wo)

    # (E, B*C, D) -> (B, E*C, D): the return all-to-all
    out = out.reshape(experts, b, cap, e).movedim(1, 0) \
        .reshape(b, experts * cap, e)
    rows = torch.arange(b, device=x.device)[:, None]
    gathered = out[rows, dest.clamp(max=experts * cap - 1)]  # (B, A, D)
    gathered = torch.where(keep[..., None], gathered,
                           torch.zeros((), dtype=x.dtype, device=x.device))
    contrib = (gathered * flat_w[..., None].to(x.dtype)) \
        .reshape(b, s, top_k, e)
    # the reference's scatter-add of a token's k contributions, in order
    y = contrib[:, :, 0]
    for j in range(1, top_k):
        y = y + contrib[:, :, j]
    return y


def moe_dense(p, x, *, top_k, experts, act="silu", capacity_factor=2.0,
              constrain=None):
    return moe_capacity_dispatch(p, x, top_k=top_k, experts=experts,
                                 capacity_factor=capacity_factor, act=act,
                                 constrain=constrain)


def moe_dropping(p, x, *, top_k, experts, act="silu", constrain=None):
    return moe_capacity_dispatch(p, x, top_k=top_k, experts=experts,
                                 capacity_factor=1.0, act=act,
                                 constrain=constrain)


def moe_gmm(p, x, *, top_k, experts, act="silu", capacity_factor=2.0,
            constrain=None):
    return moe_capacity_dispatch(p, x, top_k=top_k, experts=experts,
                                 capacity_factor=capacity_factor, act=act,
                                 use_gmm=True, constrain=constrain)


def moe_reference_dense(p, x, *, top_k, experts, act="silu"):
    """No-capacity oracle: every token reaches its experts (tests only)."""
    weights, idx = _route(p, x, top_k)
    wi, wg, wo = (p[k].to(x.dtype) for k in ("wi", "wg", "wo"))
    up = torch.einsum("bse,xef->bsxf", x, wi)
    gate = torch.einsum("bse,xef->bsxf", x, wg)
    h = _ACTS[act](gate) * up
    out = torch.einsum("bsxf,xfe->bsxe", h, wo)
    experts_ids = torch.arange(experts, device=x.device)
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for j in range(top_k):
        oh = (idx[..., j, None] == experts_ids).to(x.dtype)
        sel = torch.einsum("bsxe,bsx->bse", out, oh)
        y = y + sel.float() * weights[..., j:j + 1]
    return y.to(x.dtype)
