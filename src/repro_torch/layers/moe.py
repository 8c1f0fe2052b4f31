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
captured in a CUDA graph.  On one card ``constrain`` (the reference's
sharding constraints at the all-to-all boundary) only places values, so
it is not applied; on a rank mesh (``experts_axis``) it selects the pinned
exchange of :func:`_dispatch_on_mesh`.
"""
from __future__ import annotations

import torch

from ..core import collectives as C
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


def moe_specs() -> dict:
    """The dim names of :func:`init_moe`'s leaves."""
    return {"router": ("embed", "experts"),
            "wi": ("experts", "embed", "ffn"),
            "wg": ("experts", "embed", "ffn"),
            "wo": ("experts", "ffn", "embed")}


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


def _dispatch(x, dest, keep, tok_of, slots):
    """The (B, slots, D) expert buffer: kept slots are unique within a row,
    every dropped assignment lands (as zeros) in the overflow row, dropped
    after."""
    b, a = dest.shape
    src = x[:, tok_of] * keep[..., None].to(x.dtype)      # (B, A, D)
    buf = x.new_zeros((b, slots + 1, x.shape[-1]))
    buf.scatter_add_(1, dest[..., None].expand(b, a, x.shape[-1]), src)
    return buf[:, :-1]


def _experts(expert_in, p, act, use_gmm, dtype):
    """The experts' MLP on (E, C, D) rows, weights cast to ``dtype``."""
    wi, wg, wo = (p[k].to(dtype) for k in ("wi", "wg", "wo"))
    if use_gmm:
        up = grouped_matmul(expert_in, wi)
        gate = grouped_matmul(expert_in, wg)
        h = _ACTS[act](gate) * up
        return grouped_matmul(h, wo)
    up = torch.einsum("xce,xef->xcf", expert_in, wi)
    gate = torch.einsum("xce,xef->xcf", expert_in, wg)
    h = _ACTS[act](gate) * up
    return torch.einsum("xcf,xfe->xce", h, wo)


def _to_experts(buf, n, cap):
    """(B, n·C, D) -> (E=n, B·C, D): the reference's all-to-all boundary."""
    b, _, e = buf.shape
    return buf.reshape(b, n, cap, e).movedim(1, 0).reshape(n, b * cap, e)


def _from_experts(out, b, cap):
    """(n, B·C, D) -> (B, n·C, D): the return all-to-all."""
    n, _, e = out.shape
    return out.reshape(n, b, cap, e).movedim(1, 0).reshape(b, n * cap, e)


def _rows(out, dest, keep):
    """Each assignment's expert output row (zeros where dropped):
    (B, A, D)."""
    rows = torch.arange(out.shape[0], device=out.device)[:, None]
    gathered = out[rows, dest.clamp(max=out.shape[1] - 1)]
    return torch.where(keep[..., None], gathered,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def _weigh(gathered, flat_w, top_k):
    """Each token's k expert outputs weighted and summed in order (the
    reference's scatter-add of a token's k contributions): (B, S, D)."""
    b, a, e = gathered.shape
    contrib = (gathered * flat_w[..., None].to(gathered.dtype)) \
        .reshape(b, a // top_k, top_k, e)
    y = contrib[:, :, 0]
    for j in range(1, top_k):
        y = y + contrib[:, :, j]
    return y


def moe_capacity_dispatch(p, x, *, top_k, experts, capacity_factor=2.0,
                          act="silu", use_gmm=False, constrain=None,
                          experts_axis=None):
    """Row-grouped capacity dispatch: x (B, S, D) -> (B, S, D).  The
    expert matmuls take the weights cast to x's dtype; with ``use_gmm``
    they are the grouped-matmul kernel (:func:`grouped_matmul`), else
    einsums.  ``h = act(gate) * up``, the routing-weight scaling and the
    combine run in x's dtype, as the reference's.  On an ``experts_axis``
    of more than one rank the experts are cut over it:
    :func:`_dispatch_on_mesh`."""
    if experts_axis is not None and int(experts_axis.world) > 1:
        return _dispatch_on_mesh(p, x, top_k=top_k, experts=experts,
                                 capacity_factor=capacity_factor, act=act,
                                 use_gmm=use_gmm, pinned=constrain is not None,
                                 axis=experts_axis)
    b, s, e = x.shape
    cap = max(8, int(s * top_k * capacity_factor / experts))
    weights, idx = _route(p, x, top_k)                    # (B, S, K)
    flat_w = weights.reshape(b, s * top_k)                # (B, A)
    flat_i = idx.reshape(b, s * top_k)
    tok_of = torch.arange(s * top_k, device=x.device) // top_k
    keep, dest = capacity_slots(flat_i, experts, cap)
    buf = _dispatch(x, dest, keep, tok_of, experts * cap)
    out = _experts(_to_experts(buf, experts, cap), p, act, use_gmm, x.dtype)
    return _weigh(_rows(_from_experts(out, b, cap), dest, keep), flat_w,
                  top_k)


def _dispatch_on_mesh(p, x, *, top_k, experts, capacity_factor, act,
                      use_gmm, pinned, axis):
    """The capacity dispatch with the experts cut over ``axis`` (``model``):
    this rank holds experts ``[r·E/m, (r+1)·E/m)`` (``p``'s ``wi`` /
    ``wg`` / ``wo`` blocks) and every token of its rows.  The router is
    gathered whole, so routing, ranks and capacity are the unsharded
    ones, and every rank weighs and sums each token's k expert outputs
    itself, in the unsharded order.

    Unpinned: the rank dispatches to its experts only and runs them; each
    assignment's output row is nonzero on the one rank holding its expert,
    so a sum over ``axis`` of the rows gives every rank each assignment's
    row exactly.  Pinned (``pin_moe``, the reference's four constraint
    points): the buffer is built whole (``batch``, whole over ``model``),
    the rank's experts' rows taken from it (``experts``, ``batch``), their
    outputs (``experts``, ``batch``) gathered over ``axis`` into the whole
    (``batch``) buffer.  Either gives the unsharded values bit for bit
    when the experts' inputs are the same."""
    m, r = int(axis.world), int(axis.rank)
    if experts % m:
        raise ValueError(f"{experts} experts do not divide over the model "
                         f"axis ({m} ranks)")
    xl = experts // m
    lo = r * xl
    b, s, e = x.shape
    cap = max(8, int(s * top_k * capacity_factor / experts))
    # the routing's consumer (the weighing) runs whole on every rank; each
    # rank dispatches a part of x
    router = C.gather(axis, p["router"], 1, partial=False)
    weights, idx = _route({"router": router}, x, top_k)
    xd = C.copy_to(axis, x)
    flat_w = weights.reshape(b, s * top_k)
    flat_i = idx.reshape(b, s * top_k)
    tok_of = torch.arange(s * top_k, device=x.device) // top_k
    keep, dest = capacity_slots(flat_i, experts, cap)
    if pinned:
        buf = _dispatch(xd, dest, keep, tok_of, experts * cap)
        expert_in = _to_experts(buf, experts, cap)[lo:lo + xl]
        out = _experts(expert_in, p, act, use_gmm, x.dtype)
        out = C.gather(axis, out, 0, partial=False)
        rows = _rows(_from_experts(out, b, cap), dest, keep)
        return _weigh(rows, flat_w, top_k)
    mine = keep & (flat_i >= lo) & (flat_i < lo + xl)
    dest = torch.where(mine, dest - lo * cap,
                       torch.full_like(dest, xl * cap))
    buf = _dispatch(xd, dest, mine, tok_of, xl * cap)
    out = _experts(_to_experts(buf, xl, cap), p, act, use_gmm, x.dtype)
    rows = C.reduce_from(axis, _rows(_from_experts(out, b, cap), dest, mine))
    return _weigh(rows, flat_w, top_k)


def moe_dense(p, x, *, top_k, experts, act="silu", capacity_factor=2.0,
              constrain=None, experts_axis=None):
    return moe_capacity_dispatch(p, x, top_k=top_k, experts=experts,
                                 capacity_factor=capacity_factor, act=act,
                                 constrain=constrain,
                                 experts_axis=experts_axis)


def moe_dropping(p, x, *, top_k, experts, act="silu", constrain=None,
                 experts_axis=None):
    return moe_capacity_dispatch(p, x, top_k=top_k, experts=experts,
                                 capacity_factor=1.0, act=act,
                                 constrain=constrain,
                                 experts_axis=experts_axis)


def moe_gmm(p, x, *, top_k, experts, act="silu", capacity_factor=2.0,
            constrain=None, experts_axis=None):
    return moe_capacity_dispatch(p, x, top_k=top_k, experts=experts,
                                 capacity_factor=capacity_factor, act=act,
                                 use_gmm=True, constrain=constrain,
                                 experts_axis=experts_axis)


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
