"""Mamba2 block (zamba2's backbone): in-projection → short causal conv →
SSD scan → gate → out-projection.

The port of the reference's ``layers/mamba.py``.  The SSD core has the
planner's two candidates, the chunked form (``ssd_chunked_xla``) and the
kernel (``ssd_pallas``, ``kernels/csrc/ssd.cu`` on the card), and the
sequential recurrence for decode.  The decay ``a = exp(-softplus(dt +
dt_bias)·exp(a_log))`` is computed in float32 and cast to the activation
dtype, as the reference's.  B and C are one (B, T, N) matrix each, shared
by every head: the scan gets them expanded over heads as a view (head
stride 0), never copied per head.

On a ``model`` axis (``axis``: a rank mesh's sub-group) the block runs
the rank's ``heads / model`` heads, which are contiguous.  ``w_in`` and
``conv`` are stored as GSPMD's contiguous blocks of their concatenated
widths (a rank's block of ``w_in`` may straddle ``z`` and ``x``), so the
rank all-gathers both stored blocks over ``model`` (one collective) and
takes the columns it computes: its heads' ``z`` / ``x`` / ``dt`` and all
of ``B`` and ``C`` (one group: every head reads them).  The gather's
gradients are partial: each rank's are summed and it keeps its block.
Gathering the weights moves a block's parameters whatever the token
count; gathering the projection's output instead would move
``tokens x d_in`` activations, more past a few thousand tokens a rank.
``w_out`` is row-parallel on the rank's heads, summed over ``model``;
``a_log`` / ``dt_bias`` / ``d_skip`` and the input pass through
``copy_to``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F_

from ..core import collectives as C
from ..kernels.ssd import ssd as ssd_kernel
from ..kernels.ssd import ssd_chunked, ssd_reference
from .common import he_init

CONV_K = 4


def _dims(cfg):
    """(embed, state N, inner width, head size P, heads) of a block cfg."""
    e, n = cfg["embed"], cfg["state"]
    ei = cfg.get("expand", 2) * e
    pdim = cfg.get("head_dim", 64)
    return e, n, ei, pdim, ei // pdim


def init_mamba2(gen, cfg, dtype=torch.float32):
    """cfg: dict(embed, state, expand, head_dim) — the reference's keys and
    shapes."""
    e, n, ei, _, h = _dims(cfg)
    d_in = 2 * ei + 2 * n + h          # z, x, B, C, dt
    dev = gen.device
    return {
        "w_in": he_init(gen, (e, d_in), e, dtype),
        "conv": he_init(gen, (CONV_K, ei + 2 * n), CONV_K, dtype),
        "a_log": torch.zeros((h,), dtype=dtype, device=dev),
        "dt_bias": torch.full((h,), -2.0, dtype=dtype, device=dev),
        "d_skip": torch.ones((h,), dtype=dtype, device=dev),
        "w_out": he_init(gen, (ei, e), ei, dtype),
    }


def mamba2_specs() -> dict:
    """The dim names of :func:`init_mamba2`'s leaves."""
    return {"w_in": ("embed", "inner_cat"), "conv": ("conv_k", "inner_cat2"),
            "a_log": ("heads",), "dt_bias": ("heads",),
            "d_skip": ("heads",), "w_out": ("inner", "embed")}


def _split(cfg, zxbcdt):
    """(z, x, B, C, dt) of the in-projection's output."""
    _, n, ei, _, h = _dims(cfg)
    return torch.split(zxbcdt, [ei, ei, n, n, h], dim=-1)


def _causal_conv(x, w, conv_state=None):
    """Depthwise causal conv over time, then silu.  x: (B, T, C), w: (K, C);
    in decode ``conv_state`` (B, K-1, C) holds the previous inputs and the
    new one is returned beside the output."""
    k = w.shape[0]
    if conv_state is not None:
        xx = torch.cat([conv_state.to(x.dtype), x], dim=1)
        new_state = xx[:, -(k - 1):]
    else:
        xx = F_.pad(x, (0, 0, k - 1, 0))
        new_state = None
    t = x.shape[1]
    out = xx[:, 0:t] * w[0]
    for i in range(1, k):
        out = out + xx[:, i:i + t] * w[i]
    return F_.silu(out), new_state


def _rank_heads(p, x, cfg, axis):
    """The rank's part of the in-projection and conv on ``axis``:
    ``(p, x, z, xin, bmat, cmat, dt, conv weights, local heads)`` with the
    per-head leaves cut to the rank's heads."""
    _, n, ei, pdim, h = _dims(cfg)
    r = int(axis.rank)
    hl = h // int(axis.world)
    lo, hi = r * hl * pdim, (r + 1) * hl * pdim
    heads = slice(r * hl, (r + 1) * hl)
    w_in, conv = C.gather_leaves(axis, [p["w_in"], p["conv"]], [1, 1])
    w_in = torch.cat([w_in[:, lo:hi], w_in[:, ei + lo:ei + hi],
                      w_in[:, 2 * ei:2 * ei + 2 * n],
                      w_in[:, 2 * ei + 2 * n:][:, heads]], dim=1)
    conv = torch.cat([conv[:, lo:hi], conv[:, ei:]], dim=1).to(x.dtype)
    x = C.copy_to(axis, x)
    z, xin, bmat, cmat, dt = torch.split(
        torch.matmul(x, w_in.to(x.dtype)), [hi - lo, hi - lo, n, n, hl],
        dim=-1)
    p = {**p, **{k: C.copy_to(axis, p[k])[heads]
                 for k in ("a_log", "dt_bias", "d_skip")}}
    return p, x, z, xin, bmat, cmat, dt, conv, hl


def _decode_heads(p, x, cfg, conv_state, axis):
    """The rank's part of a decode step's in-projection and conv on
    ``axis``: ``conv_state`` (B, K-1, C) holds the conv inputs of all C
    channels or (B, K-1, C/m) the rank's contiguous block of them (the
    cache's layout, which does not follow the heads).  The conv is
    depthwise, so the rank computes the new conv inputs of every channel
    from the gathered ``w_in`` (a token a row), gathers a cut conv state
    over ``axis``, convolves every channel, keeps the ones its heads read
    (their ``x``, all of ``B`` and ``C``) and its block of the new conv
    state.  Returns ``(p, z, xin, bmat, cmat, dt, new conv state, local
    heads)`` with the per-head leaves cut to the rank's heads."""
    _, n, ei, pdim, h = _dims(cfg)
    r = int(axis.rank)
    hl = h // int(axis.world)
    lo, hi = r * hl * pdim, (r + 1) * hl * pdim
    heads = slice(r * hl, (r + 1) * hl)
    w_in, conv = C.gather_leaves(axis, [p["w_in"], p["conv"]], [1, 1])
    w_in = w_in.to(x.dtype)
    z = torch.matmul(x, w_in[:, lo:hi])
    dt = torch.matmul(x, w_in[:, 2 * ei + 2 * n:][:, heads])
    xbc = torch.matmul(x, w_in[:, ei:2 * ei + 2 * n])        # every channel
    cb = conv_state.shape[-1]
    whole = cb == ei + 2 * n
    old = conv_state if whole else C.gather(axis, conv_state.contiguous(),
                                            2, partial=False)
    conv_out, new_conv = _causal_conv(xbc, conv.to(x.dtype), old)
    xin, bmat, cmat = torch.split(conv_out, [ei, n, n], dim=-1)
    if not whole:
        new_conv = new_conv[..., r * cb:(r + 1) * cb]
    p = {**p, **{k: p[k][heads] for k in ("a_log", "dt_bias", "d_skip")}}
    return p, z, xin[..., lo:hi], bmat, cmat, dt, new_conv, hl


def mamba2_block(p, x, cfg, *, use_kernel=False, state=None,
                 conv_state=None, axis=None):
    """x: (B, T, E).  Three modes: decode (``state`` given: the sequential
    recurrence from it; returns (y, new state, new conv state)), kernel
    (``use_kernel``: :func:`ssd_kernel`) and chunked (the XLA engine's
    :func:`ssd_chunked`).  On a live ``axis`` the rank's heads, summed
    over it (decode: :func:`_decode_heads`)."""
    b, t, _ = x.shape
    _, n, _, pdim, h = _dims(cfg)
    decode = state is not None

    if decode and C.live(axis):
        p, z, xin, bmat, cmat, dt, new_conv, h = _decode_heads(
            p, x, cfg, conv_state, axis)
    else:
        if C.live(axis):
            p, x, z, xin, bmat, cmat, dt, conv, h = _rank_heads(
                p, x, cfg, axis)
        else:
            zxbcdt = torch.matmul(x, p["w_in"].to(x.dtype))
            z, xin, bmat, cmat, dt = _split(cfg, zxbcdt)
            conv = p["conv"].to(x.dtype)
        conv_in = torch.cat([xin, bmat, cmat], dim=-1)
        conv_out, new_conv = _causal_conv(conv_in, conv, conv_state)
        xin, bmat, cmat = torch.split(conv_out, [h * pdim, n, n], dim=-1)
    ei = h * pdim

    dt = F_.softplus(dt.float() + p["dt_bias"].float())          # (B, T, H)
    a = torch.exp(-dt * torch.exp(p["a_log"].float()))           # (B, T, H)

    xh = xin.reshape(b, t, h, pdim)
    xs = xh * dt[..., None].to(xh.dtype)                          # dt-scaled
    bh = bmat[:, :, None, :].expand(b, t, h, n)                   # stride 0
    chh = cmat[:, :, None, :].expand(b, t, h, n)
    a = a.to(xs.dtype)
    if decode:
        y, new_state = ssd_reference(xs, a, bh, chh, initial_state=state)
    elif use_kernel:
        y = ssd_kernel(xs, a, bh, chh)
    else:
        y, _ = ssd_chunked(xs, a, bh, chh)

    y = y + xh * p["d_skip"].to(xh.dtype)[None, None, :, None]
    y = y.reshape(b, t, ei) * F_.silu(z)
    out = C.reduce_from(axis, torch.matmul(y, p["w_out"].to(x.dtype)))
    if decode:
        return out, new_state, new_conv
    return out
