"""RWKV6 (Finch) block: time mix with data-dependent decay, and channel mix.

The port of the reference's ``layers/rwkv.py``.  The time mix's core is the
WKV6 recurrence (``kernels/wkv6.py``); its decay ``w_t = exp(-exp(w0 +
(x_t·A)·B))`` is the Finch low-rank LoRA on the decay.  Token shift uses
one learned mu per projection, as the reference.  The casts follow the
reference's: the projections run in the activation dtype; the decay is
computed in float32 and cast to the activation dtype before the
recurrence; ``u`` stays float32; the head-merge norm runs over the whole
embedding with ``ln_scale``.

On a ``model`` axis (``axis``: a rank mesh's sub-group, the reference's
GSPMD layout written out) the time mix runs the rank's ``heads / model``
heads (``attention.head_block``: when they do not divide, the first
ranks take one more and the projections are gathered and narrowed to
them): ``wr`` / ``wk`` / ``wv`` / ``wg`` column-parallel on the rank's
stored columns, ``wo`` row-parallel with a sum over ``model``, the
decay LoRA's hidden whole on every rank and the rank's columns of ``wB``
and ``w0``, its heads of ``u``, and the head-merge norm's sum of squares
summed over ``model``.  The channel mix runs the rank's ffn columns of
``wk`` and rows of ``wv``; the receptance, whole on every rank, scales
the rank's partial value before the one sum, so every branch's gradient
is a partial sum.  The leaves that are whole over ``model`` and the
input pass through ``copy_to``: their gradients are summed over it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F_

from ..core import collectives as C
from ..kernels.wkv6 import wkv6 as wkv6_kernel
from ..kernels.wkv6 import wkv6_chunked, wkv6_reference
from .attention import head_block
from .common import he_init, rmsnorm

LORA_RANK = 64


def init_rwkv_time_mix(gen, cfg, dtype=torch.float32):
    """cfg: dict(embed, heads, head_dim); the reference's keys and
    shapes."""
    e = cfg["embed"]
    h, d = cfg["heads"], cfg["head_dim"]
    if h * d != e:
        raise ValueError(f"heads x head_dim {h} x {d} != embed {e}")
    rank = min(LORA_RANK, e // 2)
    dev = gen.device
    return {
        "wr": he_init(gen, (e, e), e, dtype),
        "wk": he_init(gen, (e, e), e, dtype),
        "wv": he_init(gen, (e, e), e, dtype),
        "wg": he_init(gen, (e, e), e, dtype),
        "wo": he_init(gen, (e, e), e, dtype),
        "w0": torch.full((e,), -3.0, dtype=dtype, device=dev),  # decay bias
        "wA": he_init(gen, (e, rank), e, dtype),                # decay LoRA
        "wB": he_init(gen, (rank, e), rank, dtype),
        "u": he_init(gen, (h, d), d, dtype),                    # bonus
        "mu": torch.full((5,), 0.5, dtype=dtype, device=dev),   # shift mixes
        "ln_scale": torch.zeros((e,), dtype=dtype, device=dev),
    }


def rwkv_time_mix_specs() -> dict:
    """The dim names of :func:`init_rwkv_time_mix`'s leaves."""
    return {"wr": ("embed", "heads_flat"), "wk": ("embed", "heads_flat"),
            "wv": ("embed", "heads_flat"), "wg": ("embed", "heads_flat"),
            "wo": ("heads_flat", "embed"), "w0": ("embed",),
            "wA": ("embed", "lora"), "wB": ("lora", "embed"),
            "u": ("heads", "head_dim"), "mu": ("mix",),
            "ln_scale": ("embed",)}


def _token_shift(x):
    """x shifted one step later along time, zero at t = 0."""
    return F_.pad(x, (0, 0, 1, 0))[:, :-1]


def _shifted(x, last_x):
    if last_x is None:
        return _token_shift(x)
    return torch.cat([last_x[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _whole_over(axis, p, names):
    """``p`` with the leaves ``names`` through ``copy_to(axis)``."""
    return {**p, **{k: C.copy_to(axis, p[k]) for k in names}}


def _rank_heads(p, x, axis, heads, head_dim):
    """The time mix's view of the rank's heads (``head_block``: ``heads /
    model`` each, or one more on the first ranks when they do not
    divide): the input and the leaves that are whole over ``axis`` through
    ``copy_to`` (their gradients are partial sums), ``w0`` / ``wB`` /
    ``ln_scale`` cut to the rank's columns and ``u`` to its heads, the
    projections' columns and ``wo``'s rows the rank's (stored, or
    gathered and narrowed when the heads do not divide).  Returns ``(p,
    x, local heads)``."""
    hlo, hhi = head_block(heads, int(axis.world), int(axis.rank))
    lo, hi = hlo * head_dim, hhi * head_dim
    proj = C.span(axis, [p[k] for k in ("wr", "wk", "wv", "wg")], 1, lo, hi)
    wo = C.span(axis, [p["wo"]], 0, lo, hi)[0]
    p = _whole_over(axis, p, ("mu", "wA", "wB", "w0", "u", "ln_scale"))
    p.update(zip(("wr", "wk", "wv", "wg"), proj), wo=wo,
             wB=p["wB"][:, lo:hi], w0=p["w0"][lo:hi],
             ln_scale=p["ln_scale"][lo:hi], u=p["u"][hlo:hhi])
    return p, C.copy_to(axis, x), hhi - hlo


def rwkv_time_mix(p, x, *, heads, head_dim, use_kernel=False, last_x=None,
                  state=None, axis=None):
    """x: (B, T, E).  Three modes: decode (``state`` and ``last_x`` given:
    the sequential recurrence from ``state``; returns (y, new last_x, new
    state)), kernel (``use_kernel``: :func:`wkv6_kernel`) and chunked (the
    XLA engine's :func:`wkv6_chunked`).  On a live ``axis`` the rank's
    heads of the global ``heads``, summed over it (in decode ``state``
    holds the rank's heads)."""
    b, t, e = x.shape
    decode = state is not None
    if C.live(axis):
        p, x, heads = _rank_heads(p, x, axis, heads, head_dim)
    xs = _shifted(x, last_x if decode else None)
    mu = p["mu"].to(x.dtype)

    def mix(i):
        return x + mu[i] * (xs - x)

    def proj(i, name):
        return torch.matmul(mix(i), p[name].to(x.dtype))

    r, k, v, g = proj(0, "wr"), proj(1, "wk"), proj(2, "wv"), proj(3, "wg")
    lora = torch.matmul(torch.tanh(proj(4, "wA")), p["wB"].to(x.dtype))
    w = torch.exp(-torch.exp(p["w0"].float() + lora.float()))  # (0, 1)

    shape = (b, t, heads, head_dim)
    rh, kh, vh = r.reshape(shape), k.reshape(shape), v.reshape(shape)
    wh = w.reshape(shape).to(rh.dtype)
    if decode:
        y, new_state = wkv6_reference(rh, kh, vh, wh, p["u"],
                                      initial_state=state)
    elif use_kernel:
        y = wkv6_kernel(rh, kh, vh, wh, p["u"])
    else:
        y, _ = wkv6_chunked(rh, kh, vh, wh, p["u"])

    y = rmsnorm(y.reshape(b, t, heads * head_dim), p["ln_scale"],
                axis=axis, width=e)                     # head-merge norm
    y = y * F_.silu(g)
    out = C.reduce_from(axis, torch.matmul(y, p["wo"].to(x.dtype)))
    if decode:
        return out, x[:, -1], new_state
    return out


def init_rwkv_channel_mix(gen, cfg, dtype=torch.float32):
    """cfg: dict(embed, ffn)."""
    e, f = cfg["embed"], cfg["ffn"]
    return {
        "wk": he_init(gen, (e, f), e, dtype),
        "wv": he_init(gen, (f, e), f, dtype),
        "wr": he_init(gen, (e, e), e, dtype),
        "mu": torch.full((2,), 0.5, dtype=dtype, device=gen.device),
    }


def rwkv_channel_mix_specs() -> dict:
    """The dim names of :func:`init_rwkv_channel_mix`'s leaves."""
    return {"wk": ("embed", "ffn"), "wv": ("ffn", "embed"),
            "wr": ("embed", "embed2"), "mu": ("mix",)}


def rwkv_channel_mix(p, x, last_x=None, axis=None):
    """relu² key, sigmoid receptance gate.  With ``last_x`` (decode)
    returns (y, new last_x).  On a live ``axis`` the rank's ffn columns,
    gated by the whole receptance, summed over it."""
    if C.live(axis):
        p = _whole_over(axis, p, ("wr", "mu"))
        x = C.copy_to(axis, x)
    xs = _shifted(x, last_x)
    mu = p["mu"].to(x.dtype)
    xk = x + mu[0] * (xs - x)
    xr = x + mu[1] * (xs - x)
    k = torch.square(F_.relu(torch.matmul(xk, p["wk"].to(x.dtype))))
    kv = torch.matmul(k, p["wv"].to(x.dtype))
    out = C.reduce_from(axis, torch.sigmoid(torch.matmul(
        xr, p["wr"].to(x.dtype))) * kv)
    if last_x is not None:
        return out, x[:, -1]
    return out
