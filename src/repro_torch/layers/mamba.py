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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F_

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


def mamba2_block(p, x, cfg, *, use_kernel=False, state=None,
                 conv_state=None):
    """x: (B, T, E).  Three modes: decode (``state`` given: the sequential
    recurrence from it; returns (y, new state, new conv state)), kernel
    (``use_kernel``: :func:`ssd_kernel`) and chunked (the XLA engine's
    :func:`ssd_chunked`)."""
    b, t, _ = x.shape
    _, n, ei, pdim, h = _dims(cfg)
    decode = state is not None

    zxbcdt = torch.matmul(x, p["w_in"].to(x.dtype))
    z, xin, bmat, cmat, dt = _split(cfg, zxbcdt)
    conv_in = torch.cat([xin, bmat, cmat], dim=-1)
    conv_out, new_conv = _causal_conv(conv_in, p["conv"].to(x.dtype),
                                      conv_state)
    xin, bmat, cmat = torch.split(conv_out, [ei, n, n], dim=-1)

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
    out = torch.matmul(y, p["w_out"].to(x.dtype))
    if decode:
        return out, new_state, new_conv
    return out
