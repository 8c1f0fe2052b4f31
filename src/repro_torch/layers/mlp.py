"""MLP family: gated (SwiGLU/GeGLU) and plain FFN, fused and unfused forms.

The port of the reference's ``layers/mlp.py``.  Every projection is a plain
``torch.matmul`` in the activation's dtype (the weights cast to it per
call, as the reference casts them), as the reference leaves them to XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F_

from .common import he_init

_ACTS = {
    "silu": F_.silu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F_.gelu(x, approximate="tanh"),
    "relu": F_.relu,
    "relu2": lambda x: torch.square(F_.relu(x)),
}


def init_mlp(gen, cfg, dtype=torch.float32):
    e, f = cfg["embed"], cfg["ffn"]
    p = {"wi": he_init(gen, (e, f), e, dtype),
         "wo": he_init(gen, (f, e), f, dtype)}
    if cfg.get("gated", True):
        p["wg"] = he_init(gen, (e, f), e, dtype)
    return p


def mlp_specs(cfg) -> dict:
    """The dim names of :func:`init_mlp`'s leaves."""
    s = {"wi": ("embed", "ffn"), "wo": ("ffn", "embed")}
    if cfg.get("gated", True):
        s["wg"] = ("embed", "ffn")
    return s


def ffn_up(p, x):
    return torch.matmul(x, p["wi"].to(x.dtype))


def ffn_gate(p, x):
    return torch.matmul(x, p["wg"].to(x.dtype))


def ffn_glu(up, gate, act="silu"):
    return _ACTS[act](gate) * up


def ffn_act(up, act="gelu"):
    return _ACTS[act](up)


def ffn_down(p, h):
    return torch.matmul(h, p["wo"].to(h.dtype))


def mlp_fused(p, x, *, gated=True, act=None):
    """The fused block: up (and gate), activation, down."""
    up = ffn_up(p, x)
    if gated and "wg" in p:
        h = ffn_glu(up, ffn_gate(p, x), act or "silu")
    else:
        h = ffn_act(up, act or "gelu")
    return ffn_down(p, h)
