"""Shared layer utilities: norms, rotary embeddings, initializers.

The port of the reference's ``layers/common.py``.  The numerics follow it
cast for cast: :func:`rmsnorm` and :func:`rope` compute in float32 and cast
back to the input's dtype.  Initializers draw from a ``torch.Generator``
(the reference's ``jax.random`` keys give other numbers from the same seed,
so the tests carry the reference's parameters across as numpy arrays) and
return parameters only: the reference's sharding specs have no counterpart
on one device.
"""
from __future__ import annotations

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name (``cfg.dtype``)."""
    return _DTYPES[name]


def rmsnorm(x, scale, eps=1e-6):
    """``x * rsqrt(mean(x²) + eps) * (1 + scale)`` in float32, cast back."""
    dt = x.dtype
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def rope_tables(positions, d, *, theta=10000.0):
    """The rotation's float32 ``(cos, sin)`` for ``positions`` (..., S),
    each (..., S, 1, d/2): computed once, they rotate every head of q and
    k (and, in decode, every layer's)."""
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def rope_apply(x, cos, sin):
    """Rotate the half-split pairs ``(x[:d/2], x[d/2:])`` of x (..., S, H, D)
    by the tables of :func:`rope_tables`; cast back to x's dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x, positions, *, theta=10000.0):
    """x: (..., S, H, D) with positions (..., S) — the reference's ``rope``."""
    return rope_apply(x, *rope_tables(positions, x.shape[-1], theta=theta))


def he_init(gen, shape, fan_in=None, dtype=torch.float32):
    """Normal draws from ``gen`` scaled by ``fan_in ** -0.5`` (default
    ``shape[0]``), made on the generator's device."""
    fan = fan_in if fan_in is not None else shape[0]
    return (torch.randn(shape, generator=gen, device=gen.device)
            * (fan ** -0.5)).to(dtype)


def stack_params(trees):
    """Stack a list of identical nested dicts of tensors along a new
    leading 'layers' axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_params([t[k] for t in trees]) for k in first}
    return torch.stack(trees, dim=0)


def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked nested dict (views): the inverse of
    :func:`stack_params`."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]
