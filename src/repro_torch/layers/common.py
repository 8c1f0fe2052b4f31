"""Shared layer utilities: norms, rotary embeddings, initializers.

The port of the reference's ``layers/common.py``.  The numerics follow it
cast for cast: :func:`rmsnorm` and :func:`rope` compute in float32 and cast
back to the input's dtype.  Initializers draw from a ``torch.Generator``
(the reference's ``jax.random`` keys give other numbers from the same seed,
so the tests carry the reference's parameters across as numpy arrays) and
return parameters only; each layer's ``*_specs`` function gives the
reference's specs of the same leaves (tuples of semantic dim names, which
``core.executor.ShardingRules`` maps to mesh axes) without making a
tensor.  Given :data:`META` for a generator they make meta tensors: the
shapes and dtypes of a tree, nothing drawn and nothing allocated.
"""
from __future__ import annotations

import torch

from ..core import collectives as C

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name (``cfg.dtype``)."""
    return _DTYPES[name]


def rmsnorm(x, scale, eps=1e-6, *, axis=None, width=None):
    """``x * rsqrt(mean(x²) + eps) * (1 + scale)`` in float32, cast back.
    On a live ``axis`` (a rank mesh's sub-group) ``x`` holds the rank's
    block of ``width`` columns: the sum of squares is summed over the
    axis, forward and backward."""
    dt = x.dtype
    x32 = x.float()
    if C.live(axis):
        var = C.copy_to(axis, C.reduce_from(axis, (x32 * x32).sum(
            dim=-1, keepdim=True))) / width
    else:
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


class _MetaGen:
    """Stands for a generator where only shapes are wanted."""

    device = torch.device("meta")


META = _MetaGen()


def he_init(gen, shape, fan_in=None, dtype=torch.float32):
    """Normal draws from ``gen`` scaled by ``fan_in ** -0.5`` (default
    ``shape[0]``), made on the generator's device (an empty meta tensor
    for :data:`META`)."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    fan = fan_in if fan_in is not None else shape[0]
    return (torch.randn(shape, generator=gen, device=gen.device)
            * (fan ** -0.5)).to(dtype)


def stack_layers(make, count: int):
    """Stack ``count`` identical nested dicts of tensors, made one at a
    time by ``make()``, along a new leading 'layers' axis.  Each layer is
    copied into the stacked leaves as soon as it is made, so the peak is
    the stack plus one layer (a ``torch.stack`` over a list of layers holds
    every layer twice)."""
    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        return t.new_empty((count,) + tuple(t.shape))

    def put(dst, src, i):
        if isinstance(src, dict):
            for k, v in src.items():
                put(dst[k], v, i)
        else:
            dst[i].copy_(src)

    tree = make()
    out = alloc(tree)
    for i in range(count):
        if i:
            tree = make()
        put(out, tree, i)
        del tree
    return out


def stack_specs(spec):
    """Specs of a stacked group: ``("layers",)`` before every leaf's."""
    if isinstance(spec, dict):
        return {k: stack_specs(v) for k, v in spec.items()}
    return ("layers",) + spec


def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked nested dict (views): the inverse of
    :func:`stack_layers`."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]
