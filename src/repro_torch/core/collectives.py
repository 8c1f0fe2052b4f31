"""The collectives a layer calls on a (data, model) rank mesh, as autograd
functions.

The reference's mesh is GSPMD: a layout hint (``with_sharding_constraint``)
and XLA inserts the collectives, forward and backward.  The port has no
partitioner, so the layers call these themselves.  Each takes an *axis*:
one of a rank mesh's sub-groups (``RankMesh.axis("data")`` /
``axis("model")``, a :class:`~repro_torch.launch.mesh.DataMesh` over the
ranks that differ only along that axis), whose ``all_reduce`` /
``all_gather`` stage a card tensor through pinned host memory and count
calls and bytes.  On an axis of one rank every function is the identity
and calls nothing.

Which backward a forward collective takes depends on what consumes its
output on the axis's ranks:

  * :func:`copy_to` (identity; backward: all-reduce) enters a region
    whose ranks each compute a *part* of what follows — a column-parallel
    projection on local heads, a replicated parameter used on local rows —
    so each rank's gradient is a partial sum;
  * :func:`reduce_from` (all-reduce; backward: identity) leaves such a
    region: every rank then holds the whole value and computes the same
    thing from it, so the gradient that comes back is already whole;
  * :func:`gather` concatenates every rank's block along a dim.  With
    ``partial=True`` its consumer is partial (FSDP: a gathered weight
    applied to the rank's own rows), so the backward sums the ranks'
    gradients and keeps the rank's block (a reduce-scatter: gloo has none,
    so an all-reduce then a slice); with ``partial=False`` its consumer is
    replicated and the backward only slices.

:func:`gather_leaves` gathers several tensors in one collective per dtype
(a layer's FSDP shards), with the same two backwards.  :func:`span` is a
range of a leaf cut over an axis: the rank's own block as it is when the
range is that block, else the gathered leaf's range (the heads a rank
computes when they do not divide over ``model``).
"""
from __future__ import annotations

import torch


def live(axis) -> bool:
    """Whether ``axis`` has more than one rank (its collectives move
    data)."""
    return axis is not None and int(axis.world) > 1


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, x):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.axis.all_reduce(g.contiguous())


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, x):
        return axis.all_reduce(x.contiguous())

    @staticmethod
    def backward(ctx, g):
        return None, g


def copy_to(axis, x):
    """``x`` unchanged; the backward sums the gradient over ``axis``."""
    return _CopyTo.apply(axis, x) if live(axis) else x


def reduce_from(axis, x):
    """The sum of ``x`` over ``axis``; the backward passes the (whole)
    gradient through."""
    return _ReduceFrom.apply(axis, x) if live(axis) else x


def all_max(axis, x):
    """The elementwise max of ``x`` over ``axis`` (no gradient)."""
    return axis.all_reduce(x.contiguous(), op="max") if live(axis) else x


def _pack(xs, dims):
    """Each tensor with its gather dim moved to the front, flattened and
    concatenated: the one buffer a collective moves."""
    return torch.cat([x.movedim(d, 0).reshape(-1) for x, d in zip(xs, dims)])


class _GatherLeaves(torch.autograd.Function):
    """Every rank's block of each leaf, concatenated along the leaf's dim:
    one all-gather of the packed blocks."""

    @staticmethod
    def forward(ctx, axis, dims, partial, *xs):
        n = int(axis.world)
        flat = axis.all_gather(_pack(xs, dims)).view(n, -1)
        outs, off = [], 0
        for x, d in zip(xs, dims):
            moved = x.movedim(d, 0).shape
            numel = x.numel()
            full = flat[:, off:off + numel].reshape((n,) + tuple(moved))
            full = full.reshape((n * moved[0],) + tuple(moved[1:]))
            outs.append(full.movedim(0, d).contiguous())
            off += numel
        ctx.axis, ctx.dims, ctx.partial = axis, dims, partial
        ctx.shapes = [x.shape for x in xs]
        ctx.like = (xs[0].dtype, xs[0].device)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        axis, n, r = ctx.axis, int(ctx.axis.world), int(ctx.axis.rank)
        rows = []
        for g, shape, d in zip(grads, ctx.shapes, ctx.dims):
            full = list(shape)
            full[d] *= n
            if g is None:
                g = torch.zeros(full, dtype=ctx.like[0], device=ctx.like[1])
            rows.append(g.movedim(d, 0).reshape(n, -1))
        packed = torch.cat(rows, dim=1)
        if ctx.partial:
            packed = axis.all_reduce(packed.contiguous())
        mine = packed[r]
        out, off = [], 0
        for shape, d in zip(ctx.shapes, ctx.dims):
            moved = torch.Size(shape).numel()
            local = list(shape)
            local.insert(0, local.pop(d))
            out.append(mine[off:off + moved].reshape(local).movedim(0, d)
                       .contiguous())
            off += moved
        return (None, None, None, *out)


def gather_leaves(axis, xs, dims, *, partial=True) -> list:
    """Each tensor of ``xs`` gathered over ``axis`` along its dim of
    ``dims`` (every rank's block in rank order), one collective per dtype;
    ``partial`` as :func:`gather`'s."""
    xs = list(xs)
    if not live(axis) or not xs:
        return xs
    out = list(xs)
    by_dtype: dict = {}
    for i, x in enumerate(xs):
        by_dtype.setdefault(x.dtype, []).append(i)
    for idx in by_dtype.values():
        got = _GatherLeaves.apply(axis, tuple(dims[i] for i in idx),
                                  bool(partial), *(xs[i] for i in idx))
        for i, t in zip(idx, got):
            out[i] = t
    return out


def gather(axis, x, dim, *, partial=True):
    """Every rank's block of ``x`` concatenated along ``dim`` over
    ``axis``.  ``partial``: the consumer computes a part on each rank, so
    the backward sums the gradient over the axis before slicing; else the
    backward only slices."""
    return gather_leaves(axis, [x], [dim], partial=partial)[0]


def span(axis, xs, dim, lo, hi) -> list:
    """Elements ``[lo, hi)`` along ``dim`` of each global leaf whose block
    on this rank is ``xs[i]`` (cut contiguously over ``axis``): the blocks
    themselves when ``[lo, hi)`` is exactly the rank's block, else every
    leaf gathered over ``axis`` (one collective per dtype, the backward
    summed as :func:`gather`'s with ``partial``) and narrowed."""
    xs = list(xs)
    if not live(axis):
        return [x.narrow(dim, lo, hi - lo) for x in xs]
    n, r = xs[0].shape[dim], int(axis.rank)
    if (lo, hi) == (r * n, (r + 1) * n):
        return xs
    full = gather_leaves(axis, xs, [dim] * len(xs))
    return [x.narrow(dim, lo, hi - lo) for x in full]
