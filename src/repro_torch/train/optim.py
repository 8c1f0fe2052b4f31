"""Optimizers: AdamW, Adafactor, the cosine schedule and global-norm
clipping.

The port of the reference's ``train/optim.py``, formula for formula (not
``torch.optim``'s: its Adafactor is another algorithm).  Parameters,
gradients and states are the port's nested dicts of tensors.  The update
writes the parameters and the state in place (the reference returns new
trees; the values are the same) and reads nothing back to the host: the
step count is a device int32 scalar, as the reference's ``count``, and the
learning rate a device float32 scalar computed from it.

Adafactor (factored second moment) is the memory-feasible choice for the
400B-class configs; the config's ``optimizer`` field selects per arch.
With ``master=True`` the live parameters may be bfloat16 while the update
runs against a float32 master copy in the state.

On a rank mesh every leaf is this rank's block and ``shardings`` (the
parameters' ``core.executor.Sharding`` tree) says how it is cut:
:func:`global_norm` counts every logical element once, AdamW updates the
blocks elementwise as they are, and Adafactor's means over a cut dim (the
factored moments, their row mean, the update's RMS) sum over that dim's
axis before dividing by its global size.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from ..core import tracing


def tree_leaves(tree) -> list:
    """The tensors of a nested dict, in insertion order."""
    return list(tracing.tree_leaves(tree))


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


# --------------------------------------------------------------------------
# schedules
# --------------------------------------------------------------------------

def cosine_schedule(base_lr: float, warmup: int, total: int,
                    final_frac: float = 0.1) -> Callable:
    """``lr(step)``: linear warmup, then a cosine from ``base_lr`` down to
    ``final_frac * base_lr`` at ``total``; float32 on the step's device."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, base_lr * cos)
    return lr


# --------------------------------------------------------------------------
# gradient utilities
# --------------------------------------------------------------------------

def global_norm(tree, shardings=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32.  With
    ``shardings`` (on a rank mesh) a leaf's block counts on the ranks at
    coordinate 0 of every axis it is whole over, and the sum runs over the
    mesh: every logical element once."""
    if shardings is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                              for x in tree_leaves(tree)))
    sh = leaf_shardings(tree, shardings)
    mesh = sh[0].mesh
    live = [a for a in mesh.axis_names if int(mesh.shape[a]) > 1]
    total = None
    for x, s in zip(tree_leaves(tree), sh):
        if any(mesh.coords[a] for a in live if a not in s.sharded_axes()):
            continue
        part = torch.sum(torch.square(x.float()))
        total = part if total is None else total + part
    if total is None:
        total = torch.zeros((), dtype=torch.float32,
                            device=tree_leaves(tree)[0].device)
    for a in live:
        total = mesh.axis(a).all_reduce(total)
    return torch.sqrt(total)


def leaf_shardings(tree, shardings) -> list:
    """The Sharding record of every leaf of ``tree``, in its leaf order
    (``shardings`` is keyed as ``tree``, maybe in another order)."""
    if isinstance(tree, dict):
        return [s for k, v in tree.items()
                for s in leaf_shardings(v, shardings[k])]
    return [shardings]


def clip_by_global_norm(tree, max_norm: float, shardings=None):
    """Scales every leaf in place by ``min(1, max_norm / (norm + 1e-9))``;
    returns ``(tree, norm)``."""
    norm = global_norm(tree, shardings)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    with torch.no_grad():
        for x in tree_leaves(tree):
            x.mul_(scale)
    return tree, norm


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class AdamW:
    """AdamW with an optional float32 **master copy** (``master=True``):
    the live parameters may then be bfloat16, and the update runs against
    the master, which also accumulates what their rounding drops."""

    lr: Callable
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    master: bool = False

    def init(self, params) -> dict:
        zeros = lambda p: torch.zeros_like(  # noqa: E731
            p, dtype=torch.float32)
        first = tree_leaves(params)[0]
        st = {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
              "count": torch.zeros((), dtype=torch.int32,
                                   device=first.device)}
        if self.master:
            st["master"] = tree_map(
                lambda p: p.to(torch.float32, copy=True), params)
        return st

    @torch.no_grad()
    def update(self, grads, state, params, shardings=None):
        """One step: the moments, then the parameters (and the master),
        in place (elementwise: a rank's blocks update as they are).
        Returns ``(params, state)``."""
        c = state["count"] + 1
        b1, b2 = self.b1, self.b2
        lr = self.lr(c)
        cf = c.to(torch.float32)
        bc1 = 1 - torch.pow(b1, cf)
        bc2 = 1 - torch.pow(b2, cf)
        base = state.get("master", params)
        for p32, p, m, v, g in zip(tree_leaves(base), tree_leaves(params),
                                   tree_leaves(state["m"]),
                                   tree_leaves(state["v"]),
                                   tree_leaves(grads)):
            g32 = g.to(torch.float32)
            m.mul_(b1).add_(g32, alpha=1 - b1)
            v.mul_(b2).add_(torch.square(g32), alpha=1 - b2)
            step = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            new = p32.to(torch.float32)
            step += self.weight_decay * new
            new = new - lr * step
            p32.copy_(new)
            if p32 is not p:
                p.copy_(new)
        state["count"] = c
        return params, state


# --------------------------------------------------------------------------
# Adafactor (factored second moment, no momentum)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class Adafactor:
    lr: Callable
    decay: float = 0.8
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0
    master: bool = False      # float32 master copy for bfloat16 params

    @staticmethod
    def _factored(shape) -> bool:
        return len(shape) >= 2

    def init(self, params) -> dict:
        def one(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            slot = ({"vr": torch.zeros(p.shape[:-1], **f32),
                     "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
                    if self._factored(p.shape)
                    else {"v": torch.zeros(p.shape, **f32)})
            if self.master:
                slot["master"] = p.to(torch.float32, copy=True)
            return slot
        first = tree_leaves(params)[0]
        return {"slots": tree_map(one, params),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=first.device)}

    @torch.no_grad()
    def update(self, grads, state, params, shardings=None):
        """One step, in place; returns ``(params, state)``.  With
        ``shardings`` each mean over a cut dim sums over its axis."""
        c = state["count"] + 1
        rho = 1.0 - torch.pow(c.to(torch.float32), -self.decay)
        lr = self.lr(c)

        def upd(p, g, slot, sh):
            g32 = g.to(torch.float32)
            g2 = torch.square(g32) + self.eps
            if self._factored(p.shape):
                vr, vc = slot["vr"], slot["vc"]
                nd = p.dim()
                vr.copy_(rho * vr + (1 - rho) * _mean(g2, -1, sh, nd - 1))
                vc.copy_(rho * vc + (1 - rho) * _mean(g2, -2, sh, nd - 2))
                row = _mean(vr, -1, sh, nd - 2, keepdim=True)
                denom = torch.sqrt(
                    vr[..., None] * vc[..., None, :]
                    / torch.clamp(row[..., None], min=self.eps))
            else:
                slot["v"].copy_(rho * slot["v"] + (1 - rho) * g2)
                denom = torch.sqrt(slot["v"])
            step = g32 / torch.clamp(denom, min=self.eps)
            rms = torch.sqrt(_mean_all(torch.square(step), sh) + 1e-12)
            step = step / torch.clamp(rms / self.clip_threshold, min=1.0)
            base = slot.get("master", p).to(torch.float32)
            if self.weight_decay:
                step = step + self.weight_decay * base
            new = base - lr * step
            if self.master:
                slot["master"].copy_(new)
            p.copy_(new)

        sh = (leaf_shardings(params, shardings) if shardings is not None
              else [None] * len(tree_leaves(params)))
        for p, g, slot, s in zip(tree_leaves(params), tree_leaves(grads),
                                 _slots(state["slots"], params), sh):
            upd(p, g, slot, s)
        state["count"] = c
        return params, state


def _axes_of(sh, i: int) -> list:
    """The live sub-groups dim ``i`` of a leaf is cut over."""
    if sh is None:
        return []
    return [sh.mesh.axis(a) for a in sh.axes(i)
            if int(sh.mesh.shape[a]) > 1]


def _mean(x, dim: int, sh, pdim: int, keepdim=False):
    """``x.mean(dim)``, where ``dim`` of ``x`` is the parameter's dim
    ``pdim``: summed over its axes first when that dim is cut."""
    axes = _axes_of(sh, pdim)
    if not axes:
        return x.mean(dim=dim, keepdim=keepdim)
    total, n = x.sum(dim=dim, keepdim=keepdim), x.shape[dim]
    for ax in axes:
        total = ax.all_reduce(total)
        n *= int(ax.world)
    return total / n


def _mean_all(x, sh):
    """The mean of every element of the leaf ``x`` is a block of."""
    axes = [ax for i in range(x.dim()) for ax in _axes_of(sh, i)]
    if not axes:
        return torch.mean(x)
    total, n = x.sum(), x.numel()
    for ax in axes:
        total = ax.all_reduce(total)
        n *= int(ax.world)
    return total / n


def _slots(slots, params) -> list:
    """The slot dicts of an Adafactor state, in the leaf order of
    ``params`` (each leaf's slot is a dict, so it is no leaf itself)."""
    if isinstance(params, dict):
        return [s for k, v in params.items() for s in _slots(slots[k], v)]
    return [slots]


def make_optimizer(name: str, lr_fn: Callable, **kw):
    if name == "adamw":
        return AdamW(lr=lr_fn, **kw)
    if name == "adafactor":
        return Adafactor(lr=lr_fn, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
