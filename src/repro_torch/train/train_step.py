"""The train step: planned forward + gradients + clipping + optimizer, with
microbatching.

The port of the reference's ``train/train_step.py``.  The planned
function's loss is differentiated by autograd (the reference's
``jax.value_and_grad``): the scan nodes run their layers under their
``remat`` attr and the kernel entries' backward is their plain version's
VJP.  Parameters live in float32 ("master"); the forward computes in the
config's dtype, and ``grad_dtype="bfloat16"`` casts the float32 leaves of
two or more dimensions to bfloat16 for the forward and backward, their
gradients coming back in float32 (reference ``train_step.py:55-60``).
With ``num_microbatches`` > 1 every batch leaf is sliced on axis 0 and the
gradients accumulate in the parameters' dtype, then divide by the count,
as the reference's ``lax.scan`` does.

A step writes the parameters and the optimizer state in place and reads
nothing back to the host: ``loss``, ``grad_norm`` and ``step`` come back as
device scalars.

On a rank mesh (``fwd`` planned with ``mesh=`` and ``param_specs=``) the
parameters, the optimizer state and the batch are this rank's blocks; the
planned loss is the global one on every rank, and the backward's
collectives leave each gradient as this rank's block of the global
gradient (the FSDP gathers sum it over ``data``, a whole leaf's use sums
it over the axes it is partial on, and on a mesh with a ``pod`` axis the
step sums every gradient over ``pod``).  The clipping norm and the optimizer
read ``fwd.param_shardings``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from ..layers.common import torch_dtype
from .optim import clip_by_global_norm, tree_leaves, tree_map


@dataclass
class TrainState:
    """``(step, params, opt_state)``: a checkpoint names its leaves ``0``,
    ``1.<param path>`` and ``2.<state path>``, as the reference's pytree."""

    step: torch.Tensor
    params: Any
    opt_state: Any


def init_state(params, optimizer) -> TrainState:
    first = tree_leaves(params)[0]
    return TrainState(torch.zeros((), dtype=torch.int32, device=first.device),
                      params, optimizer.init(params))


def loss_and_grads(fwd, params, batch: dict, *, grad_dtype="float32",
                   positions_fn: Optional[Callable] = None):
    """``(loss, grads)`` of the planned loss at ``params`` on one batch:
    the reference's ``jax.value_and_grad(loss_fn)``.  Gradients come in the
    parameters' dtypes; a leaf the loss does not reach gets zeros."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _p: next(it), params)
    if grad_dtype != "float32":
        dt = torch_dtype(grad_dtype)
        live = tree_map(lambda p: p.to(dt) if p.dtype == torch.float32
                        and p.dim() >= 2 else p, live)
    aux = {}
    if positions_fn is not None:
        aux["positions"] = positions_fn(batch)
    with torch.enable_grad():
        loss = fwd(live, batch, aux)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, grads))
    return loss.detach(), tree_map(lambda _p: next(it), params)


def _sum_over_pod(mesh, grads):
    """``grads`` summed over the mesh's ``pod`` axis, when it has one of
    more than one rank: each pod's ranks hold the gradient of their pod's
    rows (the loss is the global mean), and no FSDP gather spans pods."""
    if mesh is None or "pod" not in getattr(mesh, "axis_names", ()) or \
            int(mesh.shape["pod"]) <= 1:
        return grads
    pod = mesh.axis("pod")
    return tree_map(lambda g: pod.all_reduce(g.contiguous()), grads)


def make_train_step(fwd, optimizer, *, num_microbatches: int = 1,
                    grad_dtype: str = "float32", clip_norm: float = 1.0,
                    positions_fn: Optional[Callable] = None):
    """Returns ``step(state, batch) -> (state, metrics)``.  ``batch`` is
    the dict of plan inputs (tensors on the plan's device)."""

    def grad_fn(params, mb):
        return loss_and_grads(fwd, params, mb, grad_dtype=grad_dtype,
                              positions_fn=positions_fn)

    def step(state: TrainState, batch: dict):
        if num_microbatches <= 1:
            loss, grads = grad_fn(state.params, batch)
        else:
            n = num_microbatches
            loss, grads = None, None
            for i in range(n):
                mb = {k: x[i * (x.shape[0] // n):(i + 1) * (x.shape[0] // n)]
                      for k, x in batch.items()}
                lmb, g = grad_fn(state.params, mb)
                if grads is None:
                    loss, grads = lmb.to(torch.float32), g
                else:
                    loss = loss + lmb
                    grads = tree_map(torch.add, grads, g)
            grads = tree_map(lambda g: (g / n).to(g.dtype), grads)
            loss = loss / n
        grads = _sum_over_pod(getattr(fwd, "mesh", None), grads)
        shardings = getattr(fwd, "param_shardings", None)
        grads, gnorm = clip_by_global_norm(grads, clip_norm, shardings)
        params, opt_state = optimizer.update(grads, state.opt_state,
                                             state.params, shardings)
        new_step = state.step + 1
        return (TrainState(new_step, params, opt_state),
                {"loss": loss, "grad_norm": gnorm, "step": new_step})

    return step
