"""The kernels' backward: the VJP of each kernel's plain version.

The reference differentiates its four model kernels (flash attention, the
grouped expert matmul, WKV6, SSD) through a ``jax.custom_vjp`` whose
forward is the Pallas kernel and whose backward is the VJP of the kernel's
plain oracle, recomputed from the saved inputs (``kernels/*/ops.py``).
:class:`PlainVJP` is that rule as one ``torch.autograd.Function``: its
forward calls the entry as it is called without a gradient (on a CUDA
tensor the kernel, counted in its ``launches``; on CPU tensors the plain
version) and saves the inputs; its backward re-runs the plain version under
``torch.enable_grad()`` on detached copies of them and returns
``torch.autograd.grad`` of it against the incoming gradient, each gradient
in its input's dtype.  No backward kernel: the plain VJP re-materializes
what the forward kernel never stores (flash: the S × S logits).

An entry goes through it only when :func:`needs_grad` holds (grad mode on
and an input that requires grad); otherwise it calls the kernel directly,
so serving and the decode graphs never build an autograd node.
"""
from __future__ import annotations

import torch


def needs_grad(*tensors) -> bool:
    """True when autograd would record a call on ``tensors``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class PlainVJP(torch.autograd.Function):
    """``forward(*inputs)`` for the forward, the VJP of ``plain`` for the
    backward.  ``forward`` and ``plain`` take the inputs positionally and
    return one tensor."""

    @staticmethod
    def forward(ctx, forward, plain, *inputs):
        ctx.plain = plain
        ctx.save_for_backward(*inputs)
        return forward(*inputs)

    @staticmethod
    def backward(ctx, grad_out):
        with torch.enable_grad():
            leaves = tuple(t.detach().requires_grad_()
                           for t in ctx.saved_tensors)
            out = ctx.plain(*leaves)
            grads = torch.autograd.grad(out, leaves, grad_out)
        return (None, None, *grads)
