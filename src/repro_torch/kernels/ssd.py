"""Mamba2 SSD (state-space dual) scan: the CUDA kernel and its plain
versions.

Per head, a float32 state H (N x P), a scalar decay ``a_t`` in (0, 1),
input and output projections ``b_t``, ``c_t`` (N) and a token ``x_t`` (P):

    H_t = a_t·H_{t-1} + b_t ⊗ x_t
    y_t = c_t · H_t        (the D·x skip is the caller's)

Shapes: x (B, T, H, P), a (B, T, H), b, c (B, T, H, N).

  * :func:`ssd` — the kernel ``csrc/ssd.cu`` for CUDA tensors (it replaces
    the reference's Pallas ``ssd_hmajor``; its source note gives the design
    and the bound), :func:`ssd_reference` for CPU tensors.  bfloat16 runs
    the chunked form on the tensor cores (chunks of 64 steps, ``mma.sync``
    with float32 operands split into two bfloat16 terms), float32 the
    exact sequential recurrence; one launch either way.  It takes the
    framework layout with its strides: b and c may be the mamba block's one
    (B, T, N) matrix expanded over heads with stride 0, never copied per
    head.  The planner's ``ssd_pallas`` impl calls it.
  * :func:`ssd_reference` — the sequential recurrence with an initial
    state, returning ``(y, s_fin)``: the kernel's plain version and the
    decode step's one-token recurrence (the reference's ``ref.py``).
  * :func:`ssd_chunked` — the chunked matmul form, the ``ssd_chunked_xla``
    engine (chunk 128), copied from the reference.

Under autograd :func:`ssd` runs through :class:`~.autograd.PlainVJP`: the
backward is the VJP of :func:`ssd_reference`'s output, as the reference's
``custom_vjp``.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F_

from . import build
from .autograd import PlainVJP, needs_grad

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_DIM = 128


def ssd_reference(x, a, b, c, initial_state=None):
    """The sequential recurrence in float32; returns (y in x's dtype, the
    final state (B, H, N, P) float32)."""
    bs, t, h, p = x.shape
    n = b.shape[-1]
    x32, a32, b32, c32 = (v.float() for v in (x, a, b, c))
    s = (torch.zeros((bs, h, n, p), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    ys = []
    for i in range(t):
        s = (a32[:, i, :, None, None] * s
             + b32[:, i, :, :, None] * x32[:, i, :, None, :])
        ys.append(torch.einsum("bhn,bhnp->bhp", c32[:, i], s))
    y = torch.stack(ys, dim=1) if ys else torch.zeros_like(x32)
    return y.to(x.dtype), s


def ssd_chunked(x, a, b, c, *, chunk=128):
    """The chunked matmul form (the XLA engine): per chunk of L steps

        Y_intra = ((C Bᵀ) ⊙ L_decay) X,   Y_inter = cum_a ⊙ (C H_in),
        H_out   = (Π a)·H_in + (B ⊙ w)ᵀ X,

    scanning over chunks.  Returns (y, final state)."""
    bs, t, h, p = x.shape
    n = b.shape[-1]
    ch = min(chunk, t)
    rem = (-t) % ch
    if rem:
        x, b, c = (F_.pad(v, (0, 0, 0, 0, 0, rem)) for v in (x, b, c))
        a = F_.pad(a, (0, 0, 0, rem), value=1.0)
    tt = t + rem
    nc = tt // ch

    def to_chunks(v):
        return v.float().reshape(bs, nc, ch, h, *v.shape[3:]).movedim(1, 0)

    xc, ac, bc, cc = map(to_chunks, (x, a, b, c))
    tri = torch.tril(torch.ones((ch, ch), dtype=torch.bool, device=x.device))
    s = torch.zeros((bs, h, n, p), dtype=torch.float32, device=x.device)
    ys = []
    for i in range(nc):
        xk, ak, bk, ck = xc[i], ac[i], bc[i], cc[i]      # (B, L, H, ...)
        cum = torch.cumsum(torch.log(torch.clamp(ak, min=1e-37)), dim=1)
        seg = cum[:, :, None, :] - cum[:, None, :, :]   # (B, L, L, H)
        l_decay = torch.where(tri[None, :, :, None], torch.exp(seg), 0.0)
        g = torch.einsum("blhn,bshn->blsh", ck, bk)
        y_intra = torch.einsum("blsh,bshp->blhp", g * l_decay, xk)
        y_inter = torch.einsum("blhn,bhnp->blhp",
                               ck * torch.exp(cum)[..., None], s)
        w = torch.exp(cum[:, -1:, :] - cum)              # (B, L, H)
        s = (torch.exp(cum[:, -1, :])[..., None, None] * s
             + torch.einsum("blhn,blhp->bhnp", bk * w[..., None], xk))
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(bs, tt, h, p)[:, :t]
    return y.to(x.dtype), s


def _kernel():
    return build.entry("ssd", "ssd_fwd", *[ctypes.c_void_p] * 5,
                       *[ctypes.c_int] * 6, ctypes.c_void_p, ctypes.c_void_p)


def _check(x, a, b, c):
    tensors = (x, a, b, c)
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("ssd: x, a, b, c must lie on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in tensors):
        raise TypeError("ssd: needs float32 or bfloat16 x, a, b, c of one "
                        f"dtype, got {[t.dtype for t in tensors]}")
    if x.dim() != 4 or a.dim() != 3 or b.dim() != 4 or \
            tuple(a.shape) != tuple(x.shape[:3]) or \
            b.shape != c.shape or tuple(b.shape[:3]) != tuple(x.shape[:3]):
        raise ValueError(
            "ssd: needs x (B, T, H, P), a (B, T, H), b and c (B, T, H, N), "
            f"got {[tuple(t.shape) for t in tensors]}")
    bs, _, h, p = x.shape
    n = b.shape[-1]
    for name, dim in (("head size P", p), ("state size N", n)):
        if dim % 8 or not 8 <= dim <= MAX_DIM:
            raise ValueError(f"ssd: {name} {dim} must be a multiple of 8 up "
                             f"to {MAX_DIM}")
    if bs * h > 65535:
        raise ValueError(f"ssd: batch x heads {bs * h} above 65535")


def _plain(x, a, b, c):
    return ssd_reference(x, a, b, c)[0]


def ssd(x, a, b, c):
    """x (B, T, H, P), a (B, T, H), b, c (B, T, H, N) -> y (B, T, H, P) in
    x's dtype: the CUDA kernel for CUDA tensors, :func:`ssd_reference` for
    CPU tensors; differentiable (the backward is the reference's VJP)."""
    if needs_grad(x, a, b, c):
        return PlainVJP.apply(_forward, _plain, x, a, b, c)
    return _forward(x, a, b, c)


def _forward(x, a, b, c):
    if all(t.device.type == "cpu" for t in (x, a, b, c)):
        return ssd_reference(x, a, b, c)[0]
    _check(x, a, b, c)
    bs, t, h, p = x.shape
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if t == 0:
        return y
    strides = (ctypes.c_longlong * 20)(
        *x.stride(), *a.stride(), 0, *b.stride(), *c.stride(), *y.stride())
    fn, stream = _kernel(), build.stream(x.device)
    build.check(fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                   y.data_ptr(), _DTYPES[x.dtype], bs, t, h, p, b.shape[-1],
                   ctypes.addressof(strides), stream), "ssd")
    ssd.launches += 1
    return y


ssd.launches = 0
