"""RWKV6 (Finch) WKV recurrence: the CUDA kernel and its plain versions.

Per head with head size D and a float32 state S (D x D):

    y_t = r_t · (diag(u)·(k_t ⊗ v_t) + S_{t-1})
    S_t = diag(w_t)·S_{t-1} + k_t ⊗ v_t

with the data-dependent decay ``w_t`` in (0, 1) and the per-head bonus
``u``.  Shapes: r, k, v, w (B, T, H, D); u (H, D).

  * :func:`wkv6` — the kernel ``csrc/wkv6.cu`` for CUDA tensors (it
    replaces the reference's Pallas ``wkv6_hmajor``; its source note gives
    the design and the bound), :func:`wkv6_reference` for CPU tensors.
    bfloat16 runs the chunked form on the tensor cores (chunks of 64 steps,
    sub-chunks of 16 whose boundaries keep every decay factor <= 1, no
    clamp; ``mma.sync`` with float32 operands split into two bfloat16
    terms), float32 the exact sequential recurrence; one launch either
    way.  It takes the (B, T, H, D) layout with its strides: nothing is
    transposed or padded.  The planner's ``wkv6_pallas`` impl calls it.
  * :func:`wkv6_reference` — the sequential recurrence with an initial
    state, returning ``(y, s_fin)``: the kernel's plain version and the
    decode step's one-token recurrence (the reference's ``ref.py``).
  * :func:`wkv6_chunked` — the chunked form, the ``wkv6_scan_xla`` engine
    (chunk 32, clamp 60), copied from the reference.

Under autograd :func:`wkv6` runs through :class:`~.autograd.PlainVJP`:
the backward is the VJP of :func:`wkv6_reference`'s output, as the
reference's ``custom_vjp``.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F_

from . import build
from .autograd import PlainVJP, needs_grad

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128


def wkv6_reference(r, k, v, w, u, initial_state=None):
    """The sequential recurrence in float32; returns (y in r's dtype, the
    final state (B, H, D, D) float32)."""
    b, t, h, d = r.shape
    r32, k32, v32, w32 = (x.float() for x in (r, k, v, w))
    u32 = u.float()
    s = (torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
         if initial_state is None else initial_state.float())
    ys = []
    for i in range(t):
        kv = k32[:, i, :, :, None] * v32[:, i, :, None, :]   # (B, H, D, D)
        ys.append(torch.einsum("bhi,bhij->bhj", r32[:, i],
                               u32[None, :, :, None] * kv + s))
        s = w32[:, i, :, :, None] * s + kv
    y = torch.stack(ys, dim=1) if ys else torch.zeros_like(r32)
    return y.to(r.dtype), s


def wkv6_chunked(r, k, v, w, u, *, chunk=32, clamp=60.0):
    """The chunked form (the XLA engine): within a chunk of L steps the
    interaction is an (L, L) per-head product with the channel-wise decay
    folded into the operands,

        A[t, s] = (r_t ⊙ e^{cw_{t-1}}) · (k_s ⊙ e^{-cw_s}),  s < t,

    cw the in-chunk cumulative log-decay (≤ 0, so only the k side can
    overflow; it is clamped at ``clamp``).  Returns (y, final state)."""
    b, t, h, d = r.shape
    ch = min(chunk, t)
    rem = (-t) % ch
    if rem:
        pad = (0, 0, 0, 0, 0, rem)
        r, k, v = (F_.pad(x, pad) for x in (r, k, v))
        w = F_.pad(w, pad, value=1.0)
    tt = t + rem
    nc = tt // ch

    def to_chunks(x):
        return x.float().reshape(b, nc, ch, h, d).movedim(1, 0)

    rc, kc, vc, wc = map(to_chunks, (r, k, v, w))
    u32 = u.float()
    tri = torch.tril(torch.ones((ch, ch), dtype=torch.bool,
                                device=r.device), diagonal=-1)
    s = torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
    ys = []
    for c in range(nc):
        rk, kk, vk, wk = rc[c], kc[c], vc[c], wc[c]          # (B, L, H, D)
        logw = torch.log(torch.clamp(wk, min=1e-37))
        cw = torch.cumsum(logw, dim=1)
        q_in = rk * torch.exp(cw - logw)                     # decayed queries
        k_out = kk * torch.exp(torch.clamp(-cw, max=clamp))  # boosted keys
        a = torch.einsum("blhd,bshd->bhls", q_in, k_out)
        a = torch.where(tri[None, None], a, 0.0)
        y = torch.einsum("bhls,bshd->blhd", a, vk)
        diag = torch.einsum("blhd,hd,blhd->blh", rk, u32, kk)  # bonus
        y = y + diag[..., None] * vk
        y = y + torch.einsum("blhd,bhde->blhe", q_in, s)      # carry
        decay_to_end = torch.exp(cw[:, -1:] - cw)
        s = (torch.exp(cw[:, -1])[..., None] * s
             + torch.einsum("blhd,blhe->bhde", kk * decay_to_end, vk))
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(b, tt, h, d)[:, :t]
    return y.to(r.dtype), s


def _kernel():
    return build.entry("wkv6", "wkv6_fwd", *[ctypes.c_void_p] * 6,
                       *[ctypes.c_int] * 5, ctypes.c_void_p, ctypes.c_void_p)


def _check(r, k, v, w, u):
    tensors = (r, k, v, w, u)
    dev = r.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("wkv6: r, k, v, w, u must lie on one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")
    if r.dtype not in _DTYPES or any(t.dtype != r.dtype for t in (k, v, w)):
        raise TypeError("wkv6: needs float32 or bfloat16 r, k, v, w of one "
                        f"dtype, got {[t.dtype for t in (r, k, v, w)]}")
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError("wkv6: r, k, v, w must share one (B, T, H, D) shape,"
                         f" got {[tuple(t.shape) for t in (r, k, v, w)]}")
    b, _, h, d = r.shape
    if d % 8 or not 8 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"wkv6: head size {d} must be a multiple of 8 up "
                         f"to {MAX_HEAD_DIM}")
    if tuple(u.shape) != (h, d):
        raise ValueError(f"wkv6: u must be ({h}, {d}), got {tuple(u.shape)}")
    if b * h > 65535:
        raise ValueError(f"wkv6: batch x heads {b * h} above 65535")


def _plain(r, k, v, w, u):
    return wkv6_reference(r, k, v, w, u)[0]


def wkv6(r, k, v, w, u):
    """r, k, v, w: (B, T, H, D); u: (H, D) -> y (B, T, H, D) in r's dtype:
    the CUDA kernel for CUDA tensors, :func:`wkv6_reference` for CPU
    tensors; differentiable (the backward is the reference's VJP)."""
    if needs_grad(r, k, v, w, u):
        return PlainVJP.apply(_forward, _plain, r, k, v, w, u)
    return _forward(r, k, v, w, u)


def _forward(r, k, v, w, u):
    if all(t.device.type == "cpu" for t in (r, k, v, w, u)):
        return wkv6_reference(r, k, v, w, u)[0]
    _check(r, k, v, w, u)
    b, t, h, d = r.shape
    y = torch.empty(r.shape, dtype=r.dtype, device=r.device)
    if t == 0:
        return y
    u32 = u.float().contiguous()
    strides = (ctypes.c_longlong * 20)(
        *[s for x in (r, k, v, w, y) for s in x.stride()])
    fn, stream = _kernel(), build.stream(r.device)
    build.check(fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                   u32.data_ptr(), y.data_ptr(), _DTYPES[r.dtype], b, t, h, d,
                   ctypes.addressof(strides), stream), "wkv6")
    wkv6.launches += 1
    return y


wkv6.launches = 0
