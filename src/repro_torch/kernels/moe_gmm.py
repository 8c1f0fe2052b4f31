"""Grouped expert matmul: the CUDA kernel and its plain version.

After the MoE capacity dispatch the tokens are grouped by expert, x (E, C,
D), and each expert has its weight w (E, D, F):

    out[e] = x[e] @ w[e]            (E, C, F), in x's dtype

with a float32 sum rounded once to x's dtype.

  * :func:`gmm` — the kernel ``csrc/moe_gmm.cu`` (it replaces the
    reference's Pallas ``gmm``; its source note gives the design and the
    bound): bfloat16 on the tensor cores (``wgmma`` fed by TMA), float32
    on exact SIMT FMAs.  CUDA tensors only: anything else raises.  It
    takes the true C, D and F and the operands' strides: nothing is
    padded, so a layer's slice of the stacked weight tree is read in
    place.  The bfloat16 kernel reads x and w through TMA tensor maps,
    which need a unit inner stride and a 16-byte aligned base and outer
    strides: an operand that has not (a transposed view, a row of 12
    elements) is first copied into a buffer whose rows are padded to a
    multiple of 8 (:func:`_tma_ready`).  The MoE layer's operands qualify
    as they are: ``expert_in`` comes out of a reshape and ``wi`` / ``wg``
    / ``wo`` are the cast copies.
  * :func:`gmm_reference` — the plain version (the reference's
    ``ref.gmm_reference``): a float32 einsum cast back to x's dtype.
  * :func:`grouped_matmul` — the dispatch the MoE layer calls (the
    reference's ``ops.grouped_matmul``): the kernel for CUDA tensors,
    :func:`gmm_reference` for CPU tensors.  Under autograd it runs through
    :class:`~.autograd.PlainVJP`: the backward is the VJP of
    :func:`gmm_reference`, as the reference's ``custom_vjp``.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .autograd import PlainVJP, needs_grad

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def gmm_reference(x, w):
    """x (E, C, D) @ w (E, D, F) -> (E, C, F): float32 einsum, cast back to
    x's dtype."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)


def _kernel():
    return build.entry("moe_gmm", "gmm_fwd", *[ctypes.c_void_p] * 3,
                       *[ctypes.c_int] * 5, *[ctypes.c_longlong] * 6,
                       ctypes.c_void_p)


def _check(x, w):
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError("gmm: x and w must lie on one CUDA device, got "
                         f"{x.device} and {w.device}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError("gmm: needs float32 or bfloat16 x and w of one "
                        f"dtype, got {x.dtype} and {w.dtype}")
    if x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0] \
            or w.shape[1] != x.shape[2]:
        raise ValueError(f"gmm: needs x (E, C, D) and w (E, D, F), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.shape[0] > 65535:
        raise ValueError(f"gmm: {x.shape[0]} experts above 65535")


def _tma_ready(t):
    """``t`` itself if a TMA tensor map can read it (unit inner stride,
    16-byte aligned base, the strides of the dimensions above 1 multiples
    of 8 elements), else a copy whose rows are padded to a multiple of 8
    elements, viewed at ``t``'s shape."""
    ok = (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
          and all(st % 8 == 0 for st, n in zip(t.stride()[:-1],
                                               t.shape[:-1]) if n > 1))
    if ok:
        return t
    n = t.shape[-1]
    buf = t.new_empty((*t.shape[:-1], -(-n // 8) * 8))
    buf[..., :n] = t
    return buf[..., :n]


def gmm(x, w):
    """x (E, C, D) @ w (E, D, F) -> (E, C, F) in x's dtype: the CUDA
    kernel.  Raises on anything but CUDA tensors of one float32 or
    bfloat16 dtype."""
    _check(x, w)
    e, c, d = x.shape
    f = w.shape[2]
    if d == 0:
        return torch.zeros((e, c, f), dtype=x.dtype, device=x.device)
    out = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if x.dtype == torch.bfloat16:
        x, w = _tma_ready(x), _tma_ready(w)
    fn, stream = _kernel(), build.stream(x.device)
    build.check(fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                   _DTYPES[x.dtype], e, c, d, f, *x.stride(), *w.stride(),
                   stream), "gmm")
    gmm.launches += 1
    return out


gmm.launches = 0


def _forward(x, w):
    if x.device.type == "cpu" and w.device.type == "cpu":
        return gmm_reference(x, w)
    return gmm(x, w)


def grouped_matmul(x, w):
    """The MoE layer's expert matmul: :func:`gmm` for CUDA tensors,
    :func:`gmm_reference` for CPU tensors; differentiable (the backward is
    :func:`gmm_reference`'s VJP).  Unlike the reference's
    ``ops.grouped_matmul`` nothing is padded: the kernel masks the true
    sizes."""
    if needs_grad(x, w):
        return PlainVJP.apply(_forward, gmm_reference, x, w)
    return _forward(x, w)
