"""Flash attention: blocked online-softmax attention with causal, sliding
window and GQA masks.

Two entry points launch the CUDA kernels of ``csrc/flash_attention.cu``
(which replace the reference's Pallas ``_attn_kernel``; the source note
gives the design and the bound): bfloat16 runs on the tensor cores
(``wgmma`` with TMA tile loads), float32 on exact SIMT FMAs.  Any head_dim
that is a multiple of 8 up to :data:`MAX_HEAD_DIM` = 256 is taken in both
dtypes:

  * :func:`flash_attention_hmajor` takes the heads-major layout, q (B, H,
    Sq, D) against k, v (B, K, Skv, D) — the reference's
    ``kernels/flash_attention/flash_attention.py::flash_attention_hmajor``;
  * :func:`flash_attention` takes (B, S, H, D) — the reference's
    ``ops.flash_attention`` (``_call_padded``), the one the planner's
    ``attn_flash_pallas`` impl calls.  It passes the heads-major *view*'s
    strides and the true lengths: on the card nothing is padded or copied.

On a CUDA tensor they launch the kernel or raise; on CPU tensors they run
:func:`flash_attention_plain`, the same function in plain PyTorch (the
reference's ``mha_reference``), which the CPU tests hold against the
reference and the chip smoke holds the kernel against.  The planner's
``sdpa_xla`` impl computes it too.  Under autograd (grad mode on and an
input that requires grad) both entries run through
:class:`~.autograd.PlainVJP`: the forward as above, the backward the VJP of
:func:`flash_attention_plain`, as the reference's ``custom_vjp``
(``ops.py:44-64``); the backward re-materializes the float32 S × S logits.

Semantics (the reference's): q head h reads kv head ``h // (H / K)``;
``sm_scale`` defaults to ``D ** -0.5``; the causal mask aligns the ends
(query i sits at position ``i + Skv - Sq``); ``window > 0`` keeps keys
``k > pos - window``; a query row with no valid key (causal, Sq > Skv)
gets the mean of v over all keys, as ``mha_reference`` (the TPU kernel
gives another value there, see ROADMAP §3).  Float32 logits and
accumulation; the output in q's dtype.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .autograd import PlainVJP, needs_grad

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def attention_mask(q_len: int, kv_len: int, *, causal: bool, window: int,
                   device=None):
    """(q_len, kv_len) bool mask: causal aligned to the ends, window."""
    qi = torch.arange(q_len, device=device)[:, None] + (kv_len - q_len)
    ki = torch.arange(kv_len, device=device)[None, :]
    mask = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        mask &= ki <= qi
    if window and window > 0:
        mask &= ki > qi - window
    return mask


def flash_attention_plain(q, k, v, *, causal=True, window=0, sm_scale=None):
    """q: (B, Sq, H, D); k, v: (B, Skv, K, D) -> (B, Sq, H, D).  Plain
    PyTorch: float32 logits, the mask as ``-1e30``, softmax, the output
    cast to q's dtype — the reference's ``mha_reference``."""
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    if h % kh:
        raise ValueError(f"heads {h} not a multiple of kv heads {kh}")
    groups = h // kh
    scale = sm_scale if sm_scale is not None else d ** -0.5
    kr = k.repeat_interleave(groups, dim=2)
    vr = v.repeat_interleave(groups, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) * scale
    mask = attention_mask(sq, skv, causal=causal, window=window,
                          device=q.device)
    logits = torch.where(mask, logits, torch.full((), -1e30,
                                                  device=q.device))
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vr.float())
    return out.to(q.dtype)


def _kernel():
    return build.entry("flash_attention", "flash_attention_fwd",
                       *[ctypes.c_void_p] * 4, *[ctypes.c_int] * 7,
                       *[ctypes.c_longlong] * 12, ctypes.c_float,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def _aligned(t):
    """A tensor the kernel reads in 16-byte rows of 8 elements (and the
    bfloat16 kernel through TMA tensor maps, which need the same): unit
    stride on the head dim, every other stride a multiple of 8 elements,
    a 16-byte-aligned base; else a contiguous copy."""
    ok = (t.stride(-1) == 1 and all(s % 8 == 0 for s in t.stride()[:-1])
          and t.data_ptr() % 16 == 0)
    return t if ok else t.contiguous()


def _launch(qh, kh, vh, oh, *, causal, window, sm_scale) -> None:
    """Launch the kernel on heads-major views: qh/oh (B, H, Sq, D), kh/vh
    (B, K, Skv, D), any strides with a unit head-dim stride."""
    tensors = (qh, kh, vh, oh)
    if qh.dtype not in _DTYPES or any(t.dtype != qh.dtype for t in tensors):
        raise TypeError("flash_attention: needs float32 or bfloat16 q, k, v "
                        f"of one dtype, got {[t.dtype for t in tensors]}")
    b, h, sq, d = qh.shape
    bk, kvh, skv, dk = kh.shape
    if (bk != b or dk != d or vh.shape != kh.shape or h % kvh
            or d % 8 or not 8 <= d <= MAX_HEAD_DIM or sq < 1 or skv < 1
            or sq > 65535 * 64):
        raise ValueError(
            f"flash_attention: unsupported shapes q {tuple(qh.shape)}, k "
            f"{tuple(kh.shape)}, v {tuple(vh.shape)} (heads-major; needs "
            f"head_dim a multiple of 8 up to {MAX_HEAD_DIM}, kv heads "
            f"dividing heads, non-empty sequences, at most {65535 * 64} "
            f"queries)")
    dev = qh.device
    if any(t.device != dev for t in tensors) or dev.type != "cuda":
        raise ValueError("flash_attention: q, k, v must lie on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    scale = float(sm_scale) if sm_scale is not None else d ** -0.5
    fn, stream = _kernel(), build.stream(dev)
    strides = [s for t in tensors for s in t.stride()[:3]]
    build.check(fn(qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), oh.data_ptr(),
                   _DTYPES[qh.dtype], b, h, kvh, sq, skv, d, *strides,
                   scale, int(bool(causal)), int(window or 0), stream),
                "flash_attention")
    flash_attention.launches += 1


def _forward(q, k, v, causal, window, sm_scale):
    """(B, S, H, D) layout: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     sm_scale=sm_scale)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    _launch(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            out.transpose(1, 2), causal=causal, window=window,
            sm_scale=sm_scale)
    return out


def _plain_hmajor(q, k, v, causal, window, sm_scale):
    return flash_attention_plain(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window, sm_scale=sm_scale).transpose(1, 2)


def _forward_hmajor(q, k, v, causal, window, sm_scale):
    """Heads-major layout: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return _plain_hmajor(q, k, v, causal, window, sm_scale)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    _launch(q, k, v, out, causal=causal, window=window, sm_scale=sm_scale)
    return out


def _call(forward, plain, q, k, v, causal, window, sm_scale):
    """``forward`` directly, or under autograd through PlainVJP with the
    VJP of ``plain`` for its backward."""
    if not needs_grad(q, k, v):
        return forward(q, k, v, causal, window, sm_scale)

    def bind(fn):
        return lambda q_, k_, v_: fn(q_, k_, v_, causal, window, sm_scale)
    return PlainVJP.apply(bind(forward), bind(plain), q, k, v)


def _plain(q, k, v, causal, window, sm_scale):
    return flash_attention_plain(q, k, v, causal=causal, window=window,
                                 sm_scale=sm_scale)


def flash_attention(q, k, v, *, causal=True, window=0, sm_scale=None):
    """q: (B, Sq, H, D); k, v: (B, Skv, K, D) -> (B, Sq, H, D): the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors;
    differentiable (the backward is the plain version's VJP)."""
    return _call(_forward, _plain, q, k, v, causal, window, sm_scale)


def flash_attention_hmajor(q, k, v, *, sm_scale=None, causal=True,
                           window=0):
    """q: (B, H, Sq, D); k, v: (B, K, Skv, D) -> (B, H, Sq, D): the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors;
    differentiable as :func:`flash_attention`."""
    return _call(_forward_hmajor, _plain_hmajor, q, k, v, causal, window,
                 sm_scale)


flash_attention.launches = 0
