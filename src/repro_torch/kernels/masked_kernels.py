"""The fused mask-weighted group-by: ``(Σ vals·mw, Σ mw)`` per group.

:func:`masked_segment_agg` is the wrapper ``rel_fused_agg_pallas`` calls.
On a CUDA tensor it launches the hand-written kernel
``csrc/masked_segment_agg.cu`` (which replaces the reference's
``stores/masked_kernels.py::masked_segment_agg_pallas``; its source note
gives the design and the bound) or raises — it never falls back.  On a CPU
tensor it runs :func:`masked_segment_agg_plain`, the same function in plain
PyTorch.

Convention (the reference's): keys outside ``[0, num_groups)`` — the
padding key ``-1`` — match no group.  A row whose weight is 0 adds nothing,
the reference's skip of all-zero mask blocks taken per row.
"""
from __future__ import annotations

import ctypes

import torch

from . import build


def masked_segment_agg_plain(vals: torch.Tensor, keys: torch.Tensor,
                             maskw: torch.Tensor, num_groups: int):
    """Plain PyTorch group-by: two ``index_add_`` with the padding mask,
    summed in float64 and rounded to float32, as the kernel sums.  Rows
    with weight 0 or an out-of-range key go to one spill slot past the
    end, cut off after."""
    g = int(num_groups)
    w = maskw.to(torch.float32)
    ok = (w != 0) & (keys >= 0) & (keys < g)
    idx = torch.where(ok, keys, torch.full_like(keys, g))
    acc = torch.zeros(2, g + 1, dtype=torch.float64, device=vals.device)
    acc[0].index_add_(0, idx, (vals.to(torch.float32) * w).to(torch.float64))
    acc[1].index_add_(0, idx, w.to(torch.float64))
    out = acc[:, :g].to(torch.float32)
    return out[0], out[1]


def _kernel(lib):
    fn = lib.masked_segment_agg_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def masked_segment_agg(vals: torch.Tensor, keys: torch.Tensor,
                       maskw: torch.Tensor, num_groups: int):
    """``(sums, counts)`` per group id: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    ts = (vals, keys, maskw)
    if all(t.device.type == "cpu" for t in ts):
        return masked_segment_agg_plain(vals, keys, maskw, num_groups)
    if vals.device.type != "cuda" or any(t.device != vals.device for t in ts):
        raise ValueError("masked_segment_agg: vals, keys and maskw must be on "
                         "one CUDA device, got "
                         f"{[str(t.device) for t in ts]}")
    if (vals.dtype != torch.float32 or keys.dtype != torch.int32
            or maskw.dtype != torch.float32):
        raise TypeError("masked_segment_agg: needs float32 vals, int32 keys "
                        "and float32 maskw, got "
                        f"{[str(t.dtype) for t in ts]}")
    if (vals.dim() != 1 or any(t.shape != vals.shape for t in ts)
            or not all(t.is_contiguous() for t in ts)):
        raise ValueError("masked_segment_agg: needs contiguous 1-D inputs of "
                         f"one length, got {[tuple(t.shape) for t in ts]}")
    g, r = int(num_groups), int(vals.shape[0])
    if r == 0 or g == 0:
        out = torch.zeros(2, g, dtype=torch.float32, device=vals.device)
        return out[0], out[1]
    # float64 scratch (sums, counts), rounded into ``out`` by the kernel;
    # freeing it on return is safe in stream order, as in scatter_add
    acc = torch.zeros(2, g, dtype=torch.float64, device=vals.device)
    out = torch.empty(2, g, dtype=torch.float32, device=vals.device)
    fn = _kernel(build.load("masked_segment_agg"))
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    build.check(fn(vals.data_ptr(), keys.data_ptr(), maskw.data_ptr(),
                   acc.data_ptr(), out.data_ptr(), r, g, stream),
                "masked_segment_agg")
    masked_segment_agg.launches += 1
    return out[0], out[1]


masked_segment_agg.launches = 0
