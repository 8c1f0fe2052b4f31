"""The graph store's scatter-add: ``y[n] = Σ_{e: dst[e]=n} vals[e]``.

:func:`scatter_add` is the wrapper the SpMV of every frontier op calls.  On
a CUDA tensor it launches the hand-written kernel ``csrc/scatter_add.cu``
(which replaces the reference's ``stores/graph_kernels.py::
scatter_add_pallas``; its source note gives the design and the bound) or
raises — it never falls back.  On a CPU tensor it runs
:func:`scatter_add_plain`, the same function in plain PyTorch, which the
CPU tests hold against the reference and the chip smoke holds the kernel
against.

Convention (the reference's): edges whose ``dst`` lies outside
``[0, num_nodes)`` — the padding ``dst = -1`` — match no node; zero edges
give zeros.  The kernel takes edges in any order; it is fastest when equal
``dst`` lie next to each other (the graph payload's dst-ordered copy),
since it adds each such run with one atomic.
"""
from __future__ import annotations

import ctypes

import torch

from . import build


def scatter_add_plain(vals: torch.Tensor, dst: torch.Tensor,
                      num_nodes: int) -> torch.Tensor:
    """Plain PyTorch scatter-add: ``index_add_`` with the padding mask,
    summed in float64 and rounded to float32, as the kernel sums.
    Out-of-range edges go to one spill slot past the end, cut off after,
    so they add nothing anywhere (``index_add_`` on a CUDA tensor would
    assert on them)."""
    n = int(num_nodes)
    ok = (dst >= 0) & (dst < n)
    idx = torch.where(ok, dst, torch.full_like(dst, n))
    acc = torch.zeros(n + 1, dtype=torch.float64, device=vals.device)
    acc.index_add_(0, idx, vals.to(torch.float32).to(torch.float64))
    return acc[:n].to(torch.float32)


_P = ctypes.c_void_p


def _kernel():
    """The C entry, typed once (see :func:`build.entry`)."""
    return build.entry("scatter_add", "scatter_add_f32",
                       _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P)


def scatter_add(vals: torch.Tensor, dst: torch.Tensor,
                num_nodes: int) -> torch.Tensor:
    """``y[n] = Σ_{e: dst[e]=n} vals[e]`` for ``n < num_nodes``: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    dev = vals.device
    if dst.device == dev and dev.type == "cpu":
        return scatter_add_plain(vals, dst, num_nodes)
    if dev.type != "cuda" or dst.device != dev:
        raise ValueError(f"scatter_add: vals on {vals.device}, dst on "
                         f"{dst.device}; both must be on one CUDA device")
    if vals.dtype != torch.float32 or dst.dtype != torch.int32:
        raise TypeError(f"scatter_add: needs float32 vals and int32 dst, "
                        f"got {vals.dtype} and {dst.dtype}")
    if (vals.dim() != 1 or vals.shape != dst.shape
            or not vals.is_contiguous() or not dst.is_contiguous()):
        raise ValueError(f"scatter_add: needs contiguous 1-D vals and dst of "
                         f"one length, got {tuple(vals.shape)} and "
                         f"{tuple(dst.shape)}")
    n, e = int(num_nodes), int(vals.shape[0])
    if e == 0 or n == 0:
        return torch.zeros(n, dtype=torch.float32, device=vals.device)
    # float64 scratch: the kernel sums into it and rounds into ``out``.  It
    # may be freed on return while the kernel runs: the caching allocator
    # hands its memory out again only in this stream's order.
    acc = torch.zeros(n, dtype=torch.float64, device=dev)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    build.check(_kernel()(vals.data_ptr(), dst.data_ptr(), acc.data_ptr(),
                          out.data_ptr(), e, n, build.stream(dev)),
                "scatter_add")
    scatter_add.launches += 1
    return out


scatter_add.launches = 0
