"""CSR graph store: adjacency + frontier ops.

The port's counterpart of the reference package's ``stores/graph_store.py``.
The store keeps the graph in CSR (``indptr``/``indices`` over source
vertices) plus the per-edge source expansion (``src``), so one sparse
matrix-vector product — the core of every frontier op — is

    y[v] = Σ_{e: dst[e]=v} x[src[e]] · w[e]

a gather followed by a scatter-add.  The scatter is pluggable: the plain
PyTorch scatter (any engine) or the hand-written CUDA kernel
(:func:`repro_torch.kernels.graph_kernels.scatter_add`), which the planner
offers as the ``pallas`` candidate.

Frontier ops built on the SpMV:

  * :func:`expand_frontier` — k-hop expansion of a weighted frontier;
  * :func:`expand_frontier_blockskip` — the same, skipping edge blocks
    whose sources are all zero in the frontier (a pushed selection);
  * :func:`pagerank`        — damped (optionally personalized) power
    iteration with out-degree normalization; ``skip_first=True`` block-
    skips its first SpMV on a sparse personalization.

A skipped edge would add exactly ``x[src] · w = +0.0``, so the skipping
variants are bitwise equal to the dense ones.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..core.executor import resolve_device
from ..core.ir import GraphT, ValidationError
from ..kernels.graph_kernels import scatter_add, scatter_add_plain


class GraphStore:
    """Host-side CSR container built from an edge list."""

    def __init__(self, indptr, indices, src, weights, n_nodes: int):
        self.indptr = np.asarray(indptr, np.int32)
        self.indices = np.asarray(indices, np.int32)
        self.src = np.asarray(src, np.int32)
        self.weights = np.asarray(weights, np.float32)
        self.n_nodes = int(n_nodes)
        self.n_edges = int(self.indices.shape[0])
        self.version = 0

    @classmethod
    def from_edges(cls, src, dst, n_nodes: int, weights=None,
                   symmetric: bool = False) -> "GraphStore":
        """Build CSR from COO edges.  ``symmetric=True`` mirrors every
        edge (undirected graphs)."""
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        if src.shape != dst.shape:
            raise ValidationError(f"edge arrays differ: {src.shape} vs "
                                  f"{dst.shape}")
        w = (np.ones(src.shape, np.float32) if weights is None
             else np.asarray(weights, np.float32))
        if w.shape != src.shape:
            raise ValidationError(
                f"weights shape {w.shape} != edges {src.shape}")
        if symmetric:
            src, dst, w = (np.concatenate([src, dst]),
                           np.concatenate([dst, src]),
                           np.concatenate([w, w]))
        if src.size and (src.min() < 0 or src.max() >= n_nodes
                         or dst.min() < 0 or dst.max() >= n_nodes):
            raise ValidationError("edge endpoint out of range")
        order = np.argsort(src, kind="stable")
        src, dst, w = src[order], dst[order], w[order]
        counts = np.bincount(src, minlength=n_nodes)
        indptr = np.concatenate([[0], np.cumsum(counts)])
        return cls(indptr, dst, src, w, n_nodes)

    @property
    def type(self) -> GraphT:
        return GraphT(self.n_nodes, self.n_edges,
                      weighted=bool((self.weights != 1.0).any()),
                      partitioning=None)

    def payload(self, device="cuda") -> dict:
        """The CSR on ``device`` (the card unless the caller asks for the
        CPU)."""
        dev = resolve_device(device)
        out_deg = np.maximum(np.diff(self.indptr), 1).astype(np.float32)
        return {
            "indptr": torch.from_numpy(self.indptr).to(dev),
            "indices": torch.from_numpy(self.indices).to(dev),  # dst / edge
            "src": torch.from_numpy(self.src).to(dev),          # src / edge
            "weights": torch.from_numpy(self.weights).to(dev),
            "out_deg": torch.from_numpy(out_deg).to(dev),
        }


# --------------------------------------------------------------------------
# frontier ops (pure functions over the payload)
# --------------------------------------------------------------------------


def _spmv(g: dict, x: torch.Tensor, scatter: Callable) -> torch.Tensor:
    n = g["indptr"].shape[0] - 1
    vals = x[g["src"]] * g["weights"]
    return scatter(vals, g["indices"], n)


def _scatter(use_kernel: bool) -> Callable:
    return scatter_add if use_kernel else scatter_add_plain


def expand_frontier(g: dict, frontier: torch.Tensor, hops: int = 1,
                    use_kernel: bool = False) -> torch.Tensor:
    """k-hop expansion: propagate frontier weight along edges ``hops``
    times.  One hop is exactly one SpMV."""
    scatter = _scatter(use_kernel)
    x = frontier.to(torch.float32)
    for _ in range(int(hops)):
        x = _spmv(g, x, scatter)
    return x


def _spmv_blockskip(g: dict, x: torch.Tensor, block: int) -> torch.Tensor:
    """One SpMV over the edge blocks whose source span holds a nonzero of
    ``x`` (edges are CSR-sorted by source, so a prefix sum over ``x != 0``
    tests each block's span in O(1), as in the reference).  The kept edges
    go through the plain scatter in their CSR order; the skipped ones would
    have added exactly +0.0."""
    n = int(g["indptr"].shape[0]) - 1
    src = g["src"]
    e = int(src.shape[0])
    if e == 0:
        return torch.zeros(n, dtype=torch.float32, device=x.device)
    b = max(8, min(int(block), e))
    lo = src[::b].long()
    hi = src[torch.clamp(torch.arange(b - 1, e + b - 1, b, device=src.device),
                         max=e - 1)].long()
    prefix = torch.cat([torch.zeros(1, dtype=torch.int64, device=x.device),
                        torch.cumsum((x != 0).long(), 0)])
    active = (prefix[hi + 1] - prefix[lo]) > 0
    edges = torch.nonzero(active.repeat_interleave(b)[:e]).flatten()
    vals = x[src[edges]] * g["weights"][edges]
    return scatter_add_plain(vals, g["indices"][edges], n)


def expand_frontier_blockskip(g: dict, frontier: torch.Tensor, hops: int = 1,
                              block: int = 2048) -> torch.Tensor:
    """Frontier expansion under a pushed selection: per-hop SpMV with
    edge-block skipping, re-tested every hop as the frontier densifies.
    Bitwise equal to :func:`expand_frontier` (plain scatter)."""
    x = frontier.to(torch.float32)
    for _ in range(int(hops)):
        x = _spmv_blockskip(g, x, block)
    return x


def pagerank(g: dict, iters: int = 10, damping: float = 0.85,
             personalization: Optional[torch.Tensor] = None,
             use_kernel: bool = False, skip_first: bool = False,
             block: int = 2048) -> torch.Tensor:
    """Damped power iteration with out-degree normalization.

    ``skip_first=True`` is the personalization-sparsity pushdown: iteration
    0's SpMV input is the normalized personalization, so with a sparse one
    it runs block-skipping (bitwise equal to the dense iteration); later
    iterations, whose rank vector is dense, stay dense."""
    scatter = _scatter(use_kernel)
    n = g["indptr"].shape[0] - 1
    if personalization is None:
        p0 = torch.full((n,), 1.0 / n, dtype=torch.float32,
                        device=g["out_deg"].device)
    else:
        p = personalization.to(torch.float32)
        p0 = p / torch.clamp(p.sum(), min=1e-30)
    skip = skip_first and personalization is not None
    r = p0
    for it in range(int(iters)):
        xs = r / g["out_deg"]
        y = (_spmv_blockskip(g, xs, block) if it == 0 and skip
             else _spmv(g, xs, scatter))
        r = (1.0 - damping) * p0 + damping * y
    return r
