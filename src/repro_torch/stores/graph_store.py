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

The payload also holds a dst-ordered copy of the edge list (``dst_src``,
``dst_dst``, ``dst_w``: ``src``, ``indices`` and ``weights`` permuted by a
stable sort of ``indices``), built on the payload's device by
:func:`with_dst_order`.  The kernel path's SpMV reads it: the kernel sums
each run of equal ``dst`` in registers and adds it with one atomic, so a
hub node's millions of edges cost a few thousand atomics instead of one
each.  The sort is stable, so every node's contributions keep their CSR
order.  The copy costs 12 bytes an edge (209 MB at 17.4M edges).  The
plain path and the block-skipping SpMV read the CSR order.  A store
declared sharded (:meth:`GraphStore.with_shards`) also carries the
dst-block edge arrays (``blk_*``) that the sharded SpMV of
:mod:`.sharded` reads.

Frontier ops built on the SpMV:

  * :func:`expand_frontier` — k-hop expansion of a weighted frontier;
  * :func:`expand_frontier_blockskip` — the same, skipping edge blocks
    whose sources are all zero in the frontier (a pushed selection);
  * :func:`pagerank`        — damped (optionally personalized) power
    iteration with out-degree normalization; ``skip_first=True`` block-
    skips its first SpMV on a sparse personalization;
  * :func:`triangle_count`  — Σ(A ∘ A²)/6 over the densified adjacency, as
    the reference computes it (one dense n × n product).

A skipped edge would add exactly ``x[src] · w = +0.0``, so the skipping
variants are bitwise equal to the dense ones.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.executor import resolve_device
from ..core.ir import GraphT, ValidationError
from ..core.ledger import register_store_payload
from ..core.tracing import tree_bytes
from ..kernels.graph_kernels import scatter_add, scatter_add_plain


class GraphStore:
    """Host-side CSR container built from an edge list.  ``shards > 1``
    declares it dst-block partitioned over the mesh's ``data`` axis
    (:meth:`with_shards`)."""

    def __init__(self, indptr, indices, src, weights, n_nodes: int,
                 shards: int = 1):
        self.indptr = np.asarray(indptr, np.int32)
        self.indices = np.asarray(indices, np.int32)
        self.src = np.asarray(src, np.int32)
        self.weights = np.asarray(weights, np.float32)
        self.n_nodes = int(n_nodes)
        self.n_edges = int(self.indices.shape[0])
        self.shards = int(shards)
        if self.shards < 1:
            raise ValidationError(f"shards {self.shards} < 1")
        if self.n_nodes % self.shards:
            raise ValidationError(
                f"shards {self.shards} must divide n_nodes {self.n_nodes}; "
                f"pad the node domain (with_shards pads automatically)")
        self.version = 0

    def with_shards(self, shards: int) -> "GraphStore":
        """This graph re-declared as dst-block partitioned over ``shards``
        mesh slices.  The node domain pads up to a shard multiple with
        isolated (edgeless) vertices; ``payload()`` then also carries the
        dst-block edge arrays the block-partitioned SpMV runs on."""
        n = self.n_nodes + (-self.n_nodes) % int(shards)
        indptr = self.indptr
        if n != self.n_nodes:
            pad = np.full(n - self.n_nodes, self.indptr[-1], np.int32)
            indptr = np.concatenate([self.indptr, pad])
        out = GraphStore(indptr, self.indices, self.src, self.weights, n,
                         shards=int(shards))
        out.version = self.version
        return out

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
                      partitioning="block" if self.shards > 1 else None)

    def payload(self, device="cuda") -> dict:
        """The CSR and its dst-ordered edge copy on ``device`` (the card
        unless the caller asks for the CPU), with the dst-block edge arrays
        when sharded, registered in the default memory ledger."""
        dev = resolve_device(device)
        out_deg = np.maximum(np.diff(self.indptr), 1).astype(np.float32)
        out = with_dst_order({
            "indptr": torch.from_numpy(self.indptr).to(dev),
            "indices": torch.from_numpy(self.indices).to(dev),  # dst / edge
            "src": torch.from_numpy(self.src).to(dev),          # src / edge
            "weights": torch.from_numpy(self.weights).to(dev),
            "out_deg": torch.from_numpy(out_deg).to(dev),
        })
        if self.shards > 1:
            out.update({k: torch.from_numpy(v).to(dev)
                        for k, v in self._block_payload().items()})
        return register_store_payload(
            self, out, "graph_store",
            extra=tree_bytes([out[k] for k in DST_ORDER_KEYS]))

    def _block_payload(self) -> dict:
        """Dst-block edge partition for the block-partitioned SpMV: shard
        d owns dst nodes ``[d*n/s, (d+1)*n/s)`` and exactly the edges
        landing there, as ``(s, e_max)`` arrays flattened.  The selection
        is *stable* over the CSR (src-sorted) edge order, so within every
        dst segment the contributions keep the dense SpMV's order.  Pad
        slots carry ``dst_local = n_local`` (out of range: the scatter
        drops them) and weight 0."""
        s, n = self.shards, self.n_nodes
        n_local = n // s
        block = self.indices // n_local                # dst block per edge
        counts = np.bincount(block, minlength=s)
        e_max = max(int(counts.max()) if counts.size else 0, 1)
        src_b = np.zeros((s, e_max), np.int32)
        dstl_b = np.full((s, e_max), n_local, np.int32)    # pad -> dropped
        w_b = np.zeros((s, e_max), np.float32)
        order = np.argsort(block, kind="stable")       # dst-block grouping
        starts = np.concatenate([[0], np.cumsum(counts)])
        for d in range(s):
            sel = order[starts[d]:starts[d + 1]]
            src_b[d, :sel.size] = self.src[sel]
            dstl_b[d, :sel.size] = self.indices[sel] - d * n_local
            w_b[d, :sel.size] = self.weights[sel]
        return {"blk_src": src_b.reshape(-1),
                "blk_dst_local": dstl_b.reshape(-1),
                "blk_weights": w_b.reshape(-1)}


# the keys with_dst_order adds: the port's payload holds them beyond the
# reference's, and the ledger adds their bytes to the predicted ones
DST_ORDER_KEYS = ("dst_src", "dst_dst", "dst_w")


def with_dst_order(g: dict) -> dict:
    """Add the dst-ordered copy of the edge list to the CSR payload ``g``
    (in place; returns ``g``): ``dst_src``, ``dst_dst`` and ``dst_w`` are
    ``src``, ``indices`` and ``weights`` permuted by a stable sort of
    ``indices``, computed on the payload's device."""
    dst, order = torch.sort(g["indices"], stable=True)
    g["dst_src"] = g["src"][order]
    g["dst_dst"] = dst
    g["dst_w"] = g["weights"][order]
    return g


# --------------------------------------------------------------------------
# frontier ops (pure functions over the payload)
# --------------------------------------------------------------------------


def _spmv(g: dict, x: torch.Tensor, use_kernel: bool) -> torch.Tensor:
    """One SpMV: the kernel over the dst-ordered edge copy, or the plain
    scatter over the CSR order.  Both add each node's contributions in
    the same order."""
    n = g["indptr"].shape[0] - 1
    if not use_kernel:
        return scatter_add_plain(x[g["src"]] * g["weights"], g["indices"], n)
    if "dst_dst" not in g:
        raise ValidationError(
            "graph payload lacks the dst-ordered edge copy (dst_src, "
            "dst_dst, dst_w) the scatter kernel reads: build it with "
            "GraphStore.payload, payload_from_numpy or with_dst_order")
    return scatter_add(x[g["dst_src"]] * g["dst_w"], g["dst_dst"], n)


def expand_frontier(g: dict, frontier: torch.Tensor, hops: int = 1,
                    use_kernel: bool = False) -> torch.Tensor:
    """k-hop expansion: propagate frontier weight along edges ``hops``
    times.  One hop is exactly one SpMV."""
    x = frontier.to(torch.float32)
    for _ in range(int(hops)):
        x = _spmv(g, x, use_kernel)
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
             else _spmv(g, xs, use_kernel))
        r = (1.0 - damping) * p0 + damping * y
    return r


def triangle_count(g: dict) -> torch.Tensor:
    """Triangles in the (symmetric, simple) graph: Σ(A ∘ A²)/6 in float32,
    a 0-d tensor.  A is densified from the CSR (1.0 at every ``(src,
    dst)``, repeated edges once) and squared by one dense matmul, as in the
    reference; it holds three n × n float32 buffers at its peak."""
    n = g["indptr"].shape[0] - 1
    src = g["src"]
    a = torch.zeros((n, n), dtype=torch.float32, device=src.device)
    a.index_put_((src.long(), g["indices"].long()),
                 torch.ones((), dtype=torch.float32, device=src.device))
    return (a * (a @ a)).sum() / 6.0
