"""The frozen yardstick: the card's peaks and the kernels' logical work.

A kernel's share of its roofline is the least time the card could take for
the operator's logical work (the larger of bytes over the HBM bandwidth
and operations over the peak rate) over the kernel's device time.  The
work counts each logical input read once and each output written once,
from the operator's shapes alone, never from a kernel's tiling or
launches, so the same count bounds any implementation.  Where the work
depends on the data (the documents a mask keeps), it counts what these
inputs need.

Peaks: NVIDIA's H100 SXM data sheet (dense, without sparsity), at the
full 700 W; the run prints the card's power limit beside its shares.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12            # outside the tensor cores


def bound_s(nbytes: float, flops: float = 0.0,
            flops_per_s: float = FP32_FLOPS) -> float:
    """The least time for ``nbytes`` of traffic and ``flops`` operations."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flops_per_s)


def spmv_scatter(edges: int, nodes: int) -> dict:
    """The SpMV's scatter ``y[dst[e]] += vals[e]`` over every edge: reads
    ``vals`` (float32) and ``dst`` (int32) once, writes ``y`` (float32)
    once; one add an edge."""
    return {"bytes": 8 * edges + 4 * nodes, "flops": edges}


def masked_tfidf(docs: int, kept_docs: int, kept_postings: int,
                 kept_terms: int) -> dict:
    """Masked TF-IDF scoring: reads the mask (one byte a document), each
    kept document's posting offset and length (4 + 4 bytes), each kept
    posting's term id and tf (4 + 4 bytes), the weight of each distinct
    term the kept postings name (4 bytes), and writes every document's
    score (4 bytes); a multiply, a divide and an add a kept posting."""
    nbytes = (docs + 4 * docs + 8 * kept_docs + 8 * kept_postings
              + 4 * kept_terms)
    return {"bytes": nbytes, "flops": 3 * kept_postings}
