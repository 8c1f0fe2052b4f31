"""Kernels written by hand for Hopper, each beside its plain PyTorch version.

  * :func:`graph_kernels.scatter_add` — the graph SpMV's scatter-add
    (``csrc/scatter_add.cu``);
  * :func:`masked_kernels.masked_segment_agg` — the fused mask-weighted
    group-by (``csrc/masked_segment_agg.cu``);
  * :func:`masked_kernels.masked_tfidf` — masked TF-IDF scoring under a
    pushed doc mask (``csrc/masked_tfidf.cu``);
  * :func:`masked_kernels.join_probe` — equi-join probe against a small
    unique-key build side (``csrc/join_probe.cu``);
  * :func:`masked_kernels.compact_prefix` — prefix compaction of stacked
    columns (``csrc/compact_prefix.cu``).

Sources build with ``nvcc`` for ``sm_90a`` at first use (:mod:`.build`).
"""
from .graph_kernels import scatter_add, scatter_add_plain
from .masked_kernels import (compact_prefix, compact_prefix_plain, join_probe,
                             join_probe_plain, masked_segment_agg,
                             masked_segment_agg_plain, masked_tfidf,
                             masked_tfidf_plain)

KERNELS = (scatter_add, masked_segment_agg, masked_tfidf, join_probe,
           compact_prefix)


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for k in KERNELS:
        k.launches = 0


def launches() -> dict:
    """Every kernel's launch count, by name."""
    return {k.__name__: k.launches for k in KERNELS}
