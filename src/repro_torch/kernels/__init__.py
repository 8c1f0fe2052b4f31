"""Kernels written by hand for Hopper, each beside its plain PyTorch version.

  * :func:`graph_kernels.scatter_add` — the graph SpMV's scatter-add
    (``csrc/scatter_add.cu``);
  * :func:`masked_kernels.masked_segment_agg` — the fused mask-weighted
    group-by (``csrc/masked_segment_agg.cu``).

Sources build with ``nvcc`` for ``sm_90a`` at first use (:mod:`.build`).
"""
from .graph_kernels import scatter_add, scatter_add_plain
from .masked_kernels import masked_segment_agg, masked_segment_agg_plain

KERNELS = (scatter_add, masked_segment_agg)


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for k in KERNELS:
        k.launches = 0
