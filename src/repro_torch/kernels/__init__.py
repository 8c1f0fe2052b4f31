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
    columns (``csrc/compact_prefix.cu``);
  * :func:`flash_attention.flash_attention` (and its heads-major entry
    ``flash_attention_hmajor``) — blocked online-softmax attention, the
    serving prefill's ``attn_flash_pallas`` (``csrc/flash_attention.cu``).
    The package attribute ``flash_attention`` stays the module;
  * :func:`wkv6.wkv6` — the RWKV6 WKV recurrence, rwkv6-3b's
    ``wkv6_pallas`` (``csrc/wkv6.cu``);
  * :func:`ssd.ssd` — the Mamba2 SSD scan, zamba2-7b's ``ssd_pallas``
    (``csrc/ssd.cu``).  The package attributes ``wkv6`` and ``ssd`` stay
    the modules;
  * :func:`moe_gmm.gmm` — the grouped expert matmul, the MoE family's
    ``moe_gmm_pallas`` (``csrc/moe_gmm.cu``); the package attribute
    ``moe_gmm`` stays the module.

Sources build with ``nvcc`` for ``sm_90a`` at first use (:mod:`.build`).
"""
from . import flash_attention as _flash_attention
from .flash_attention import flash_attention_hmajor, flash_attention_plain
from .graph_kernels import scatter_add, scatter_add_plain
from .masked_kernels import (compact_prefix, compact_prefix_plain, join_probe,
                             join_probe_plain, masked_segment_agg,
                             masked_segment_agg_plain, masked_tfidf,
                             masked_tfidf_plain)
from . import moe_gmm as _moe_gmm
from . import ssd as _ssd
from . import wkv6 as _wkv6

KERNELS = (scatter_add, masked_segment_agg, masked_tfidf, join_probe,
           compact_prefix, _flash_attention.flash_attention, _wkv6.wkv6,
           _ssd.ssd, _moe_gmm.gmm)


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for k in KERNELS:
        k.launches = 0


def launches() -> dict:
    """Every kernel's launch count, by name."""
    return {k.__name__: k.launches for k in KERNELS}
