"""Learned cost model (paper §6).

The paper trains, per physical operator, a linear regression over the
degree-2 polynomial expansion of raw features (Eq. 2), estimates a candidate
sub-plan's cost as the **sum** of its operators' costs (Eq. 1 — valid because
AWESOME applies no task parallelism; same for us, a candidate chain executes
sequentially inside the jitted step), and at run time — once input sizes are
known — scores each virtual node's candidates and selects the argmin (§6.3).

Raw features here are the TPU analogues of the paper's table sizes / node
counts / keyword-list sizes: token counts, operand widths, and the three
roofline terms (per-device FLOPs / HBM bytes / interconnect bytes scaled by
the hardware peaks from the system catalog).  Before any calibration the
model falls back to the *analytic* roofline sum — which is itself an instance
of Eq. 2 with known weights (w=1 on the three roofline features) — so the
planner is always total.  Calibration (``calibrate.py``) refits the weights
from measured timings, exactly the paper's §6.2 loop.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from .ir import (CorpusT, GraphT, ScalarT, SystemCatalog, TableT, TensorT,
                 TupleT, dtype_bytes)
from .physical import PhysPlan, Candidate

# --------------------------------------------------------------------------
# Raw feature extraction (paper §6.2 "Operators and features")
# --------------------------------------------------------------------------

FEATURE_NAMES = ("f_compute", "f_memory", "f_network", "tokens_m", "width_k")

_ESTIMATORS: dict = {}


def estimator(*impls):
    def deco(fn):
        for i in impls:
            _ESTIMATORS[i] = fn
        return fn
    return deco


def _tensor_like(t):
    if isinstance(t, TupleT):
        return _tensor_like(t.elems[0])
    return t if isinstance(t, TensorT) else None


def _tokens(t):
    tt = _tensor_like(t)
    if tt is None:
        return 1
    n = 1
    for name in ("batch", "seq"):
        if tt.has_dim(name):
            n *= tt.dim(name)
    return n


def _sum_bytes(types):
    out = 0
    for t in types:
        if isinstance(t, TupleT):
            out += _sum_bytes(t.elems)
        elif isinstance(t, (TensorT, TableT, GraphT, CorpusT)):
            out += t.bytesize()
    return out


@dataclass
class OpCost:
    """Raw flops / bytes / collective-bytes for one op instance, device-local."""

    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0


def _proj_cost(in_t, d_out_total, syscat, tp_sharded=True):
    t = _tensor_like(in_t)
    toks = _tokens(t)
    d_in = t.shape[-1] if t else 1
    dp = syscat.axis_size("data") * syscat.axis_size("pod")
    tp = syscat.axis_size("model") if tp_sharded else 1
    flops = 2.0 * toks * d_in * d_out_total / (dp * tp)
    bts = (toks * d_in * dtype_bytes(t.dtype) / dp
           + d_in * d_out_total * 4 / tp
           + toks * d_out_total * dtype_bytes(t.dtype) / (dp * tp))
    return OpCost(flops, bts, 0.0)


@estimator("q_proj_xla", "k_proj_xla", "v_proj_xla")
def _e_proj(in_types, attrs, syscat):
    d_out = attrs["heads"] * attrs["head_dim"]
    return _proj_cost(in_types[0], d_out, syscat)


@estimator("qkv_proj_fused")
def _e_qkv(in_types, attrs, syscat):
    d_out = (attrs["heads"] + 2 * attrs["kv_heads"]) * attrs["head_dim"]
    c = _proj_cost(in_types[0], d_out, syscat)
    # fused: one pass over the activations instead of three
    t = _tensor_like(in_types[0])
    c.bytes -= 2 * _tokens(t) * t.shape[-1] * dtype_bytes(t.dtype) / (
        syscat.axis_size("data") * syscat.axis_size("pod"))
    return c


@estimator("out_proj_xla")
def _e_outp(in_types, attrs, syscat):
    t = _tensor_like(in_types[0])
    d_in = t.shape[-1] * t.shape[-2] if t.rank >= 2 else t.shape[-1]
    return _proj_cost(in_types[0], attrs["embed"], syscat)


def _attn_dims(in_types, attrs):
    t = _tensor_like(in_types[0])
    b = t.dim("batch") if t.has_dim("batch") else 1
    s = t.dim("seq") if t.has_dim("seq") else 1
    return b, s, attrs["heads"], attrs["head_dim"]


@estimator("sdpa_xla")
def _e_sdpa(in_types, attrs, syscat):
    b, s, h, d = _attn_dims(in_types, attrs)
    kv = s if "kv_seq" not in attrs else attrs["kv_seq"]
    causal = 0.5 if attrs.get("causal", True) and kv == s else 1.0
    dp = syscat.axis_size("data") * syscat.axis_size("pod")
    tp = syscat.axis_size("model")
    flops = 4.0 * b * s * kv * h * d * causal / (dp * tp)
    # full materialized scores: S×KV logits written+read in fp32
    bts = (b * h * s * kv * 8 * causal / (dp * tp)
           + 2 * b * s * h * d * 2 / (dp * tp)
           + 2 * b * kv * attrs["kv_heads"] * d * 2 / (dp * tp))
    return OpCost(flops, bts, 0.0)


@estimator("sdpa_banded_xla")
def _e_banded(in_types, attrs, syscat):
    b, s, h, d = _attn_dims(in_types, attrs)
    w = min(attrs.get("window") or s, s)
    dp = syscat.axis_size("data") * syscat.axis_size("pod")
    tp = syscat.axis_size("model")
    flops = 4.0 * b * s * w * h * d / (dp * tp)
    bts = (b * h * s * w * 8 / (dp * tp) + 4 * b * s * h * d * 2 / (dp * tp))
    return OpCost(flops, bts, 0.0)


@estimator("attn_flash_pallas")
def _e_flash(in_types, attrs, syscat):
    c = _e_sdpa(in_types, attrs, syscat)
    # online softmax: no materialized S×KV logits; only q/k/v/o HBM traffic
    b, s, h, d = _attn_dims(in_types, attrs)
    kv = s if "kv_seq" not in attrs else attrs["kv_seq"]
    dp = syscat.axis_size("data") * syscat.axis_size("pod")
    tp = syscat.axis_size("model")
    c.bytes = (2 * b * s * h * d * 2 + 2 * b * kv * attrs["kv_heads"] * d * 2) \
        / (dp * tp)
    return c


@estimator("mlp_fused_xla", "ffn_up_xla", "ffn_gate_xla", "ffn_down_xla")
def _e_mlp(in_types, attrs, syscat):
    t = _tensor_like(in_types[0])
    toks = _tokens(t)
    d = t.shape[-1]
    f = attrs.get("ffn", attrs.get("embed", d))
    mult = 3.0 if "mlp_fused" in str(attrs.get("pattern", "")) or \
        attrs.get("gated", False) else 1.0
    dp = syscat.axis_size("data") * syscat.axis_size("pod")
    tp = syscat.axis_size("model")
    flops = 2.0 * toks * d * f * mult / (dp * tp)
    bts = (toks * d * dtype_bytes(t.dtype) / dp + d * f * mult * 4 / tp)
    return OpCost(flops, bts, 0.0)


@estimator("moe_dense_onehot")
def _e_moe_dense(in_types, attrs, syscat):
    t = _tensor_like(in_types[0])
    toks = _tokens(t)
    d = t.shape[-1]
    f, e, k = attrs["ffn"], attrs["experts"], attrs["top_k"]
    cf = attrs.get("capacity_factor", 2.0)
    cap = max(1, int(toks * k * cf / e))
    dp = syscat.axis_size("data") * syscat.axis_size("pod")
    tp = syscat.axis_size("model")
    expert_flops = 2.0 * e * cap * 3 * d * f / (dp * tp)
    dispatch_flops = 2.0 * 2 * toks * e * cap * 1 / dp  # dispatch+combine einsum
    # all-to-all: tokens cross the model axis to reach their experts
    a2a = toks * d * 2 * 2 / dp
    return OpCost(expert_flops + dispatch_flops,
                  (toks * d * 2 + e * 3 * d * f * 4 / tp) / dp, a2a)


@estimator("moe_dropping")
def _e_moe_drop(in_types, attrs, syscat):
    # capacity-1.0 dispatch: overflow tokens drop, halving expert flops vs the
    # cf=2.0 dense dispatch (a speed/quality tradeoff the config must opt into)
    a = dict(attrs)
    a["capacity_factor"] = attrs.get("capacity_factor_dropped", 1.0)
    return _e_moe_dense(in_types, a, syscat)


@estimator("moe_gmm_pallas")
def _e_moe_gmm(in_types, attrs, syscat):
    t = _tensor_like(in_types[0])
    toks = _tokens(t)
    d = t.shape[-1]
    f, e, k = attrs["ffn"], attrs["experts"], attrs["top_k"]
    dp = syscat.axis_size("data") * syscat.axis_size("pod")
    tp = syscat.axis_size("model")
    # dropless grouped matmul: exactly tokens·k expert rows, no padding
    flops = 2.0 * toks * k * 3 * d * f / (dp * tp)
    a2a = toks * d * 2 * 2 / dp
    return OpCost(flops, (toks * d * 2 + e * 3 * d * f * 4 / tp) / dp, a2a)


@estimator("wkv6_scan_xla", "wkv6_pallas", "ssd_chunked_xla", "ssd_pallas")
def _e_recurrent(in_types, attrs, syscat):
    t = _tensor_like(in_types[0])
    toks = _tokens(t)
    h, d = attrs["heads"], attrs["head_dim"]
    n = attrs.get("state", d)
    dp = syscat.axis_size("data") * syscat.axis_size("pod")
    tp = syscat.axis_size("model")
    flops = 2.0 * toks * h * d * n * 3 / (dp * tp)
    bts = toks * h * d * 2 * 4 / (dp * tp)
    if attrs.get("_impl_pallas"):
        bts /= 2  # fused state in VMEM
    return OpCost(flops, bts, 0.0)


@estimator("embed_gather")
def _e_embed(in_types, attrs, syscat):
    t = _tensor_like(in_types[0])
    toks = _tokens(t) or t.size()
    dp = syscat.axis_size("data") * syscat.axis_size("pod")
    return OpCost(0.0, toks * attrs["embed"] * 2 / dp, 0.0)


@estimator("unembed_matmul")
def _e_unembed(in_types, attrs, syscat):
    return _proj_cost(in_types[0], attrs["vocab"], syscat)


# -- tri-store operators (raw features = the paper's table sizes / node
#    counts / keyword-list sizes, here rows / edges / postings).  Work is
#    priced on the **expected count** (the type's cardinality estimate, fed
#    by hints and observed-selectivity feedback), while streaming bytes are
#    priced on capacity — a masked engine still reads every physical row,
#    which is exactly why compact-then-dense can out-price masked-dense.


def _expected_rows(t) -> float:
    if isinstance(t, TableT):
        return float(t.expected_rows())
    return 1.0


def _capacity_rows(t) -> float:
    return float(t.rows) if isinstance(t, TableT) else 1.0


@estimator("rel_scan_col", "rel_filter_col", "col_tensor_rel")
def _e_rel_stream(in_types, attrs, syscat):
    t = in_types[0]
    b = _sum_bytes([t])
    return OpCost(_expected_rows(t), 2.0 * b, 0.0)


@estimator("rel_hash_join")
def _e_rel_join(in_types, attrs, syscat):
    lb, rb = _sum_bytes([in_types[0]]), _sum_bytes([in_types[1]])
    lr = _expected_rows(in_types[0])
    rr = _capacity_rows(in_types[1])
    # build (sort right) + probe (binary search per expected left row)
    logr = max(1.0, math.log2(max(rr, 2)))
    return OpCost(rr * logr + lr * logr, 2.0 * (lb + rb), 0.0)


@estimator("rel_join_probe_pallas")
def _e_rel_join_probe(in_types, attrs, syscat):
    """MXU key-equality probe: the whole (expected-count-bounded) build
    side against every probe block, one fused contraction — no sort.  The
    one-hot compare is MXU-shaped, so its flops are credited against the
    matrix unit; the candidate gate keeps the build bounded."""
    lb, rb = _sum_bytes([in_types[0]]), _sum_bytes([in_types[1]])
    lr = _capacity_rows(in_types[0])
    # the one-hot is as wide as the build side's *physical capacity* (the
    # VMEM-resident block); the gate keeps it bounded, the expected count
    # keeps the candidate from being offered against fat builds at all
    bw = float(attrs.get("build_rows", _capacity_rows(in_types[1])))
    mxu_credit = 64.0            # systolic contraction vs scalar compares
    blocks = max(1.0, lr / 512.0)
    return OpCost(lr * max(bw, 1.0) / mxu_credit + blocks * 256.0,
                  1.5 * (lb + rb), 0.0)


@estimator("bounded_join_col")
def _e_bounded_join(in_types, attrs, syscat):
    lb, rb = _sum_bytes([in_types[0]]), _sum_bytes([in_types[1]])
    lr = _expected_rows(in_types[0])
    rr = _capacity_rows(in_types[1])
    cap = float(attrs.get("capacity", lr))
    logr = max(1.0, math.log2(max(rr, 2)))
    # build sort + two binary searches per probe row + per-slot owner lookup
    out_b = cap * 4.0 * max(1, len(getattr(in_types[0], "columns", ())) + 1)
    return OpCost(rr * logr + 2.0 * lr * logr + cap * logr,
                  2.0 * (lb + rb) + out_b, 0.0)


@estimator("compact_prefix_col", "compact_prefix_pallas")
def _e_compact(in_types, attrs, syscat):
    """One full-capacity pass (the prefix sum over validity) plus a
    capacity-bounded gather/scatter write: what compact *costs* up front,
    repaid by every downstream op running at the narrowed capacity."""
    t = in_types[0]
    rows = _capacity_rows(t)
    cap = float(attrs.get("capacity", rows))
    ncols = max(1, len(getattr(t, "columns", ())))
    out_b = cap * 4.0 * (ncols + 1)
    flops = rows + cap * ncols
    if attrs.get("_impl_pallas"):
        # one-hot scatter: row-block x out-block matmul work instead of a
        # gather, partially credited to the MXU
        flops = rows + rows * cap / 64.0
    return OpCost(flops, _sum_bytes([t]) + 2.0 * out_b, 0.0)


@estimator("rel_group_agg_col")
def _e_rel_group(in_types, attrs, syscat):
    t = in_types[0]
    n_aggs = max(1, len(attrs.get("aggs", ())))
    out_b = int(attrs.get("num_groups", 1)) * 4 * (n_aggs + 1)
    return OpCost(_expected_rows(t) * n_aggs,
                  2.0 * _sum_bytes([t]) + out_b, 0.0)


def _graph_cost(g, passes, syscat, pallas=False):
    e, n = int(g.edges), int(g.nodes)
    flops = 2.0 * e * passes
    # CSR pass: per-edge (src gather + dst scatter) + per-node frontier r/w
    bts = passes * (e * 12.0 + n * 8.0)
    if pallas:
        bts /= 2  # frontier accumulator stays VMEM-resident per node block
    return OpCost(flops, bts, 0.0)


@estimator("graph_expand_csr", "graph_expand_pallas")
def _e_graph_expand(in_types, attrs, syscat):
    g = in_types[0]
    if not isinstance(g, GraphT):
        return OpCost(0.0, _sum_bytes(in_types), 0.0)
    return _graph_cost(g, int(attrs.get("hops", 1)), syscat,
                       pallas=attrs.get("_impl_pallas", False))


@estimator("graph_pagerank_csr", "graph_pagerank_pallas")
def _e_graph_pagerank(in_types, attrs, syscat):
    g = in_types[0]
    if not isinstance(g, GraphT):
        return OpCost(0.0, _sum_bytes(in_types), 0.0)
    return _graph_cost(g, int(attrs.get("iters", 10)), syscat,
                       pallas=attrs.get("_impl_pallas", False))


@estimator("graph_tricount_csr")
def _e_graph_tricount(in_types, attrs, syscat):
    g = in_types[0]
    if not isinstance(g, GraphT):
        return OpCost(0.0, _sum_bytes(in_types), 0.0)
    n, e = int(g.nodes), int(g.edges)
    # A·A over the densified adjacency (small-graph realization)
    return OpCost(2.0 * n * n * max(1, e // max(n, 1)), n * n * 8.0, 0.0)


@estimator("text_topk_inv")
def _e_text_topk(in_types, attrs, syscat):
    c = in_types[0]
    if not isinstance(c, CorpusT):
        return OpCost(0.0, _sum_bytes(in_types), 0.0)
    # one pass over the postings + a top-k over doc scores
    k = int(attrs.get("k", 10))
    return OpCost(2.0 * c.postings + c.docs * max(1.0, math.log2(max(k, 2))),
                  float(c.bytesize()) + c.docs * 4.0, 0.0)


@estimator("text_scores_inv")
def _e_text_scores(in_types, attrs, syscat):
    c = in_types[0]
    if not isinstance(c, CorpusT):
        return OpCost(0.0, _sum_bytes(in_types), 0.0)
    return OpCost(2.0 * c.postings, float(c.bytesize()) + c.docs * 4.0, 0.0)


@estimator("masked_topk_xla")
def _e_masked_topk(in_types, attrs, syscat):
    t = _tensor_like(in_types[0])
    n = int(t.shape[0]) if t is not None and t.rank else 1
    k = int(attrs.get("k", 10))
    return OpCost(n * max(1.0, math.log2(max(k, 2))), n * 9.0, 0.0)


@estimator("sel_mask_rel")
def _e_sel_mask(in_types, attrs, syscat):
    t = in_types[0]
    rows = t.rows if isinstance(t, TableT) else 1
    return OpCost(float(rows), rows * 5.0 + int(attrs.get("size", 1)), 0.0)


# expected-selectivity pricing (pushdown's decision variable): masked ops
# carry the rewrite pass's estimate as an IR attr, and the skip candidates
# are credited exactly the postings/edges they are expected not to touch —
# plus a per-block control overhead, so at selectivity ~1.0 the dense
# candidate prices lower and the planner keeps the unpushed execution.

TEXT_SKIP_BLOCK = 8192       # postings per block-skip scan step
GRAPH_SKIP_BLOCK = 2048      # edges per block-skip SpMV step
_BLOCK_OVERHEAD_FLOPS = 256.0


@estimator("text_topk_skip_inv", "text_topk_masked_pallas")
def _e_text_topk_skip(in_types, attrs, syscat):
    c = in_types[0]
    if not isinstance(c, CorpusT):
        return OpCost(0.0, _sum_bytes(in_types), 0.0)
    s = float(attrs.get("selectivity", 1.0))
    k = int(attrs.get("k", 10))
    blocks = max(1.0, c.postings / TEXT_SKIP_BLOCK)
    flops = (2.0 * c.postings * s + blocks * _BLOCK_OVERHEAD_FLOPS
             + c.docs * max(1.0, math.log2(max(k, 2))))
    bts = float(c.bytesize()) * s + c.docs * 9.0 + blocks * 64.0
    if attrs.get("_impl_pallas"):
        bts /= 2     # doc-block accumulator stays VMEM-resident
    return OpCost(flops, bts, 0.0)


@estimator("graph_pagerank_skip")
def _e_graph_pagerank_skip(in_types, attrs, syscat):
    """First-iteration block-skipping PageRank: iteration 0 touches only
    the edge blocks the sparse personalization activates; the remaining
    iterations (dense rank vector) cost the full CSR pass."""
    g = in_types[0]
    if not isinstance(g, GraphT):
        return OpCost(0.0, _sum_bytes(in_types), 0.0)
    s = float(attrs.get("personalization_selectivity", 1.0))
    iters = max(1, int(attrs.get("iters", 10)))
    per_pass = _graph_cost(g, 1, syscat)
    blocks = max(1.0, int(g.edges) / GRAPH_SKIP_BLOCK)
    eff = (iters - 1) + min(1.0, s)
    return OpCost(per_pass.flops * eff + blocks * _BLOCK_OVERHEAD_FLOPS
                  + 2.0 * int(g.nodes),
                  per_pass.bytes * eff + int(g.nodes) * 8.0 + blocks * 64.0,
                  0.0)


@estimator("graph_expand_skip")
def _e_graph_expand_skip(in_types, attrs, syscat):
    g = in_types[0]
    if not isinstance(g, GraphT):
        return OpCost(0.0, _sum_bytes(in_types), 0.0)
    s = float(attrs.get("frontier_selectivity", 1.0))
    hops = int(attrs.get("hops", 1))
    e, n = int(g.edges), int(g.nodes)
    deg = max(1.0, e / max(n, 1))
    # the frontier densifies by ~avg-degree per hop: later hops skip less
    eff = sum(min(1.0, s * deg ** h) for h in range(hops)) / max(hops, 1)
    base = _graph_cost(g, hops, syscat)
    blocks = max(1.0, e / GRAPH_SKIP_BLOCK)
    return OpCost(base.flops * eff + hops * (blocks * _BLOCK_OVERHEAD_FLOPS
                                             + 2.0 * n),
                  base.bytes * eff + hops * (n * 8.0 + blocks * 64.0), 0.0)


# fused store chains: Eq. 1 over the recorded steps (each step priced by
# its per-op estimator on the recorded input types), minus the interior
# table reads the fusion avoids — interior steps stream the mask, not the
# full relation, so each non-head step is charged its output instead of a
# second full input pass.

_STEP_IMPL = {"rel_scan": "rel_scan_col", "rel_filter": "rel_filter_col",
              "compact": "compact_prefix_col",
              "rel_join": "rel_hash_join",
              "bounded_join": "bounded_join_col",
              "rel_group_agg": "rel_group_agg_col"}


@estimator("rel_fused_col", "rel_fused_agg_pallas")
def _e_rel_fused(in_types, attrs, syscat):
    total = OpCost()
    prev_t = None
    for op, step_attrs, srcs, out_t in attrs.get("chain", ()):
        step_ins = [prev_t if s == "prev" else
                    (in_types[int(s)] if int(s) < len(in_types) else None)
                    for s in srcs]
        c = op_cost(_STEP_IMPL.get(op, op), step_ins, step_attrs, syscat)
        if prev_t is not None:
            # fused: the interior input was just produced in-engine; credit
            # one full-relation read per non-head step
            c.bytes = max(0.0, c.bytes - _sum_bytes([prev_t]))
        total.flops += c.flops
        total.bytes += c.bytes
        total.coll_bytes += c.coll_bytes
        prev_t = out_t
    if attrs.get("_impl_pallas"):
        total.bytes *= 0.75   # masked one-hot agg keeps partials in VMEM
    return total


@estimator("xfer_pin")
def _e_xfer_pin(in_types, attrs, syscat):
    # stays device-resident: one HBM pass at most (often free after fusion)
    return OpCost(0.0, _sum_bytes(in_types), 0.0)


@estimator("xfer_spill")
def _e_xfer_spill(in_types, attrs, syscat):
    # materialize through the host: device->host->device round trip, priced
    # on the interconnect (the cross-engine wire of the paper's tri-store)
    b = _sum_bytes(in_types)
    return OpCost(0.0, 2.0 * b, 2.0 * b)


@estimator("xfer_local")
def _e_xfer_local(in_types, attrs, syscat):
    # layout-compatible handoff between sharded store ops: no wire bytes
    return OpCost(0.0, 0.0, 0.0)


@estimator("xfer_replicate")
def _e_xfer_replicate(in_types, attrs, syscat):
    # all-gather a data-axis-partitioned value: every device receives the
    # (n-1)/n of the value it does not already hold
    n = max(1, syscat.axis_size("data"))
    b = float(attrs.get("est_bytes", _sum_bytes(in_types) * (n - 1) / n))
    return OpCost(0.0, b, b)


@estimator("xfer_repartition")
def _e_xfer_repartition(in_types, attrs, syscat):
    # all-to-all reshuffle onto the join key's owner shards: each device
    # keeps 1/n of its 1/n slice and sends the rest — (n-1)/n^2 of the
    # global value crosses the wire per device
    n = max(1, syscat.axis_size("data"))
    b = float(attrs.get("est_bytes",
                        _sum_bytes(in_types) * (n - 1) / (n * n)))
    return OpCost(0.0, b, b)


def op_cost(impl: str, in_types, attrs, syscat: SystemCatalog) -> OpCost:
    fn = _ESTIMATORS.get(impl)
    if fn is None:
        return OpCost(0.0, _sum_bytes(in_types) /
                      max(1, syscat.axis_size("data") * syscat.axis_size("pod")),
                      0.0)
    a = dict(attrs)
    if impl.endswith("_pallas"):
        a["_impl_pallas"] = True
    c = fn(in_types, a, syscat)
    dist = attrs.get("dist")
    if dist and not impl.startswith("xfer"):
        # shard-local execution (shard_stores): compute and memory divide
        # over the data axis; the broadcast join additionally prices the
        # build side's all-gather, psum-style aggregates a tree reduction
        n = max(1, syscat.axis_size("data"))
        coll = c.coll_bytes
        if dist == "broadcast":
            coll += float(attrs.get("bcast_bytes", 0.0))
        elif dist in ("psum", "doc"):
            coll += c.bytes / max(n, 1) * math.log2(max(n, 2))
        return OpCost(c.flops / n, c.bytes / n, coll)
    return c


def raw_features(impl, in_types, attrs, syscat) -> dict:
    """The paper's raw feature vector f1..fn for one operator instance."""
    c = op_cost(impl, in_types, attrs, syscat)
    hw = syscat.hardware
    t = _tensor_like(in_types[0]) if in_types else None
    return {
        "f_compute": c.flops / hw.peak_flops,
        "f_memory": c.bytes / hw.hbm_bw,
        "f_network": c.coll_bytes / hw.ici_bw,
        "tokens_m": (_tokens(t) if t is not None else 0) / 1e6,
        "width_k": (t.shape[-1] if t is not None and t.rank else 0) / 1e3,
    }


# --------------------------------------------------------------------------
# Eq. 2 — degree-2 polynomial regression per operator
# --------------------------------------------------------------------------


def poly2(x: np.ndarray) -> np.ndarray:
    """[1, xi..., xi^2..., xi*xj...] exactly as Eq. 2."""
    n = x.shape[-1]
    feats = [np.ones(x.shape[:-1] + (1,)), x, x * x]
    cross = [x[..., i:i + 1] * x[..., j:j + 1]
             for i in range(n) for j in range(i + 1, n)]
    return np.concatenate(feats + cross, axis=-1)


@dataclass
class CostModel:
    """Per-operator learned weights; falls back to analytic roofline."""

    weights: dict = field(default_factory=dict)  # impl -> np.ndarray
    feature_names: tuple = FEATURE_NAMES

    # -- Eq. 2 -------------------------------------------------------------
    def op_seconds(self, impl, in_types, attrs, syscat) -> float:
        f = raw_features(impl, in_types, attrs, syscat)
        if impl in self.weights:
            x = np.array([f[k] for k in self.feature_names])
            return float(poly2(x[None, :])[0] @ self.weights[impl])
        # analytic fallback: roofline additive model (known-weight Eq. 2)
        return f["f_compute"] + f["f_memory"] + f["f_network"]

    # -- Eq. 1 -------------------------------------------------------------
    def chain_seconds(self, impls, in_types, attrs, syscat) -> float:
        return sum(self.op_seconds(i, in_types, attrs, syscat) for i in impls)

    # -- §6.2 fit ------------------------------------------------------------
    def fit(self, samples, ridge: float = 1e-8):
        """samples: iterable of (impl, feature-dict, measured_seconds)."""
        by_impl: dict = {}
        for impl, f, t in samples:
            by_impl.setdefault(impl, []).append((f, t))
        for impl, rows in by_impl.items():
            X = np.stack([np.array([f[k] for k in self.feature_names])
                          for f, _ in rows])
            y = np.array([t for _, t in rows])
            P = poly2(X)
            A = P.T @ P + ridge * np.eye(P.shape[1])
            self.weights[impl] = np.linalg.solve(A, P.T @ y)
        return self

    def predict_samples(self, samples):
        out = []
        for impl, f, _ in samples:
            x = np.array([f[k] for k in self.feature_names])
            if impl in self.weights:
                out.append(float(poly2(x[None, :])[0] @ self.weights[impl]))
            else:
                out.append(f["f_compute"] + f["f_memory"] + f["f_network"])
        return np.array(out)

    # -- identity ------------------------------------------------------------
    def fingerprint(self) -> str:
        """Content hash of the learned weights ("analytic" before any
        calibration).  Part of the plan-cache key: refitted weights change
        candidate selection, so they must invalidate cached plans."""
        if not self.weights:
            return "analytic"
        import hashlib
        h = hashlib.sha256()
        for impl in sorted(self.weights):
            h.update(impl.encode())
            h.update(np.asarray(self.weights[impl], np.float64).tobytes())
        return h.hexdigest()

    # -- persistence ---------------------------------------------------------
    def save(self, path):
        with open(path, "w") as fh:
            json.dump({k: v.tolist() for k, v in self.weights.items()}, fh)

    @classmethod
    def load(cls, path):
        with open(path) as fh:
            w = json.load(fh)
        return cls({k: np.array(v) for k, v in w.items()})


# --------------------------------------------------------------------------
# §6.3 — run-time candidate selection at each virtual node
# --------------------------------------------------------------------------


def select_candidates(pp: PhysPlan, syscat: SystemCatalog,
                      model: Optional[CostModel] = None,
                      engines=None, allow_pallas=None) -> tuple:
    """Score every virtual node's candidates (Eq. 1 over the chain) and pick
    the argmin.  ``engines`` names the engines whose candidates are eligible
    (registry names; the legacy ``allow_pallas`` boolean still maps through).
    Returns (choices dict incl. nested subplans, report list)."""
    from .engines import resolve_engines
    engines = resolve_engines(engines, allow_pallas=allow_pallas)
    model = model or CostModel()
    choices: dict = {}
    report = []

    def visit(plan: PhysPlan):
        for n in plan.topo():
            if n.subplan is not None:
                visit(n.subplan)
            if not n.virtual:
                continue
            in_types = [plan.types.get(i) or plan.inputs.get(i)
                        for i in n.inputs]
            scored = []
            for cand in plan.pm[n.id]:
                if cand.requires_backend not in engines:
                    continue
                sec = model.chain_seconds(cand.impls, in_types, n.attrs, syscat)
                scored.append((sec, cand))
            if not scored:
                raise RuntimeError(f"no available candidate for {n.id}")
            scored.sort(key=lambda x: x[0])
            choices[n.id] = scored[0][1]
            report.append({
                "virtual": n.id,
                "pattern": n.attrs.get("pattern"),
                "chosen": scored[0][1].name,
                "engine": scored[0][1].requires_backend,
                "costs": {c.name: s for s, c in scored},
            })

    visit(pp)
    return choices, report


# --------------------------------------------------------------------------
# Resident-byte prediction (ledger predicted-vs-actual)
# --------------------------------------------------------------------------


def predicted_resident_bytes(t) -> Optional[int]:
    """Cost-model expectation for the *device-resident* bytes a store holds
    for a value of type ``t`` — ``bytesize()`` (capacity-derived: padded
    columns + validity, CSR arrays, COO postings) plus the shard-local
    block payloads a partitioned store keeps alongside the replicated
    structure.  The MemoryLedger compares this against the measured
    ``tree_bytes`` of the actual payload; the tri-store benchmark enforces
    2x agreement."""
    base = t.bytesize() if hasattr(t, "bytesize") else None
    if base is None:
        return None
    extra = 0
    if isinstance(t, GraphT) and getattr(t, "partitioning", None):
        # dst-block payload: blk_src + blk_dst_local (int32) + blk_weights
        # (f32), each padded to the max per-block edge count ~ edges total
        extra = t.edges * 12
    elif isinstance(t, CorpusT) and getattr(t, "partitioning", None):
        # doc-block payload: blk_doc_local + blk_term_ids (int32) + blk_tf
        # (f32) padded per partition ~ postings total
        extra = t.postings * 12
    return int(base + extra)
