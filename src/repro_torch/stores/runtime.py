"""Executor implementations for the tri-store physical operators.

The port's counterpart of the reference package's ``stores/runtime.py``:
importing this module registers the relational / graph / text impls and
the cross-engine transfers under the port's engine registry.  Every
relational value is a :class:`~repro_torch.stores.bounded.BoundedRel`
whose ``count`` stays on the device.

The relational ops are pure *step functions* shared by the per-op impls
and the fused-chain impls (``rel_fused_*``): a fused chain runs the same
steps in the same order.  The ``pallas`` impls are the kernel slot: they
call the hand-written CUDA kernels of :mod:`repro_torch.kernels`, which
take their plain PyTorch version only for CPU tensors.

On a mesh (``ExecContext.mesh``, a
:class:`~repro_torch.launch.mesh.DataMesh`) the plain impls of a node the
planner stamped with a ``dist`` attr run the sharded operators of
:mod:`.sharded`, as the reference's do: a filter's observed count, the
group-by, the broadcast and partitioned joins, expansion, PageRank and the
text top-k.  Values stay global, so a node whose shapes do not divide the
mesh runs dense.  The kernel impls ignore ``dist`` and run dense on every
rank, as the reference's do.
"""
from __future__ import annotations

import torch

from ..core.engines import get_engine
from ..core.feedback import filter_site, sel_mask_site
from ..core.ledger import default_ledger
from ..kernels.masked_kernels import (compact_prefix, join_probe,
                                      masked_segment_agg, masked_tfidf)
from .base import GRAPH_ENGINE, REL_ENGINE, TEXT_ENGINE
from .bounded import BoundedRel, as_bounded, compact_rel
from .column_store import (filter_mask, group_agg, hash_join,
                           hash_join_nonunique)
from .graph_store import (expand_frontier, expand_frontier_blockskip,
                          pagerank, triangle_count)
from .sharded import (_shardable, coll_all_to_all_bytes, coll_allgather_bytes,
                      coll_psum_bytes, data_axis_size, sharded_broadcast_join,
                      sharded_count, sharded_expand, sharded_group_agg,
                      sharded_pagerank, sharded_partitioned_join,
                      sharded_tfidf_topk)
from .text_store import (masked_topk, tfidf_scores, tfidf_topk,
                         tfidf_topk_blockskip, tfidf_topk_masked)

_XLA = get_engine("xla")
_PALLAS = get_engine("pallas")


def _record_count(ctx, site, count, capacity):
    """Cardinality observation hook: when the caller planted a
    ``count_sink`` in ``ctx.aux``, append this site's (count, capacity).
    Counts stay on the device; a no-op otherwise."""
    sink = None if ctx is None else ctx.aux.get("count_sink")
    if sink is not None:
        sink.append((site, count, capacity))


def _annotate(ctx, **attrs):
    """Runtime-attribution hook: when the executor traced this op
    (``ExecContext.tracer``), report which dist strategy the impl actually
    dispatched and the per-shard collective bytes its kernel moves.  A
    cheap no-op when tracing is off."""
    tr = None if ctx is None else getattr(ctx, "tracer", None)
    if tr is not None:
        tr.annotate(**attrs)


# --------------------------------------------------------------------------
# relational engine: step functions + per-op impls
# --------------------------------------------------------------------------


def _step_rel_scan(tbl, attrs, ctx=None):
    rel = as_bounded(tbl)
    cols = attrs.get("cols")
    if cols:
        return rel.with_cols({c: rel.cols[c] for c in cols})
    return rel


def _step_rel_filter(tbl, attrs, ctx=None):
    rel = as_bounded(tbl)
    m = filter_mask(rel.cols[attrs["col"]], attrs["cmp"], attrs["value"])
    out = rel.narrowed(m)
    if ctx is not None and ctx.aux.get("count_sink") is not None:
        # the *marginal* selectivity: survivors over the rows this filter
        # saw; the planner-stamped site wins over the self-derived one
        site = attrs.get("site")
        if site is None:
            site = filter_site(attrs, rel.col_names(), rel.capacity)
        count = out.count
        mesh = ctx.mesh
        if (attrs.get("dist") == "row"
                and _shardable(mesh, out.valid.shape[0])):
            # shard-local survivor count + psum: integer addition is
            # associative, so SelectivityFeedback sees the exact count
            count = sharded_count(out.valid, mesh)
            _annotate(ctx, dist="row", coll="psum",
                      coll_bytes=coll_psum_bytes(4, data_axis_size(mesh)))
        _record_count(ctx, tuple(site), count,
                      torch.clamp(rel.count, min=1))
    return out


def _merge_join_cols(left, right, ro, idx):
    """Joined column set: every left column plus the right side's
    non-key, non-colliding columns gathered at ``idx``."""
    cols = dict(left.cols)
    for k, v in right.cols.items():
        if k == ro or k in cols:
            continue
        cols[k] = v[idx]
    return cols


def _step_rel_join(left, right, attrs, ctx=None):
    left, right = as_bounded(left), as_bounded(right)
    lo, ro = attrs["left_on"], attrs["right_on"]
    idx, matched = hash_join(left.cols[lo], right.cols[ro])
    rmask = right.valid[idx]
    cols = _merge_join_cols(left, right, ro, idx)
    valid = left.valid & matched & rmask
    return BoundedRel(cols, valid, None, left.overflow | right.overflow)


def _step_rel_join_probe(left, right, attrs, ctx=None):
    """The kernel realization of ``rel_join``: the probe kernel against the
    small build side.  Invalid build rows never match, so validity needs no
    second gather; gathered values at unmatched rows differ from the
    sort-probe path only under ``valid=False``."""
    left, right = as_bounded(left), as_bounded(right)
    lo, ro = attrs["left_on"], attrs["right_on"]
    idx, matched = join_probe(left.cols[lo], right.cols[ro], right.valid)
    cols = _merge_join_cols(left, right, ro, idx)
    valid = left.valid & matched
    return BoundedRel(cols, valid, None, left.overflow | right.overflow)


def _step_bounded_join(left, right, attrs, ctx=None):
    """Non-unique equi-join into ``attrs["capacity"]`` slots: the left
    columns gathered at each slot's probe row, the right side's merged at
    its build row; overflow ORs into the result's flag."""
    left, right = as_bounded(left), as_bounded(right)
    lo, ro = attrs["left_on"], attrs["right_on"]
    lidx, ridx, valid, count, ovf = hash_join_nonunique(
        left.cols[lo], left.valid, right.cols[ro], right.valid,
        int(attrs["capacity"]))
    gathered = left.with_cols({k: v[lidx] for k, v in left.cols.items()})
    cols = _merge_join_cols(gathered, right, ro, ridx)
    return BoundedRel(cols, valid, count,
                      ovf | left.overflow | right.overflow)


def _step_rel_group_agg(tbl, attrs, ctx=None):
    rel = as_bounded(tbl)
    key = rel.cols[attrs["key"]]
    g = int(attrs["num_groups"])
    mask = rel.valid
    cols = {attrs["key"]: torch.arange(g, dtype=torch.int32,
                                       device=key.device)}
    for out_name, fn, col in attrs["aggs"]:
        vals = None if fn == "count" else rel.cols[col]
        r = group_agg(vals, key, g, mask, fn)
        if fn == "max":
            # an all-masked group is an *invalid row* of the output
            r, _valid = r
        cols[out_name] = r
    count = group_agg(None, key, g, mask, "count")
    return BoundedRel(cols, count > 0, None, rel.overflow)


def _record_overflow(ctx, attrs, out):
    """Report a compaction site's overflow flag to the observation sink: an
    overflowed bound dropped rows, and the feedback store backs off."""
    site = attrs.get("site")
    if site is not None:
        _record_count(ctx, ("compact_overflow", tuple(site)),
                      out.overflow, 1)


def _step_compact(tbl, attrs, ctx=None):
    rel = as_bounded(tbl)
    out = compact_rel(rel, attrs.get("capacity"))
    _record_overflow(ctx, attrs, out)
    return out


def _step_compact_pallas(tbl, attrs, ctx=None):
    """Kernel realization of ``compact``: destination slots from a prefix
    sum, the scatter as the compaction kernel.  Bit-exact for float
    columns; integer and bool columns round-trip through float32 (exact
    below 2^24; the candidate gate admits only float and bool columns)."""
    rel = as_bounded(tbl)
    cap = int(attrs.get("capacity", rel.capacity))
    cap = max(1, min(cap, rel.capacity))
    keep = rel.valid.to(torch.float32)
    pos = torch.where(rel.valid,
                      torch.cumsum(rel.valid.to(torch.int32), 0,
                                   dtype=torch.int32) - 1,
                      torch.full_like(keep, -1, dtype=torch.int32))
    names = tuple(rel.cols)
    stacked = torch.stack([rel.cols[n].to(torch.float32) for n in names])
    out = compact_prefix(stacked, pos, keep, cap)
    count = torch.clamp(rel.count, max=cap).to(torch.int32)
    valid = torch.arange(cap, dtype=torch.int32, device=rel.device) < count
    cols = {}
    for i, n in enumerate(names):
        dt = rel.cols[n].dtype
        v = out[i]
        if not dt.is_floating_point:
            v = torch.round(v)
        cols[n] = v.to(dt)
    overflow = rel.overflow | (rel.count > cap)
    out = BoundedRel(cols, valid, count, overflow)
    _record_overflow(ctx, attrs, out)
    return out


_REL_STEPS = {
    "rel_scan": lambda ins, attrs, ctx=None: _step_rel_scan(ins[0], attrs, ctx),
    "rel_filter": lambda ins, attrs, ctx=None: _step_rel_filter(ins[0], attrs,
                                                                ctx),
    "rel_join": lambda ins, attrs, ctx=None: _step_rel_join(ins[0], ins[1],
                                                            attrs, ctx),
    "bounded_join": lambda ins, attrs, ctx=None: _step_bounded_join(
        ins[0], ins[1], attrs, ctx),
    "rel_group_agg": lambda ins, attrs, ctx=None: _step_rel_group_agg(
        ins[0], attrs, ctx),
    "compact": lambda ins, attrs, ctx=None: _step_compact(ins[0], attrs, ctx),
}


def _run_chain(args, chain, ctx=None, *, stop_before_last=False):
    """Execute a ``rel_fused`` step chain over the node's bound inputs."""
    steps = chain[:-1] if stop_before_last else chain
    prev = None
    for op, attrs, srcs, _out_t in steps:
        ins = [prev if s == "prev" else args[int(s)] for s in srcs]
        prev = _REL_STEPS[op](ins, attrs, ctx)
    return prev


def _annotate_local(ctx, node, rel):
    """A ``dist="row"`` scan or filter chain is shard-local: on a mesh its
    span says so (``coll="none"``), where the reference's says nothing."""
    if (node.attrs.get("dist") == "row"
            and _shardable(ctx.mesh,
                           as_bounded(rel).capacity)):
        _annotate(ctx, dist="row", coll="none", coll_bytes=0.0)


@REL_ENGINE.impl("rel_scan_col")
def _i_rel_scan(ctx, args, node):
    _annotate_local(ctx, node, args[0])
    return _step_rel_scan(args[0], node.attrs, ctx)


@REL_ENGINE.impl("rel_filter_col")
def _i_rel_filter(ctx, args, node):
    return _step_rel_filter(args[0], node.attrs, ctx)


@REL_ENGINE.impl("rel_hash_join")
def _i_rel_join(ctx, args, node):
    a = node.attrs
    mesh = ctx.mesh
    if a.get("dist") == "broadcast":
        left, right = as_bounded(args[0]), as_bounded(args[1])
        if _shardable(mesh, left.capacity):
            # probe side row-partitioned, build side whole on every rank:
            # each shard probes its block (bitwise = dense)
            idx, matched = sharded_broadcast_join(
                left.cols[a["left_on"]], right.cols[a["right_on"]], mesh)
            n = data_axis_size(mesh)
            build_b = sum(v.numel() * v.element_size()
                          for v in right.cols.values()) + right.capacity
            _annotate(ctx, dist="broadcast", coll="all_gather",
                      coll_bytes=coll_allgather_bytes(build_b, n))
            cols = _merge_join_cols(left, right, a["right_on"], idx)
            valid = left.valid & matched & right.valid[idx]
            return BoundedRel(cols, valid, None,
                              left.overflow | right.overflow)
    return _step_rel_join(args[0], args[1], node.attrs, ctx)


@_PALLAS.impl("rel_join_probe_pallas")
def _i_rel_join_probe(ctx, args, node):
    return _step_rel_join_probe(args[0], args[1], node.attrs, ctx)


@REL_ENGINE.impl("bounded_join_col")
def _i_bounded_join(ctx, args, node):
    a = node.attrs
    mesh = ctx.mesh
    if a.get("dist") == "partitioned":
        left, right = as_bounded(args[0]), as_bounded(args[1])
        cap = int(a["capacity"])
        if _shardable(mesh, left.capacity, right.capacity, cap):
            # co-partition both sides on the key (one all-to-all of fixed
            # bucket_cap buckets), then join shard-locally.  Output rows
            # land in shard-major slot order: same match *set* as the
            # dense join, different slot order.
            bucket_cap = int(a.get("bucket_cap", 64))
            lidx, ridx, valid, count, ovf = sharded_partitioned_join(
                left.cols[a["left_on"]], left.valid,
                right.cols[a["right_on"]], right.valid,
                cap, mesh, bucket_cap)
            n = data_axis_size(mesh)
            # both sides route (n, bucket_cap) staged buckets of
            # (key, slot-index, validity) rows through the all-to-all
            staged = 2 * n * bucket_cap * (4 + 4 + 1)
            _annotate(ctx, dist="partitioned", coll="all_to_all",
                      coll_bytes=coll_all_to_all_bytes(staged, n),
                      bucket_cap=bucket_cap)
            # the staged buckets are real device memory at the peak
            default_ledger().note_transient(
                ("shuffle_buckets", node.id), staged * n,
                kind="shuffle_buckets")
            gathered = left.with_cols(
                {k: v[lidx] for k, v in left.cols.items()})
            cols = _merge_join_cols(gathered, right, a["right_on"], ridx)
            return BoundedRel(cols, valid, count,
                              ovf | left.overflow | right.overflow)
    return _step_bounded_join(args[0], args[1], node.attrs, ctx)


@REL_ENGINE.impl("rel_group_agg_col")
def _i_rel_group(ctx, args, node):
    a = node.attrs
    mesh = ctx.mesh
    rel = as_bounded(args[0])
    if a.get("dist") == "row" and _shardable(mesh, rel.capacity):
        # shard-local segment reduce + psum / pmax (cross-shard float sums
        # re-associate: allclose to the dense aggregate, not bitwise)
        key = rel.cols[a["key"]]
        g = int(a["num_groups"])
        _annotate(ctx, dist="row", coll="psum",
                  coll_bytes=coll_psum_bytes(
                      (len(a["aggs"]) + 1) * g * 4, data_axis_size(mesh)))
        cols = {a["key"]: torch.arange(g, dtype=torch.int32,
                                       device=key.device)}
        for out_name, fn, col in a["aggs"]:
            vals = None if fn == "count" else rel.cols[col]
            r = sharded_group_agg(vals, key, g, rel.valid, fn, mesh)
            if fn == "max":
                r, _valid = r
            cols[out_name] = r
        count = sharded_group_agg(None, key, g, rel.valid, "count", mesh)
        return BoundedRel(cols, count > 0, None, rel.overflow)
    return _step_rel_group_agg(args[0], node.attrs, ctx)


@REL_ENGINE.impl("compact_prefix_col")
def _i_compact(ctx, args, node):
    return _step_compact(args[0], node.attrs, ctx)


@_PALLAS.impl("compact_prefix_pallas")
def _i_compact_pallas(ctx, args, node):
    return _step_compact_pallas(args[0], node.attrs, ctx)


@REL_ENGINE.impl("rel_fused_col")
def _i_rel_fused(ctx, args, node):
    _annotate_local(ctx, node, args[0])
    return _run_chain(args, node.attrs["chain"], ctx)


@_PALLAS.impl("rel_fused_agg_pallas")
def _i_rel_fused_agg(ctx, args, node):
    """Fused chain whose terminal group-by runs the masked segment-
    aggregate kernel (sum/count/mean; gated by the pattern set)."""
    chain = node.attrs["chain"]
    rel = as_bounded(_run_chain(args, chain, ctx, stop_before_last=True))
    attrs = chain[-1][1]
    key = rel.cols[attrs["key"]]
    g = int(attrs["num_groups"])
    mw = rel.valid.to(torch.float32)
    cols = {attrs["key"]: torch.arange(g, dtype=torch.int32,
                                       device=key.device)}
    count = None
    for out_name, fn, col in attrs["aggs"]:
        vals = mw if fn == "count" else rel.cols[col].to(torch.float32)
        s, c = masked_segment_agg(vals, key, mw, g)
        count = c
        cols[out_name] = (c if fn == "count"
                          else s if fn == "sum"
                          else s / torch.clamp(c, min=1.0))
    if count is None:
        count, _ = masked_segment_agg(mw, key, mw, g)
    return BoundedRel(cols, count > 0, None, rel.overflow)


@REL_ENGINE.impl("col_tensor_rel")
def _i_col_tensor(ctx, args, node):
    rel = as_bounded(args[0])
    dtype = getattr(torch, node.attrs.get("dtype", "float32"))
    v = rel.cols[node.attrs["col"]].to(dtype)
    return torch.where(rel.valid, v, torch.zeros_like(v))


@REL_ENGINE.impl("sel_mask_rel")
def _i_sel_mask(ctx, args, node):
    """Selection-mask export: ``mask[v]`` is set when a valid row has
    ``col == v`` — a scatter-max of bools over the entity domain, the
    predicate pushdown hands across the engine boundary.  Rows outside
    ``[0, size)`` set nothing."""
    rel = as_bounded(args[0])
    col = rel.cols[node.attrs["col"]]
    size = int(node.attrs["size"])
    ok = rel.valid & (col >= 0) & (col < size)
    idx = torch.where(ok, col, torch.full_like(col, size)).long()
    out = torch.zeros(size + 1, dtype=torch.bool, device=col.device)
    out = out.index_fill_(0, idx, True)[:size]
    if ctx.aux.get("count_sink") is not None:
        _record_count(ctx, sel_mask_site(node.attrs),
                      out.sum(dtype=torch.int32), size)
    return out


# --------------------------------------------------------------------------
# graph engine (plain scatter) + the CUDA scatter kernel
# --------------------------------------------------------------------------


def _block_graph(ctx, node, g) -> bool:
    """A ``dist="block"`` node over a block-partitioned payload on a mesh
    its node count and blocks divide."""
    return (node.attrs.get("dist") == "block" and "blk_src" in g
            and _shardable(ctx.mesh,
                           g["indptr"].shape[0] - 1, g["blk_src"].shape[0]))


@GRAPH_ENGINE.impl("graph_expand_csr")
def _i_expand_csr(ctx, args, node):
    g, hops = args[0], int(node.attrs.get("hops", 1))
    if _block_graph(ctx, node, g):
        nodes_b = (g["indptr"].shape[0] - 1) * 4
        _annotate(ctx, dist="block", coll="all_gather",
                  coll_bytes=hops * coll_allgather_bytes(
                      nodes_b, data_axis_size(ctx.mesh)))
        return sharded_expand(g, args[1], hops, ctx.mesh)
    return expand_frontier(g, args[1], hops=hops)


@GRAPH_ENGINE.impl("graph_expand_skip")
def _i_expand_skip(ctx, args, node):
    return expand_frontier_blockskip(args[0], args[1],
                                     hops=int(node.attrs.get("hops", 1)))


@_PALLAS.impl("graph_expand_pallas")
def _i_expand_kernel(ctx, args, node):
    return expand_frontier(args[0], args[1],
                           hops=int(node.attrs.get("hops", 1)),
                           use_kernel=True)


def _pagerank(args, node, use_kernel, skip_first=False):
    return pagerank(args[0], iters=int(node.attrs.get("iters", 10)),
                    damping=float(node.attrs.get("damping", 0.85)),
                    personalization=args[1] if len(args) > 1 else None,
                    use_kernel=use_kernel, skip_first=skip_first)


@GRAPH_ENGINE.impl("graph_pagerank_csr")
def _i_pagerank_csr(ctx, args, node):
    g = args[0]
    if _block_graph(ctx, node, g):
        iters = int(node.attrs.get("iters", 10))
        nodes_b = (g["indptr"].shape[0] - 1) * 4
        _annotate(ctx, dist="block", coll="all_gather",
                  coll_bytes=iters * coll_allgather_bytes(
                      nodes_b, data_axis_size(ctx.mesh)))
        return sharded_pagerank(
            g, iters, float(node.attrs.get("damping", 0.85)),
            args[1] if len(args) > 1 else None, ctx.mesh)
    return _pagerank(args, node, use_kernel=False)


@GRAPH_ENGINE.impl("graph_pagerank_skip")
def _i_pagerank_skip(ctx, args, node):
    """Personalization-sparsity pushdown: iteration 0's SpMV block-skips on
    the pushed mask's support; bitwise equal to the dense iteration."""
    return _pagerank(args, node, use_kernel=False, skip_first=True)


@_PALLAS.impl("graph_pagerank_pallas")
def _i_pagerank_kernel(ctx, args, node):
    return _pagerank(args, node, use_kernel=True)


@GRAPH_ENGINE.impl("graph_tricount_csr")
def _i_tricount(ctx, args, node):
    return triangle_count(args[0])


# --------------------------------------------------------------------------
# text engine
# --------------------------------------------------------------------------


def _topk_rel(ids, scores, valid):
    """Top-k results are a BoundedRel: the valid slots form a prefix."""
    return BoundedRel({"doc": ids, "score": scores}, valid)


@TEXT_ENGINE.impl("text_topk_inv")
def _i_text_topk(ctx, args, node):
    k = int(node.attrs["k"])
    if len(args) == 3:
        # pushed candidate-doc mask, dense realization: score the whole
        # corpus, then mask + top-k (the bitwise reference of the skipping
        # and kernel realizations)
        return _topk_rel(*tfidf_topk_masked(args[0], args[1], args[2], k))
    c, mesh = args[0], ctx.mesh
    if (node.attrs.get("dist") == "doc" and "blk_doc_local" in c
            and _shardable(mesh, c["doc_len"].shape[0],
                           c["blk_doc_local"].shape[0])):
        # shard-local score + local top-k, then a fixed-capacity candidate
        # merge (bitwise = the dense top-k, tie-breaking included)
        n = data_axis_size(mesh)
        _annotate(ctx, dist="doc", coll="all_gather",
                  coll_bytes=coll_allgather_bytes(n * k * 8, n))
        return _topk_rel(*sharded_tfidf_topk(c, args[1], k, mesh))
    return _topk_rel(*tfidf_topk(args[0], args[1], k))


@TEXT_ENGINE.impl("text_topk_skip_inv")
def _i_text_topk_skip(ctx, args, node):
    return _topk_rel(*tfidf_topk_blockskip(args[0], args[1], args[2],
                                           int(node.attrs["k"])))


@_PALLAS.impl("text_topk_masked_pallas")
def _i_text_topk_kernel(ctx, args, node):
    """Masked TF-IDF scoring through the masked_tfidf kernel, which
    gathers inside (a masked document costs one mask byte), then the
    masked top-k."""
    corpus, query, doc_mask = args
    w = query.to(torch.float32) * corpus["idf"]
    scores = masked_tfidf(corpus["doc_ptr"], corpus["term_ids"],
                          corpus["tf"], corpus["doc_len"], w, doc_mask,
                          corpus["max_doc_postings"])
    return _topk_rel(*masked_topk(scores, doc_mask, int(node.attrs["k"])))


@TEXT_ENGINE.impl("text_scores_inv")
def _i_text_scores(ctx, args, node):
    return tfidf_scores(args[0], args[1])


@_XLA.impl("masked_topk_xla")
def _i_masked_topk(ctx, args, node):
    return _topk_rel(*masked_topk(args[0], args[1], int(node.attrs["k"])))


# --------------------------------------------------------------------------
# cross-engine transfer
# --------------------------------------------------------------------------


@_XLA.impl("xfer_pin")
def _i_xfer_pin(ctx, args, node):
    # AWESOME's in-memory placement: the value stays on the device and the
    # receiving engine reads it in place (a no-op at run time)
    return args[0]


def _host_roundtrip(v):
    if isinstance(v, torch.Tensor):
        return v.cpu().clone().to(v.device)
    if isinstance(v, BoundedRel):
        return BoundedRel({k: _host_roundtrip(c) for k, c in v.cols.items()},
                          _host_roundtrip(v.valid), _host_roundtrip(v.count),
                          _host_roundtrip(v.overflow))
    if isinstance(v, dict):
        return {k: _host_roundtrip(c) for k, c in v.items()}
    return v


@_XLA.impl("xfer_local", "xfer_repartition")
def _i_xfer_local(ctx, args, node):
    """Layout-compatible handoff (identity).  The repartition's all-to-all
    runs inside the partitioned join; this node is where the planner
    prices it."""
    return args[0]


@_XLA.impl("xfer_replicate")
def _i_xfer_replicate(ctx, args, node):
    """Identity, on a mesh or off it.  The reference constrains a
    data-partitioned value to a replicated sharding here (GSPMD inserts
    the all-gather); the port's sharded operators already all-gather
    their results, so the value arrives whole on every rank."""
    return args[0]


@_XLA.impl("xfer_spill")
def _i_xfer_spill(ctx, args, node):
    # per-op materialization: the value round-trips device -> host ->
    # device (what a naive federated mediator does between engine calls)
    return _host_roundtrip(args[0])
