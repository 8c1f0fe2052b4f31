"""Sharded tri-store operators: the stores partitioned over the mesh's
``data`` axis.

The port's counterpart of the reference package's ``stores/sharded.py``.
Each store partitions along its natural record axis — ColumnStore by row
range, GraphStore by dst-node blocks, TextStore by document range — and
every operator here computes on the rank's block and merges through the
reference's collective, called on the mesh
(:class:`~repro_torch.launch.mesh.DataMesh`): ``psum`` is ``all_reduce``
with ``op="sum"``, ``pmax`` with ``op="max"``, and ``all_gather`` /
``all_to_all`` are the mesh's of those names.

  * filter / count   — shard-local count, ``psum``;
  * group-agg        — shard-local segment reduce + ``psum`` (``pmax`` for
    ``max``); float sums re-associate across shards: allclose, not bitwise;
  * broadcast join   — build side whole on every rank, probe side
    row-partitioned: bitwise equal to the dense join;
  * partitioned join — both sides hash-co-partitioned on the key through
    one ``all_to_all`` of fixed ``(n, bucket_cap)`` buckets, then joined
    shard-locally; the slot order is shard-major (set-equal to the dense
    join, and slot for slot equal to the reference's sharded join);
  * PageRank / k-hop — dst-block SpMV with a per-iteration frontier
    ``all_gather``; the stable dst-block edge selection keeps every
    destination's contribution order, so results are bitwise equal to the
    dense plain SpMV;
  * top-k TF-IDF     — shard-local scoring (the dense path's ordered
    float32 sum over a shard-local ``doc_ptr``) and top-k, then a merge
    ordered by (score desc, doc asc): bitwise equal to the dense top-k.

Inputs and outputs stay *logically global*: every rank holds the whole
value, an operator slices its rank's block (:func:`_block`, a view), and a
result the reference returns partitioned is all-gathered, so every rank
returns the tensor the dense operator would.  Global lengths must divide
the data-axis size; the stores pad themselves when built with
``shards=``.
"""
from __future__ import annotations

import math

import torch

from ..core.ir import ValidationError
from ..kernels.graph_kernels import scatter_add_plain
from ..kernels.masked_kernels import ordered_doc_sum
from .column_store import hash_join, hash_join_nonunique


def data_axis_size(mesh) -> int:
    """Ranks along the ``data`` axis (1 for no mesh)."""
    return 1 if mesh is None else int(mesh.world)


def _shardable(mesh, *lengths) -> bool:
    n = data_axis_size(mesh)
    return n > 1 and all(int(ln) % n == 0 for ln in lengths)


def _block(x: torch.Tensor, mesh) -> torch.Tensor:
    """The rank's block of the global ``x``: rows ``[r·len/n,
    (r+1)·len/n)`` (a view)."""
    size = int(x.shape[0]) // mesh.world
    return x[mesh.rank * size:(mesh.rank + 1) * size]


# --------------------------------------------------------------------------
# collective-byte attribution (what each operator's collectives move per
# shard, the runtime side of the cost model's wire-byte formulas)
# --------------------------------------------------------------------------


def coll_allgather_bytes(nbytes: float, n: int) -> float:
    """Per-shard wire bytes of all-gathering an ``nbytes`` value that is
    partitioned over ``n`` shards: each receives the other (n-1)/n."""
    n = max(1, int(n))
    return float(nbytes) * (n - 1) / n


def coll_psum_bytes(nbytes: float, n: int) -> float:
    """Per-shard wire bytes of a tree all-reduce over an ``nbytes``-sized
    replicated result: log2(n) exchange rounds."""
    return float(nbytes) * math.log2(max(int(n), 2))


def coll_all_to_all_bytes(nbytes: float, n: int) -> float:
    """Per-shard wire bytes of an all-to-all over staged buckets totalling
    ``nbytes`` per shard: every shard keeps its own 1/n and ships the
    rest."""
    n = max(1, int(n))
    return float(nbytes) * (n - 1) / n


# --------------------------------------------------------------------------
# filter count and group aggregate
# --------------------------------------------------------------------------


def sharded_count(valid: torch.Tensor, mesh) -> torch.Tensor:
    """Global valid-row count as a shard-local sum + ``psum``: a 0-d int32
    equal to the dense count (integer addition is associative)."""
    return mesh.all_reduce(_block(valid, mesh).sum(dtype=torch.int32))


def _segment_max(v, keys, num_groups: int) -> torch.Tensor:
    """Per-group max of ``v`` (-inf for empty groups; keys outside
    ``[0, num_groups)`` dropped)."""
    g = int(num_groups)
    idx = torch.where((keys >= 0) & (keys < g), keys,
                      torch.full_like(keys, g)).long()
    m = torch.full((g + 1,), -torch.inf, dtype=torch.float32,
                   device=v.device)
    return m.scatter_reduce(0, idx, v, reduce="amax")[:g]


def sharded_group_agg(values, keys, num_groups: int, mask, fn: str, mesh):
    """Mask-weighted segment aggregate over a row-partitioned relation:
    shard-local segment reduce, then ``psum`` (``pmax`` for ``max``) into
    the replicated ``(num_groups,)`` result.  ``max`` returns ``(values,
    valid)`` like the dense :func:`~.column_store.group_agg`."""
    ng = int(num_groups)
    k, m = _block(keys, mesh), _block(mask, mesh)
    w = m.to(torch.float32)
    if fn == "count":
        return mesh.all_reduce(scatter_add_plain(w, k, ng))
    v = (torch.zeros(k.shape, dtype=torch.float32, device=k.device)
         if values is None else _block(values, mesh).to(torch.float32))
    if fn == "sum":
        return mesh.all_reduce(scatter_add_plain(v * w, k, ng))
    if fn == "mean":
        s = mesh.all_reduce(scatter_add_plain(v * w, k, ng))
        c = mesh.all_reduce(scatter_add_plain(w, k, ng))
        return s / torch.clamp(c, min=1.0)
    if fn == "max":
        neg = torch.where(m, v, torch.full_like(v, -torch.inf))
        gm = mesh.all_reduce(_segment_max(neg, k, ng), op="max")
        valid = torch.isfinite(gm)
        return torch.where(valid, gm, torch.zeros_like(gm)), valid
    raise ValidationError(f"sharded_group_agg: unknown fn {fn!r}")


# --------------------------------------------------------------------------
# joins
# --------------------------------------------------------------------------


def sharded_broadcast_join(lkeys, rkeys, mesh):
    """Unique-build-key equi-join with the build side whole on every rank
    and the probe side row-partitioned: each rank probes its row block, and
    the gathered probe-aligned ``(idx, matched)`` is bitwise the dense
    :func:`~.column_store.hash_join`'s."""
    idx, matched = hash_join(_block(lkeys, mesh), rkeys)
    return mesh.all_gather(idx), mesh.all_gather(matched)


def _route(keys, mask, mesh, bcap: int):
    """Scatter this rank's rows into ``(n, bcap)`` owner buckets (flat):
    owner ``key % n``, invalid rows to owner ``n`` (dropped), a stable
    sort by owner, each row's rank inside its owner, rows past ``bcap``
    dropped and counted.  Returns ``(keys_b, gids_b, mask_b, dropped)``."""
    n = mesh.world
    rows = int(keys.shape[0])
    dev = keys.device
    gids = (mesh.rank * rows
            + torch.arange(rows, dtype=torch.int32, device=dev))
    owner = torch.where(mask, keys % n, torch.full_like(keys, n))
    order = torch.argsort(owner, stable=True)
    so, sk, sg = owner[order], keys[order], gids[order]
    start = torch.searchsorted(
        so, torch.arange(n + 1, dtype=so.dtype, device=dev))
    rank = (torch.arange(rows, dtype=torch.int64, device=dev)
            - start[torch.clamp(so, 0, n).long()])
    ok = (so < n) & (rank < bcap)
    slot = torch.where(ok, so.long() * bcap + rank,
                       torch.full_like(rank, n * bcap))   # past the end
    out = []
    for vals, dtype in ((sk, keys.dtype), (sg, torch.int32),
                        (ok, torch.bool)):
        buf = torch.zeros(n * bcap + 1, dtype=dtype, device=dev)
        buf[slot] = vals
        out.append(buf[:n * bcap])
    dropped = ((so < n) & ~ok).sum(dtype=torch.int32)
    return (*out, dropped)


def sharded_partitioned_join(lkeys, lmask, rkeys, rmask, capacity: int,
                             mesh, bucket_cap: int):
    """Non-unique-key equi-join with **both sides hash-co-partitioned on
    the key**: every rank routes its rows to ``owner = key % n`` through
    one ``all_to_all`` per staged array of fixed ``(n, bucket_cap)``
    buckets, then runs the bounded join over what it received into
    ``capacity // n`` slots.

    ``bucket_cap`` bounds the shuffle buffer per (sender, owner) pair; a
    skewed key distribution overflows visibly (rows dropped,
    ``overflow=True``).  Returns ``(lidx, ridx, valid, count, overflow)``
    like :func:`~.column_store.hash_join_nonunique`, with ``lidx`` /
    ``ridx`` global row ids and the slots in shard-major order: set-equal
    to the dense join.  ``capacity`` must divide the data axis."""
    n = data_axis_size(mesh)
    cap = int(capacity)
    if cap % n:
        raise ValidationError(
            f"sharded_partitioned_join: capacity {cap} must divide "
            f"the data axis ({n})")
    bcap = max(1, int(bucket_cap))
    lkb, lgb, lmb, ldrop = _route(_block(lkeys, mesh), _block(lmask, mesh),
                                  mesh, bcap)
    rkb, rgb, rmb, rdrop = _route(_block(rkeys, mesh), _block(rmask, mesh),
                                  mesh, bcap)
    lk_r, lg_r, lm_r = (mesh.all_to_all(x) for x in (lkb, lgb, lmb))
    rk_r, rg_r, rm_r = (mesh.all_to_all(x) for x in (rkb, rgb, rmb))
    li, ri, valid, cnt, ovf = hash_join_nonunique(lk_r, lm_r, rk_r, rm_r,
                                                  cap // n)
    count = mesh.all_reduce(cnt)
    shuffle_drop = mesh.all_reduce(ldrop + rdrop)
    overflow = (mesh.all_reduce(ovf.to(torch.int32)) + shuffle_drop) > 0
    return (mesh.all_gather(lg_r[li]), mesh.all_gather(rg_r[ri]),
            mesh.all_gather(valid), count, overflow)


# --------------------------------------------------------------------------
# graph: dst-block-partitioned SpMV
# --------------------------------------------------------------------------

_BLOCK_KEYS = ("blk_src", "blk_dst_local", "blk_weights")


def _block_spmv(xs_local, blocks, n_local: int, mesh):
    """One SpMV step over this rank's dst-block edges: the source vector
    gathered whole (the per-iteration frontier all-gather), contributions
    in the stable dst-block edge order through the dense path's plain
    scatter; pad edges (``dst_local == n_local``) add nothing."""
    src_b, dst_b, w_b = blocks
    xs = mesh.all_gather(xs_local)
    return scatter_add_plain(xs[src_b] * w_b, dst_b, n_local)


def sharded_pagerank(g: dict, iters: int, damping: float,
                     personalization, mesh) -> torch.Tensor:
    """Damped power iteration over the dst-block-partitioned graph: rank,
    out-degree and personalization node-partitioned, one frontier
    all-gather per iteration.  The teleport normalization sums the
    gathered personalization (not a psum of partials), so it is the dense
    sum: bitwise equal to the dense plain :func:`~.graph_store.pagerank`."""
    n = int(g["indptr"].shape[0]) - 1
    n_local = n // mesh.world
    blocks = [_block(g[k], mesh) for k in _BLOCK_KEYS]
    if personalization is None:
        p_l = _block(torch.full((n,), 1.0 / n, dtype=torch.float32,
                                device=g["out_deg"].device), mesh)
        p0_l = p_l
    else:
        p_l = _block(personalization.to(torch.float32), mesh)
        p_full = mesh.all_gather(p_l)
        p0_l = p_l / torch.clamp(p_full.sum(), min=1e-30)
    deg_l = _block(g["out_deg"], mesh)
    r_l = p0_l
    for _ in range(int(iters)):
        y_l = _block_spmv(r_l / deg_l, blocks, n_local, mesh)
        r_l = (1.0 - damping) * p0_l + damping * y_l
    return mesh.all_gather(r_l)


def sharded_expand(g: dict, frontier, hops: int, mesh) -> torch.Tensor:
    """k-hop frontier expansion on the dst-block-partitioned SpMV: one
    all-gather per hop, bitwise equal to the dense plain expansion."""
    n = int(g["indptr"].shape[0]) - 1
    n_local = n // mesh.world
    blocks = [_block(g[k], mesh) for k in _BLOCK_KEYS]
    x_l = _block(frontier, mesh).to(torch.float32)
    for _ in range(int(hops)):
        x_l = _block_spmv(x_l, blocks, n_local, mesh)
    return mesh.all_gather(x_l)


# --------------------------------------------------------------------------
# text: shard-local scoring + distributed top-k merge
# --------------------------------------------------------------------------


def sharded_tfidf_topk(corpus: dict, query, k: int, mesh):
    """Distributed top-k TF-IDF: score the rank's documents with the dense
    path's ordered float32 sum (over a shard-local ``doc_ptr``; the stable
    doc-block posting selection keeps each document's posting order), take
    the rank's top ``k_l``, then merge the gathered candidates by (score
    desc, doc asc) — the dense top-k's order, so the result is bitwise
    equal to it.  Returns ``(ids, scores, valid)`` of length
    ``min(k, n_docs)``."""
    n_docs = int(corpus["doc_len"].shape[0])
    n_local = n_docs // mesh.world
    k = min(int(k), n_docs)
    k_l = min(k, n_local)
    docl = _block(corpus["blk_doc_local"], mesh)
    dev = docl.device
    # the block's postings are doc-sorted, pads (doc_local = n_local) last
    ptr = torch.searchsorted(
        docl, torch.arange(n_local + 1, dtype=docl.dtype, device=dev))
    w = query.to(torch.float32) * corpus["idf"]
    scores_l = ordered_doc_sum(
        ptr, torch.arange(n_local, device=dev),
        _block(corpus["blk_term_ids"], mesh), _block(corpus["blk_tf"], mesh),
        _block(corpus["doc_len"], mesh), w, corpus["max_doc_postings"])
    ids = torch.sort(scores_l, descending=True, stable=True).indices[:k_l]
    vals = mesh.all_gather(scores_l[ids])
    gids = mesh.all_gather((ids + mesh.rank * n_local).to(torch.int32))
    # (score desc, doc asc): a stable sort by doc, then by score
    by_doc = torch.argsort(gids, stable=True)
    order = by_doc[torch.sort(vals[by_doc], descending=True,
                              stable=True).indices][:k]
    return (gids[order], vals[order],
            torch.ones(k, dtype=torch.bool, device=dev))
