"""The multi-query workload: many analysts' queries over one tri-store.

The port's copy of ``benchmarks/multi_query.py``'s stores and programs.
16 clients share the stores with the overlap real dashboards have:

  * :func:`heavy_analysis` — the paper's tri-query: a relational seed
    (engagement filter -> per-hashtag count), a 2-hop expansion and
    personalized PageRank over the co-mention graph, and TF-IDF relevance
    of the text query vector ``q`` joined back to the tweets, fused.  The
    graph side dominates and does not depend on ``q``: what the subplan
    cache shares between heavy queries that differ only in ``q``;
  * :func:`light_analysis` — the per-hashtag text relevance alone, fully
    determined by ``q``: what same-shape batching coalesces.

:func:`workload` lays out the 16 requests as the benchmark does: 4 exact
twins of one heavy query, 2 x 2 heavy queries that differ only in ``q``,
and 8 light queries that differ in ``q`` (``batch_param="q"``).
"""
from __future__ import annotations

import numpy as np

from ..core.adil import Analysis
from ..core.ir import TensorT, standard_catalog
from ..stores import ColumnStore, GraphStore, TextStore

CAT = standard_catalog()
# the benchmark's --smoke sizes
SMOKE = {"rows": 3_000, "nodes": 64, "vocab": 64, "iters": 12}
TERMS = 6                     # query terms of every q
# the reference runtime's sharing counters for the --smoke workload planned
# with the kernel slot (tests/test_torch_mqo.py holds the port to them)
SMOKE_COUNTERS = {"deduped": 5, "batched": 8, "shared_hits": 2}


def build_stores(rng, *, rows, nodes, vocab):
    """The benchmark's tweets (hashtag, doc, engagement), symmetric
    co-mention graph (rows / 2 random pairs) and corpus (3-9 terms a
    document), from ``rng``."""
    table = ColumnStore({
        "hashtag": rng.randint(0, nodes, rows).astype(np.int32),
        "doc": np.arange(rows, dtype=np.int32),
        "engagement": (rng.gamma(2.0, 12.0, rows)).astype(np.float32),
    })
    e = rng.randint(0, nodes, (2, rows // 2))
    graph = GraphStore.from_edges(e[0], e[1], nodes, symmetric=True)
    corpus = TextStore.from_docs(
        [rng.randint(0, vocab, rng.randint(3, 10)) for _ in range(rows)],
        vocab)
    return table, graph, corpus


def heavy_analysis(table, graph, corpus, *, iters, k=64):
    """The tri-query (see the module note); returns the Analysis.  ``k``
    and ``iters`` are the attrs a ``DegradePolicy`` clamps."""
    nodes = graph.n_nodes
    with Analysis("pulse", CAT) as a:
        tw = a.bind("tweets", table)
        gr = a.bind("g", graph)
        cx = a.bind("cx", corpus)
        q = a.input("q", TensorT((corpus.vocab,), "float32", ("vocab",)))
        t = a.op("rel_scan", tw)
        hot = a.op("rel_filter", t, col="engagement", cmp="ge", value=30.0)
        seeds = a.op("rel_group_agg", hot, key="hashtag", num_groups=nodes,
                     aggs=(("seed", "count", None),))
        sv = a.op("col_tensor", seeds, col="seed", dim="nodes")
        fr = a.op("graph_expand", gr, sv, hops=2)
        pr = a.op("graph_pagerank", gr, fr, iters=iters, damping=0.85)
        hits = a.op("text_topk", cx, q, k=k)
        j = a.op("rel_join", hits, tw, left_on="doc", right_on="doc")
        trel = a.op("rel_group_agg", j, key="hashtag", num_groups=nodes,
                    aggs=(("textrel", "sum", "score"),))
        tv = a.op("col_tensor", trel, col="textrel", dim="nodes")
        a.store(a.op("residual_add", pr, tv))
    return a


def light_analysis(table, corpus, nodes):
    """Per-hashtag text relevance only; returns the Analysis."""
    with Analysis("textrel", CAT) as a:
        tw = a.bind("tweets", table)
        cx = a.bind("cx", corpus)
        q = a.input("q", TensorT((corpus.vocab,), "float32", ("vocab",)))
        hits = a.op("text_topk", cx, q, k=64)
        j = a.op("rel_join", hits, tw, left_on="doc", right_on="doc")
        trel = a.op("rel_group_agg", j, key="hashtag", num_groups=nodes,
                    aggs=(("textrel", "sum", "score"),))
        a.store(a.op("col_tensor", trel, col="textrel", dim="nodes"))
    return a


def query_vectors(rng, corpus, n):
    """``n`` query vectors of TERMS random terms each (numpy float32)."""
    return [corpus.query_vector(rng.randint(0, corpus.vocab, TERMS))
            for _ in range(n)]


def workload(heavy, light, heavy_inputs, light_inputs, qs):
    """The 16 requests as ``(planned, inputs, batch_param, versions)``:
    ``qs`` holds 11 query vectors on the plan's device (``qa``, ``qb1``,
    ``qb2``, then the 8 light ones); ``heavy`` / ``light`` are ``(Analysis,
    PlannedFunction)`` pairs."""
    (ah, fh), (al, fl) = heavy, light
    qa, qb1, qb2 = qs[:3]
    return ([(fh, {**heavy_inputs, "q": qa}, None, ah.store_versions())] * 4
            + [(fh, {**heavy_inputs, "q": qb1}, None,
                ah.store_versions())] * 2
            + [(fh, {**heavy_inputs, "q": qb2}, None,
                ah.store_versions())] * 2
            + [(fl, {**light_inputs, "q": q}, "q", al.store_versions())
               for q in qs[3:]])
