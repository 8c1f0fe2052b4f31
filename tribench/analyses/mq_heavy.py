"""``mq_heavy``: the heavy query of the reference's
``benchmarks/multi_query.py``, the same tri-query as ``hashtag_pulse``
(engagement filter -> per-hashtag count, 2-hop expansion, personalised
PageRank, TF-IDF top 64 joined back and summed per hashtag, fused), built
with the ``Analysis`` API as that benchmark builds it.  The graph side
does not depend on ``q``: it is what the subplan cache shares between
heavy queries that differ only in ``q``.

Params: ``threshold`` (float), ``iters`` (int).
"""
K = 64
HOPS = 2
DAMPING = 0.85
INPUTS = ("tweets", "g", "cx", "q")


def build(stores: dict, params: dict):
    """The program's analysis, built with the ``Analysis`` API."""
    from repro_torch.core.adil import Analysis
    from repro_torch.core.ir import TensorT, standard_catalog
    table, graph, corpus = stores["tweets"], stores["g"], stores["cx"]
    nodes = graph.n_nodes
    with Analysis("pulse", standard_catalog()) as a:
        tw = a.bind("tweets", table)
        gr = a.bind("g", graph)
        cx = a.bind("cx", corpus)
        q = a.input("q", TensorT((corpus.vocab,), "float32", ("vocab",)))
        t = a.op("rel_scan", tw)
        hot = a.op("rel_filter", t, col="engagement", cmp="ge",
                   value=float(params["threshold"]))
        seeds = a.op("rel_group_agg", hot, key="hashtag", num_groups=nodes,
                     aggs=(("seed", "count", None),))
        sv = a.op("col_tensor", seeds, col="seed", dim="nodes")
        fr = a.op("graph_expand", gr, sv, hops=HOPS)
        pr = a.op("graph_pagerank", gr, fr, iters=int(params["iters"]),
                  damping=DAMPING)
        hits = a.op("text_topk", cx, q, k=K)
        j = a.op("rel_join", hits, tw, left_on="doc", right_on="doc")
        trel = a.op("rel_group_agg", j, key="hashtag", num_groups=nodes,
                    aggs=(("textrel", "sum", "score"),))
        tv = a.op("col_tensor", trel, col="textrel", dim="nodes")
        a.store(a.op("residual_add", pr, tv))
    return a


def reference(ref, params: dict, q):
    """The output's ``(graph part, text part)`` by the plain reference
    ``ref`` (:class:`tribench.reference.Reference`)."""
    key = ("pagerank", float(params["threshold"]), int(params["iters"]))
    if key not in ref.memo:
        hot = ref.cols["engagement"] >= float(params["threshold"])
        fr = ref.expand(ref.count_by("hashtag", hot), HOPS)
        ref.memo[key] = ref.pagerank(fr, int(params["iters"]), DAMPING)
    docs, scores = ref.topk(ref.scores(q), K)
    return ref.memo[key], ref.sum_by_doc("hashtag", docs, scores)
