"""``mq_light``: the light query of the reference's
``benchmarks/multi_query.py``: per-hashtag text relevance alone (TF-IDF
top 64 for ``q``, joined back to the tweets, summed per hashtag), fully
determined by ``q``: what same-shape batching coalesces.

Params: none.
"""
K = 64
INPUTS = ("tweets", "cx", "q")


def build(stores: dict, params: dict):
    """The program's analysis, built with the ``Analysis`` API."""
    from repro_torch.core.adil import Analysis
    from repro_torch.core.ir import TensorT, standard_catalog
    table, graph, corpus = stores["tweets"], stores["g"], stores["cx"]
    with Analysis("textrel", standard_catalog()) as a:
        tw = a.bind("tweets", table)
        cx = a.bind("cx", corpus)
        q = a.input("q", TensorT((corpus.vocab,), "float32", ("vocab",)))
        hits = a.op("text_topk", cx, q, k=K)
        j = a.op("rel_join", hits, tw, left_on="doc", right_on="doc")
        trel = a.op("rel_group_agg", j, key="hashtag",
                    num_groups=graph.n_nodes,
                    aggs=(("textrel", "sum", "score"),))
        a.store(a.op("col_tensor", trel, col="textrel", dim="nodes"))
    return a


def reference(ref, params: dict, q):
    """The output's ``(graph part, text part)`` by the plain reference
    ``ref`` (:class:`tribench.reference.Reference`)."""
    docs, scores = ref.topk(ref.scores(q), K)
    return None, ref.sum_by_doc("hashtag", docs, scores)
