"""Time-windowed ranking on the port: the predicate-pushdown workload.

The port's copy of the reference's ``tri_selective_<sel>`` analysis
(``benchmarks/tri_store_eff.py::build_selective_workload``): "among the
window's tweets, the top-k most query-relevant, aggregated per hashtag,
plus the window's seed expansion over the co-mention graph" —

  1. relational: scan the tweet table and keep a recency window
     (``ts >= cut``, an exact selectivity hint: tweets are append-ordered);
  2. the window becomes a doc mask (``sel_mask``) that masks the text
     scores before the top-k (``masked_topk``); the default pipeline's
     ``push_predicates`` carries it into the text engine, where the masked
     TF-IDF kernel scores only the window's documents;
  3. the hits join back to the window and are summed per hashtag;
  4. the window's tweets per hashtag seed a 2-hop graph expansion;
  5. fused score = expansion + text relevance.

:func:`build_window_data` draws from the numpy ``RandomState`` in the
reference's call order, so one seed gives the reference's arrays; the
corpus is indexed with ``TextStore.from_flat`` (arrays equal
``from_docs``').

    PYTHONPATH=src python -m repro_torch.examples.windowed_ranking \\
        [--tweets N] [--selectivity S] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import compile as compile_analysis
from ..core.adil import Analysis
from ..core.ir import TensorT, standard_catalog
from ..stores import ColumnStore, GraphStore, TextStore


def build_window_data(rng, *, tweets, hashtags, edges, vocab, terms_lo,
                      terms_hi):
    """The tweet table (append-ordered ``ts``), the co-mention graph between
    zipf-popular tags, and the corpus (one document per tweet)."""
    tag = (rng.zipf(1.3, tweets) % hashtags).astype(np.int32)
    cols = {
        "hashtag": tag,
        "doc": np.arange(tweets, dtype=np.int32),
        "ts": np.arange(tweets, dtype=np.int32),       # append-ordered log
        "engagement": (rng.gamma(2.0, 12.0, tweets)).astype(np.float32),
    }
    for i in range(8):
        cols[f"metric{i}"] = rng.rand(tweets).astype(np.float32)
    table = ColumnStore(cols)
    src = (rng.zipf(1.3, edges) % hashtags).astype(np.int64)
    dst = rng.randint(0, hashtags, edges)
    graph = GraphStore.from_edges(src, dst, hashtags, symmetric=True)
    lens = rng.randint(terms_lo, terms_hi, tweets)
    flat = (rng.zipf(1.4, int(lens.sum())) % vocab).astype(np.int64)
    corpus = TextStore.from_flat(flat, lens, vocab)
    return table, graph, corpus


def windowed_ranking(table, graph, corpus, selectivity: float,
                     k: int = 64) -> Analysis:
    """The ``tri_selective_<selectivity>`` analysis over the three stores."""
    cut = int(table.rows * (1.0 - selectivity))
    hashtags, docs = graph.n_nodes, corpus.n_docs
    with Analysis(f"tri_selective_{selectivity}", standard_catalog()) as a:
        tw = a.bind("tweets", table)
        gr = a.bind("g", graph)
        cx = a.bind("cx", corpus)
        q = a.input("q", TensorT((corpus.vocab,), "float32", ("vocab",)))
        t = a.op("rel_scan", tw)
        recent = a.op("rel_filter", t, col="ts", cmp="ge", value=cut,
                      selectivity=selectivity)
        m = a.op("sel_mask", recent, col="doc", size=docs)
        sc = a.op("text_scores", cx, q)
        hits = a.op("masked_topk", sc, m, k=k)
        j = a.op("rel_join", recent, hits, left_on="doc", right_on="doc")
        trel = a.op("rel_group_agg", j, key="hashtag", num_groups=hashtags,
                    aggs=(("textrel", "sum", "score"),))
        seeds = a.op("rel_group_agg", recent, key="hashtag",
                     num_groups=hashtags, aggs=(("seed", "count", None),))
        sv = a.op("col_tensor", seeds, col="seed", dim="nodes")
        fr = a.op("graph_expand", gr, sv, hops=2)
        tv = a.op("col_tensor", trel, col="textrel", dim="nodes")
        a.store(a.op("residual_add", fr, tv))
    return a


def build_selective_workload(rng, selectivity: float, **size):
    """Stores, analysis and query in the reference's RandomState order:
    ``(analysis, (table, graph, corpus), query)``."""
    table, graph, corpus = build_window_data(rng, **size)
    analysis = windowed_ranking(table, graph, corpus, selectivity)
    query = corpus.query_vector(rng.randint(0, size["vocab"], 6))
    return analysis, (table, graph, corpus), query


def inputs_for(table, graph, corpus, query, device) -> dict:
    """The plan inputs of ``tri_selective_<sel>`` on ``device``."""
    return {"tweets": table.payload(device), "g": graph.payload(device),
            "cx": corpus.payload(device),
            "q": torch.from_numpy(np.asarray(query, np.float32)).to(device)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tweets", type=int, default=20_000)
    ap.add_argument("--hashtags", type=int, default=4096)
    ap.add_argument("--edges", type=int, default=None,
                    help="default: 0.6 per tweet, as the reference")
    ap.add_argument("--vocab", type=int, default=1024)
    ap.add_argument("--selectivity", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    rng = np.random.RandomState(args.seed)
    edges = (int(args.tweets * 0.6) if args.edges is None else args.edges)
    analysis, (table, graph, corpus), query = build_selective_workload(
        rng, args.selectivity, tweets=args.tweets, hashtags=args.hashtags,
        edges=edges, vocab=args.vocab, terms_lo=12, terms_hi=20)
    fn = compile_analysis(analysis, device=args.device)
    print(fn.explain())
    print()
    score = fn({}, inputs_for(table, graph, corpus, query, fn.device))
    score = score.cpu().numpy()
    top = np.argsort(-score, kind="stable")[:10]
    print(f"window: the last {args.selectivity:.2%} of {table.rows} tweets")
    print("top hashtags (seed expansion + text relevance):")
    for h in top:
        print(f"  #{h:<6} score={float(score[h]):.4f}")
    print(f"\nimpls: {', '.join(fn.chosen_impls())}")


if __name__ == "__main__":
    main()
