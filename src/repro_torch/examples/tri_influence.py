"""Influencer rollup on the port: the tri-model analysis with a non-unique,
capacity-bounded join to an influencer side table.

The port's copy of the reference's tri-store workload
(``benchmarks/tri_store_sharded.py::build_workload``) on one device, its
unsharded "single" run:

  1. relational: scan the tweet table, keep the hot (``engagement >=
     25``) and then the viral (``retweets >= 10``) tweets, count them per
     hashtag (the frontier seed);
  2. graph: 2-hop expansion of the seed over the hashtag graph, then
     personalized PageRank;
  3. text: top-k TF-IDF documents for a query, joined back to the tweets
     and summed per hashtag;
  4. the viral tweets ``bounded_join`` the influencer table on ``user``
     (several influencer rows a user; ``capacity`` slots, overflow
     flagged), summed per hashtag;
  5. fused ranking = PageRank + text relevance + influence.

:func:`influence_arrays` draws from the numpy ``RandomState`` in the
reference's call order, so one seed gives the reference's arrays; the
corpus is indexed with ``TextStore.from_flat`` (arrays equal
``from_docs``').

    PYTHONPATH=src python -m repro_torch.examples.tri_influence \\
        [--tweets N] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import compile as compile_analysis
from ..core.adil import Analysis
from ..core.ir import TensorT, standard_catalog
from ..stores import ColumnStore, GraphStore, TextStore

# the reference's --smoke sizes (its first), small enough for the CPU
SMOKE = dict(tweets=48_000, docs=8_000, hashtags=1024, edges=8_000,
             vocab=256, terms_hi=6, iters=2, influencers=16_384)


def tweet_columns(rng, tweets, hashtags) -> dict:
    """The tweet table's columns, drawn in the reference's order."""
    cols = {
        "user": rng.randint(0, 65536, tweets).astype(np.int32),
        "hashtag": (rng.zipf(1.3, tweets) % hashtags).astype(np.int32),
        "doc": np.arange(tweets, dtype=np.int32),
        "engagement": (rng.gamma(2.0, 12.0, tweets)).astype(np.float32),
        "retweets": rng.randint(0, 500, tweets).astype(np.int32),
    }
    for i in range(8):
        cols[f"metric{i}"] = rng.rand(tweets).astype(np.float32)
    return cols


def corpus_terms(rng, docs, vocab, terms_hi):
    """``(terms, lengths)`` of ``docs`` documents of 3 to ``terms_hi - 1``
    zipf-drawn term ids each, back to back."""
    lens = rng.randint(3, terms_hi, docs)
    flat = (rng.zipf(1.4, int(lens.sum())) % vocab).astype(np.int64)
    return flat, lens


def influence_arrays(rng, *, tweets, docs, hashtags, edges, vocab,
                     terms_hi, influencers, **_) -> dict:
    """The stores' host arrays, drawn in the reference's order: the tweet
    columns, the graph's random pairs ``(2, edges)``, the corpus's terms
    and lengths, and the influencer columns (non-unique ``user`` keys)."""
    cols = tweet_columns(rng, tweets, hashtags)
    pairs = rng.randint(0, hashtags, (2, edges))
    terms, lengths = corpus_terms(rng, docs, vocab, terms_hi)
    infl = {"user": rng.randint(0, 65536, influencers).astype(np.int32),
            "influence": rng.rand(influencers).astype(np.float32)}
    return {"tweets": cols, "pairs": pairs, "terms": terms,
            "lengths": lengths, "infl": infl}


def stores_from_arrays(arrays, *, hashtags, vocab, **_):
    """The tweet table, the hashtag graph (the pairs made symmetric), the
    corpus and the influencer table over :func:`influence_arrays`'
    output."""
    pairs = arrays["pairs"]
    return (ColumnStore(arrays["tweets"]),
            GraphStore.from_edges(pairs[0], pairs[1], hashtags,
                                  symmetric=True),
            TextStore.from_flat(arrays["terms"], arrays["lengths"], vocab),
            ColumnStore(arrays["infl"]))


def influence_rollup(table, graph, corpus, infl, *, iters, k=64,
                     capacity=None, name="tri_sharded_s1") -> Analysis:
    """The analysis over the four stores; ``capacity`` of the bounded join
    defaults to the tweet count, as in the reference.  ``name`` is the
    reference's for its one-shard build (plan ids hash it)."""
    hashtags, vocab = graph.n_nodes, corpus.vocab
    cap = table.rows if capacity is None else int(capacity)
    with Analysis(name, standard_catalog()) as a:
        tw = a.bind("tweets", table)
        gr = a.bind("g", graph)
        cx = a.bind("cx", corpus)
        fl = a.bind("infl", infl)
        q = a.input("q", TensorT((vocab,), "float32", ("vocab",)))
        t = a.op("rel_scan", tw)
        hot = a.op("rel_filter", t, col="engagement", cmp="ge", value=25.0)
        viral = a.op("rel_filter", hot, col="retweets", cmp="ge", value=10)
        seeds = a.op("rel_group_agg", viral, key="hashtag",
                     num_groups=hashtags, aggs=(("seed", "count", None),))
        sv = a.op("col_tensor", seeds, col="seed", dim="nodes")
        fr = a.op("graph_expand", gr, sv, hops=2)
        pr = a.op("graph_pagerank", gr, fr, iters=iters, damping=0.85)
        hits = a.op("text_topk", cx, q, k=k)
        j = a.op("rel_join", t, hits, left_on="doc", right_on="doc")
        trel = a.op("rel_group_agg", j, key="hashtag", num_groups=hashtags,
                    aggs=(("textrel", "sum", "score"),))
        tv = a.op("col_tensor", trel, col="textrel", dim="nodes")
        mentions = a.op("bounded_join", viral, fl, left_on="user",
                        right_on="user", capacity=cap)
        irel = a.op("rel_group_agg", mentions, key="hashtag",
                    num_groups=hashtags,
                    aggs=(("infl", "sum", "influence"),))
        iv = a.op("col_tensor", irel, col="infl", dim="nodes")
        comb = a.op("residual_add", a.op("residual_add", pr, tv), iv)
        a.store(comb)
    return a


def build_workload(rng, **size):
    """Stores, analysis and query in the reference's RandomState order:
    ``(analysis, (table, graph, corpus, infl), query)``."""
    stores = stores_from_arrays(influence_arrays(rng, **size), **size)
    analysis = influence_rollup(*stores, iters=size["iters"])
    query = stores[2].query_vector(rng.randint(0, size["vocab"], 6))
    return analysis, stores, query


def inputs_for(table, graph, corpus, infl, query, device) -> dict:
    """The plan inputs on ``device``."""
    return {"tweets": table.payload(device), "g": graph.payload(device),
            "cx": corpus.payload(device), "infl": infl.payload(device),
            "q": torch.from_numpy(np.asarray(query, np.float32)).to(device)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tweets", type=int, default=SMOKE["tweets"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    rng = np.random.RandomState(args.seed)
    analysis, stores, query = build_workload(
        rng, **{**SMOKE, "tweets": args.tweets})
    fn = compile_analysis(analysis, device=args.device)
    print(fn.explain())
    print()
    score = fn({}, inputs_for(*stores, query, fn.device))
    score = score.cpu().numpy()
    top = np.argsort(-score, kind="stable")[:10]
    print(f"{stores[0].rows} tweets, {stores[3].rows} influencer rows")
    print("top hashtags (PageRank + text relevance + influence):")
    for h in top:
        print(f"  #{h:<6} score={float(score[h]):.4f}")
    print(f"\nimpls: {', '.join(fn.chosen_impls())}")


if __name__ == "__main__":
    main()
