"""Tri-model analysis on the port: one ADIL program over table + graph +
corpus.

The port's copy of the reference example ``examples/tri_model_analysis.py``
(the paper's PoliSci scenario): a textual ADIL script declares the three
native store types and pipes them through one plan —

  1. relational: scan the tweet table, filter on engagement, count tweets
     per hashtag (the frontier seed);
  2. graph: 2-hop expansion over the hashtag co-mention graph, then
     personalized PageRank;
  3. text: top-k TF-IDF docs for a query, joined back to tweets and summed
     per hashtag;
  4. fused ranking = PageRank + text relevance.

:func:`build_social_data` draws from the numpy ``RandomState`` in the
reference's call order, so one seed gives the reference's arrays; it
indexes the corpus in one vectorized pass instead of one document at a
time.

    PYTHONPATH=src python -m repro_torch.examples.tri_model_analysis \\
        [--tweets N] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import compile as compile_analysis
from ..core.adil_parser import parse_adil
from ..core.ir import standard_catalog
from ..stores import ColumnStore, GraphStore, TextStore


def build_social_data(rng, *, users=500, hashtags=128, tweets=20_000,
                      vocab=256):
    """Synthetic social-media slice: a tweet table, a hashtag co-mention
    graph, and the tweet-text corpus (one doc per tweet)."""
    user = rng.randint(0, users, tweets).astype(np.int32)
    tag = (rng.zipf(1.3, tweets) % hashtags).astype(np.int32)
    doc = np.arange(tweets, dtype=np.int32)
    engagement = (rng.gamma(2.0, 12.0, tweets)).astype(np.float32)
    table = ColumnStore({"user": user, "hashtag": tag, "doc": doc,
                         "engagement": engagement})

    # co-mention edges: tweets by the same user mentioning different tags
    order = np.argsort(user, kind="stable")
    u_sorted, t_sorted = user[order], tag[order]
    same_user = u_sorted[1:] == u_sorted[:-1]
    diff_tag = t_sorted[1:] != t_sorted[:-1]
    sel = same_user & diff_tag
    graph = GraphStore.from_edges(t_sorted[:-1][sel], t_sorted[1:][sel],
                                  hashtags, symmetric=True)

    lens = rng.randint(3, 12, tweets)
    flat = (rng.zipf(1.4, int(lens.sum())) % vocab).astype(np.int64)
    corpus = TextStore.from_flat(flat, lens, vocab)
    return table, graph, corpus


def adil_script(table, graph, corpus):
    t = table.type
    cols = ", ".join(f"[{n}, {d}]" for n, d in t.columns)
    return f"""
USE socialDB;
create analysis hashtag_pulse as {{
  tweets := table(rows={t.rows}, cols=[{cols}]);
  g      := graph(nodes={graph.type.nodes}, edges={graph.type.edges});
  cx     := corpus(docs={corpus.type.docs}, vocab={corpus.type.vocab},
                   postings={corpus.type.postings});
  q      := input([{corpus.type.vocab}], float32, dims=[vocab]);

  t      := rel_scan(tweets);
  hot    := rel_filter(t, col=engagement, cmp=ge, value=30.0);
  seeds  := rel_group_agg(hot, key=hashtag, num_groups={graph.type.nodes},
                          aggs=[[seed, count, hashtag]]);
  sv     := col_tensor(seeds, col=seed, dim=nodes);

  fr     := graph_expand(g, sv, hops=2);
  pr     := graph_pagerank(g, fr, iters=8, damping=0.85);

  hits   := text_topk(cx, q, k=64);
  j      := rel_join(hits, tweets, left_on=doc, right_on=doc);
  trel   := rel_group_agg(j, key=hashtag, num_groups={graph.type.nodes},
                          aggs=[[textrel, sum, score]]);
  tv     := col_tensor(trel, col=textrel, dim=nodes);

  score  := residual_add(pr, tv);
  store(score);
}}
"""


def inputs_for(table, graph, corpus, query, device) -> dict:
    """The plan inputs of ``hashtag_pulse`` on ``device``."""
    return {"tweets": table.payload(device), "g": graph.payload(device),
            "cx": corpus.payload(device),
            "q": torch.from_numpy(np.asarray(query, np.float32)).to(device)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tweets", type=int, default=20_000)
    ap.add_argument("--users", type=int, default=500)
    ap.add_argument("--hashtags", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    rng = np.random.RandomState(args.seed)
    table, graph, corpus = build_social_data(
        rng, users=args.users, hashtags=args.hashtags, tweets=args.tweets,
        vocab=args.vocab)
    analysis = parse_adil(adil_script(table, graph, corpus),
                          standard_catalog())
    fn = compile_analysis(analysis, device=args.device)
    print(fn.explain())
    print()

    query = corpus.query_vector(rng.randint(0, args.vocab, 6))
    score = fn({}, inputs_for(table, graph, corpus, query, fn.device))
    score = score.cpu().numpy()
    top = np.argsort(-score, kind="stable")[:10]
    print("top hashtags (pagerank + text relevance):")
    for h in top:
        print(f"  #{h:<6} score={float(score[h]):.4f}")
    xfers = [r for r in fn.report if r["pattern"] == "xfer_op"]
    pins = sum(1 for r in xfers if r["chosen"] == "xfer_pin")
    print(f"\ncross-engine boundaries: {len(xfers)}, pinned in device "
          f"memory: {pins}")


if __name__ == "__main__":
    main()
