"""``hashtag_pulse``: the paper's tri-model analysis, as the ADIL text of
the reference's ``examples/tri_model_analysis.py``, with the engagement
threshold and the PageRank iterations as parameters.

  1. relational: tweets with ``engagement >= threshold``, counted per
     hashtag (the frontier seed);
  2. graph: a 2-hop expansion of the seed over the co-mention graph, then
     personalised PageRank (damping 0.85);
  3. text: the top 64 documents for the query ``q``, joined back to the
     tweets and summed per hashtag;
  4. the fused score: PageRank + text relevance, one float per hashtag.

Params: ``threshold`` (float), ``iters`` (int).
"""
K = 64
HOPS = 2
DAMPING = 0.85
INPUTS = ("tweets", "g", "cx", "q")


def adil(stores: dict, params: dict) -> str:
    table, graph, corpus = stores["tweets"], stores["g"], stores["cx"]
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
  hot    := rel_filter(t, col=engagement, cmp=ge,
                       value={float(params["threshold"])!r});
  seeds  := rel_group_agg(hot, key=hashtag, num_groups={graph.type.nodes},
                          aggs=[[seed, count, hashtag]]);
  sv     := col_tensor(seeds, col=seed, dim=nodes);

  fr     := graph_expand(g, sv, hops={HOPS});
  pr     := graph_pagerank(g, fr, iters={int(params["iters"])},
                           damping={DAMPING});

  hits   := text_topk(cx, q, k={K});
  j      := rel_join(hits, tweets, left_on=doc, right_on=doc);
  trel   := rel_group_agg(j, key=hashtag, num_groups={graph.type.nodes},
                          aggs=[[textrel, sum, score]]);
  tv     := col_tensor(trel, col=textrel, dim=nodes);

  score  := residual_add(pr, tv);
  store(score);
}}
"""


def build(stores: dict, params: dict):
    """The program's analysis (parsed from the ADIL text)."""
    from repro_torch.core.adil_parser import parse_adil
    from repro_torch.core.ir import standard_catalog
    return parse_adil(adil(stores, params), standard_catalog())


def reference(ref, params: dict, q):
    """The output's ``(graph part, text part)`` by the plain reference
    ``ref`` (:class:`tribench.reference.Reference`)."""
    # the graph side has no q in it: computed once per parameter set
    key = ("pagerank", float(params["threshold"]), int(params["iters"]))
    if key not in ref.memo:
        hot = ref.cols["engagement"] >= float(params["threshold"])
        fr = ref.expand(ref.count_by("hashtag", hot), HOPS)
        ref.memo[key] = ref.pagerank(fr, int(params["iters"]), DAMPING)
    docs, scores = ref.topk(ref.scores(q), K)
    return ref.memo[key], ref.sum_by_doc("hashtag", docs, scores)
