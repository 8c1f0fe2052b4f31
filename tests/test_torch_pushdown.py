"""The pushdown path — the time-windowed ranking analysis — on the port
against the reference.

At a small size (400 tweets, 64 hashtags, vocab 128) the port's example
and ``benchmarks/tri_store_eff.build_selective_workload`` build the same
stores from one seed.  Both packages plan the analysis under the default,
the unpushed and the unfused pipeline with ``store_engines(pallas=True)``
and one ``HardwareSpec``; the reference runs with its Pallas kernels in
interpret mode, the port on the CPU (its kernels' plain versions).  Every
node's output is compared: relations on their valid rows, ids, flags and
counts exact, float sums ``rtol=1e-5, atol=1e-6``.

Inside the port the reference's bitwise equivalences hold: pushed ≡
unpushed at the edge selectivities, block-skipping ≡ dense scoring and
expansion, and kernel compaction ≡ gather compaction on valid rows.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# two intra-op threads: the suite runs beside other test workers
torch.set_num_threads(2)

from benchmarks.tri_store_eff import (  # noqa: E402
    build_selective_workload as jbuild)
from repro.core import ir as jir  # noqa: E402
from repro.core.executor import ExecContext as JExecContext  # noqa: E402
from repro.core.executor import run_plan_subset as jrun_subset  # noqa: E402
from repro.core.rewrite import DEFAULT_PIPELINE  # noqa: E402
from repro.core.rewrite import UNPUSHED_PIPELINE  # noqa: E402
from repro.stores import store_engines as jengines  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.core import ir as tir  # noqa: E402
from repro_torch.core.engines import dispatch  # noqa: E402
from repro_torch.core.executor import ExecContext, run_plan_subset  # noqa
from repro_torch.examples import windowed_ranking as wr  # noqa: E402
from repro_torch.kernels import masked_tfidf  # noqa: E402
from repro_torch.stores import (BoundedRel, ColumnStore,  # noqa: E402
                                GraphStore, TextStore, store_engines)
from repro_torch.stores.graph_store import (  # noqa: E402
    expand_frontier, expand_frontier_blockskip, pagerank)
from repro_torch.stores.runtime import _step_compact  # noqa: E402
from repro_torch.stores.text_store import (  # noqa: E402
    masked_topk, tfidf_topk_blockskip, tfidf_topk_masked)

SIZE = dict(tweets=400, hashtags=64, edges=240, vocab=128, terms_lo=12,
            terms_hi=20)
HW = dict(name="h100-sxm", peak_flops=989e12, hbm_bw=3.35e12, ici_bw=450e9,
          hbm_bytes=80e9, vmem_bytes=232_448)
NOFUSE_PIPELINE = tuple(p for p in DEFAULT_PIPELINE if p != "fuse_store_ops")
PIPELINES = {"default": DEFAULT_PIPELINE, "unpushed": UNPUSHED_PIPELINE,
             "unfused": NOFUSE_PIPELINE}
TOPK_IMPLS = ("text_topk_inv", "text_topk_skip_inv", "text_topk_masked_pallas",
              "masked_topk_xla")
RTOL, ATOL = 1e-5, 1e-6
CPU = torch.device("cpu")


def _env(fn, inputs):
    ctx = ExecContext(root={}, scope={}, device=CPU)
    return run_plan_subset(fn.concrete, ctx, inputs,
                           [n.id for n in fn.concrete.topo()])


def _topk(fn, env):
    (nid,) = [n.id for n in fn.concrete.topo() if n.impl in TOPK_IMPLS]
    return env[nid]


@pytest.fixture(scope="module", params=[0.01, 0.2], ids=["sel1", "sel20"])
def workloads(request):
    sel = request.param
    jrng, trng = np.random.RandomState(0), np.random.RandomState(0)
    jana, jins = jbuild(jrng, sel, **SIZE)
    tana, stores, query = wr.build_selective_workload(trng, sel, **SIZE)
    return sel, jana, jins, tana, stores, query


def test_window_data_gives_the_reference_arrays(workloads):
    _, _, jins, _, (table, graph, corpus), query = workloads
    np.testing.assert_array_equal(np.asarray(jins["q"]), query)
    for name, col in jins["tweets"].cols.items():
        np.testing.assert_array_equal(table.column(name), np.asarray(col))
    for name in ("indptr", "indices", "src", "weights"):
        np.testing.assert_array_equal(getattr(graph, name),
                                      np.asarray(jins["g"][name]))
    for name in ("doc_ids", "term_ids", "tf", "doc_len", "idf"):
        np.testing.assert_array_equal(getattr(corpus, name),
                                      np.asarray(jins["cx"][name]))


def _same_value(got, want, where):
    """One node's output, the port's against the reference's."""
    if isinstance(got, BoundedRel):
        valid = np.asarray(want.valid)
        np.testing.assert_array_equal(got.valid.numpy(), valid, err_msg=where)
        assert set(got.cols) == set(want.cols), where
        for k, v in got.cols.items():
            g, w = v.numpy()[valid], np.asarray(want.cols[k])[valid]
            if np.issubdtype(w.dtype, np.floating):
                np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                           err_msg=f"{where}.{k}")
            else:
                np.testing.assert_array_equal(g, w, err_msg=f"{where}.{k}")
    elif isinstance(got, torch.Tensor):
        w = np.asarray(want)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(got.numpy(), w, rtol=RTOL, atol=ATOL,
                                       err_msg=where)
        else:
            np.testing.assert_array_equal(got.numpy(), w, err_msg=where)


@pytest.mark.parametrize("pipeline", list(PIPELINES))
def test_plans_and_outputs_match_reference(workloads, pipeline):
    sel, jana, jins, tana, stores, query = workloads
    pipe = PIPELINES[pipeline]
    jfn = jana.compile(jir.SystemCatalog(hardware=jir.HardwareSpec(**HW)),
                       engines=jengines(pallas=True), cache=False,
                       rewrite_pipeline=pipe)
    tfn = repro_torch.compile(
        tana, tir.SystemCatalog(hardware=tir.HardwareSpec(**HW)),
        device="cpu", cache=False, rewrite_pipeline=pipe)
    assert tfn.plan_id == jfn.plan_id
    impls = tfn.chosen_impls()
    assert impls == [n.impl for n in jfn.concrete.topo()]
    assert [n.id for n in tfn.concrete.topo()] == \
        [n.id for n in jfn.concrete.topo()]
    want_kernels = {"default": {"text_topk_masked_pallas",
                                "rel_fused_agg_pallas"},
                    "unpushed": {"text_scores_inv", "masked_topk_xla"},
                    "unfused": {"text_topk_masked_pallas",
                                "rel_join_probe_pallas"}}[pipeline]
    assert want_kernels <= set(impls)
    if sel == 0.01:
        assert "graph_expand_skip" in impls or pipeline == "unpushed"

    jenv = jrun_subset(jfn.concrete, JExecContext(root={}, scope={}), jins,
                       [n.id for n in jfn.concrete.topo()])
    tenv = _env(tfn, wr.inputs_for(*stores, query, "cpu"))
    for n in tfn.concrete.topo():
        _same_value(tenv[n.id], jenv[n.id], f"{n.id}:{n.impl}")
    got = tenv[tfn.concrete.outputs[0]]
    assert got.shape == (SIZE["hashtags"],) and torch.isfinite(got).all()
    hits, jhits = _topk(tfn, tenv), _topk(jfn, jenv)
    np.testing.assert_array_equal(hits.cols["doc"].numpy(),
                                  np.asarray(jhits.cols["doc"]))
    np.testing.assert_array_equal(hits.valid.numpy(),
                                  np.asarray(jhits.valid))
    # the window is the last sel share of the tweets: k=64 overflows at 1 %
    window = SIZE["tweets"] - int(SIZE["tweets"] * (1 - sel))
    assert int(hits.count) == min(64, window)
    assert bool((hits.cols["score"][~hits.valid] == 0).all())


# the reference's edge cases (tests/test_pushdown.py:336): empty window,
# full window, k beyond the doc count, a narrow k
EDGE_CASES = [(0.0, 8), (1.0, 8), (0.05, 10_000), (0.2, 4)]
SMALL = dict(tweets=80, hashtags=12, edges=48, vocab=16, terms_lo=2,
             terms_hi=8)


@pytest.fixture(scope="module")
def small():
    rng = np.random.RandomState(1)
    stores = wr.build_window_data(rng, **SMALL)
    query = stores[2].query_vector([1, 2, 3])
    return stores, wr.inputs_for(*stores, query, "cpu")


@pytest.mark.parametrize("sel,k", EDGE_CASES)
def test_pushed_plan_bitwise_equals_unpushed(small, sel, k):
    stores, ins = small
    a = wr.windowed_ranking(*stores, selectivity=sel, k=k)
    plans = {}
    for pallas in (False, True):
        for name, pipe in (("pushed", DEFAULT_PIPELINE),
                           ("unpushed", UNPUSHED_PIPELINE)):
            plans[name, pallas] = repro_torch.compile(
                a, device="cpu", engines=store_engines(pallas=pallas),
                cache=False, rewrite_pipeline=pipe)
    # plain engines: the whole output, as the reference compares it
    assert torch.equal(plans["pushed", False]({}, ins),
                       plans["unpushed", False]({}, ins))
    # with the kernel slot: the top-k hits, ids and scores
    hp = _topk(plans["pushed", True], _env(plans["pushed", True], ins))
    hu = _topk(plans["unpushed", True], _env(plans["unpushed", True], ins))
    for col in ("doc", "score"):
        assert torch.equal(hp.cols[col], hu.cols[col]), col
    assert torch.equal(hp.valid, hu.valid)
    # the kernel realization is offered up to 25 % selectivity
    assert ("text_topk_masked_pallas" in plans["pushed", True]
            .chosen_impls()) == (sel <= 0.25)


def test_blockskip_and_kernel_scoring_bitwise_match_dense():
    rng = np.random.RandomState(0)
    docs, vocab = 300, 32
    tx = TextStore.from_docs(
        [rng.randint(0, vocab, rng.randint(0, 7)) for _ in range(docs)],
        vocab)
    cp = tx.payload("cpu")
    q = torch.from_numpy(tx.query_vector([2, 4, 4, 7]))
    for mask in (np.zeros(docs, bool), np.ones(docs, bool),
                 np.arange(docs) >= docs - 30, rng.rand(docs) > 0.9):
        m = torch.from_numpy(mask)
        want = tfidf_topk_masked(cp, q, m, 16)
        scores = masked_tfidf(cp["doc_ptr"], cp["term_ids"], cp["tf"],
                              cp["doc_len"], q * cp["idf"], m,
                              cp["max_doc_postings"])
        for got in [tfidf_topk_blockskip(cp, q, m, 16, block=blk)
                    for blk in (8, 64, 1 << 20)] + [masked_topk(scores, m,
                                                                16)]:
            for g, w in zip(got, want):
                assert torch.equal(g, w)
        assert bool((want[1][~want[2]] == 0).all())


def test_graph_blockskip_bitwise_matches_dense():
    rng = np.random.RandomState(0)
    n, e = 200, 900
    g = GraphStore.from_edges(rng.randint(0, n, e), rng.randint(0, n, e), n,
                              symmetric=True).payload("cpu")
    for density in (0.0, 0.02, 1.0):
        fr = torch.from_numpy(np.where(rng.rand(n) < density, rng.rand(n),
                                       0.0).astype(np.float32))
        for hops in (1, 3):
            assert torch.equal(
                expand_frontier_blockskip(g, fr, hops=hops, block=128),
                expand_frontier(g, fr, hops=hops))
        assert torch.equal(pagerank(g, iters=3, personalization=fr,
                                    skip_first=True, block=128),
                           pagerank(g, iters=3, personalization=fr))


def test_compact_kernel_impl_matches_gather_on_valid_rows():
    """The registered ``compact_prefix_pallas`` impl, through the engine
    dispatch, against ``compact_prefix_col`` (the reference's
    tests/test_bounded.py:176), with int32 keys below 2^24 (which pass
    through float32 exactly) and a bool column."""
    rng = np.random.RandomState(0)
    rel = ColumnStore({
        "a": rng.randint(-2**24, 2**24, 90).astype(np.int32),
        "b": rng.randn(90).astype(np.float32),
        "c": rng.rand(90) > 0.5,
    }).payload("cpu").narrowed(torch.from_numpy(rng.rand(90) > 0.7))
    kernel = dispatch("compact_prefix_pallas", "pallas")
    gather = dispatch("compact_prefix_col", "rel")
    ctx = ExecContext(root={}, scope={}, device=CPU)
    for cap in (8, 40):
        node = type("Node", (), {"attrs": {"capacity": cap}})()
        got, want = kernel(ctx, [rel], node), gather(ctx, [rel], node)
        assert torch.equal(got.valid, want.valid)
        assert int(got.count) == int(want.count)
        assert bool(got.overflow) == bool(want.overflow) == (cap == 8)
        v = want.valid
        for k in ("a", "b", "c"):
            assert got.cols[k].dtype == want.cols[k].dtype
            assert torch.equal(got.cols[k][v], want.cols[k][v]), k
        assert torch.equal(want.valid, _step_compact(rel, node.attrs).valid)


def test_sel_mask_records_its_count(workloads):
    sel, _, _, tana, stores, query = workloads
    fn = repro_torch.compile(tana, device="cpu", cache=False)
    sink = []
    fn({}, wr.inputs_for(*stores, query, "cpu"), aux={"count_sink": sink})
    (obs,) = [o for o in sink if o[0][0] == "sel_mask"]
    window = SIZE["tweets"] - int(SIZE["tweets"] * (1 - sel))
    assert obs[0] == ("sel_mask", "doc", SIZE["tweets"])
    assert int(obs[1]) == window and obs[2] == SIZE["tweets"]


def _reference_windowed(table, graph, corpus, sel, k=64):
    """The reference's ``tri_selective_<sel>`` analysis over store types
    alone (``build_selective_workload`` builds it only with data)."""
    from repro.core.adil import Analysis
    cut = int(table.rows * (1.0 - sel))
    with Analysis(f"tri_selective_{sel}", jir.standard_catalog()) as a:
        tw, gr, cx = (a.bind("tweets", table), a.bind("g", graph),
                      a.bind("cx", corpus))
        q = a.input("q", jir.TensorT((corpus.vocab,), "float32", ("vocab",)))
        recent = a.op("rel_filter", a.op("rel_scan", tw), col="ts",
                      cmp="ge", value=cut, selectivity=sel)
        m = a.op("sel_mask", recent, col="doc", size=corpus.n_docs)
        hits = a.op("masked_topk", a.op("text_scores", cx, q), m, k=k)
        j = a.op("rel_join", recent, hits, left_on="doc", right_on="doc")
        trel = a.op("rel_group_agg", j, key="hashtag",
                    num_groups=graph.n_nodes,
                    aggs=(("textrel", "sum", "score"),))
        seeds = a.op("rel_group_agg", recent, key="hashtag",
                     num_groups=graph.n_nodes, aggs=(("seed", "count", None),))
        fr = a.op("graph_expand", gr, a.op("col_tensor", seeds, col="seed",
                                           dim="nodes"), hops=2)
        tv = a.op("col_tensor", trel, col="textrel", dim="nodes")
        a.store(a.op("residual_add", fr, tv))
    return a


@pytest.mark.parametrize("pipeline", list(PIPELINES))
def test_full_size_plans_equal_reference_and_chip_smoke(pipeline):
    """At the chip smoke's size (10M tweets, 94.7M postings) both planners
    choose the same plan, and it is the one ``chip_smoke.py`` expects."""
    import importlib.util
    from collections import Counter
    from pathlib import Path
    from types import SimpleNamespace as NS
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    w = smoke.WINDOW
    cols = (("hashtag", "int32"), ("doc", "int32"), ("ts", "int32"),
            ("engagement", "float32")) + tuple(
        (f"metric{i}", "float32") for i in range(8))

    def stores(ir):
        return (NS(type=ir.TableT(cols, w["tweets"]), rows=w["tweets"]),
                NS(type=ir.GraphT(w["hashtags"], 2 * w["edges"]),
                   n_nodes=w["hashtags"]),
                NS(type=ir.CorpusT(w["tweets"], w["vocab"], 94_735_201),
                   n_docs=w["tweets"], vocab=w["vocab"]))

    pipe = PIPELINES[pipeline]
    jfn = _reference_windowed(*stores(jir), smoke.SELECTIVITY).compile(
        jir.SystemCatalog(hardware=jir.HardwareSpec(**HW)),
        engines=jengines(pallas=True), cache=False, rewrite_pipeline=pipe)
    tfn = repro_torch.compile(
        wr.windowed_ranking(*stores(tir), smoke.SELECTIVITY),
        tir.SystemCatalog(hardware=tir.HardwareSpec(**HW)), device="cpu",
        cache=False, rewrite_pipeline=pipe)
    assert tfn.plan_id == jfn.plan_id
    assert tfn.chosen_impls() == [n.impl for n in jfn.concrete.topo()]
    want_pipe, want_impls, _launches = smoke.WINDOW_PLANS[pipeline]
    assert want_pipe == pipe
    assert Counter(tfn.chosen_impls()) == want_impls
