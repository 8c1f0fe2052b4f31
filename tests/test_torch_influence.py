"""The influencer rollup — the tri-model analysis with a non-unique,
capacity-bounded join — on the port against the reference.

At the reference's smoke size (48,000 tweets, 1,024 hashtags, 16,384
influencer rows) the port's example (``repro_torch.examples.
tri_influence``) and the reference's one-shard workload, rebuilt here
with the reference's ``Analysis`` and stores, draw the same arrays from
one seed.  Both packages plan it with ``store_engines(pallas=True)`` under
one ``HardwareSpec`` and the default and unfused pipelines; the reference
runs with its Pallas kernels in interpret mode, the port on the CPU.
Every node's output is compared: relations on their valid rows, ids,
flags, counts and ``overflow`` exact, float sums ``rtol=1e-5, atol=1e-6``.

The reference's ``benchmarks/tri_store_sharded.py`` is not imported: its
import forces an 8-device host platform for the whole process.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# two intra-op threads: the suite runs beside other test workers
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.core import ir as jir  # noqa: E402
from repro.core.adil import Analysis as JAnalysis  # noqa: E402
from repro.core.executor import ExecContext as JExecContext  # noqa: E402
from repro.core.executor import run_plan_subset as jrun_subset  # noqa: E402
from repro.core.rewrite import DEFAULT_PIPELINE  # noqa: E402
from repro.stores import ColumnStore as JColumnStore  # noqa: E402
from repro.stores import GraphStore as JGraphStore  # noqa: E402
from repro.stores import TextStore as JTextStore  # noqa: E402
from repro.stores import store_engines as jengines  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.core import ir as tir  # noqa: E402
from repro_torch.core.executor import ExecContext, run_plan_subset  # noqa
from repro_torch.examples import tri_influence as ti  # noqa: E402
from repro_torch.stores import BoundedRel  # noqa: E402
from repro_torch.stores.column_store import hash_join_nonunique  # noqa

SIZE = ti.SMOKE
HW = dict(name="h100-sxm", peak_flops=989e12, hbm_bw=3.35e12, ici_bw=450e9,
          hbm_bytes=80e9, vmem_bytes=232_448)
NOFUSE_PIPELINE = tuple(p for p in DEFAULT_PIPELINE if p != "fuse_store_ops")
PIPELINES = {"default": DEFAULT_PIPELINE, "unfused": NOFUSE_PIPELINE}
RTOL, ATOL = 1e-5, 1e-6
CPU = torch.device("cpu")


def reference_workload(rng, *, tweets, docs, hashtags, edges, vocab,
                       terms_hi, iters, influencers):
    """``benchmarks/tri_store_sharded.py::build_workload(rng, 1, ...)``,
    line for line, on the reference's stores."""
    user = rng.randint(0, 65536, tweets).astype(np.int32)
    tag = (rng.zipf(1.3, tweets) % hashtags).astype(np.int32)
    cols = {
        "user": user,
        "hashtag": tag,
        "doc": np.arange(tweets, dtype=np.int32),
        "engagement": (rng.gamma(2.0, 12.0, tweets)).astype(np.float32),
        "retweets": rng.randint(0, 500, tweets).astype(np.int32),
    }
    for i in range(8):
        cols[f"metric{i}"] = rng.rand(tweets).astype(np.float32)
    table = JColumnStore(cols)
    e = rng.randint(0, hashtags, (2, edges))
    graph = JGraphStore.from_edges(e[0], e[1], hashtags, symmetric=True)
    lens = rng.randint(3, terms_hi, docs)
    flat = (rng.zipf(1.4, int(lens.sum())) % vocab).astype(np.int64)
    corpus = JTextStore.from_docs(np.split(flat, np.cumsum(lens)[:-1]), vocab)
    infl = JColumnStore({
        "user": rng.randint(0, 65536, influencers).astype(np.int32),
        "influence": rng.rand(influencers).astype(np.float32)})

    cat = jir.standard_catalog()
    with JAnalysis("tri_sharded_s1", cat) as a:
        tw = a.bind("tweets", table)
        gr = a.bind("g", graph)
        cx = a.bind("cx", corpus)
        fl = a.bind("infl", infl)
        q = a.input("q", jir.TensorT((vocab,), "float32", ("vocab",)))
        t = a.op("rel_scan", tw)
        hot = a.op("rel_filter", t, col="engagement", cmp="ge", value=25.0)
        viral = a.op("rel_filter", hot, col="retweets", cmp="ge", value=10)
        seeds = a.op("rel_group_agg", viral, key="hashtag",
                     num_groups=hashtags, aggs=(("seed", "count", None),))
        sv = a.op("col_tensor", seeds, col="seed", dim="nodes")
        fr = a.op("graph_expand", gr, sv, hops=2)
        pr = a.op("graph_pagerank", gr, fr, iters=iters, damping=0.85)
        hits = a.op("text_topk", cx, q, k=64)
        j = a.op("rel_join", t, hits, left_on="doc", right_on="doc")
        trel = a.op("rel_group_agg", j, key="hashtag", num_groups=hashtags,
                    aggs=(("textrel", "sum", "score"),))
        tv = a.op("col_tensor", trel, col="textrel", dim="nodes")
        mentions = a.op("bounded_join", viral, fl, left_on="user",
                        right_on="user", capacity=tweets)
        irel = a.op("rel_group_agg", mentions, key="hashtag",
                    num_groups=hashtags,
                    aggs=(("infl", "sum", "influence"),))
        iv = a.op("col_tensor", irel, col="infl", dim="nodes")
        comb = a.op("residual_add", a.op("residual_add", pr, tv), iv)
        a.store(comb)

    inputs = {"tweets": table.payload(), "g": graph.payload(),
              "cx": corpus.payload(), "infl": infl.payload(),
              "q": jnp.asarray(corpus.query_vector(rng.randint(0, vocab, 6)))}
    return a, inputs


@pytest.fixture(scope="module")
def workloads():
    jana, jins = reference_workload(np.random.RandomState(0), **SIZE)
    tana, stores, query = ti.build_workload(np.random.RandomState(0), **SIZE)
    return jana, jins, tana, stores, query


def test_influence_data_gives_the_reference_arrays(workloads):
    _, jins, _, (table, graph, corpus, infl), query = workloads
    np.testing.assert_array_equal(np.asarray(jins["q"]), query)
    for store, name in ((table, "tweets"), (infl, "infl")):
        for col, v in jins[name].cols.items():
            np.testing.assert_array_equal(store.column(col), np.asarray(v))
    for name in ("indptr", "indices", "src", "weights"):
        np.testing.assert_array_equal(getattr(graph, name),
                                      np.asarray(jins["g"][name]))
    for name in ("doc_ids", "term_ids", "tf", "doc_len", "idf"):
        np.testing.assert_array_equal(getattr(corpus, name),
                                      np.asarray(jins["cx"][name]))


def _same_value(got, want, where):
    if isinstance(got, BoundedRel):
        valid = np.asarray(want.valid)
        np.testing.assert_array_equal(got.valid.numpy(), valid, err_msg=where)
        assert int(got.count) == int(want.count), where
        assert bool(got.overflow) == bool(want.overflow), where
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
    jana, jins, tana, stores, query = workloads
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
    chains = {n.id: [s[0] for s in n.attrs["chain"]]
              for n in tfn.concrete.topo() if n.impl.startswith("rel_fused")}
    if pipeline == "default":
        # the join feeds the masked group-by kernel inside one fused chain
        assert ["bounded_join", "rel_group_agg"] in chains.values()
        assert impls.count("rel_fused_agg_pallas") == 2
    else:
        assert "bounded_join_col" in impls and not chains

    jenv = jrun_subset(jfn.concrete, JExecContext(root={}, scope={}), jins,
                       [n.id for n in jfn.concrete.topo()])
    tenv = run_plan_subset(tfn.concrete,
                           ExecContext(root={}, scope={}, device=CPU),
                           ti.inputs_for(*stores, query, "cpu"),
                           [n.id for n in tfn.concrete.topo()])
    for n in tfn.concrete.topo():
        _same_value(tenv[n.id], jenv[n.id], f"{n.id}:{n.impl}")
    got = tenv[tfn.concrete.outputs[0]]
    assert got.shape == (SIZE["hashtags"],) and torch.isfinite(got).all()
    # the three rollups are the col_tensor nodes; the influence one is
    # nonzero (the join matched) and the join did not overflow
    rollups = [tenv[n.id] for n in tfn.concrete.topo()
               if n.impl == "col_tensor_rel"]
    assert len(rollups) == 3 and all(bool(r.any()) for r in rollups)


def test_join_of_the_viral_tweets_matches_reference(workloads):
    """The analysis's bounded join on its own inputs: every slot equal; a
    viral tweet matches ``influencers / 65,536`` rows on average, well
    inside ``capacity = tweets``."""
    jana, jins, tana, stores, query = workloads
    table, _, _, infl = stores
    from repro.stores.column_store import hash_join_nonunique as jjoin
    rel, irel = table.payload("cpu"), infl.payload("cpu")
    viral = (rel.valid & (rel.cols["engagement"] >= 25.0)
             & (rel.cols["retweets"] >= 10))
    cap = SIZE["tweets"]
    got = hash_join_nonunique(rel.cols["user"], viral, irel.cols["user"],
                              irel.valid, cap)
    want = jjoin(jins["tweets"].cols["user"], jnp.asarray(viral.numpy()),
                 jins["infl"].cols["user"], jins["infl"].valid, cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    expect = int(viral.sum()) * SIZE["influencers"] / 65536
    assert 0.8 * expect < int(got[3]) < 1.2 * expect and not bool(got[4])
