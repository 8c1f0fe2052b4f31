"""The sharded tri-store on the port against the reference.

The stores partitioned with ``with_shards``, the seven sharded operators of
``repro_torch.stores.sharded`` over a ``torch.distributed`` gloo world on
the CPU, and the influencer rollup ``repro_torch.examples.tri_sharded``
through ``repro_torch.compile(..., mesh=)`` at 2 and 4 ranks.

  * plans: the port's plan of ``tri_sharded`` at the reference's smoke
    size equals the reference's (id, impls, ``dist`` and ``bucket_cap``,
    xfer kinds) under one ``SystemCatalog``;
  * payloads: ``with_shards(n)`` payloads equal the reference's key by key
    and bit for bit, and the ledger's ``actual - predicted`` is the
    reference's;
  * operators: one spawned world at n = 2 and one at n = 4 run every
    operator on seeded cases.  Each is held against the reference's dense
    function at the reference's strength (bitwise joins and top-k,
    set-equal partitioned join, allclose group sums) — graph results
    ``rtol=1e-5, atol=1e-6``, as every port-vs-reference SpMV (the port's
    plain scatter sums in float64 and rounds once; the reference sums in
    float32) — and bitwise against the port's own dense op where the
    reference asserts bitwise.  A subprocess runs the reference's own
    ``stores/sharded.py`` on a forced 4-device host platform over the same
    cases: the partitioned join equals it slot for slot, the rest bitwise
    (PageRank and the group-by's float sums ``rtol=1e-5, atol=1e-6``);
  * the workload: at n = 2 and 4, under ``store_engines()`` and the port's
    default engines, every rank's output is the same tensor, allclose
    (``rtol=1e-4, atol=1e-5``, the reference benchmark's) to the
    reference's and the port's single run, the expand / PageRank / top-64
    outputs bitwise the port's single run's, and under ``analyze`` every
    ``dist`` node of a plain impl reports its ``coll``;
  * failure: a rank that raises ends the world at once with its error.

The reference's ``benchmarks/tri_store_sharded.py`` is not imported: its
import forces an 8-device host platform for the whole process.
"""
import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# two intra-op threads: the suite runs beside other test workers (the
# ranks take the parent's count)
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.core import ir as jir  # noqa: E402
from repro.core import ledger as jledger  # noqa: E402
from repro.core.adil import Analysis as JAnalysis  # noqa: E402
from repro.stores import ColumnStore as JColumnStore  # noqa: E402
from repro.stores import GraphStore as JGraphStore  # noqa: E402
from repro.stores import TextStore as JTextStore  # noqa: E402
from repro.stores import column_store as jcol  # noqa: E402
from repro.stores import graph_store as jgraph  # noqa: E402
from repro.stores import store_engines as jengines  # noqa: E402
from repro.stores import text_store as jtext  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.core import ir as tir  # noqa: E402
from repro_torch.core.executor import ExecContext, run_plan_subset  # noqa
from repro_torch.core.faults import FaultInjectedError  # noqa: E402
from repro_torch.core.ledger import default_ledger  # noqa: E402
from repro_torch.core.resilience import classify, fallback_class  # noqa
from repro_torch.examples import tri_influence as ti  # noqa: E402
from repro_torch.examples import tri_sharded as tsh  # noqa: E402
from repro_torch.launch.mesh import (RankError, run_calls,  # noqa: E402
                                     run_ranks, syscat_for_mesh)
from repro_torch.stores import (ColumnStore, GraphStore,  # noqa: E402
                                TextStore, store_engines)
from repro_torch.stores import column_store as tcol  # noqa: E402
from repro_torch.stores import graph_store as tgraph  # noqa: E402
from repro_torch.stores import sharded as S  # noqa: E402
from repro_torch.stores import text_store as ttext  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SIZE = ti.SMOKE
WORLDS = (2, 4)
ENGINE_SETS = ("xla", "xla,pallas")
HW = dict(name="h100-sxm", peak_flops=989e12, hbm_bw=3.35e12, ici_bw=450e9,
          hbm_bytes=80e9, vmem_bytes=232_448)
# the reference's own default part, under which its plan ids are quoted
REF_HW = dataclasses.asdict(jir.HardwareSpec())
RTOL, ATOL = 1e-5, 1e-6
BENCH_RTOL, BENCH_ATOL = 1e-4, 1e-5    # benchmarks/tri_store_sharded.py's
WORLD_TIMEOUT = 240.0


def reference_workload(rng, shards, *, tweets, docs, hashtags, edges, vocab,
                       terms_hi, iters, influencers):
    """``benchmarks/tri_store_sharded.py::build_workload``, line for line,
    on the reference's stores."""
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
    if shards > 1:
        table = table.with_shards(shards)
        graph = graph.with_shards(shards)
        corpus = corpus.with_shards(shards)
        infl = infl.with_shards(shards)

    cat = jir.standard_catalog()
    with JAnalysis(f"tri_sharded_s{shards}", cat) as a:
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


def _catalogs(hw, shards):
    mesh = dict(mesh_axes=("data", "model"), mesh_shape=(shards, 1))
    return (jir.SystemCatalog(hardware=jir.HardwareSpec(**hw), **mesh),
            tir.SystemCatalog(hardware=tir.HardwareSpec(**hw), **mesh))


@pytest.fixture(scope="module")
def workloads():
    """``{shards: (reference analysis, reference inputs, port analysis,
    port stores, query)}`` for 1, 2 and 4 shards."""
    out = {}
    for shards in (1,) + WORLDS:
        jana, jins = reference_workload(np.random.RandomState(0), shards,
                                        **SIZE)
        tana, stores, query = tsh.build_workload(np.random.RandomState(0),
                                                 shards, **SIZE)
        out[shards] = (jana, jins, tana, stores, query)
    return out


# --------------------------------------------------------------------------
# the mesh's catalog and plans
# --------------------------------------------------------------------------


def test_syscat_for_mesh_is_the_reference_shape():
    for world in WORLDS:
        got = syscat_for_mesh(SimpleNamespace(world=world))
        assert got == tir.SystemCatalog(mesh_axes=("data", "model"),
                                        mesh_shape=(world, 1))
    assert syscat_for_mesh(None).mesh_shape == (1, 1)


def _plan_summary(fn, topo):
    return ([n.impl for n in topo],
            [(n.impl, n.attrs["dist"], n.attrs.get("bucket_cap"))
             for n in topo if n.attrs.get("dist")],
            [n.impl for n in topo if n.impl.startswith("xfer_")])


@pytest.mark.parametrize("hw", ["h100", "reference"])
@pytest.mark.parametrize("engines", ENGINE_SETS)
@pytest.mark.parametrize("shards", WORLDS)
def test_plan_matches_reference(workloads, shards, engines, hw):
    jsys, tsys = _catalogs(HW if hw == "h100" else REF_HW, shards)
    pallas = engines == "xla,pallas"
    jana, _, tana, _, _ = workloads[shards]
    jfn = jana.compile(jsys, engines=jengines(pallas=pallas), cache=False)
    tfn = repro_torch.compile(tana, tsys, engines=store_engines(pallas=pallas),
                              device="cpu", cache=False)
    assert tfn.plan_id == jfn.plan_id
    got = _plan_summary(tfn, tfn.concrete.topo())
    want = _plan_summary(jfn, jfn.concrete.topo())
    assert got == want
    dists = {d for _, d, _ in got[1]}
    assert dists == {"row", "block", "doc", "broadcast", "partitioned"}
    assert sorted(got[2]) == sorted(["xfer_local"] * 5
                                    + ["xfer_repartition"] * 2
                                    + ["xfer_replicate"])
    # the unsharded workload plans apart
    jone, _, tone, _, _ = workloads[1]
    one = repro_torch.compile(tone, tsys, engines=store_engines(pallas=pallas),
                              device="cpu", cache=False)
    assert one.plan_id != tfn.plan_id


def test_plan_ids_quoted_from_the_reference(workloads):
    """The reference's ids at 4 shards under its default part, as quoted
    for its plans of ``store_engines()`` and ``store_engines(pallas=True)``
    (and the unsharded one)."""
    _, tsys = _catalogs(REF_HW, 4)
    _, tone = _catalogs(REF_HW, 1)
    ids = [repro_torch.compile(workloads[s][2], sys_, cache=False,
                               engines=store_engines(pallas=p),
                               device="cpu").plan_id[:12]
           for s, sys_, p in ((4, tsys, False), (4, tsys, True),
                              (1, tone, True))]
    assert ids == ["f231aab912b0", "341fd5eccc2e", "f5f8bfb22f37"]


# --------------------------------------------------------------------------
# payloads
# --------------------------------------------------------------------------


def _small_stores(pkg, shards):
    C, G, T = ((JColumnStore, JGraphStore, JTextStore) if pkg == "ref"
               else (ColumnStore, GraphStore, TextStore))
    rng = np.random.RandomState(3)
    table = C({"k": rng.randint(0, 9, 10).astype(np.int32),
               "v": rng.rand(10).astype(np.float32)})
    e = rng.randint(0, 10, (2, 60))
    graph = G.from_edges(e[0], e[1], 10,
                         weights=rng.rand(60).astype(np.float32) + 0.5)
    corpus = T.from_docs([rng.randint(0, 12, rng.randint(1, 7))
                          for _ in range(10)], 12)
    return {"column_store": table.with_shards(shards),
            "graph_store": graph.with_shards(shards),
            "text_store": corpus.with_shards(shards)}


@pytest.mark.parametrize("kind", ["column_store", "graph_store",
                                  "text_store"])
@pytest.mark.parametrize("shards", WORLDS)
def test_sharded_payload_is_the_reference(shards, kind):
    store = _small_stores("port", shards)[kind]
    jstore = _small_stores("ref", shards)[kind]
    assert repr(store.type) == repr(jstore.type)
    got, want = store.payload("cpu"), jstore.payload()
    if kind == "column_store":
        assert got.capacity == want.capacity == 10 + (-10) % shards
        got = {**got.cols, "valid": got.valid, "count": got.count}
        want = {**want.cols, "valid": want.valid, "count": want.count}
    else:
        assert {k for k in want if k.startswith("blk_")} == {
            k for k in got if k.startswith("blk_")}
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(w),
                                      err_msg=k)
        assert got[k].numpy().dtype == np.asarray(w).dtype, k
    e = default_ledger().get((kind, f"{id(store):#x}"))
    je = jledger.default_ledger().get((kind, f"{id(jstore):#x}"))
    assert e.nbytes - e.predicted == je.nbytes - je.predicted


def test_sharded_append_repads_as_the_reference():
    cols = {"k": np.arange(5, dtype=np.int32)}
    more = {"k": np.arange(3, dtype=np.int32)}
    got = ColumnStore(cols).with_shards(4).append(more)
    want = JColumnStore(cols).with_shards(4).append(more)
    assert (got.rows, got.capacity) == (want.rows, want.capacity) == (8, 8)
    got.append(more)
    want.append(more)
    assert (got.capacity, repr(got.type)) == (want.capacity,
                                               repr(want.type))


# --------------------------------------------------------------------------
# the operators
# --------------------------------------------------------------------------


def _cases(n):
    """Seeded operator cases at world ``n``: name -> arrays and ints."""
    rng = np.random.RandomState(100 + n)
    cases = {"count": {"valid": rng.rand(8 * n) > 0.4}}
    for fn in ("sum", "count", "mean", "max"):
        cases[f"agg_{fn}"] = {
            "values": rng.randn(10 * n).astype(np.float32),
            "keys": rng.randint(0, 12, 10 * n).astype(np.int32),
            "mask": rng.rand(10 * n) > 0.4, "groups": 12}
    cases["bjoin"] = {"lkeys": rng.randint(0, 80, 8 * n).astype(np.int32),
                      "rkeys": rng.permutation(80)[:30].astype(np.int32)}
    nl, nr = 4 * n, 3 * n
    join = {"lk": rng.randint(0, 16, nl).astype(np.int32),
            "lm": rng.rand(nl) > 0.3,
            "rk": rng.randint(0, 16, nr).astype(np.int32),
            "rm": rng.rand(nr) > 0.3}
    # headroom for every match in one owner: the match set is determined
    cases["pjoin"] = {**join, "cap": nl * nr * n, "bucket_cap": max(nl, nr)}
    # one-slot buckets: the shuffle drops rows and flags overflow
    cases["pjoin_drop"] = {**join, "cap": nl * nr * n, "bucket_cap": 1}
    nodes = 37
    pairs = rng.randint(0, nodes, (2, 150))
    padded = nodes + (-nodes) % n
    p = rng.rand(padded).astype(np.float32)
    graph = {"src": pairs[0], "dst": pairs[1], "nodes": nodes}
    cases["pagerank"] = {**graph, "p": p, "iters": 3}
    cases["expand"] = {**graph, "frontier": (p > 0.7).astype(np.float32),
                       "hops": 2}
    lengths = rng.randint(1, 10, 25)
    text = {"terms": rng.randint(0, 24, int(lengths.sum())),
            "lengths": lengths, "vocab": 24,
            "q": rng.randint(0, 24, 4)}
    cases["topk_5"] = {**text, "k": 5}
    cases["topk_40"] = {**text, "k": 40}      # past the doc count
    return cases


OPS = tuple(_cases(2))


def _graph_payload(c, n):
    return GraphStore.from_edges(c["src"], c["dst"], c["nodes"],
                                 symmetric=True).with_shards(n).payload("cpu")


def _corpus(c, n):
    return TextStore.from_flat(c["terms"], c["lengths"],
                               c["vocab"]).with_shards(n)


def _host(payload):
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v
            for k, v in payload.items()}


def _call(name, c, n):
    """``(fn, args, kwargs)`` of case ``name`` for :func:`run_calls`."""
    if name == "count":
        return S.sharded_count, (c["valid"],), {}
    if name.startswith("agg_"):
        return (S.sharded_group_agg, (c["values"], c["keys"], c["groups"],
                                      c["mask"], name[4:]), {})
    if name == "bjoin":
        return S.sharded_broadcast_join, (c["lkeys"], c["rkeys"]), {}
    if name.startswith("pjoin"):
        return (S.sharded_partitioned_join,
                (c["lk"], c["lm"], c["rk"], c["rm"], c["cap"]),
                {"bucket_cap": c["bucket_cap"]})
    if name == "pagerank":
        return (S.sharded_pagerank, (_host(_graph_payload(c, n)), c["iters"],
                                     0.85, c["p"]), {})
    if name == "expand":
        return (S.sharded_expand, (_host(_graph_payload(c, n)),
                                   c["frontier"], c["hops"]), {})
    corpus = _corpus(c, n)
    return (S.sharded_tfidf_topk, (_host(corpus.payload("cpu")),
                                   corpus.query_vector(c["q"]), c["k"]), {})


def _as_tuple(r):
    return tuple(r) if isinstance(r, tuple) else (r,)


@pytest.fixture(scope="module")
def port_ops(ref_proc, tmp_path_factory):
    """``{n: {case: result tuple}}`` from one gloo world at each n; every
    rank's results are checked equal to rank 0's.  (It asks for
    ``ref_proc`` so the reference's subprocess runs beside the worlds.)"""
    out = {}
    for n in WORLDS:
        cases = _cases(n)
        calls = [_call(name, cases[name], n) for name in OPS]
        ranks = run_ranks(run_calls, n, device="cpu", timeout=WORLD_TIMEOUT,
                          init_file=tmp_path_factory.mktemp("ops") / "g",
                          args=(calls,))
        for r in ranks[1:]:
            for a, b in zip(r, ranks[0]):
                for x, y in zip(_as_tuple(a), _as_tuple(b)):
                    np.testing.assert_array_equal(x, y)
        out[n] = {name: _as_tuple(r) for name, r in zip(OPS, ranks[0])}
    return out


REF_SCRIPT = r"""
import functools
import sys
import numpy as np
import jax
import jax.numpy as jnp
from repro.stores import GraphStore, TextStore
from repro.stores import sharded as S

z = np.load(sys.argv[1])
cases = {}
for key in z.files:
    n, name, field = key.split("__")
    cases.setdefault((int(n), name), {})[field] = z[key]
out = {}
for (n, name), c in sorted(cases.items()):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(n, 1),
                             ("data", "model"))

    def run(fn, *args, **static):
        # one jitted program a case: shard_map dispatched op by op is slow
        return jax.jit(functools.partial(fn, mesh=mesh, **static))(*args)

    a = lambda k: jnp.asarray(c[k])
    if name == "count":
        r = run(S.sharded_count, a("valid"))
    elif name.startswith("agg_"):
        r = jax.jit(functools.partial(
            S.sharded_group_agg, num_groups=int(c["groups"]), fn=name[4:],
            mesh=mesh))(values=a("values"), keys=a("keys"), mask=a("mask"))
    elif name == "bjoin":
        r = run(S.sharded_broadcast_join, a("lkeys"), a("rkeys"))
    elif name.startswith("pjoin"):
        r = run(S.sharded_partitioned_join, a("lk"), a("lm"), a("rk"),
                a("rm"), capacity=int(c["cap"]),
                bucket_cap=int(c["bucket_cap"]))
    elif name in ("pagerank", "expand"):
        g = GraphStore.from_edges(c["src"], c["dst"], int(c["nodes"]),
                                  symmetric=True).with_shards(n).payload()
        r = (jax.jit(functools.partial(
                S.sharded_pagerank, iters=int(c["iters"]), damping=0.85,
                mesh=mesh))(g, personalization=a("p"))
             if name == "pagerank" else
             run(S.sharded_expand, g, a("frontier"), hops=int(c["hops"])))
    else:
        docs = np.split(c["terms"], np.cumsum(c["lengths"])[:-1])
        tx = TextStore.from_docs(docs, int(c["vocab"])).with_shards(n)
        r = run(S.sharded_tfidf_topk, tx.payload(),
                jnp.asarray(tx.query_vector(c["q"])), k=int(c["k"]))
    for i, x in enumerate(r if isinstance(r, tuple) else (r,)):
        out[f"{n}__{name}__{i}"] = np.asarray(x)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def ref_proc(tmp_path_factory):
    """The reference's sharded operators over the cases on a forced
    4-device host platform, started in a subprocess (it runs while the
    port's worlds do): ``(process, output path)``."""
    tmp = tmp_path_factory.mktemp("ref_ops")
    arrays = {f"{n}__{name}__{k}": np.asarray(v)
              for n in WORLDS for name, c in _cases(n).items()
              for k, v in c.items()}
    np.savez(tmp / "cases.npz", **arrays)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.Popen([sys.executable, "-c", REF_SCRIPT,
                             str(tmp / "cases.npz"), str(tmp / "out.npz")],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield proc, tmp / "out.npz"
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ref_ops(ref_proc):
    """``{n: {case: result tuple}}`` of the reference's sharded operators."""
    proc, path = ref_proc
    _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-4000:]
    z = np.load(path)
    out = {n: {} for n in WORLDS}
    for key in sorted(z.files, key=lambda k: int(k.rsplit("__", 1)[1])):
        n, name, _ = key.split("__")
        out[int(n)].setdefault(name, ())
        out[int(n)][name] += (z[key],)
    return out


def _dense(name, c, n, pkg):
    """The dense function of case ``name`` in ``pkg`` ("ref" or "port"),
    as a tuple of numpy arrays."""
    if pkg == "ref":
        a = jnp.asarray
        if name == "count":
            return (np.asarray(c["valid"].sum(dtype=np.int32)),)
        if name.startswith("agg_"):
            r = jcol.group_agg(a(c["values"]), a(c["keys"]), c["groups"],
                               a(c["mask"]), name[4:])
        elif name == "bjoin":
            r = jcol.hash_join(a(c["lkeys"]), a(c["rkeys"]))
        elif name.startswith("pjoin"):
            r = jcol.hash_join_nonunique(a(c["lk"]), a(c["lm"]), a(c["rk"]),
                                         a(c["rm"]), c["cap"])
        elif name in ("pagerank", "expand"):
            g = JGraphStore.from_edges(c["src"], c["dst"], c["nodes"],
                                       symmetric=True).with_shards(n)
            r = (jgraph.pagerank(g.payload(), iters=c["iters"], damping=0.85,
                                 personalization=a(c["p"]))
                 if name == "pagerank" else
                 jgraph.expand_frontier(g.payload(), a(c["frontier"]),
                                        c["hops"]))
        else:
            docs = np.split(c["terms"], np.cumsum(c["lengths"])[:-1])
            tx = JTextStore.from_docs(docs, c["vocab"]).with_shards(n)
            r = jtext.tfidf_topk(tx.payload(),
                                 a(tx.query_vector(c["q"])), c["k"])
        return tuple(np.asarray(x) for x in _as_tuple(r))
    t = torch.from_numpy
    if name == "count":
        return (t(c["valid"]).sum(dtype=torch.int32).numpy(),)
    if name.startswith("agg_"):
        r = tcol.group_agg(t(c["values"]), t(c["keys"]), c["groups"],
                           t(c["mask"]), name[4:])
    elif name == "bjoin":
        r = tcol.hash_join(t(c["lkeys"]), t(c["rkeys"]))
    elif name.startswith("pjoin"):
        r = tcol.hash_join_nonunique(t(c["lk"]), t(c["lm"]), t(c["rk"]),
                                     t(c["rm"]), c["cap"])
    elif name == "pagerank":
        r = tgraph.pagerank(_graph_payload(c, n), iters=c["iters"],
                            damping=0.85, personalization=t(c["p"]))
    elif name == "expand":
        r = tgraph.expand_frontier(_graph_payload(c, n), t(c["frontier"]),
                                   c["hops"])
    else:
        corpus = _corpus(c, n)
        r = ttext.tfidf_topk(corpus.payload("cpu"),
                             t(corpus.query_vector(c["q"])), c["k"])
    return tuple(x.numpy() for x in _as_tuple(r))


def _pairs(lidx, ridx, valid, *_):
    got = np.stack([lidx[valid], ridx[valid]], 1)
    return got[np.lexsort(got.T[::-1])]


def _bitwise(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype, f"{what}[{i}]: {g.dtype} != {w.dtype}"
        np.testing.assert_array_equal(g, w, err_msg=f"{what}[{i}]")


def _close(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what}[{i}]")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what}[{i}]")


@pytest.mark.parametrize("name", OPS)
@pytest.mark.parametrize("n", WORLDS)
def test_operator_against_the_dense_functions(port_ops, n, name):
    c = _cases(n)[name]
    got = port_ops[n][name]
    ref, port = _dense(name, c, n, "ref"), _dense(name, c, n, "port")
    if name == "pjoin_drop":
        # the shuffle dropped rows: flagged, and no match outside the set
        assert bool(got[4]) and not bool(ref[4]) and not bool(port[4])
        assert int(got[3]) < int(ref[3])
        assert set(map(tuple, _pairs(*got))) < set(map(tuple, _pairs(*ref)))
        return
    if name == "pjoin":
        # set-equal: shard-major slot order, exact count, no overflow
        assert int(got[3]) == int(ref[3]) == int(port[3])
        assert not bool(got[4]) and not bool(ref[4])
        np.testing.assert_array_equal(_pairs(*got), _pairs(*ref))
        np.testing.assert_array_equal(_pairs(*got), _pairs(*port))
        return
    if name.startswith("agg_"):
        # cross-shard float sums re-associate: allclose; max's valid exact
        _close(got, ref, f"{name} vs the reference")
        _close(got, port, f"{name} vs the port")
        return
    if name == "pagerank":
        _close(got, ref, f"{name} vs the reference")
    else:
        _bitwise(got, ref, f"{name} vs the reference")
    _bitwise(got, port, f"{name} vs the port")


@pytest.mark.parametrize("name", OPS)
@pytest.mark.parametrize("n", WORLDS)
def test_operator_against_the_reference_sharded(port_ops, ref_ops, n, name):
    got, want = port_ops[n][name], ref_ops[n][name]
    if name.startswith("pjoin"):
        # slot for slot: lidx, ridx, valid, count, overflow
        _bitwise(got, want, name)
    elif name in ("agg_sum", "agg_mean", "pagerank"):
        # float sums: the group-by's re-associate; PageRank's SpMV sums in
        # float64 here and in float32 there (the dense ops differ alike)
        _close(got, want, name)
    else:
        _bitwise(got, want, name)


# --------------------------------------------------------------------------
# the workload at 2 and 4 ranks
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    """``{n: [rank summaries]}``: ``tri_sharded`` at the smoke size on n
    ranks under both engine sets."""
    return {n: run_ranks(tsh.rank_run, n, device="cpu",
                         timeout=WORLD_TIMEOUT,
                         init_file=tmp_path_factory.mktemp("world") / "g",
                         args=(SIZE, ENGINE_SETS, 0, 1))
            for n in WORLDS}


@pytest.fixture(scope="module")
def single_runs(workloads):
    """The reference's single run (``store_engines()``, as its benchmark)
    and the port's single run and node outputs under each engine set."""
    jana, jins, tana, stores, query = workloads[1]
    jfn = jana.compile(jir.SystemCatalog(), engines=jengines(), cache=False)
    ref = np.asarray(jfn({}, jins))
    port = {}
    inputs = ti.inputs_for(*stores, query, "cpu")
    for engines in ENGINE_SETS:
        fn = repro_torch.compile(tana, engines=store_engines(
            pallas=engines == "xla,pallas"), device="cpu", cache=False)
        env = run_plan_subset(fn.concrete, ExecContext({}, {}, fn.device),
                              inputs, [n.id for n in fn.concrete.topo()])
        port[engines] = (fn({}, inputs).numpy(), tsh.node_outputs(fn, env))
    return ref, port


@pytest.mark.parametrize("engines", ENGINE_SETS)
@pytest.mark.parametrize("n", WORLDS)
def test_workload_matches_the_single_runs(sharded_runs, single_runs,
                                          workloads, n, engines):
    ranks = [r[engines] for r in sharded_runs[n]]
    head = ranks[0]
    for r in ranks[1:]:
        assert r["plan_id"] == head["plan_id"]
        assert r["out"].dtype == head["out"].dtype
        np.testing.assert_array_equal(r["out"], head["out"])
    ref, port = single_runs
    out, nodes = port[engines]
    np.testing.assert_allclose(head["out"], ref, rtol=BENCH_RTOL,
                               atol=BENCH_ATOL)
    np.testing.assert_allclose(head["out"], out, rtol=BENCH_RTOL,
                               atol=BENCH_ATOL)
    for k, v in nodes.items():
        np.testing.assert_array_equal(head["nodes"][k], v, err_msg=k)
    join = head["join"]
    assert join["same_set"] and not join["overflow"]
    assert join["count"] == join["dense_count"] > 0
    # the plan the ranks ran is the reference's under their catalog
    jsys = jir.SystemCatalog(mesh_axes=("data", "model"), mesh_shape=(n, 1),
                             hardware=jir.HardwareSpec(**HW))
    jfn = workloads[n][0].compile(
        jsys, engines=jengines(pallas=engines == "xla,pallas"), cache=False)
    assert head["plan_id"] == jfn.plan_id


@pytest.mark.parametrize("engines", ENGINE_SETS)
@pytest.mark.parametrize("n", WORLDS)
def test_workload_dist_spans_report_their_collective(sharded_runs, n,
                                                     engines):
    for r in sharded_runs[n]:
        summary = r[engines]
        spans = summary["spans"]
        assert len(spans) == len(summary["dist"])
        plain = [s for s in spans if not s[1].endswith("_pallas")]
        assert plain and all(coll for *_, coll in plain), plain
        colls = {impl: coll for _, impl, _, coll in plain}
        assert colls["bounded_join_col"] == "all_to_all"
        assert colls["rel_group_agg_col"] == "psum"
        assert colls["text_topk_inv"] == "all_gather"
        stats = summary["stats"]
        assert stats["all_to_all_calls"] == 6
        assert stats.get("staged_bytes", 0) == 0      # CPU: no staging


# --------------------------------------------------------------------------
# failures
# --------------------------------------------------------------------------


def test_a_failing_rank_ends_the_world(tmp_path):
    """Rank 1's block reads a source id past the graph: it raises after the
    first hop's all-gather, while rank 0 waits in the second's.  The world
    ends at once with rank 1's error, not at the collective timeout."""
    g = {"indptr": np.arange(5, dtype=np.int32),
         "blk_src": np.array([0, 1, 99, 2], np.int32),
         "blk_dst_local": np.zeros(4, np.int32),
         "blk_weights": np.ones(4, np.float32)}
    calls = [(S.sharded_expand, (g, np.ones(4, np.float32), 2), {})]
    t0 = time.perf_counter()
    with pytest.raises(RankError, match="rank 1 of 2 raised") as err:
        run_ranks(run_calls, 2, device="cpu", timeout=WORLD_TIMEOUT,
                  init_file=tmp_path / "g", args=(calls,))
    assert "IndexError" in str(err.value)
    assert time.perf_counter() - t0 < 45.0


def test_a_collective_error_is_no_breaker():
    """A real failure in a collective (gloo raises RuntimeError) is
    retryable on the same plan and has no fallback class; only an injected
    fault at an xfer site maps to "sharded"."""
    node = SimpleNamespace(id="x", op="xfer", impl="xfer_replicate")
    err = classify(RuntimeError("Connection closed by peer"), node=node,
                   engine="xla")
    assert err.retryable and fallback_class(err) is None
    injected = classify(FaultInjectedError(("xfer", "x", "xfer_replicate"), 0),
                        node=node, engine="xla")
    assert fallback_class(injected) == "sharded"


def test_a_mesh_on_another_device_is_refused(workloads):
    mesh = SimpleNamespace(world=2, rank=0, device=torch.device("cuda"))
    with pytest.raises(ValueError, match="mesh"):
        repro_torch.compile(workloads[2][2], syscat_for_mesh(mesh),
                            device="cpu", mesh=mesh, cache=False)


def test_no_mesh_runs_the_partitioned_plan_dense(workloads, single_runs):
    """Without a mesh the sharded plan's ``dist`` nodes run dense (the
    global values need no collective) and give the single run's output."""
    _, _, tana, stores, query = workloads[2]
    fn = repro_torch.compile(tana, syscat_for_mesh(SimpleNamespace(world=2)),
                             engines=store_engines(), device="cpu",
                             cache=False)
    assert any(n.attrs.get("dist") == "partitioned"
               for n in fn.concrete.topo())
    out = fn({}, ti.inputs_for(*stores, query, "cpu")).numpy()
    np.testing.assert_allclose(out, single_runs[1]["xla"][0], rtol=RTOL,
                               atol=ATOL)
