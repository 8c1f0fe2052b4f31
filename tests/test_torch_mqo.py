"""The port's multi-query layer against the reference, on the CPU.

The cases of ``tests/test_mqo.py`` run on the port's ``core/mqo.py``
(content keys, sub-DAG keys, the subplan cache, ``mqo_run``) and on its
serving runtime's ``serve_analyses`` (single flight, same-shape batching
under ``torch.func.vmap``, concurrent tasks, timeouts), each held against
the reference on the same numpy inputs: keys equal the reference's
(``content_key`` hashes a tensor by its numpy dtype name, shape and
bytes), cache statistics equal, and the counters of
``benchmarks/multi_query.py``'s ``--smoke`` workload equal the reference
runtime's.  Results are held bitwise: a reused intermediate is the tensor
an identical computation produced, and a batched query runs the same
elementwise ops, stable sorts and per-row group-bys as an isolated one.
Also: the out-of-place forms on the batched path (``scatter_add_plain``,
the block-skipping text scorer) equal the in-place forms they replaced,
and ``masked_segment_agg``'s batching rule equals a loop of unbatched
calls.
"""
import asyncio
import sys
from dataclasses import asdict
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# two intra-op threads: the suite runs beside other test workers
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.core import ir as jir  # noqa: E402
from repro.core import mqo as jmqo  # noqa: E402
from repro.core.adil import Analysis as JAnalysis  # noqa: E402
from repro.core.ledger import MemoryLedger as JLedger  # noqa: E402
from repro.core.plan_cache import PlanCache as JPlanCache  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.serving import AnalysisRequest as JRequest  # noqa: E402
from repro.serving import AsyncServingRuntime as JRuntime  # noqa: E402
from repro.stores import ColumnStore as JColumnStore  # noqa: E402
from repro.stores import store_engines as jengines  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import ir as tir  # noqa: E402
from repro_torch.core import mqo  # noqa: E402
from repro_torch.core.adil import Analysis  # noqa: E402
from repro_torch.core.feedback import SelectivityFeedback  # noqa: E402
from repro_torch.core.ledger import (FlightRecorder,  # noqa: E402
                                     MemoryLedger)
from repro_torch.core.mqo import (SubplanCache, content_key,  # noqa: E402
                                  input_keys_for, mqo_run,
                                  split_at_frontier, subdag_keys)
from repro_torch.core.plan_cache import PlanCache  # noqa: E402
from repro_torch.examples import multi_query as mq  # noqa: E402
from repro_torch.kernels.build import KernelError  # noqa: E402
from repro_torch.kernels.graph_kernels import (  # noqa: E402
    scatter_add_plain)
from repro_torch.kernels.masked_kernels import (  # noqa: E402
    masked_segment_agg, masked_segment_agg_plain)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.lm import params_from_numpy  # noqa: E402
from repro_torch.serving import (AnalysisRequest,  # noqa: E402
                                 AsyncServingRuntime)
from repro_torch.stores import (ColumnStore, TextStore,  # noqa: E402
                                store_engines, text_store)

# the port plans for the reference's default hardware, so plan ids (and
# every sub-DAG key under them) are the reference's
SYS = tir.SystemCatalog(hardware=tir.HardwareSpec(**asdict(
    jir.HardwareSpec())))
JSYS = jir.SystemCatalog()
CPU = "cpu"


def _columns(rng, rows=64):
    return {"k": (np.arange(rows) % 16).astype(np.int32),
            "v": rng.rand(rows).astype(np.float32)}


def _compile_agg(cols, name="q", *, feedback=None, extra=0.0, ref=False):
    """rel_scan -> group_agg -> col_tensor (+``extra`` marks a variant), in
    the port or (``ref``) the reference; returns (analysis, fn, table)."""
    A, Store = (JAnalysis, JColumnStore) if ref else (Analysis, ColumnStore)
    cat = (jir if ref else tir).standard_catalog()
    table = Store({k: v.copy() for k, v in cols.items()})
    with A(name, cat) as a:
        t = a.op("rel_scan", a.bind("t", table))
        g = a.op("rel_group_agg", t, key="k", num_groups=16,
                 aggs=(("s", "sum", "v"),))
        vec = a.op("col_tensor", g, col="s", dim="nodes")
        if extra:
            vec = a.op("residual_add", vec, vec)
        a.store(vec)
    kw = {"cache": False}
    if feedback is not None:
        kw["feedback"] = feedback
    if ref:
        return a, a.compile(JSYS, engines=jengines(), **kw), table
    return a, a.compile(SYS, engines=store_engines(), device=CPU,
                        **kw), table


# --------------------------------------------------------------------------
# keys against the reference's
# --------------------------------------------------------------------------

def test_subdag_keys_equal_the_reference(rng):
    """Equal programs over equal stores: equal plan ids and equal runtime
    sub-DAG keys, with and without params, and equal input keys for a
    small tensor input (hashed) and a store payload (its version)."""
    cols = _columns(rng)
    a, fn, table = _compile_agg(cols)
    ja, jfn, jtable = _compile_agg(cols, ref=True)
    assert fn.plan_id == jfn.plan_id
    ins, jins = {"t": table.payload(CPU)}, {"t": jtable.payload()}
    for params in (None, {"w": 1.5}):
        k = subdag_keys(fn, ins, versions=a.store_versions(), params=params)
        jk = jmqo.subdag_keys(jfn, jins, versions=ja.store_versions(),
                              params=params)
        assert k == jk
    q = rng.rand(8).astype(np.float32)
    assert input_keys_for({"t": ins["t"], "q": torch.from_numpy(q)},
                          a.store_versions()) == \
        jmqo.input_keys_for({"t": jins["t"], "q": jnp.asarray(q)},
                            ja.store_versions())


CASES = (([1, 2], [12]), ({}, []), ([1.5, 2], [1.52]), ((1, 2), [1, 2]),
         ([1, [2]], [[1], 2]), ({"a": 1}, {"a": "1"}), ("1", 1), (1, True),
         (None, [None]))


@pytest.mark.parametrize("left,right", CASES)
def test_content_key_framing_never_collides(left, right):
    """Leaves are type-tagged and delimited, containers emit open/close
    markers: the framing cases of the reference's test differ, and each
    side's key is the reference's."""
    assert content_key(left) != content_key(right)
    assert content_key(left) == jmqo.content_key(left)
    assert content_key(right) == jmqo.content_key(right)


@pytest.mark.parametrize("dtype", ["float32", "int32", "int8", "bool",
                                   "bfloat16"])
def test_content_key_of_a_tensor_equals_the_reference(dtype):
    """A tensor leaf hashes as the reference's array of the same numpy
    input: dtype name, shape, bytes (bfloat16 by its bits).  Tensors of
    equal values and other dtypes never share a key."""
    rng = np.random.RandomState(3)
    x = rng.rand(2, 5).astype(np.float32) * 4 - 2
    if dtype == "bfloat16":
        t, j = torch.from_numpy(x).to(torch.bfloat16), \
            jnp.asarray(x, jnp.bfloat16)
    else:
        xd = x.astype(dtype)
        t, j = torch.from_numpy(xd), jnp.asarray(xd)
    assert content_key({"q": t}) == jmqo.content_key({"q": j})
    assert content_key([t]) != content_key([t.to(torch.float64)])
    copies = mqo.host_copies
    content_key([t])
    assert mqo.host_copies == copies     # a CPU tensor needs no copy


def test_subdag_keys_miss_on_store_append(rng):
    """An append bumps the store version; every key under that input
    changes, so stale intermediates can never be hit."""
    a, fn, table = _compile_agg(_columns(rng))
    k0 = subdag_keys(fn, {"t": table.payload(CPU)},
                     versions=a.store_versions())
    table.append({"k": np.array([3], np.int32),
                  "v": np.array([1.0], np.float32)})
    k1 = subdag_keys(fn, {"t": table.payload(CPU)},
                     versions=(("t", table.version),))
    assert set(k0) == set(k1)
    assert all(k0[n] != k1[n] for n in k0)


def test_subdag_keys_miss_on_feedback_change(rng):
    cols = _columns(rng)
    fb = SelectivityFeedback()
    _, f0, table = _compile_agg(cols, feedback=fb)
    assert "none" in f0.staged.mqo_salt
    fb.record(("sel_filter", "v", 64), 10, 64)
    _, f1, _ = _compile_agg(cols, feedback=fb)
    assert f0.staged.mqo_salt != f1.staged.mqo_salt
    ins = {"t": table.payload(CPU)}
    k0 = subdag_keys(f0, ins, versions=(("t", 0),))
    k1 = subdag_keys(f1, ins, versions=(("t", 0),))
    assert all(k0[n] != k1[n] for n in k0 if n in k1)


def test_subdag_keys_hit_across_different_programs(rng):
    """Two textually different programs share the scan->agg subtree's keys,
    so the second reuses the first one's intermediates, bitwise."""
    cols = _columns(rng)
    a1, f1, table = _compile_agg(cols, "prog_one")
    a2, f2, _ = _compile_agg(cols, "prog_two", extra=1.0)
    ins = {"t": table.payload(CPU)}
    k1 = subdag_keys(f1, ins, versions=a1.store_versions())
    k2 = subdag_keys(f2, ins, versions=a2.store_versions())
    assert len(set(k1.values()) & set(k2.values())) >= 3
    cache = SubplanCache(8 << 20, ledger=MemoryLedger())
    mqo_run(f1, {}, ins, cache=cache, versions=a1.store_versions())
    out2, info2 = mqo_run(f2, {}, ins, cache=cache,
                          versions=a2.store_versions())
    assert info2["shared_hits"] >= 1
    assert torch.equal(f2({}, ins), out2)


def test_mqo_run_bitwise_identical_and_residual_shrinks(rng):
    """mqo_run equals __call__ bitwise, cold and warm, and the warm run
    executes a shrinking residual; the frontier decisions equal the
    reference's."""
    cols = _columns(rng)
    a, fn, table = _compile_agg(cols)
    ja, jfn, jtable = _compile_agg(cols, ref=True)
    ins, jins = {"t": table.payload(CPU)}, {"t": jtable.payload()}
    ref = fn({}, ins)
    cache = SubplanCache(8 << 20, ledger=MemoryLedger())
    jcache = jmqo.SubplanCache(8 << 20, ledger=JLedger())
    infos, jinfos = [], []
    for _ in range(2):
        out, info = mqo_run(fn, {}, ins, cache=cache,
                            versions=a.store_versions())
        _, jinfo = jmqo.mqo_run(jfn, {}, jins, cache=jcache,
                                versions=ja.store_versions())
        assert torch.equal(ref, out)
        infos.append(info)
        jinfos.append(jinfo)
    assert infos == jinfos
    assert infos[0]["shared_hits"] == 0 and infos[1]["shared_hits"] >= 1
    assert infos[1]["executed"] < infos[0]["executed"]
    assert cache.stats() == jcache.stats()


def test_subdag_keys_fold_in_params_identity(rng):
    a, fn, table = _compile_agg(_columns(rng))
    ins = {"t": table.payload(CPU)}
    sv = a.store_versions()
    k0 = subdag_keys(fn, ins, versions=sv, params={"w": 1.0})
    k1 = subdag_keys(fn, ins, versions=sv, params={"w": 2.0})
    kn = subdag_keys(fn, ins, versions=sv)
    assert all(k0[n] != k1[n] for n in k0)
    assert all(kn[n] != k0[n] for n in kn)
    assert subdag_keys(fn, ins, versions=sv, params={}) == kn
    cache = SubplanCache(8 << 20, ledger=MemoryLedger())
    _, i1 = mqo_run(fn, {"w": 1.0}, ins, cache=cache, versions=sv)
    _, i2 = mqo_run(fn, {"w": 2.0}, ins, cache=cache, versions=sv)
    assert i1["shared_hits"] == 0 and i2["shared_hits"] == 0


def test_split_at_frontier_survives_deep_plans():
    depth = sys.getrecursionlimit() + 500
    nodes = {0: SimpleNamespace(id=0, inputs=("in",))}
    for i in range(1, depth):
        nodes[i] = SimpleNamespace(id=i, inputs=(i - 1,))
    pplan = SimpleNamespace(
        nodes=nodes, outputs=(depth - 1,),
        topo=lambda: [nodes[i] for i in range(depth)])
    cache = SubplanCache(1 << 20, ledger=MemoryLedger())
    hits, residual = split_at_frontier(pplan, {}, cache)
    assert not hits and residual == list(range(depth))


def test_input_keys_version_beats_content_and_uniq_never_collides():
    keys = input_keys_for({"a": torch.zeros(4), "b": torch.zeros(4)},
                          versions=(("a", 3),))
    assert keys["a"] == "ver:a:3"
    assert keys["b"] == jmqo.content_key(np.zeros(4, np.float32))
    big = torch.zeros(1 << 23, dtype=torch.int8)   # over the 4 MiB cap
    copies = mqo.host_copies
    k1 = input_keys_for({"x": big})["x"]
    k2 = input_keys_for({"x": big})["x"]
    assert k1.startswith("uniq:") and k1 != k2
    assert mqo.host_copies == copies     # never copied: over the cap


# --------------------------------------------------------------------------
# SubplanCache: budget, ledger, invalidation, thrash trip
# --------------------------------------------------------------------------

def test_subplan_cache_byte_budget_evicts_lru():
    """6 values of 100 bytes into a 400-byte cache: LRU evictions, the
    reference's statistics, the ledger's subplan bytes."""
    led = MemoryLedger()
    cache = SubplanCache(4 * 100, ledger=led)
    jcache = jmqo.SubplanCache(4 * 100, ledger=JLedger())
    for i in range(6):
        assert cache.insert(f"k{i}", torch.zeros(25))
        assert jcache.insert(f"k{i}", np.zeros(25, np.float32))
    assert cache.bytes_in_cache <= cache.byte_budget
    assert cache.evictions >= 2
    assert cache.lookup("k0") is None and cache.lookup("k5") is not None
    jcache.lookup("k0"), jcache.lookup("k5")
    assert cache.stats() == jcache.stats()
    assert led.snapshot()["by_kind"]["subplan"] == cache.bytes_in_cache


def test_subplan_cache_clear_leaves_no_subplan_bytes():
    """clear() drains through MemoryLedger.release_kind: no "subplan"
    bytes and no leaks remain, and other kinds stay."""
    led = MemoryLedger()
    led.register(("store", "t"), nbytes=128, kind="column_store")
    cache = SubplanCache(1 << 20, ledger=led)
    for i in range(3):
        cache.insert(f"k{i}", torch.zeros(16), stores=(("t", 0),))
    assert led.bytes_for_kind("subplan") == 3 * 64
    cache.clear()
    assert led.bytes_for_kind("subplan") == 0
    assert not led.entries("subplan") and len(cache) == 0
    assert led.bytes_for_kind("column_store") == 128
    assert led.release_kind("column_store") == 128
    assert led.total_bytes() == 0 and led.leaks() == []


def test_subplan_cache_oversize_value_is_skipped():
    cache = SubplanCache(64, ledger=MemoryLedger())
    assert not cache.insert("big", torch.zeros(1000))
    assert cache.oversize_skips == 1 and len(cache) == 0


def test_subplan_cache_note_store_evicts_stale_versions():
    cache = SubplanCache(1 << 20, ledger=MemoryLedger())
    cache.insert("old", torch.ones(8), stores=(("t", 0),))
    cache.insert("other", torch.ones(8) * 2, stores=(("u", 5),))
    assert cache.note_store("t", 1) == 1
    assert cache.lookup("old") is None
    assert cache.lookup("other") is not None
    assert cache.version_evictions == 1


def test_subplan_cache_thrash_trips_flight_recorder(tmp_path):
    rec = FlightRecorder(dump_dir=tmp_path)
    cache = SubplanCache(4 * 100, ledger=MemoryLedger(), recorder=rec,
                         thrash_window=8, thrash_rate=0.5)
    cache.note_frontier({"plan_id": "p", "shared_hits": 0, "executed": 9})
    for i in range(40):
        cache.insert(f"k{i}", torch.zeros(25))
    assert cache.thrash_trips >= 1
    dumps = list(tmp_path.glob("flight_*_subplan_thrash.jsonl"))
    assert dumps
    text = dumps[0].read_text()
    assert "eviction_rate" in text and "frontiers" in text


# --------------------------------------------------------------------------
# the batched path's out-of-place forms and the group-by's batching rule
# --------------------------------------------------------------------------

def test_scatter_add_plain_out_of_place_equals_in_place():
    rng = np.random.RandomState(5)
    vals = torch.from_numpy(rng.rand(5000).astype(np.float32))
    dst = torch.from_numpy(rng.randint(-1, 1002, 5000).astype(np.int32))
    n = 1000
    ok = (dst >= 0) & (dst < n)
    idx = torch.where(ok, dst, torch.full_like(dst, n))
    acc = torch.zeros(n + 1, dtype=torch.float64)
    acc.index_add_(0, idx, vals.to(torch.float64))
    assert torch.equal(scatter_add_plain(vals, dst, n),
                       acc[:n].to(torch.float32))
    # and under vmap with batched values, per row
    vb = torch.from_numpy(rng.rand(3, 5000).astype(np.float32))
    got = torch.func.vmap(lambda v: scatter_add_plain(v, dst, n))(vb)
    for i in range(3):
        assert torch.equal(got[i], scatter_add_plain(vb[i], dst, n))


def test_blockskip_scorer_out_of_place_equals_in_place():
    """The block-skipping scorer's out-of-place write gives the in-place
    form's scores, and the dense masked path's top-k (bitwise)."""
    rng = np.random.RandomState(6)
    docs = [rng.randint(0, 64, rng.randint(1, 9)) for _ in range(3000)]
    cx = TextStore.from_docs(docs, 64).payload(CPU)
    q = torch.from_numpy(TextStore.from_docs(docs, 64).query_vector(
        rng.randint(0, 64, 6)))
    mask = torch.from_numpy(rng.rand(3000) < 0.05)
    got = text_store.tfidf_topk_blockskip(cx, q, mask, 16, block=64)
    want = text_store.tfidf_topk_masked(cx, q, mask, 16)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the in-place form on the documents the skipping path scores
    docs_t = torch.arange(3000)
    w = q * cx["idf"]
    scores = torch.zeros(3000)
    scores[docs_t] = text_store.ordered_doc_sum(
        cx["doc_ptr"], docs_t, cx["term_ids"], cx["tf"], cx["doc_len"], w,
        cx["max_doc_postings"])
    assert torch.equal(scores, text_store.tfidf_scores(cx, q))


def test_masked_segment_agg_batching_rule_equals_a_loop():
    """vmap over each argument (and all three) equals one plain call per
    row, bitwise: the rule runs the wrapper once a row."""
    rng = np.random.RandomState(7)
    b, r, g = 4, 2000, 300
    vals = torch.from_numpy(rng.rand(b, r).astype(np.float32))
    keys = torch.from_numpy(rng.randint(-1, g + 2, (b, r)).astype(np.int32))
    mw = torch.from_numpy((rng.rand(b, r) < 0.5).astype(np.float32))
    for dims in ((0, 0, 0), (0, None, None), (None, 0, None),
                 (None, None, 0), (1, 1, 1)):
        args = [x if d is None or d == 0 else x.T.contiguous()
                for x, d in zip((vals, keys, mw), dims)]
        args = [a[0] if d is None else a for a, d in zip(args, dims)]
        s, c = torch.func.vmap(
            lambda v, k, w: masked_segment_agg(v, k, w, g),
            in_dims=dims)(*args)
        for i in range(b):
            row = [a if d is None else (a[i] if d == 0 else a[:, i])
                   for a, d in zip(args, dims)]
            ps, pc = masked_segment_agg_plain(*row, g)
            assert torch.equal(s[i], ps) and torch.equal(c[i], pc)


# --------------------------------------------------------------------------
# the metrics copy: keep_samples and the analytics view
# --------------------------------------------------------------------------

@pytest.mark.parametrize("keep", [True, False])
def test_metrics_keep_samples_and_analytics_view_equal_the_reference(keep):
    """A Summary with and without ``keep_samples`` (a bounded ring of
    ``cap`` samples, exact running stats) and the registry's analytics
    view give the reference's numbers for the same observations."""
    from repro.serving import metrics as jmetrics
    from repro_torch.serving import metrics
    views = []
    for m in (metrics, jmetrics):
        s = m.Summary("x", keep_samples=keep, cap=8)
        for v in range(100):
            s.observe(v)
        reg = m.MetricsRegistry(keep_samples=keep)
        for v in (3.0, 1.0, 2.0):
            reg.summary("analytics.ttfr_ms").observe(v)
        reg.count("analytics.requests", 3)
        reg.count("analytics.deduped", 2)
        sm = m.ServingMetrics(registry=reg)
        views.append((list(s.samples), s.count, s.max, s.percentile(50),
                      sm.analytics_summary(), sm.analytics_report()))
    assert views[0] == views[1]
    assert len(views[0][0]) == (100 if keep else 8)


# --------------------------------------------------------------------------
# run_analyses: dedup single-flight + vmapped batching (runtime path)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm():
    """qwen3 SMOKE in float32: the port's model and parameters (from the
    reference's, through numpy) and the reference's."""
    jm = jbuild(jsmoke("qwen3-0.6b").replace(dtype="float32"))
    jparams, _ = jm.init_params(jax.random.key(1))
    tm = build_model(get_smoke_config("qwen3-0.6b").replace(dtype="float32"))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)
    return tm, tparams, jm, jparams


@pytest.fixture(scope="module")
def runtime(lm):
    tm, tparams, _, _ = lm
    return AsyncServingRuntime(tm, tparams, max_batch=2, max_seq=32,
                               plan_cache=PlanCache(),
                               subplan_budget=16 << 20,
                               tenant_weights={"gold": 3, "free": 1},
                               device=CPU)


def test_run_analyses_single_flights_identical_queries(rng, runtime):
    a, fn, table = _compile_agg(_columns(rng), "dedup_q")
    ins = {"t": table.payload(CPU)}
    ref = fn({}, ins)
    d0 = runtime.registry.count("analytics.deduped", 0)
    reqs = [AnalysisRequest(rid=i, planned=fn, inputs=ins, params={},
                            tenant="gold" if i % 2 else "free",
                            store_versions=a.store_versions())
            for i in range(6)]
    res = runtime.serve_analyses(reqs)
    assert [r.rid for r in res] == list(range(6))
    assert all(r.ok for r in res)
    assert all(torch.equal(ref, r.value) for r in res)
    assert sum(1 for r in res if r.deduped) == 5
    assert runtime.registry.count("analytics.deduped", 0) - d0 == 5


def test_run_analyses_batches_same_shape_queries(rng, runtime):
    """The reference's case: queries identical modulo ``seed`` coalesce
    into ONE vmapped forward, bitwise equal to isolated runs."""
    table = ColumnStore(_columns(rng))
    with Analysis("param_q", tir.standard_catalog()) as a:
        t = a.op("rel_scan", a.bind("t", table))
        g = a.op("rel_group_agg", t, key="k", num_groups=16,
                 aggs=(("s", "sum", "v"),))
        vec = a.op("col_tensor", g, col="s", dim="nodes")
        seed = a.input("seed", tir.TensorT((16,), "float32", ("nodes",)))
        a.store(a.op("residual_add", vec, seed))
    fn = a.compile(SYS, engines=store_engines(), cache=False, device=CPU)
    ins0 = {"t": table.payload(CPU)}
    seeds = [torch.from_numpy(rng.rand(16).astype(np.float32))
             for _ in range(4)]
    iso = [fn({}, {**ins0, "seed": s}) for s in seeds]
    b0 = runtime.registry.count("analytics.batched", 0)
    reqs = [AnalysisRequest(rid=f"b{i}", planned=fn,
                            inputs={**ins0, "seed": s}, params={},
                            batch_param="seed",
                            store_versions=a.store_versions())
            for i, s in enumerate(seeds)]
    res = runtime.serve_analyses(reqs)
    assert all(r.ok and r.batched for r in res)
    assert all(torch.equal(ref, r.value) for r, ref in zip(res, iso))
    assert runtime.registry.count("analytics.batched", 0) - b0 == 4


def test_run_analyses_concurrent_tasks_share_inflight_futures(rng, runtime):
    a, fn, table = _compile_agg(_columns(rng), "xtask_q")
    ins = {"t": table.payload(CPU)}
    sv = a.store_versions()

    async def both():
        r1 = runtime.run_analyses(
            [AnalysisRequest(rid="t1", planned=fn, inputs=ins, params={},
                             store_versions=sv)])
        r2 = runtime.run_analyses(
            [AnalysisRequest(rid="t2", planned=fn, inputs=ins, params={},
                             store_versions=sv)])
        return await asyncio.gather(r1, r2)

    (a_res,), (b_res,) = asyncio.run(both())
    assert a_res.ok and b_res.ok
    assert torch.equal(a_res.value, b_res.value)


def test_run_analyses_kernel_error_fails_every_twin_without_a_hang(
        rng, runtime, monkeypatch):
    """Task A's tick raises a KernelError on query y while task B awaits
    A's in-flight future for y's twin: both calls raise it, neither hangs
    (a 30 s guard turns a hang into a failure), and a later twin of y
    computes anew instead of waiting on a stale future."""
    a, fn, table = _compile_agg(_columns(rng), "kerr_q")
    ins = {"t": table.payload(CPU)}
    sv = a.store_versions()
    exec_ = runtime._analysis_exec

    def broken(req, keys=None):
        if req.params.get("w") == 1.0:
            raise KernelError("masked_segment_agg: CUDA error 700 at launch")
        return exec_(req, keys=keys)

    def req(rid, w):
        return AnalysisRequest(rid=rid, planned=fn, inputs=ins,
                               params={"w": w}, store_versions=sv)

    monkeypatch.setattr(runtime, "_analysis_exec", broken)

    async def both():
        first = runtime.run_analyses([req("x", 0.0), req("y", 1.0)])
        twin = runtime.run_analyses([req("y2", 1.0)])
        return await asyncio.wait_for(
            asyncio.gather(first, twin, return_exceptions=True), 30.0)

    res = asyncio.run(both())
    assert [type(r) for r in res] == [KernelError, KernelError]
    assert not runtime._analysis_inflight
    assert runtime.analysis_sched.depth() == 0
    monkeypatch.setattr(runtime, "_analysis_exec", exec_)
    (later,) = runtime.serve_analyses([req("y3", 1.0)], timeout_s=30.0)
    assert later.ok and not later.deduped
    assert torch.equal(later.value, fn({"w": 1.0}, ins))


def test_run_analyses_distinct_params_are_not_deduped(rng, runtime):
    a, fn, table = _compile_agg(_columns(rng), "params_q")
    ins = {"t": table.payload(CPU)}
    reqs = [AnalysisRequest(rid=f"p{i}", planned=fn, inputs=ins,
                            params={"w": float(i)},
                            store_versions=a.store_versions())
            for i in range(2)]
    res = runtime.serve_analyses(reqs)
    assert all(r.ok for r in res)
    assert not any(r.deduped for r in res)


def test_run_analyses_timeout_purges_stragglers(rng, runtime):
    a, fn, table = _compile_agg(_columns(rng), "timeout_q")
    ins = {"t": table.payload(CPU)}
    sv = a.store_versions()
    reqs = [AnalysisRequest(rid=f"to{i}", planned=fn, inputs=ins,
                            params={}, store_versions=sv)
            for i in range(3)]
    res = runtime.serve_analyses(reqs, timeout_s=0.0)
    assert [r.rid for r in res] == ["to0", "to1", "to2"]
    assert all(not r.ok and r.error["reason"] == "timeout" for r in res)
    assert runtime.analysis_sched.depth() == 0
    res2 = runtime.serve_analyses(
        [AnalysisRequest(rid="after", planned=fn, inputs=ins, params={},
                         store_versions=sv)])
    assert len(res2) == 1 and res2[0].ok


def test_run_analyses_does_not_adopt_orphan_stragglers(rng, runtime):
    a, fn, table = _compile_agg(_columns(rng), "orphan_q")
    ins = {"t": table.payload(CPU)}
    sv = a.store_versions()
    orphan = AnalysisRequest(rid="orphan", planned=fn, inputs=ins,
                             params={}, tenant="free", store_versions=sv)
    runtime.analysis_sched.enqueue(orphan, orphan.tenant)
    old_tick = runtime.analysis_tick
    runtime.analysis_tick = 1
    try:
        res = runtime.serve_analyses(
            [AnalysisRequest(rid="fresh", planned=fn, inputs=ins,
                             params={}, store_versions=sv)])
    finally:
        runtime.analysis_tick = old_tick
    assert [r.rid for r in res] == ["fresh"] and res[0].ok
    assert runtime.analysis_sched.depth() == 0


def test_run_analysis_routes_through_subplan_cache(rng, runtime):
    a, fn, table = _compile_agg(_columns(rng), "single_q")
    ins = {"t": table.payload(CPU)}
    ref = fn({}, ins)
    hits0 = runtime.subplans.hits
    r1 = runtime.run_analysis(fn, {}, ins, store_versions=a.store_versions())
    r2 = runtime.run_analysis(fn, {}, ins, store_versions=a.store_versions())
    assert torch.equal(ref, r1) and torch.equal(ref, r2)
    assert runtime.subplans.hits > hits0


def test_analytics_summary_reports_the_mqo_counters(runtime):
    s = runtime.metrics.analytics_summary()
    assert s["requests"] >= 1
    assert "shared_hits" in s and "batched" in s and "deduped" in s
    assert "p95_ttfr_ms" in s
    assert "shared subplan hits" in runtime.metrics.analytics_report()


# --------------------------------------------------------------------------
# benchmarks/multi_query.py's --smoke workload, port against reference
# --------------------------------------------------------------------------

def _smoke_workload(pkg):
    """The 16 requests of the --smoke workload, planned with the kernel
    slot (``store_engines(pallas=True)``), in the port or the reference;
    returns (requests, heavy fn, light fn)."""
    from benchmarks import multi_query as jb
    rng = np.random.RandomState(0)
    sz = mq.SMOKE
    port = pkg == "port"
    table, graph, corpus = (mq if port else jb).build_stores(
        rng, rows=sz["rows"], nodes=sz["nodes"], vocab=sz["vocab"])
    if port:
        ah = mq.heavy_analysis(table, graph, corpus, iters=sz["iters"])
        al = mq.light_analysis(table, corpus, graph.n_nodes)
        kw = {"engines": store_engines(pallas=True), "cache": False,
              "device": CPU}
        fh, fl = ah.compile(SYS, **kw), al.compile(SYS, **kw)
        ins = {"tweets": table.payload(CPU), "g": graph.payload(CPU),
               "cx": corpus.payload(CPU)}
        qs = [torch.from_numpy(q)
              for q in mq.query_vectors(rng, corpus, 11)]
        wl = mq.workload((ah, fh), (al, fl), ins,
                         {"tweets": ins["tweets"], "cx": ins["cx"]}, qs)
        Req = AnalysisRequest
    else:
        ah, _ = jb.heavy_analysis(table, graph, corpus, iters=sz["iters"])
        al, _ = jb.light_analysis(table, corpus, graph.n_nodes)
        kw = {"engines": jengines(pallas=True), "cache": False}
        fh, fl = ah.compile(JSYS, **kw), al.compile(JSYS, **kw)
        ins = {"tweets": table.payload(), "g": graph.payload(),
               "cx": corpus.payload()}
        qs = [jnp.asarray(corpus.query_vector(
            rng.randint(0, sz["vocab"], mq.TERMS))) for _ in range(11)]
        light = {"tweets": ins["tweets"], "cx": ins["cx"]}
        wl = ([(fh, {**ins, "q": qs[0]}, None, ah.store_versions())] * 4
              + [(fh, {**ins, "q": qs[1]}, None, ah.store_versions())] * 2
              + [(fh, {**ins, "q": qs[2]}, None, ah.store_versions())] * 2
              + [(fl, {**light, "q": q}, "q", al.store_versions())
                 for q in qs[3:]])
        Req = JRequest
    reqs = [Req(rid=i, planned=fn, inputs=inp, params={},
                tenant=f"client{i % 4}", batch_param=bp, store_versions=sv)
            for i, (fn, inp, bp, sv) in enumerate(wl)]
    return reqs, fh, fl


def test_smoke_workload_counters_equal_the_reference(lm):
    """The --smoke multi-query workload: plan ids, per-query flags and the
    deduped / batched / shared_hits counters equal the reference
    runtime's; every result (single-flighted, cache-served, batched) is
    bitwise an isolated __call__'s and allclose (rtol 1e-5, atol 1e-6:
    float sums in another order) to the reference's; no batch_fallback;
    the subplan cache within its budget and its ledger bytes drained by
    clear()."""
    tm, tparams, jm, jparams = lm
    reqs, fh, fl = _smoke_workload("port")
    jreqs, jfh, jfl = _smoke_workload("ref")
    assert (fh.plan_id, fl.plan_id) == (jfh.plan_id, jfl.plan_id)
    assert "rel_fused_agg_pallas" in fl.chosen_impls()
    iso = [r.planned({}, r.inputs) for r in reqs]
    led, jled = MemoryLedger(), JLedger()
    rt = AsyncServingRuntime(tm, tparams, max_batch=2, max_seq=32,
                             plan_cache=PlanCache(ledger=led), ledger=led,
                             subplan_budget=64 << 20, device=CPU)
    jrt = JRuntime(jm, jparams, max_batch=2, max_seq=32,
                   plan_cache=JPlanCache(ledger=jled), ledger=jled,
                   subplan_budget=64 << 20)
    res = rt.serve_analyses(reqs, timeout_s=600)
    jres = jrt.serve_analyses(jreqs, timeout_s=600)
    flags = [(r.status, r.deduped, r.batched, r.shared_hits) for r in res]
    assert flags == [(r.status, r.deduped, r.batched, r.shared_hits)
                     for r in jres]
    assert all(r.batched for r in res[8:])
    for r, want, jr in zip(res, iso, jres):
        assert torch.equal(r.value, want)
        np.testing.assert_allclose(r.value.numpy(), np.asarray(jr.value),
                                   rtol=1e-5, atol=1e-6)
    keys = ("deduped", "batched", "shared_hits", "requests")
    s, js = rt.metrics.analytics_summary(), jrt.metrics.analytics_summary()
    assert {k: s[k] for k in keys} == {k: js[k] for k in keys}
    assert {k: s[k] for k in mq.SMOKE_COUNTERS} == mq.SMOKE_COUNTERS
    assert not [e for e in rt.recorder.events() if e.kind == "batch_fallback"]
    sub = rt.subplans.stats()
    assert sub == jrt.subplans.stats()
    assert sub["bytes"] <= sub["byte_budget"] and sub["oversize_skips"] == 0
    assert led.snapshot()["by_kind"]["subplan"] == sub["bytes"]
    rt.subplans.clear()
    assert led.snapshot()["by_kind"].get("subplan", 0) == 0
    assert led.leaks() == []
