"""EXPLAIN ANALYZE on the port against the reference, on the CPU.

Three analyses are built in both packages from the same numpy arrays and
planned under one ``HardwareSpec``: the windowed rollup of
``tests/test_tracing.py`` (filter -> join -> group -> tensor, 20,000
tweets), the pushdown path ``tri_selective_0.01`` at 400 tweets and the
influencer rollup at the reference's smoke size.  The reference runs its
``analyze`` with the Pallas kernels in interpret mode, the port on the
CPU.  Equal, exactly: the span names, impls, engines, ``count`` /
``overflow`` / ``capacity`` / xfer attrs, the resolved count sink, the
cost model's ``predicted_s`` and each sample's ``raw_features`` (to
``rel=1e-12``: the cost model is the reference's, copied), ``observe``'s
feedback fingerprint and the re-planned plan ids, and the
``explain(analyze=...)`` rows with the observed times masked.  Also: the
one-transfer semantics of ``Tracer.resolve`` / ``resolve_counts`` over
0-d tensors and Python scalars, the exporters and
``validate_chrome_trace`` against the reference's, and that a run
without a tracer never enters the tracer and computes no lazy count.  No
wall-clock ratio is asserted here: the two tracing overhead guards of the
reference fail by turns under parallel test load.
"""
import io
import json
import re
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# two intra-op threads: the suite runs beside other test workers
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

from benchmarks.tri_store_eff import (  # noqa: E402
    build_selective_workload as jwindow)
from repro.core import ir as jir  # noqa: E402
from repro.core import tracing as jtracing  # noqa: E402
from repro.core.adil import Analysis as JAnalysis  # noqa: E402
from repro.core.feedback import SelectivityFeedback as JFeedback  # noqa
from repro.stores import ColumnStore as JColumnStore  # noqa: E402
from repro.stores import store_engines as jengines  # noqa: E402
from test_torch_influence import reference_workload  # noqa: E402
from repro_torch.core import executor as texecutor  # noqa: E402
from repro_torch.core import ir as tir  # noqa: E402
from repro_torch.core import tracing  # noqa: E402
from repro_torch.core.adil import Analysis  # noqa: E402
from repro_torch.core.executor import ExecContext, run_plan  # noqa: E402
from repro_torch.core.feedback import (SelectivityFeedback,  # noqa: E402
                                       fit_weights)
from repro_torch.core.tracing import (RunTrace, Tracer,  # noqa: E402
                                      resolve_counts, tree_bytes,
                                      validate_chrome_trace,
                                      xfer_wire_bytes)
from repro_torch.examples import tri_influence as ti  # noqa: E402
from repro_torch.examples import windowed_ranking as wr  # noqa: E402
from repro_torch.stores import BoundedRel, ColumnStore  # noqa: E402
from repro_torch.stores import store_engines  # noqa: E402

HW = dict(name="h100-sxm", peak_flops=989e12, hbm_bw=3.35e12, ici_bw=450e9,
          hbm_bytes=80e9, vmem_bytes=232_448)
WINDOW = dict(tweets=400, hashtags=64, edges=240, vocab=128, terms_lo=12,
              terms_hi=20)
CPU = torch.device("cpu")


# --------------------------------------------------------------------------
# workloads, built in both packages from one seed
# --------------------------------------------------------------------------


def build_rollup(analysis_cls, store_cls, catalog, tweets=20_000,
                 hashtags=256, selectivity=0.1, metrics=2):
    """``tests/test_tracing.py::build_rollup`` over either package's
    ``Analysis`` and ``ColumnStore``: ``(analysis, stores by input)``."""
    rng = np.random.RandomState(0)
    cols = {"hashtag": (rng.zipf(1.3, tweets) % hashtags).astype(np.int32),
            "doc": np.arange(tweets, dtype=np.int32),
            "ts": np.arange(tweets, dtype=np.int32)}
    for i in range(metrics):
        cols[f"m{i}"] = rng.rand(tweets).astype(np.float32)
    table = store_cls(cols)
    dims = store_cls({"hashtag": np.arange(hashtags, dtype=np.int32),
                      "weight": rng.rand(hashtags).astype(np.float32)})
    cut = int(tweets * (1.0 - selectivity))
    with analysis_cls(f"trace_rollup_{tweets}_{selectivity}", catalog) as a:
        tw = a.bind("tweets", table)
        dm = a.bind("dims", dims)
        t = a.op("rel_scan", tw)
        recent = a.op("rel_filter", t, col="ts", cmp="ge", value=cut,
                      selectivity=selectivity)
        j = a.op("rel_join", recent, dm, left_on="hashtag",
                 right_on="hashtag")
        aggs = tuple((f"s{i}", "sum", f"m{i}") for i in range(metrics))
        roll = a.op("rel_group_agg", j, key="hashtag", num_groups=hashtags,
                    aggs=aggs)
        a.store(a.op("col_tensor", roll, col="s0", dim="nodes"))
    return a, {"tweets": table, "dims": dims}


def _rollup():
    ja, jst = build_rollup(JAnalysis, JColumnStore, jir.standard_catalog())
    ta, tst = build_rollup(Analysis, ColumnStore, tir.standard_catalog())
    jins = {k: s.payload() for k, s in jst.items()}
    tins = {k: s.payload("cpu") for k, s in tst.items()}
    return ja, jins, ta, tins, False


def _window():
    jana, jins = jwindow(np.random.RandomState(0), 0.01, **WINDOW)
    tana, stores, query = wr.build_selective_workload(
        np.random.RandomState(0), 0.01, **WINDOW)
    return jana, jins, tana, wr.inputs_for(*stores, query, "cpu"), True


def _influence():
    jana, jins = reference_workload(np.random.RandomState(0), **ti.SMOKE)
    tana, stores, query = ti.build_workload(np.random.RandomState(0),
                                            **ti.SMOKE)
    return jana, jins, tana, ti.inputs_for(*stores, query, "cpu"), True


WORKLOADS = {"rollup": _rollup, "window": _window, "influence": _influence}


@pytest.fixture(scope="module", params=list(WORKLOADS))
def runs(request):
    """One analyzed run of each package on the same plan:
    ``(analyses, jfn, jins, jout, tfn, tins, tout)``."""
    jana, jins, tana, tins, pallas = WORKLOADS[request.param]()
    jfn = jana.compile(jir.SystemCatalog(hardware=jir.HardwareSpec(**HW)),
                       engines=jengines(pallas=pallas), cache=False)
    tfn = tana.compile(tir.SystemCatalog(hardware=tir.HardwareSpec(**HW)),
                       engines=store_engines(pallas=pallas), cache=False,
                       device="cpu")
    assert tfn.plan_id == jfn.plan_id
    jout = jfn.analyze({}, jins)
    tout = tfn.analyze({}, tins)
    return (jana, tana), jfn, jins, jout, tfn, tins, tout


def _attrs(sp, drop=("predicted_s", "plan_id")):
    return {k: v for k, v in sp.attrs.items() if k not in drop}


# --------------------------------------------------------------------------
# the traced run against the reference's
# --------------------------------------------------------------------------


def test_span_names_impls_and_engines_equal_reference(runs):
    _, jfn, _, _, tfn, _, _ = runs
    jspans, tspans = jfn.last_run_trace.spans, tfn.last_run_trace.spans
    assert [(s.name, s.cat) for s in tspans] == \
        [(s.name, s.cat) for s in jspans]
    assert [(s.attrs.get("impl"), s.attrs.get("engine"))
            for s in tspans] == \
        [(s.attrs.get("impl"), s.attrs.get("engine")) for s in jspans]
    run = {s.name: s for s in tspans}["run"]
    assert run.attrs["plan_id"] == jfn.plan_id
    # nesting: every op span sits under the run span
    for sp in tfn.last_run_trace.op_spans():
        assert sp.parent_id == run.span_id


def test_counts_overflow_capacity_and_xfer_attrs_equal_reference(runs):
    _, jfn, _, _, tfn, _, _ = runs
    jtr, ttr = jfn.last_run_trace, tfn.last_run_trace
    for js, ts in zip(jtr.spans, ttr.spans):
        assert _attrs(ts) == _attrs(js), ts.name
        for key in ("count", "overflow", "capacity"):
            if key in js.attrs:
                assert type(ts.attrs[key]) is type(js.attrs[key]), key
    assert ttr.counts == jtr.counts
    assert any("count" in s.attrs for s in ttr.op_spans())


def test_predictions_and_sample_features_equal_reference(runs):
    _, jfn, _, _, tfn, _, _ = runs
    jtr, ttr = jfn.last_run_trace, tfn.last_run_trace
    assert len(ttr.samples) == len(jtr.samples) > 0
    for (ti_, tf, ts), (ji, jf, _js) in zip(ttr.samples, jtr.samples):
        assert ti_ == ji
        assert tf.keys() == jf.keys()
        for k in jf:
            assert tf[k] == pytest.approx(jf[k], rel=1e-12, abs=0.0), k
        assert ts >= 0.0
    for js, ts in zip(jtr.spans, ttr.spans):
        if "predicted_s" in js.attrs:
            assert ts.attrs["predicted_s"] == pytest.approx(
                js.attrs["predicted_s"], rel=1e-12, abs=0.0)


def test_analyze_outputs_bitwise_equal_call_and_allclose_reference(runs):
    _, _, _, jout, tfn, tins, tout = runs
    plain = tfn({}, tins)
    assert torch.equal(tout, plain)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-6)


def test_observe_fingerprint_and_replanned_ids_equal_reference(runs):
    (jana, tana), jfn, jins, _, tfn, tins, _ = runs
    jfb, tfb = JFeedback(), SelectivityFeedback()
    jfn.observe({}, jins, jfb)
    before = tracing.transfers
    out = tfn.observe({}, tins, tfb)
    assert tracing.transfers - before == 1          # one copy per run
    assert torch.equal(out, tfn({}, tins))
    assert len(tfb) == len(jfb) > 0
    assert tfb.fingerprint() == jfb.fingerprint()
    # analyze drains the same observations
    tfb2 = SelectivityFeedback()
    tfn.analyze({}, tins, feedback=tfb2)
    assert tfb2.fingerprint() == tfb.fingerprint()
    # re-planning under the observed selectivities gives equal plans
    pallas = "pallas" in tfn.staged.options.engines
    j2 = jana.compile(jir.SystemCatalog(hardware=jir.HardwareSpec(**HW)),
                      engines=jengines(pallas=pallas), cache=False,
                      feedback=jfb)
    t2 = tana.compile(tir.SystemCatalog(hardware=tir.HardwareSpec(**HW)),
                      engines=store_engines(pallas=pallas), cache=False,
                      feedback=tfb, device="cpu")
    assert t2.plan_id == j2.plan_id != tfn.plan_id


_MS = re.compile(r"(observed=|wall=|sync )[0-9.]+ ?ms")


def _analyze_rows(report: str) -> list:
    rows = report.splitlines()
    start = next(i for i, r in enumerate(rows) if "EXPLAIN ANALYZE" in r)
    return [_MS.sub(r"\1<ms>", r) for r in rows[start:]]


def test_explain_analyze_rows_equal_reference(runs):
    _, jfn, _, _, tfn, _, _ = runs
    rep = tfn.explain(analyze=True)
    assert "StagedPhysicalPlan" in rep and "EXPLAIN ANALYZE wall=" in rep
    assert _analyze_rows(rep) == _analyze_rows(jfn.explain(analyze=True))
    for sp in tfn.last_run_trace.op_spans():
        assert f"analyze {sp.name}" in rep
    # a RunTrace may be passed directly
    assert _analyze_rows(tfn.explain(analyze=tfn.last_run_trace)) == \
        _analyze_rows(rep)


def test_device_sync_span_present_and_empty_on_the_cpu(runs):
    _, _, _, _, tfn, _, _ = runs
    trace = tfn.last_run_trace
    (sync,) = [s for s in trace.spans if s.cat == "sync"]
    assert sync.name == "device_sync" and sync.attrs == {}
    assert sync.dur_ms < 5.0 and trace.sync_ms == sync.dur_ms
    assert trace.wall_ms > 0 and trace.plan_id == tfn.plan_id


def test_jsonl_and_chrome_exports_round_trip_as_reference(runs, tmp_path):
    _, jfn, _, _, tfn, _, _ = runs
    jtr, ttr = jfn.last_run_trace, tfn.last_run_trace
    path = tmp_path / "trace.jsonl"
    ttr.to_jsonl(path)
    recs = [json.loads(ln) for ln in path.read_text().splitlines()]
    buf = io.StringIO()
    jtr.to_jsonl(buf)
    jrecs = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    assert [r["record"] for r in recs] == [r["record"] for r in jrecs]
    assert recs[0]["spans"] == len(ttr.spans) and recs[0]["wall_ms"] > 0
    assert recs[0]["collective_totals"] == jrecs[0]["collective_totals"]
    for r, j in zip(recs[1:], jrecs[1:]):
        if r["record"] == "span":
            assert (r["name"], r["cat"]) == (j["name"], j["cat"])
            assert {k: v for k, v in r["attrs"].items()
                    if k != "predicted_s"} == \
                {k: v for k, v in j["attrs"].items() if k != "predicted_s"}
        else:
            assert r == j
    cpath = tmp_path / "trace.json"
    ttr.to_chrome(cpath)
    doc = json.loads(cpath.read_text())
    assert validate_chrome_trace(doc) == []
    counters = [(e["name"], e["args"]) for e in doc["traceEvents"]
                if e["ph"] == "C"]
    jcounters = [(e["name"], e["args"]) for e in jtr.chrome_events()
                 if e["ph"] == "C"]
    assert counters == jcounters and counters
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert "run" in names and "device_sync" in names


def test_fit_weights_from_port_traces():
    ta, tst = build_rollup(Analysis, ColumnStore, tir.standard_catalog())
    fn = ta.compile(tir.SystemCatalog(), engines=store_engines(),
                    cache=False, device="cpu")
    inputs = {k: s.payload("cpu") for k, s in tst.items()}
    traces = []
    for _ in range(3):
        fn.analyze({}, inputs)
        traces.append(fn.last_run_trace)
    model = fit_weights(traces, min_samples=3)
    assert model.weights and model.fingerprint() != "analytic"


def test_explain_analyze_requires_a_run():
    ta, _ = build_rollup(Analysis, ColumnStore, tir.standard_catalog())
    fn = ta.compile(tir.SystemCatalog(), engines=store_engines(),
                    cache=False, device="cpu")
    with pytest.raises(ValueError):
        fn.explain(analyze=True)
    assert "StagedPhysicalPlan" in fn.explain()


# --------------------------------------------------------------------------
# the untraced fast path, and no CPU fallback
# --------------------------------------------------------------------------


def test_untraced_run_never_enters_a_tracer_and_computes_no_lazy_count(
        monkeypatch):
    ta, tst = build_rollup(Analysis, ColumnStore, tir.standard_catalog())
    fn = ta.compile(tir.SystemCatalog(), engines=store_engines(),
                    cache=False, device="cpu")
    inputs = {k: s.payload("cpu") for k, s in tst.items()}
    traced = fn.analyze({}, inputs)

    def boom(*a, **k):
        raise AssertionError("the untraced path entered the tracer")

    for meth in ("span", "annotate", "defer", "resolve"):
        monkeypatch.setattr(Tracer, meth, boom)
    monkeypatch.setattr(texecutor, "_run_plan_traced", boom)
    assert torch.equal(fn({}, inputs), traced)
    # every relation an untraced run leaves behind keeps its lazy count;
    # the traced run computes them (the deferred counts)
    ctx = ExecContext(root={}, scope={}, device=CPU)
    env = texecutor.run_plan_subset(fn.concrete, ctx, inputs,
                                    [n.id for n in fn.concrete.topo()])
    rels = [n.id for n in fn.concrete.topo()
            if isinstance(env[n.id], BoundedRel)]
    assert rels and all(env[i]._count is None for i in rels)
    monkeypatch.undo()
    tctx = ExecContext(root={}, scope={}, device=CPU, tracer=Tracer())
    env_t = {}
    orig = texecutor._impl_fn

    def keep(n):
        fn_ = orig(n)

        def call(ctx_, args, node):
            env_t[node.id] = out = fn_(ctx_, args, node)
            return out
        return call

    monkeypatch.setattr(texecutor, "_impl_fn", keep)
    run_plan(fn.concrete, tctx, inputs)
    assert all(env_t[i]._count is not None for i in rels)


def test_analyze_never_falls_back_to_the_cpu(monkeypatch):
    ta, tst = build_rollup(Analysis, ColumnStore, tir.standard_catalog())
    fn = ta.compile(tir.SystemCatalog(), engines=store_engines(),
                    cache=False, device="cpu")
    inputs = {k: s.payload("cpu") for k, s in tst.items()}
    fn.device = torch.device("cuda")           # a plan bound to the card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        fn.analyze({}, inputs)
    # a card that is there, with inputs on the CPU: refused, not moved
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="payload"):
        fn.analyze({}, inputs)
    assert fn.last_run_trace is None


# --------------------------------------------------------------------------
# the tracer itself
# --------------------------------------------------------------------------


def _script(tr):
    with tr.span("outer"):
        with tr.span("mid"):
            with tr.span("inner"):
                tr.annotate(dist="row", coll_bytes=42.0)
        tr.annotate(seen=True)
    return [(s.name, s.cat, s.attrs, s.parent_id is None) for s in tr.spans]


def test_tracer_nesting_and_annotate_equal_reference():
    got, want = _script(Tracer()), _script(jtracing.Tracer())
    assert got == want
    t = Tracer()
    _script(t)
    by = {s.name: s for s in t.spans}
    assert by["inner"].parent_id == by["mid"].span_id
    assert by["mid"].parent_id == by["outer"].span_id
    assert [s.name for s in t.spans] == ["inner", "mid", "outer"]


def test_tracer_thread_safety():
    tr = Tracer()
    n_threads, per_thread = 8, 50

    def work(tid):
        for i in range(per_thread):
            with tr.span(f"t{tid}_outer{i}"):
                with tr.span(f"t{tid}_inner{i}"):
                    pass

    threads = [threading.Thread(target=work, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(tr.spans) == n_threads * per_thread * 2
    ids = [s.span_id for s in tr.spans]
    assert len(set(ids)) == len(ids)
    by_id = {s.span_id: s for s in tr.spans}
    for s in tr.spans:
        if "inner" in s.name:
            parent = by_id[s.parent_id]
            assert parent.tid == s.tid
            assert parent.name.replace("outer", "inner") == s.name


def test_defer_resolves_in_one_transfer():
    tr = Tracer()
    with tr.span("op1"):
        tr.defer("count", torch.tensor(7, dtype=torch.int32))
    with tr.span("op2"):
        tr.defer("count", torch.tensor(9, dtype=torch.int32))
        tr.defer("overflow", torch.tensor(False))
        tr.defer("mean", torch.tensor(0.5, dtype=torch.float32))
        tr.defer("host", 3)
    before = tracing.transfers
    tr.resolve([(("site", "a"), torch.tensor(12.0), torch.tensor(100))])
    assert tracing.transfers - before == 1
    by = {s.name: s for s in tr.spans}
    assert by["op1"].attrs["count"] == 7
    assert type(by["op1"].attrs["count"]) is int
    assert by["op2"].attrs["overflow"] is False
    assert by["op2"].attrs["mean"] == 0.5
    assert type(by["op2"].attrs["mean"]) is float
    assert by["op2"].attrs["host"] == 3


def _jsink():
    return [(("site", "a"), jnp.float32(12.0), jnp.int32(100)),
            (("compact_overflow", ("site", "a")), jnp.bool_(True), 1),
            (("site", "b"), jnp.int32(7), 64),
            (("site", "c"), 5, jnp.int32(9))]


def _tsink():
    return [(("site", "a"), torch.tensor(12.0), torch.tensor(
                100, dtype=torch.int32)),
            (("compact_overflow", ("site", "a")), torch.tensor(True), 1),
            (("site", "b"), torch.tensor(7, dtype=torch.int32), 64),
            (("site", "c"), 5, torch.tensor(9, dtype=torch.int32))]


def test_resolve_counts_mixed_sink_one_transfer_equals_reference():
    before = tracing.transfers
    got = resolve_counts(_tsink())
    assert tracing.transfers - before == 1
    assert got == jtracing.resolve_counts(_jsink())
    assert [type(c) for _s, c, _cap in got] == [float] * 4
    assert [type(cap) for _s, _c, cap in got] == [int] * 4
    assert resolve_counts([]) == [] and tracing.transfers - before == 1
    # the tracer's resolve gives the same sink, in the same one copy
    tr = Tracer()
    assert tr.resolve(_tsink()) == got
    assert tracing.transfers - before == 2


@pytest.mark.parametrize("dtype,want", [
    (torch.bool, bool), (torch.int32, int), (torch.int64, int),
    (torch.float32, float), (torch.float64, float)])
def test_resolved_values_keep_their_kind(dtype, want):
    tr = Tracer()
    with tr.span("op"):
        tr.defer("v", torch.ones((), dtype=dtype))
        tr.defer("vec", torch.arange(3).to(dtype))
    tr.resolve()
    (sp,) = tr.spans
    assert type(sp.attrs["v"]) is want and sp.attrs["v"] == 1
    vec = sp.attrs["vec"]
    assert isinstance(vec, np.ndarray)
    assert vec.dtype == np.dtype(str(dtype).replace("torch.", ""))
    np.testing.assert_array_equal(vec, np.arange(3).astype(vec.dtype))


@pytest.mark.parametrize("kind,payload,n", [
    ("pin", 1000, 4), ("local", 1000, 4), ("replicate", 1000, 4),
    ("repartition", 1600, 4), ("spill", 1000, 4), ("replicate", 1000, 1)])
def test_xfer_wire_bytes_equal_reference(kind, payload, n):
    assert xfer_wire_bytes(kind, payload, n) == \
        jtracing.xfer_wire_bytes(kind, payload, n)


def test_tree_bytes_counts_what_the_reference_counts():
    v = {"a": torch.zeros(10), "b": torch.zeros(4, dtype=torch.int32)}
    assert tree_bytes(v) == 40 + 16 == jtracing.tree_bytes(
        {"a": jnp.zeros(10), "b": jnp.zeros(4, jnp.int32)})
    # a relation: columns, valid, count and overflow; a lazy count is 4
    # bytes and is not computed by the walk
    rel = BoundedRel({"x": torch.zeros(8)}, torch.ones(8, dtype=torch.bool))
    assert tree_bytes(rel) == 32 + 8 + 4 + 1 and rel._count is None
    # lists, host ints (4 bytes, as the reference's fallback), None
    assert tree_bytes([rel, 7, None]) == tree_bytes(rel) + 4
    assert jtracing.tree_bytes([7, None]) == 4
    # store payloads from the same arrays: the port's extras on top
    tab = ColumnStore({"a": np.arange(100, dtype=np.int32)})
    jtab = JColumnStore({"a": np.arange(100, dtype=np.int32)})
    assert tree_bytes(tab.payload("cpu")) == jtracing.tree_bytes(
        jtab.payload())


def test_validate_chrome_trace_flags_as_reference():
    bad = [
        {}, {"traceEvents": []}, {"traceEvents": "x"},
        {"traceEvents": [{"ph": "X", "pid": 1, "tid": 0, "name": "x",
                          "ts": "oops", "dur": 1.0}]},
        {"traceEvents": [{"ph": "Q", "pid": 1, "name": "x"}]},
        {"traceEvents": [{"ph": "C", "pid": 1, "tid": 0, "name": "c",
                          "ts": 1.0, "args": {"n": "one"}}]},
        {"traceEvents": [{"ph": "C", "pid": 1, "tid": 0, "name": "c",
                          "ts": None, "args": {}}]},
    ]
    for doc in bad:
        got = validate_chrome_trace(doc)
        assert got and got == jtracing.validate_chrome_trace(doc)
    trace = RunTrace(plan_id="p")
    assert validate_chrome_trace({"traceEvents": trace.chrome_events()}) \
        == []
