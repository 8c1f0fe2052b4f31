"""The port's memory ledger and flight recorder against the reference, on
the CPU.

Each bookkeeping scenario of ``tests/test_ledger.py`` (register / release /
replace, transient scratch, predicted-vs-actual, leaks by eviction and by
superseded version, the gauges, the plan cache's byte budget and its
eviction order, the recorder's ring and trips) runs on the port's
``MemoryLedger`` / ``PlanCache`` / ``FlightRecorder`` and on the
reference's, and the two must observe the same: snapshots, reports,
leaks, dump records (time stamps aside).  Store payloads built from the
same numpy arrays register as the reference's do; the port's graph and
text payloads carry more (the graph's dst-ordered edge copy, the corpus's
``doc_ptr`` and ``max_doc_postings``) and each store prices exactly those
extras, so ``actual - predicted`` is the reference's for every store and
``actual / predicted`` is the reference's wherever the reference prices
every byte.  ``PlannedFunction.analyze`` trips the recorder on a
bounded join's overflow and on an executor error, which it re-raises; the
serving runtime registers its KV pool and its kept prefill plans and
trips on an admission rejection and a loop timeout.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# two intra-op threads: the suite runs beside other test workers
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.core import ir as jir  # noqa: E402
from repro.core import ledger as jledger  # noqa: E402
from repro.core import plan_cache as jplan_cache  # noqa: E402
from repro.core.adil import Analysis as JAnalysis  # noqa: E402
from repro.serving import metrics as jmetrics  # noqa: E402
from repro.stores import ColumnStore as JColumnStore  # noqa: E402
from repro.stores import GraphStore as JGraphStore  # noqa: E402
from repro.stores import TextStore as JTextStore  # noqa: E402
from repro.stores import store_engines as jengines  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import ir as tir  # noqa: E402
from repro_torch.core import ledger  # noqa: E402
from repro_torch.core import plan_cache  # noqa: E402
from repro_torch.core.adil import Analysis  # noqa: E402
from repro_torch.core.ledger import (FlightRecorder,  # noqa: E402
                                     MemoryLedger, default_ledger)
from repro_torch.core.plan_cache import PlanCache  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import (AsyncServingRuntime,  # noqa: E402
                                 PagedKVPool, ServeRequest)
from repro_torch.serving import metrics  # noqa: E402
from repro_torch.stores import (ColumnStore, GraphStore,  # noqa: E402
                                TextStore, graph_store, store_engines,
                                text_store)

PORT = {"ledger": ledger, "plan_cache": plan_cache, "metrics": metrics,
        "zeros": lambda n: torch.zeros(n, dtype=torch.float32)}
REF = {"ledger": jledger, "plan_cache": jplan_cache, "metrics": jmetrics,
       "zeros": lambda n: jnp.zeros(n, jnp.float32)}


@pytest.fixture(autouse=True)
def fresh_default_ledgers():
    """Both packages' process-wide ledgers start empty in every test."""
    ledger.reset_default_ledger()
    jledger.reset_default_ledger()
    yield
    ledger.reset_default_ledger()
    jledger.reset_default_ledger()


# --------------------------------------------------------------------------
# bookkeeping scenarios, each run on both packages
# --------------------------------------------------------------------------


def _register_release(m):
    led = m["ledger"].MemoryLedger()
    led.register(("a", "1"), nbytes=100, kind="x")
    led.register(("b", "1"), nbytes=50, kind="y")
    out = [led.total_bytes(), led.bytes_for_kind("x"),
           led.bytes_for_kind("y"), led.release(("a", "1")),
           led.total_bytes(), led.release(("a", "1"))]
    return out, led


def _value_bytes(m):
    led = m["ledger"].MemoryLedger()
    e = led.register("arr", {"x": m["zeros"](256)})
    return [e.nbytes, led.total_bytes()], led


def _replace(m):
    led = m["ledger"].MemoryLedger()
    led.register(("store", "s1"), nbytes=1000, kind="col")
    led.register(("store", "s1"), nbytes=400, kind="col")
    return [led.total_bytes(), led.bytes_for_kind("col"),
            len(led.entries()), led.peak_bytes], led


def _transient(m):
    led = m["ledger"].MemoryLedger()
    led.register("resident", nbytes=100)
    led.note_transient("shuffle", 900, kind="shuffle_buckets")
    return [led.total_bytes(), led.peak_bytes, led.transient_bytes,
            led.transient_peak], led


def _predicted(m):
    led = m["ledger"].MemoryLedger()
    led.register("p", nbytes=150, predicted=100)
    led.register("q", nbytes=80)
    return [(e.owner, p, a, r) for e, p, a, r in led.predicted_vs_actual()
            ], led


def _evicted_leak(m):
    led = m["ledger"].MemoryLedger()
    led.register(("plan_cache", "p1"), nbytes=10, kind="plan_cache")
    led.register(("plan_jit", "p1"), nbytes=0, kind="plan_jit",
                 tied_to=("plan_cache", "p1"))
    before = led.leaks()
    led.release(("plan_cache", "p1"))
    return [before, [(r, e.owner) for r, e in led.leaks()]], led


def _superseded_leak(m):
    led = m["ledger"].MemoryLedger()
    led.register(("col", "s"), nbytes=100, kind="col", version=3)
    led.register(("pin", "c"), nbytes=100, kind="pin",
                 tied_to=("col", "s"), version=3)
    before = led.leaks()
    led.register(("col", "s"), nbytes=120, kind="col", version=4)
    return [before, [(r, e.owner) for r, e in led.leaks()]], led


def _publish(m):
    led = m["ledger"].MemoryLedger()
    led.register("a", nbytes=300, kind="col")
    reg = m["metrics"].MetricsRegistry()
    led.publish(reg)
    return sorted((k, g.value) for k, g in reg.gauges.items()), led


SCENARIOS = {"register_release": _register_release,
             "value_bytes": _value_bytes, "replace": _replace,
             "transient": _transient, "predicted": _predicted,
             "evicted_leak": _evicted_leak,
             "superseded_leak": _superseded_leak,
             "publish": _publish}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_ledger_scenario_equals_reference(name):
    got, led = SCENARIOS[name](PORT)
    want, jled = SCENARIOS[name](REF)
    assert got == want
    assert led.snapshot() == jled.snapshot()
    assert led.report() == jled.report()
    assert [e.as_dict() for e in led.entries()] == \
        [e.as_dict() for e in jled.entries()]


def test_reset_clears_everything():
    led = MemoryLedger()
    led.register("a", nbytes=10, kind="x")
    led.note_transient("t", 5)
    led.reset()
    assert led.snapshot() == {"total_bytes": 0, "peak_bytes": 0,
                              "transient_bytes": 0, "by_kind": {},
                              "entries": 0, "leaks": 0}


# --------------------------------------------------------------------------
# the plan cache's byte budget, each run on both packages
# --------------------------------------------------------------------------


class _Staged:
    def __init__(self, nbytes):
        self.nbytes = nbytes


def _largest_first(m):
    led = m["ledger"].MemoryLedger()
    pc = m["plan_cache"].PlanCache(maxsize=10, byte_budget=500, ledger=led)
    pc.insert("a", _Staged(400))
    pc.insert("b", _Staged(90))
    mid = [pc.bytes_in_cache, led.total_bytes()]
    pc.insert("c", _Staged(300))
    return mid + [sorted(pc._entries), pc.bytes_in_cache, pc.byte_evictions,
                  led.get(("plan_cache", "a")), led.total_bytes()], led


def _stale_first(m):
    led = m["ledger"].MemoryLedger()
    pc = m["plan_cache"].PlanCache(maxsize=10, byte_budget=600, ledger=led)
    pc.insert("old", _Staged(50), fingerprint="fit1")
    pc.note_fingerprint("fit2")
    pc.insert("big", _Staged(400), fingerprint="fit2")
    pc.insert("new", _Staged(200), fingerprint="fit2")
    return [sorted(pc._entries), pc.stale_evictions, pc.byte_evictions], led


def _keeps_newest(m):
    led = m["ledger"].MemoryLedger()
    pc = m["plan_cache"].PlanCache(maxsize=10, byte_budget=100, ledger=led)
    pc.insert("huge", _Staged(1000))
    first = sorted(pc._entries)
    pc.insert("huge2", _Staged(900))
    return [first, sorted(pc._entries)], led


def _clear(m):
    led = m["ledger"].MemoryLedger()
    pc = m["plan_cache"].PlanCache(maxsize=4, byte_budget=None, ledger=led)
    pc.insert("a", _Staged(100))
    pc.insert("b", _Staged(200))
    mid = [led.total_bytes(), pc.stats()["bytes"], pc.stats()["byte_budget"]]
    pc.clear()
    return mid + [led.total_bytes(), pc.bytes_in_cache], led


def _reinsert(m):
    led = m["ledger"].MemoryLedger()
    pc = m["plan_cache"].PlanCache(maxsize=4, ledger=led)
    pc.insert("a", _Staged(100))
    pc.insert("a", _Staged(250))
    return [pc.bytes_in_cache, led.total_bytes()], led


CACHE_SCENARIOS = {"largest_first": _largest_first,
                   "stale_first": _stale_first,
                   "keeps_newest": _keeps_newest, "clear": _clear,
                   "reinsert": _reinsert}


@pytest.mark.parametrize("name", list(CACHE_SCENARIOS))
def test_plan_cache_budget_scenario_equals_reference(name):
    got, led = CACHE_SCENARIOS[name](PORT)
    want, jled = CACHE_SCENARIOS[name](REF)
    assert got == want
    assert led.snapshot() == jled.snapshot()


def test_plan_cache_registers_in_the_default_ledger():
    pc = PlanCache()
    assert pc.ledger is default_ledger()
    assert not hasattr(plan_cache, "_NullLedger")
    pc.insert("p", _Staged(123))
    assert default_ledger().get(("plan_cache", "p")).nbytes == 123
    pc.clear()
    assert default_ledger().get(("plan_cache", "p")) is None


# --------------------------------------------------------------------------
# the flight recorder, on both packages
# --------------------------------------------------------------------------


def _records(recs):
    """Dump records without their time stamps."""
    out = []
    for r in recs:
        r = dict(r)
        r.pop("ts", None)
        if isinstance(r.get("payload"), dict):
            r["payload"] = dict(r["payload"])
        out.append(r)
    return out


def _ring(m):
    rec = m["ledger"].FlightRecorder(capacity=4)
    for i in range(10):
        rec.record("tick", {"i": i})
    return [len(rec), rec.dropped, [e.payload["i"] for e in rec.events()],
            [e.seq for e in rec.events()]]


def _trip_in_memory(m):
    rec = m["ledger"].FlightRecorder(capacity=8)
    rec.record("tick", {"i": 1})
    records = rec.trip("overflow", {"site": "x"})
    return [_records(records), rec.trips, rec.events()[-1].kind]


def _trip_to_files(m, tmp):
    rec = m["ledger"].FlightRecorder(capacity=8, dump_dir=str(tmp))
    for i in range(3):
        rec.record("tick", {"i": i})
    path = rec.trip("executor_error", {"error": "boom"})
    path2 = rec.trip("overflow")
    lines = [json.loads(ln) for ln in open(path)]
    return [os.path.basename(path), os.path.basename(path2),
            _records(lines)]


def test_recorder_ring_and_trips_equal_reference(tmp_path):
    assert _ring(PORT) == _ring(REF)
    assert _trip_in_memory(PORT) == _trip_in_memory(REF)
    assert _trip_to_files(PORT, tmp_path / "p") == \
        _trip_to_files(REF, tmp_path / "j")
    with pytest.raises(ValueError):
        FlightRecorder(capacity=0)


# --------------------------------------------------------------------------
# store payloads: registration, predictions, appends
# --------------------------------------------------------------------------


def _stores(pkg, weighted):
    """Column, graph and text stores of either package, same arrays."""
    cs, gs, ts = pkg
    rng = np.random.RandomState(0)
    table = cs({"a": np.arange(100, dtype=np.int32),
                "v": rng.rand(100).astype(np.float32)})
    e = rng.randint(0, 64, (2, 500))
    w = (rng.rand(500).astype(np.float32) + 0.5) if weighted else None
    graph = gs.from_edges(e[0], e[1], 64, weights=w)
    corpus = ts.from_docs([rng.randint(0, 32, 5) for _ in range(20)], 32)
    return {"column_store": table, "graph_store": graph,
            "text_store": corpus}


@pytest.mark.parametrize("weighted", [True, False],
                         ids=["weighted", "unweighted"])
@pytest.mark.parametrize("kind", ["column_store", "graph_store",
                                  "text_store"])
def test_store_payload_registers_as_the_reference(kind, weighted):
    store = _stores((ColumnStore, GraphStore, TextStore), weighted)[kind]
    jstore = _stores((JColumnStore, JGraphStore, JTextStore), weighted)[kind]
    got, want = store.payload("cpu"), jstore.payload()
    e = default_ledger().get((kind, f"{id(store):#x}"))
    je = jledger.default_ledger().get((kind, f"{id(jstore):#x}"))
    assert e is not None and je is not None
    assert (e.kind, e.version) == (je.kind, je.version)
    extra = _extra_bytes(got, want)
    assert e.nbytes == je.nbytes + extra
    assert e.predicted == je.predicted + extra
    assert e.nbytes - e.predicted == je.nbytes - je.predicted
    if je.ratio == 1.0 or kind == "column_store":
        # the reference prices every byte (or the port carries no extra):
        # the ratio is the reference's
        assert e.ratio == je.ratio
    else:
        # an unweighted graph's unpriced weights: the same bytes over a
        # larger prediction, so a ratio between 1 and the reference's
        assert 1.0 < e.ratio < je.ratio
    assert 0.5 <= e.ratio <= 2.0
    assert default_ledger().bytes_for_kind(kind) == e.nbytes


def _extra_bytes(got, want) -> int:
    """Bytes of the keys the port's payload holds beyond the reference's
    (a host int counts 4, as tree_bytes counts it)."""
    if not isinstance(got, dict):
        return 0
    return sum(v.nbytes if isinstance(v, torch.Tensor) else 4
               for k, v in got.items() if k not in want)


def test_extras_are_the_payload_keys_the_reference_lacks():
    stores = _stores((ColumnStore, GraphStore, TextStore), True)
    jstores = _stores((JColumnStore, JGraphStore, JTextStore), True)
    own = {"graph_store": graph_store.DST_ORDER_KEYS,
           "text_store": text_store.PORT_KEYS}
    for kind in ("graph_store", "text_store"):
        got, want = stores[kind].payload("cpu"), jstores[kind].payload()
        assert sorted(k for k in got if k not in want) == \
            sorted(own[kind]), kind
        e = default_ledger().get((kind, f"{id(stores[kind]):#x}"))
        je = jledger.default_ledger().get((kind, f"{id(jstores[kind]):#x}"))
        nb = _extra_bytes(got, want)
        assert nb > 0, kind
        assert e.predicted - je.predicted == nb, kind
        assert e.nbytes - je.nbytes == nb, kind


@pytest.mark.parametrize("kind", ["column_store", "text_store"])
def test_store_append_reregisters_the_same_owner(kind):
    stores = _stores((ColumnStore, GraphStore, TextStore), True)
    store = stores[kind]
    store.payload("cpu")
    owner = (kind, f"{id(store):#x}")
    before = default_ledger().get(owner)
    if kind == "column_store":
        store.append({"a": np.arange(64, dtype=np.int32),
                      "v": np.zeros(64, np.float32)})
    else:
        store.append([[1, 2, 3], [4, 5]])
    store.payload("cpu")
    after = default_ledger().get(owner)
    assert after.nbytes > before.nbytes
    assert after.version == before.version + 1 == store.version
    assert sum(1 for e in default_ledger().entries(kind)
               if e.owner == owner) == 1
    assert default_ledger().leaks() == []


# --------------------------------------------------------------------------
# analyze: incident trips
# --------------------------------------------------------------------------


def _overflow_analysis(analysis_cls, store_cls, catalog):
    rng = np.random.RandomState(0)
    nodes, rows = 8, 64
    dims = store_cls({"tag": np.arange(nodes, dtype=np.int32)})
    facts = store_cls({"tag": rng.randint(0, nodes, rows).astype(np.int32),
                       "v": rng.rand(rows).astype(np.float32)})
    with analysis_cls("flight_ovf", catalog) as a:
        dm = a.bind("dims", dims)
        fc = a.bind("facts", facts)
        bj = a.op("bounded_join", dm, fc, left_on="tag", right_on="tag",
                  capacity=8)                    # 64 matches cannot fit
        a.store(bj)
    return a, dims, facts


def test_forced_overflow_trips_the_recorder_as_the_reference(tmp_path):
    ta, dims, facts = _overflow_analysis(Analysis, ColumnStore,
                                         tir.standard_catalog())
    ja, jdims, jfacts = _overflow_analysis(JAnalysis, JColumnStore,
                                           jir.standard_catalog())
    fn = ta.compile(tir.SystemCatalog(), engines=store_engines(),
                    cache=False, device="cpu")
    jfn = ja.compile(jir.SystemCatalog(), engines=jengines(), cache=False)
    rec = FlightRecorder(capacity=16, dump_dir=str(tmp_path / "p"))
    jrec = jledger.FlightRecorder(capacity=16, dump_dir=str(tmp_path / "j"))
    fn.analyze({}, {"dims": dims.payload("cpu"),
                    "facts": facts.payload("cpu")}, recorder=rec)
    jfn.analyze({}, {"dims": jdims.payload(), "facts": jfacts.payload()},
                recorder=jrec)
    assert [r for r, _ in rec.trips] == [r for r, _ in jrec.trips]
    assert "overflow" in [r for r, _ in rec.trips]
    assert sorted(os.listdir(tmp_path / "p")) == \
        sorted(os.listdir(tmp_path / "j"))
    assert [e.kind for e in rec.events()] == [e.kind for e in jrec.events()]
    got = [e.payload for e in rec.events() if e.kind == "trip"]
    want = [e.payload for e in jrec.events() if e.kind == "trip"]
    assert [p["detail"]["overflows"] for p in got] == \
        [p["detail"]["overflows"] for p in want]


def test_executor_error_trips_and_reraises():
    cs = ColumnStore({"a": np.arange(16, dtype=np.int32)})
    with Analysis("flight_err", tir.standard_catalog()) as a:
        t = a.op("rel_scan", a.bind("t", cs))
        a.store(a.op("col_tensor",
                     a.op("rel_group_agg", t, key="a", num_groups=16,
                          aggs=(("s", "sum", "a"),)),
                     col="s", dim="nodes"))
    fn = a.compile(tir.SystemCatalog(), engines=store_engines(),
                   cache=False, device="cpu")
    rec = FlightRecorder(capacity=8)
    with pytest.raises(Exception):
        fn.analyze({}, {"t": None}, recorder=rec,
                   trip_context=lambda: {"ledger": {"entries": 0}})
    assert [r for r, _ in rec.trips] == ["executor_error"]
    (trip,) = [e for e in rec.events() if e.kind == "trip"]
    assert trip.payload["detail"]["plan_id"] == fn.plan_id
    assert trip.payload["detail"]["ledger"] == {"entries": 0}
    assert fn.last_run_trace is None
    # a good run records its summary
    fn.analyze({}, {"t": cs.payload("cpu")}, recorder=rec)
    ev = next(e for e in rec.events() if e.kind == "run_trace")
    assert ev.payload["plan_id"] == fn.plan_id and ev.payload["spans"] > 0


# --------------------------------------------------------------------------
# the serving runtime: KV pool, kept plans, trips, telemetry
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke_model():
    model = build_model(get_smoke_config("qwen3-0.6b").replace(
        dtype="float32"))
    params = model.init_params(torch.Generator().manual_seed(0))
    return model, params


def test_kv_pool_registers_its_one_allocation(smoke_model):
    model, _ = smoke_model
    led = MemoryLedger()
    pool = PagedKVPool(model, 2, 32, page_size=8, ledger=led, device="cpu")
    entry = led.get(("kv_pool", f"{id(pool):#x}"))
    assert entry is not None and entry.kind == "kv_pool"
    want = sum(t.nbytes for gc in pool.cache.values() for t in gc.values())
    assert entry.nbytes == want > 0
    assert led.bytes_for_kind("kv_pool") == entry.nbytes
    # the reference's pool of the same model holds the same bytes
    from repro.configs import get_smoke_config as jsmoke
    from repro.models import build_model as jbuild
    from repro.serving.kv_pool import PagedKVPool as JPool
    jled = jledger.MemoryLedger()
    jpool = JPool(jbuild(jsmoke("qwen3-0.6b").replace(dtype="float32")), 2,
                  32, page_size=8, ledger=jled)
    assert jled.get(("kv_pool", f"{id(jpool):#x}")).nbytes == entry.nbytes


def test_runtime_trips_registers_and_snapshots(smoke_model):
    model, params = smoke_model
    led = MemoryLedger()
    pc = PlanCache(ledger=led)
    rec = FlightRecorder(capacity=32)
    rt = AsyncServingRuntime(model, params, max_batch=2, max_seq=32,
                             page_size=8, plan_cache=pc, recorder=rec,
                             snapshot_every=1, device="cpu")
    assert rt.ledger is led                      # the plan cache's ledger
    assert led.get(("kv_pool", f"{id(rt.pool):#x}")) is not None
    reqs = [ServeRequest(0, (1, 2, 3), 2), ServeRequest(1, (), 2),
            ServeRequest(2, tuple(range(40)), 2)]
    res = rt.serve(reqs)
    assert [r.status for r in res] == ["ok", "rejected", "rejected"]
    assert [r for r, _ in rec.trips] == ["admission_reject"] * 2
    details = [e.payload["detail"]["reason"] for e in rec.events()
               if e.kind == "trip"]
    assert details == ["empty prompt or zero gen", "exceeds max_seq"]
    # the kept prefill plan is tied to its plan-cache entry
    (fwd,) = rt._prefill_fns.values()
    jit = led.get(("plan_jit", fwd.plan_id))
    assert jit is not None and jit.nbytes == 0
    assert jit.tied_to == ("plan_cache", fwd.plan_id)
    assert led.leaks() == []
    kinds = [e.kind for e in rec.events()]
    assert "telemetry" in kinds
    snap = rt.telemetry_snapshot()
    assert snap["ledger"]["by_kind"]["kv_pool"] == \
        led.bytes_for_kind("kv_pool")
    assert snap["kv"]["slots_used"] == 0 and snap["plan_cache"]["size"] == 1
    assert rt.registry.gauges["ledger.total_bytes"].value == \
        led.total_bytes()
    # the cache evicts the plan the runtime still holds: a leak
    pc.clear()
    assert [(r, e.owner) for r, e in led.leaks()] == \
        [("evicted", ("plan_jit", fwd.plan_id))]


def test_runtime_timeout_trips_serve_timeout(smoke_model):
    model, params = smoke_model
    rec = FlightRecorder(capacity=8)
    rt = AsyncServingRuntime(model, params, max_batch=2, max_seq=32,
                             page_size=8, plan_cache=PlanCache(
                                 ledger=MemoryLedger()),
                             recorder=rec, device="cpu")
    res = rt.serve([ServeRequest(0, (1, 2, 3), 4)], timeout_s=-1.0)
    assert [r.status for r in res] == ["timeout"]
    assert [r for r, _ in rec.trips] == ["serve_timeout"]
    (trip,) = [e for e in rec.events() if e.kind == "trip"]
    assert trip.payload["detail"]["expected"] == 1
    assert "ledger" in trip.payload["detail"]["telemetry"]
