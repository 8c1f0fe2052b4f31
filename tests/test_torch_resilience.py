"""The port's resilience layer against the reference, on the CPU.

The cases of ``tests/test_resilience.py`` on the port: deterministic fault
injection (schedules equal the reference's for equal seeds and sites), the
``ExecError`` taxonomy (``classify`` agrees with the reference on the
same exceptions, ``fallback_class`` on injected faults), retries with deterministic backoff,
circuit breakers whose re-plans carry the reference's degraded plan ids,
``DegradePolicy``'s clamped re-plans (plan ids equal the reference's), and
the serving runtime's deadlines, token-boundary cancellation, prefill and
decode fault seams and incident trips, on qwen3 SMOKE in float32.  Plus
the port's kernel-error rule: only an injected fault opens a breaker, and
a ``KernelError`` (or a sticky CUDA error) is fatal, so a broken kernel
never re-plans without the kernels quietly.  Results after a retry or a fallback are held
bitwise against the fault-free run (the fallback's plain impls reduce in
the kernel slot's order on the CPU: both are the plain versions there).
"""
from dataclasses import asdict

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# two intra-op threads: the suite runs beside other test workers
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.core import faults as jfaults  # noqa: E402
from repro.core import ir as jir  # noqa: E402
from repro.core import resilience as jres  # noqa: E402
from repro.core.adil import Analysis as JAnalysis  # noqa: E402
from repro.core.rewrite import DEFAULT_PIPELINE as JPIPELINE  # noqa: E402
from repro.serving import DegradePolicy as JDegradePolicy  # noqa: E402
from repro.stores import ColumnStore as JColumnStore  # noqa: E402
from repro.stores import GraphStore as JGraphStore  # noqa: E402
from repro.stores import TextStore as JTextStore  # noqa: E402
from repro.stores import store_engines as jengines  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import ir as tir  # noqa: E402
from repro_torch.core.adil import Analysis  # noqa: E402
from repro_torch.core.faults import (FaultInjectedError,  # noqa: E402
                                     FaultInjector)
from repro_torch.core.ledger import (FlightRecorder,  # noqa: E402
                                     MemoryLedger)
from repro_torch.core import resilience as tres  # noqa: E402
from repro_torch.core.plan_cache import PlanCache  # noqa: E402
from repro_torch.core.resilience import (  # noqa: E402
    CircuitBreaker, ExecError, ResilientExecutor, RetryPolicy, classify,
    degrade_options, fallback_class, is_kernel_error)
from repro_torch.core.rewrite import DEFAULT_PIPELINE  # noqa: E402
from repro_torch.kernels.build import KernelError  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import (AsyncServingRuntime,  # noqa: E402
                                 DegradePolicy, ServeRequest)
from repro_torch.stores import (ColumnStore, GraphStore,  # noqa: E402
                                TextStore, runtime, store_engines)

CPU = "cpu"
CAT, JCAT = tir.standard_catalog(), jir.standard_catalog()
# the port plans for the reference's default hardware: equal plan ids
SYS = tir.SystemCatalog(hardware=tir.HardwareSpec(**asdict(
    jir.HardwareSpec())))
JSYS = jir.SystemCatalog()
# keep compaction as standalone physical nodes (named fault sites)
NOFUSE_PIPELINE = tuple(p for p in DEFAULT_PIPELINE if p != "fuse_store_ops")
JNOFUSE = tuple(p for p in JPIPELINE if p != "fuse_store_ops")


# --------------------------------------------------------------------------
# fault injector: determinism, spec parsing, site filters
# --------------------------------------------------------------------------

def _drive(fi, n=40, err=FaultInjectedError):
    for i in range(n):
        try:
            fi.check(("node", f"n{i % 8}", "impl_x"))
        except err:
            pass
    return fi.schedule()


@pytest.mark.parametrize("spec", ["seed=7,rate=0.3", "seed=8,rate=0.3",
                                  "seed=0,rate=0.05",
                                  "seed=3,rate=0.5,max_faults=4",
                                  "seed=1,always_fail=n3+n5"])
def test_fault_schedule_equals_the_reference(spec):
    """Equal specs give the reference's schedule site for site (the fire
    decision is the same sha256 of (seed, site, occurrence)), and the
    same schedule again after reset()."""
    fi = FaultInjector.from_spec(spec)
    got = _drive(fi)
    want = _drive(jfaults.FaultInjector.from_spec(spec),
                  err=jfaults.FaultInjectedError)
    assert got == want
    fi.reset()
    assert _drive(fi) == got
    assert [fi.would_fail(("decode", t), 0) for t in range(64)] == \
        [jfaults.FaultInjector.from_spec(spec).would_fail(("decode", t), 0)
         for t in range(64)]


def test_fault_injector_different_seed_different_schedule():
    assert _drive(FaultInjector(seed=7, rate=0.3)) != \
        _drive(FaultInjector(seed=8, rate=0.3))


def test_fault_injector_occurrence_keyed():
    fi = FaultInjector(seed=0, rate=0.5)
    outcomes = []
    for _ in range(16):
        try:
            fi.check(("node", "same_site", "impl"))
            outcomes.append(False)
        except FaultInjectedError:
            outcomes.append(True)
    assert True in outcomes and False in outcomes
    assert outcomes == [fi.would_fail(("node", "same_site", "impl"), i)
                        for i in range(16)]


def test_fault_injector_spec_and_filters():
    fi = FaultInjector.from_spec("seed=3,rate=0.25,max_faults=2")
    assert fi.seed == 3 and fi.rate == 0.25 and fi.max_faults == 2
    with pytest.raises(ValueError):
        FaultInjector.from_spec("seed=1,bogus=2")
    with pytest.raises(ValueError):
        FaultInjector(rate=1.5)
    fi = FaultInjector(seed=0, rate=1.0, categories=("prefill",))
    fi.check(("node", "n0", "impl"))
    with pytest.raises(FaultInjectedError):
        fi.check(("prefill", "r1", 16))
    fi = FaultInjector(seed=0, rate=0.0, always_fail=("compact",))
    with pytest.raises(FaultInjectedError):
        fi.check(("node", "compact_filter_3", "compact_gather_xla"))
    fi.check(("node", "rel_filter_1", "rel_filter_mask"))
    fi = FaultInjector(seed=0, always_fail=("x",), max_faults=1)
    with pytest.raises(FaultInjectedError):
        fi.check(("node", "x1", "i"))
    fi.check(("node", "x1", "i"))


def test_fault_injector_stall_sleeps_instead_of_raising():
    slept = []
    fi = FaultInjector(seed=0, rate=1.0, stall_s=0.01, sleep=slept.append)
    fi.check(("admission", "r1"))
    assert slept == [0.01]
    assert fi.schedule()[0][0] == "stall"


# --------------------------------------------------------------------------
# taxonomy + retry policy, against the reference
# --------------------------------------------------------------------------

def _exceptions(m, fault_error):
    """The same exceptions for the port (``m`` = its resilience module)
    and the reference; each with the classify() keywords it is tried
    with."""
    return [
        (fault_error(("node", "n1", "sdpa_xla"), 0), {}),
        (fault_error(("node", "n1", "rel_fused_agg_pallas"), 0), {}),
        (fault_error(("xfer", "n2", "xfer_pin"), 0), {}),
        (fault_error(("node", "compact_3", "compact_prefix_col"), 0), {}),
        (ValueError("bad shape"), {"plan_id": "p1"}),
        (KeyError("tweets"), {}),
        (NotImplementedError("no engine"), {"engine": "pallas"}),
        (RuntimeError("backend blew up"), {}),
        (RuntimeError("backend blew up"), {"engine": "pallas"}),
        (m.ExecError("x", retryable=False), {}),
    ]


def test_classify_and_fallback_class_agree_with_the_reference():
    """classify() agrees on every exception; fallback_class() on every
    injected fault, and gives no class to any other failure, where the
    reference maps a pallas-engine RuntimeError to "pallas" (the port's
    kernel-error rule)."""
    port = _exceptions(tres, FaultInjectedError)
    ref = _exceptions(jres, jfaults.FaultInjectedError)
    for (pe, kw), (je, jkw) in zip(port, ref):
        p, j = classify(pe, **kw), jres.classify(je, **jkw)
        assert (p.retryable, p.engine, p.plan_id, str(p)) == \
            (j.retryable, j.engine, j.plan_id, str(j))
        if isinstance(pe, FaultInjectedError):
            assert fallback_class(p) == jres.fallback_class(j)
        else:
            assert fallback_class(p) is None
    assert jres.fallback_class(jres.classify(
        RuntimeError("backend blew up"), engine="pallas")) == "pallas"
    for impl in ("moe_gmm_pallas", "xfer_replicate", "compact_gather_xla",
                 "rel_filter_mask"):
        site = ("node", "n1", "sdpa_xla")
        assert fallback_class(ExecError(
            "e", impl=impl, cause=FaultInjectedError(site, 0))) == \
            jres.fallback_class(jres.ExecError(
                "e", impl=impl, cause=jfaults.FaultInjectedError(site, 0)))
        assert fallback_class(ExecError("e", impl=impl)) is None
    e = ExecError("x", retryable=False)
    assert classify(e) is e


def test_kernel_error_is_fatal_and_opens_no_breaker():
    """The port's kernel-error rule: a KernelError, raised by a kernel
    impl (engine "pallas", impl ``*_pallas``), is fatal and maps to no
    fallback class, where the reference would retry a RuntimeError and
    drop the "pallas" engine."""
    exc = KernelError("masked_segment_agg: CUDA error 700 at launch")
    assert isinstance(exc, RuntimeError)
    err = classify(exc, engine="pallas", plan_id="p")
    assert not err.retryable and fallback_class(err) is None
    assert is_kernel_error(exc) and is_kernel_error(err)
    assert not is_kernel_error(RuntimeError("x"))
    jerr = jres.classify(RuntimeError(str(exc)), engine="pallas")
    assert jerr.retryable and jres.fallback_class(jerr) == "pallas"
    br = CircuitBreaker(threshold=1)
    assert br.record_failure("p", err) is None and br.blocklist("p") == ()
    if hasattr(torch, "AcceleratorError"):
        assert torch.AcceleratorError in tres._FATAL_TYPES


def test_retry_policy_equals_the_reference():
    for seed in (0, 5):
        p = RetryPolicy(max_attempts=3, base_backoff_s=0.01, jitter=0.25,
                        seed=seed)
        j = jres.RetryPolicy(max_attempts=3, base_backoff_s=0.01,
                             jitter=0.25, seed=seed)
        assert [p.backoff_s(i) for i in range(1, 8)] == \
            [j.backoff_s(i) for i in range(1, 8)]
    err = ExecError("e", retryable=True)
    assert p.should_retry(err, 1) and not p.should_retry(err, 3)
    assert not p.should_retry(ExecError("e", retryable=False), 1)
    assert not p.should_retry(err, 1, elapsed_s=0.999, deadline_s=1.0)


def test_degrade_options_equal_the_reference():
    engines = ("xla", "rel", "graph", "text", "pallas")
    for bl in ((), ("pallas",), ("sharded", "compacted"),
               ("compacted", "pallas", "sharded")):
        assert degrade_options(engines, DEFAULT_PIPELINE, bl) == \
            jres.degrade_options(engines, JPIPELINE, bl)


def test_circuit_breaker_opens_and_half_opens():
    t = [0.0]
    br = CircuitBreaker(threshold=2, cooldown_s=10.0, clock=lambda: t[0])
    err = ExecError("e", engine="pallas", cause=FaultInjectedError(
        ("node", "n1", "rel_fused_agg_pallas"), 0))
    assert br.record_failure("p1", err) is None
    assert br.record_failure("p1", err) == "pallas"
    assert br.blocklist("p1") == ("pallas",) and br.blocklist("p2") == ()
    assert br.fingerprint("p1") == ("blocklist", "pallas")
    t[0] = 11.0
    assert not br.is_open("p1", "pallas") and br.blocklist("p1") == ()
    br.record_success("p1")
    assert ("close", "p1", "pallas") in br.events


# --------------------------------------------------------------------------
# executor fault path (analytical tri-store plans), against the reference
# --------------------------------------------------------------------------

def _arrays(rng, rows=400, nodes=64, vocab=32):
    cols = {"hashtag": rng.randint(0, nodes, rows).astype(np.int32),
            "doc": np.arange(rows, dtype=np.int32),
            "ts": np.arange(rows, dtype=np.int32),
            "engagement": (rng.rand(rows) * 50).astype(np.float32)}
    e = rng.randint(0, nodes, (2, 300))
    docs = [rng.randint(0, vocab, rng.randint(2, 8)) for _ in range(rows)]
    return cols, e, docs, nodes, vocab


def _tri(arrays, *, ref=False, selectivity=0.05, k=16, iters=3):
    """The reference test's tri-analysis over stores built from
    ``arrays``, in the port or the reference: (analysis, inputs)."""
    cols, e, docs, nodes, vocab = arrays
    A, Col, Graph, Text, cat = (
        (JAnalysis, JColumnStore, JGraphStore, JTextStore, JCAT) if ref
        else (Analysis, ColumnStore, GraphStore, TextStore, CAT))
    table = Col({k_: v.copy() for k_, v in cols.items()})
    graph = Graph.from_edges(e[0], e[1], nodes, symmetric=True)
    corpus = Text.from_docs(docs, vocab)
    rows = table.rows
    cut = int(rows * (1 - selectivity))
    with A("resil", cat) as a:
        tw = a.bind("tweets", table)
        gr = a.bind("g", graph)
        cx = a.bind("cx", corpus)
        q = a.input("q", (jir if ref else tir).TensorT(
            (vocab,), "float32", ("vocab",)))
        t = a.op("rel_scan", tw)
        recent = a.op("rel_filter", t, col="ts", cmp="ge", value=cut,
                      selectivity=selectivity)
        m = a.op("sel_mask", recent, col="doc", size=corpus.n_docs)
        sc = a.op("text_scores", cx, q)
        hits = a.op("masked_topk", sc, m, k=k)
        j = a.op("rel_join", recent, hits, left_on="doc", right_on="doc")
        trel = a.op("rel_group_agg", j, key="hashtag", num_groups=nodes,
                    aggs=(("textrel", "sum", "score"),))
        seeds = a.op("rel_group_agg", recent, key="hashtag",
                     num_groups=nodes, aggs=(("seed", "count", None),))
        sv = a.op("col_tensor", seeds, col="seed", dim="nodes")
        pr = a.op("graph_pagerank", gr, sv, iters=iters)
        tv = a.op("col_tensor", trel, col="textrel", dim="nodes")
        a.store(a.op("residual_add", pr, tv))
    qv = corpus.query_vector((1, 2, 3))
    if ref:
        ins = {"tweets": table.payload(), "g": graph.payload(),
               "cx": corpus.payload(), "q": jnp.asarray(qv)}
    else:
        ins = {"tweets": table.payload(CPU), "g": graph.payload(CPU),
               "cx": corpus.payload(CPU), "q": torch.from_numpy(qv)}
    return a, ins


def _rex(**kw):
    kw.setdefault("plan_kwargs", {"cache": False, "device": CPU})
    kw.setdefault("sleep", lambda s: None)
    return ResilientExecutor(CAT, SYS, **kw)


def test_faulted_path_zero_rate_is_bitwise_identical(rng):
    a, ins = _tri(_arrays(rng))
    fn = a.compile(SYS, engines=store_engines(), cache=False, device=CPU)
    base = fn({}, ins)
    fn.faults = FaultInjector(seed=0, rate=0.0)
    assert torch.equal(fn({}, ins), base)
    assert fn.faults.checked == len(fn.concrete.nodes)
    checked = fn.faults.checked
    assert torch.equal(fn.analyze({}, ins), base)   # the traced path too
    assert fn.faults.checked == 2 * checked


def test_executor_fault_wraps_exec_error_with_site(rng):
    a, ins = _tri(_arrays(rng))
    fn = a.compile(SYS, engines=store_engines(), cache=False, device=CPU)
    fn.faults = FaultInjector(seed=0, always_fail=("masked_topk",))
    with pytest.raises(ExecError) as ei:
        fn({}, ins)
    err = ei.value
    assert err.retryable
    assert "masked_topk" in err.node_id or "masked_topk" in err.impl
    assert isinstance(err.cause, FaultInjectedError)


@pytest.mark.parametrize("broken,pipeline,engines_pallas", [
    ("compact", "nofuse", False), ("rel_fused_agg_pallas", "default", True)],
    ids=["compacted", "pallas"])
def test_retry_then_fallback_bitwise_with_the_reference_plan_ids(
        rng, broken, pipeline, engines_pallas):
    """A persistently failing op trips the breaker; the re-plan drops its
    capability under a new plan id — the reference's degraded plan id —
    and its output is bitwise the fault-free run's (on the CPU the kernel
    slot's impls run their plain versions, which reduce as the fallback's
    plain impls do) and allclose (rtol 1e-5, atol 1e-6) to the
    reference's fallback."""
    arrays = _arrays(rng)
    a, ins = _tri(arrays)
    ja, jins = _tri(arrays, ref=True)
    pipe, jpipe = ((NOFUSE_PIPELINE, JNOFUSE) if pipeline == "nofuse"
                   else (DEFAULT_PIPELINE, JPIPELINE))
    eng, jeng = store_engines(pallas=engines_pallas), \
        jengines(pallas=engines_pallas)
    clean = a.compile(SYS, engines=eng, cache=False, device=CPU,
                      rewrite_pipeline=pipe)
    assert any(broken in n.impl for n in clean.concrete.topo())
    expected = clean({}, ins)
    recorder = FlightRecorder()
    rex = _rex(engines=eng, rewrite_pipeline=pipe,
               policy=RetryPolicy(max_attempts=3, base_backoff_s=0.0,
                                  jitter=0.0),
               breaker=CircuitBreaker(threshold=1), recorder=recorder,
               faults=FaultInjector(seed=0, always_fail=(broken,)))
    out, fn = rex.run(a.plan, {}, ins)
    jrex = jres.ResilientExecutor(
        JCAT, JSYS, engines=jeng, rewrite_pipeline=jpipe,
        policy=jres.RetryPolicy(max_attempts=3, base_backoff_s=0.0,
                                jitter=0.0),
        breaker=jres.CircuitBreaker(threshold=1),
        faults=jfaults.FaultInjector(seed=0, always_fail=(broken,)),
        sleep=lambda s: None, plan_kwargs={"cache": False})
    jout, jfn = jrex.run(ja.plan, {}, jins)
    assert torch.equal(out, expected)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-6)
    assert fn.plan_id != clean.plan_id and fn.plan_id == jfn.plan_id
    assert [x[2] for x in rex.attempts_log] == \
        [x[2] for x in jrex.attempts_log]
    assert not any(broken in n.impl for n in fn.concrete.topo())
    base_plan_id = rex.attempts_log[0][2]
    cls = "compacted" if broken == "compact" else "pallas"
    assert rex.breaker.blocklist(base_plan_id) == (cls,)
    assert [s for s, *_ in rex.attempts_log] == ["fail", "ok"]
    assert any(r == "breaker_open" for r, _ in recorder.trips)


def test_kernel_error_in_a_kernel_impl_fails_fast_breaker_closed(
        rng, monkeypatch):
    """A KernelError raised inside rel_fused_agg_pallas: one attempt, no
    re-plan, the breaker closed, no breaker_open trip."""
    a, ins = _tri(_arrays(rng))

    def broken(*args, **kw):
        raise KernelError("masked_segment_agg: CUDA error 700 at launch")

    monkeypatch.setattr(runtime, "masked_segment_agg", broken)
    recorder = FlightRecorder()
    rex = _rex(engines=store_engines(pallas=True),
               policy=RetryPolicy(max_attempts=5, base_backoff_s=0.0,
                                  jitter=0.0),
               breaker=CircuitBreaker(threshold=1), recorder=recorder,
               faults=FaultInjector(seed=0, rate=0.0))
    with pytest.raises(ExecError) as ei:
        rex.run(a.plan, {}, ins)
    assert not ei.value.retryable
    assert isinstance(ei.value.cause, KernelError)
    assert ei.value.impl == "rel_fused_agg_pallas"
    assert [s for s, *_ in rex.attempts_log] == ["fail"]
    base = rex.attempts_log[0][2]
    assert rex.breaker.blocklist(base) == () and not rex.breaker.events
    assert [r for r, _ in recorder.trips] == ["retries_exhausted"]
    # without an injector the raw KernelError classifies the same way
    rex2 = _rex(engines=store_engines(pallas=True))
    with pytest.raises(ExecError) as ei2:
        rex2.run(a.plan, {}, ins)
    assert isinstance(ei2.value.cause, KernelError)
    assert len(rex2.attempts_log) == 1 and not rex2.breaker.events


@pytest.mark.parametrize("exc", [
    RuntimeError("masked_segment_agg: scratch allocation failed"),
    OSError("libmasked_segment_agg.so: cannot open shared object file")],
    ids=["RuntimeError", "OSError"])
def test_real_error_in_a_kernel_impl_never_replans(rng, monkeypatch, exc):
    """Any failure of a kernel impl but an injected fault, under a
    FaultInjector: retried on the same plan up to max_attempts, the
    breaker closed, and every attempt's plan keeps its ``_pallas`` impls,
    where the reference would open "pallas" and re-plan without them."""
    a, ins = _tri(_arrays(rng))

    def broken(*args, **kw):
        raise exc

    monkeypatch.setattr(runtime, "masked_segment_agg", broken)
    recorder = FlightRecorder()
    rex = _rex(engines=store_engines(pallas=True),
               policy=RetryPolicy(max_attempts=3, base_backoff_s=0.0,
                                  jitter=0.0),
               breaker=CircuitBreaker(threshold=1), recorder=recorder,
               faults=FaultInjector(seed=0, rate=0.0))
    with pytest.raises(ExecError) as ei:
        rex.run(a.plan, {}, ins)
    assert ei.value.retryable and ei.value.cause is exc
    assert ei.value.impl == "rel_fused_agg_pallas"
    assert [s for s, *_ in rex.attempts_log] == ["fail"] * 3
    base = rex.attempts_log[0][2]
    assert {x[2] for x in rex.attempts_log} == {base}
    assert rex.compile(a.plan).plan_id == base
    assert any(n.impl.endswith("_pallas")
               for n in rex.compile(a.plan).concrete.topo())
    assert rex.breaker.blocklist(base) == () and not rex.breaker.events
    assert not any(r == "breaker_open" for r, _ in recorder.trips)


def test_a_library_that_does_not_load_is_a_kernel_error(tmp_path,
                                                       monkeypatch):
    """build.load wraps the OSError of a library that does not load in a
    KernelError, so the kernel-error rule sees it: fatal, no class."""
    from repro_torch.kernels import build
    lib = tmp_path / "masked_segment_agg-0.so"
    lib.write_bytes(b"not a shared object")
    monkeypatch.setattr(build, "lib_path", lambda name: lib)
    monkeypatch.setattr(build, "_LIBS", {})
    with pytest.raises(KernelError) as ei:
        build.load("masked_segment_agg")
    assert isinstance(ei.value.__cause__, OSError)
    err = classify(ei.value, engine="pallas")
    assert not err.retryable and fallback_class(err) is None


def test_transient_fault_plain_retry_same_plan(rng):
    a, ins = _tri(_arrays(rng))
    expected = a.compile(SYS, engines=store_engines(), cache=False,
                         device=CPU)({}, ins)
    rex = _rex(engines=store_engines(),
               policy=RetryPolicy(max_attempts=4, base_backoff_s=0.0,
                                  jitter=0.0),
               breaker=CircuitBreaker(threshold=10),
               faults=FaultInjector(seed=0, rate=1.0, categories=("node",),
                                    max_faults=1))
    out, fn = rex.run(a.plan, {}, ins)
    assert torch.equal(out, expected)
    assert fn.plan_id == rex.attempts_log[0][2]
    assert [s for s, *_ in rex.attempts_log] == ["fail", "ok"]


def test_rate_injector_retries_to_the_fault_free_result(rng):
    """The chip smoke's second resilience case at test size: a rate-only
    injector (seed 0, rate 0.05) on the kernel-slot plan; retries give the
    fault-free result bitwise, on the plan the run started with."""
    a, ins = _tri(_arrays(rng))
    eng = store_engines(pallas=True)
    expected = a.compile(SYS, engines=eng, cache=False, device=CPU)({}, ins)
    rex = _rex(engines=eng, policy=RetryPolicy(max_attempts=6,
                                               base_backoff_s=0.0),
               breaker=CircuitBreaker(threshold=10),
               faults=FaultInjector.from_spec("seed=0,rate=0.05"))
    out, fn = rex.run(a.plan, {}, ins)
    assert torch.equal(out, expected)
    assert fn.plan_id == rex.attempts_log[0][2]


def test_fatal_error_fails_fast_no_retry(rng):
    a, _ = _tri(_arrays(rng))
    rex = _rex(engines=store_engines())
    with pytest.raises(ExecError) as ei:
        rex.run(a.plan, {}, {})                 # missing inputs: KeyError
    assert not ei.value.retryable
    assert len([s for s, *_ in rex.attempts_log if s == "fail"]) == 1


def test_deadline_stops_retries(rng):
    a, ins = _tri(_arrays(rng))
    recorder = FlightRecorder()
    rex = _rex(engines=store_engines(),
               policy=RetryPolicy(max_attempts=50, base_backoff_s=10.0,
                                  jitter=0.0),
               recorder=recorder,
               faults=FaultInjector(seed=0, always_fail=("masked_topk",)))
    with pytest.raises(ExecError):
        rex.run(a.plan, {}, ins, deadline_s=1.0)
    assert len(rex.attempts_log) == 1
    assert any(r == "retries_exhausted" for r, _ in recorder.trips)


# --------------------------------------------------------------------------
# degraded-mode replanning, against the reference
# --------------------------------------------------------------------------

def test_degrade_policy_levels():
    pol, jpol = DegradePolicy(CAT), JDegradePolicy(JCAT)
    for q, f in ((0, 0.1), (4, 0.1), (8, 0.1), (0, 0.85), (0, 0.99)):
        assert pol.level(queue_depth=q, max_batch=4, kv_fill=f) == \
            jpol.level(queue_depth=q, max_batch=4, kv_fill=f)
    assert pol.level(queue_depth=8, max_batch=4) == 2


def test_degrade_replan_plan_ids_equal_the_reference(rng):
    """Level 2 clamps k to 8 and iters to 3 under the reference's
    degraded plan id, equal to a direct compile of the clamped program;
    level 0 and a plan with nothing to clamp return the original."""
    arrays = _arrays(rng)
    a, ins = _tri(arrays, k=64, iters=10)
    ja, _ = _tri(arrays, ref=True, k=64, iters=10)
    planned = a.compile(SYS, engines=store_engines(), cache=False,
                        device=CPU)
    jplanned = ja.compile(JSYS, engines=jengines(), cache=False)
    assert planned.plan_id == jplanned.plan_id
    pol, jpol = DegradePolicy(CAT), JDegradePolicy(JCAT)
    deg, jdeg = pol.replan(planned, 2, cache=False), \
        jpol.replan(jplanned, 2, cache=False)
    assert deg.plan_id != planned.plan_id and deg.plan_id == jdeg.plan_id
    assert pol.events[0]["clamps"] == jpol.events[0]["clamps"]
    clamped = {(c["attr"], c["to"]) for c in pol.events[0]["clamps"]}
    assert ("k", 8) in clamped and ("iters", 3) in clamped
    direct, _ = _tri(arrays, k=8, iters=3)
    dfn = direct.compile(SYS, engines=store_engines(), cache=False,
                         device=CPU)
    assert torch.equal(deg({}, ins), dfn({}, ins))
    assert pol.replan(planned, 0) is planned
    small, _ = _tri(arrays, k=4, iters=2)
    small_fn = small.compile(SYS, engines=store_engines(), cache=False,
                             device=CPU)
    assert pol.replan(small_fn, 2, cache=False) is small_fn


# --------------------------------------------------------------------------
# serving: deadlines, cancellation, prefill / decode faults, trips
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served():
    cfg = get_smoke_config("qwen3-0.6b").replace(dtype="float32")
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(1))
    return cfg, model, params


def _runtime(model, params, **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_seq", 64)
    ledger = kw.setdefault("ledger", MemoryLedger())
    kw.setdefault("plan_cache", PlanCache(ledger=ledger))
    return AsyncServingRuntime(model, params, device=CPU, **kw)


def _trace(rng, n=4, gen=6):
    return [ServeRequest(f"r{i}", tuple(int(t) for t in
                                        rng.randint(0, 64, 5 + i)),
                         gen, arrival=0.0) for i in range(n)]


def _clean(rt):
    occ = rt.pool.occupancy()
    return occ["slots_used"] == 0 and occ["pages_used"] == 0 \
        and rt.ledger.leaks() == []


def test_serve_timeout_resolves_every_request(served, rng):
    _, model, params = served
    rt = _runtime(model, params)
    reqs = _trace(rng, n=3)
    results = rt.serve(reqs, timeout_s=0.0)
    assert [r.status for r in results] == ["timeout"] * 3
    assert all(r.error["reason"] == "timeout" for r in results)
    assert _clean(rt)
    assert any(r == "serve_timeout" for r, _ in rt.recorder.trips)


def test_deadline_expired_request_gets_structured_error(served, rng):
    _, model, params = served
    rt = _runtime(model, params)
    rt.warmup([8])
    req = ServeRequest("dl", (1, 2, 3), 4, arrival=0.0, deadline_s=0.0)
    ok = ServeRequest("ok", (1, 2, 3), 4, arrival=0.0)
    res = {r.rid: r for r in rt.serve([req, ok], timeout_s=120.0)}
    assert res["dl"].status == "deadline_exceeded"
    assert res["dl"].error["reason"] == "deadline_exceeded"
    assert res["ok"].status == "ok" and len(res["ok"].tokens) == 4
    assert _clean(rt)


def test_token_boundary_cancellation_returns_kv_pages(served):
    """Mid-decode deadline expiry: the request leaves at the next token
    boundary with its partial tokens, and its pages return to the pool."""
    _, model, params = served
    rt = _runtime(model, params)
    rt.warmup([8])
    import time
    rt._t0 = time.perf_counter()
    req = ServeRequest("c1", (1, 2, 3, 4), 32, arrival=0.0, deadline_s=60.0)
    rt.submit(req)
    assert rt._try_join() and rt.pool.holds("c1")
    rt._decode_tick()
    rt._decode_tick()
    partial = list(rt.scheduler.active()[0].out)
    rt._t0 -= 120.0                             # run-clock passes deadline
    rt._expire_deadlines()
    res = rt._results["c1"]
    assert res.status == "deadline_exceeded"
    assert res.error["phase"] == "decode"
    assert res.tokens == partial and len(partial) == 3
    assert not rt.pool.holds("c1") and _clean(rt)
    assert rt.registry.counters["serving.deadline_miss"] == 1


def test_prefill_fault_retries_then_matches_fault_free(served, rng):
    _, model, params = served
    reqs = _trace(rng, n=2, gen=5)
    clean_rt = _runtime(model, params, prefill_batch=1)
    clean_rt.warmup([r.prompt_len for r in reqs])
    clean = {r.rid: r.tokens for r in clean_rt.serve(reqs, timeout_s=120.0)}
    faults = FaultInjector(seed=0, rate=1.0, categories=("prefill",),
                           max_faults=1)
    rt = _runtime(model, params, faults=faults)
    assert rt.prefill_batch == 1
    rt.warmup([r.prompt_len for r in reqs])
    results = {r.rid: r for r in rt.serve(reqs, timeout_s=120.0)}
    assert faults.n_errors() == 1
    assert all(results[r.rid].status == "ok"
               and results[r.rid].tokens == clean[r.rid] for r in reqs)
    assert any(ev.kind == "prefill_fault" for ev in rt.recorder.events())
    assert _clean(rt)


def test_persistent_prefill_fault_resolves_with_error(served, rng):
    _, model, params = served
    rt = _runtime(model, params, prefill_retries=1,
                  faults=FaultInjector(seed=0, always_fail=("prefill",)))
    rt.warmup([8])
    res = rt.serve(_trace(rng, n=1), timeout_s=120.0)[0]
    assert res.status == "error"
    assert res.error["reason"] == "prefill_failed"
    assert res.error["attempts"] == 2
    assert _clean(rt)
    assert any(r == "prefill_error" for r, _ in rt.recorder.trips)


def test_kernel_error_in_a_prefill_is_raised_not_retried(served, rng,
                                                         monkeypatch):
    """The kernel-error rule at the prefill seam: the slot's pages are
    returned and the KernelError raised, never re-enqueued."""
    _, model, params = served
    rt = _runtime(model, params, faults=FaultInjector(seed=0, rate=0.0))
    rt.warmup([8])

    def broken(*a, **k):
        raise KernelError("flash_attention: CUDA error 700 at launch")

    monkeypatch.setattr(rt, "_prefill", broken)
    with pytest.raises(KernelError):
        rt.serve(_trace(rng, n=1), timeout_s=120.0)
    assert _clean(rt) and not rt._prefill_attempts


def test_persistent_decode_fault_fails_batch_structurally(served, rng):
    _, model, params = served
    rt = _runtime(model, params, decode_fault_cap=3,
                  faults=FaultInjector(seed=0, always_fail=("decode",)))
    rt.warmup([8])
    results = rt.serve(_trace(rng, n=2, gen=4), timeout_s=120.0)
    assert all(r.status == "error" and r.error["reason"] == "decode_failed"
               for r in results)
    assert _clean(rt)
    assert any(r == "decode_error" for r, _ in rt.recorder.trips)


def test_chaos_schedule_terminates_and_replays(served, rng):
    """Under the pinned chaos spec every request terminates, ok requests
    match the fault-free run token for token, two runs under one seed
    give one schedule, and the pool and ledger end clean."""
    _, model, params = served
    reqs = _trace(rng, n=4, gen=5)
    clean_rt = _runtime(model, params, prefill_batch=1)
    clean_rt.warmup([r.prompt_len for r in reqs])
    clean = {r.rid: r.tokens for r in clean_rt.serve(reqs, timeout_s=120.0)}
    schedules = []
    for _ in range(2):
        faults = FaultInjector(seed=0, rate=0.10,
                               categories=("prefill", "decode"))
        rt = _runtime(model, params, faults=faults)
        rt.warmup([r.prompt_len for r in reqs])
        results = rt.serve(reqs, timeout_s=120.0)
        for r in results:
            if r.status == "ok":
                assert r.tokens == clean[r.rid]
            else:
                assert r.error is not None
        assert _clean(rt)
        schedules.append(faults.schedule())
    assert schedules[0] and schedules[0] == schedules[1]


def test_executor_error_trip_includes_ledger_and_metrics(served):
    _, model, params = served
    rt = _runtime(model, params)
    table = ColumnStore({"k": np.arange(8, dtype=np.int32),
                         "v": np.arange(8, dtype=np.float32)})
    with Analysis("boom", CAT) as a:
        t = a.op("rel_scan", a.bind("t", table))
        g = a.op("rel_group_agg", t, key="k", num_groups=8,
                 aggs=(("s", "sum", "v"),))
        a.store(a.op("col_tensor", g, col="s", dim="nodes"))
    planned = a.compile(SYS, engines=store_engines(), cache=False,
                        device=CPU)
    for analyze in (False, True):
        with pytest.raises(Exception):
            rt.run_analysis(planned, {}, {}, analyze=analyze)
    trips = [ev.payload for ev in rt.recorder.events()
             if ev.kind == "trip"
             and ev.payload.get("reason") == "executor_error"]
    assert len(trips) == 2
    for t in trips:
        assert "total_bytes" in t["detail"]["ledger"]
        assert "metrics" in t["detail"]


def test_run_analysis_degrades_under_overload(served, rng):
    _, model, params = served
    arrays = _arrays(rng)
    a, ins = _tri(arrays, k=64, iters=10)
    planned = a.compile(SYS, engines=store_engines(), cache=False,
                        device=CPU)
    pol = DegradePolicy(CAT)
    rt = _runtime(model, params, degrade=pol)
    pol.registry, pol.recorder = rt.registry, rt.recorder
    full = rt.run_analysis(planned, {}, ins)
    assert torch.equal(full, planned({}, ins))
    assert "analytics.degraded" not in rt.registry.counters
    out = rt.run_analysis(planned, {}, ins, degrade=2)
    assert rt.registry.counters["analytics.degraded"] == 1
    assert any(ev.kind == "degrade" for ev in rt.recorder.events())
    direct, _ = _tri(arrays, k=8, iters=3)
    assert torch.equal(out, direct.compile(
        SYS, engines=store_engines(), cache=False, device=CPU)({}, ins))
    rt.run_analysis(planned, {}, ins, degrade=False)
    assert rt.registry.counters["analytics.degraded"] == 1


def test_run_analysis_deadline_miss_is_recorded(served):
    _, model, params = served
    rt = _runtime(model, params)
    table = ColumnStore({"k": np.arange(8, dtype=np.int32),
                         "v": np.arange(8, dtype=np.float32)})
    with Analysis("slow", CAT) as a:
        t = a.op("rel_scan", a.bind("t", table))
        g = a.op("rel_group_agg", t, key="k", num_groups=8,
                 aggs=(("s", "sum", "v"),))
        a.store(a.op("col_tensor", g, col="s", dim="nodes"))
    planned = a.compile(SYS, engines=store_engines(), cache=False,
                        device=CPU)
    rt.run_analysis(planned, {}, {"t": table.payload(CPU)}, deadline_s=0.0)
    assert rt.registry.counters["analytics.deadline_miss"] == 1
    assert any(ev.kind == "deadline_miss" for ev in rt.recorder.events())
