"""The port's serving subsystem against the reference, on the CPU.

Bucketed admission, the continuous-batching scheduler and the paged KV pool
behave as the reference's (the cases of ``tests/test_serving.py``); the
port's ``AsyncServingRuntime`` and ``serve_sequential`` give the reference
runtime's token streams token for token, from the same numpy parameters
(qwen3 SMOKE, float32).  The reference side runs ``("xla",)``: its flash
kernel in interpret mode under ``vmap`` is slow, and its flash and
``sdpa_xla`` agree on every row this path produces (no query row is fully
masked in a prefill).  The port runs both engine sets.  Also: batched
prefill ≡ per-request prefill, no re-planning after warmup, one planned
forward per prefill call, and no silent CPU fallback without a card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# two intra-op threads: the suite runs beside other test workers
torch.set_num_threads(2)

import jax  # noqa: E402

from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.core.plan_cache import PlanCache as JPlanCache  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.serving import AsyncServingRuntime as JRuntime  # noqa: E402
from repro.serving import ServeRequest as JRequest  # noqa: E402
from repro.serving import serve_sequential as jsequential  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.plan_cache import PlanCache  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.lm import params_from_numpy  # noqa: E402
from repro_torch.serving import (AdmissionController,  # noqa: E402
                                 AsyncServingRuntime,
                                 ContinuousBatchScheduler, PagedKVPool,
                                 ServeRequest, bucket_len, serve_sequential)

ARCH = "qwen3-0.6b"


@pytest.fixture(scope="module")
def smoke():
    """(cfg, port model, port params, reference model, reference params)."""
    jm = jbuild(jsmoke(ARCH).replace(dtype="float32"))
    jparams, _ = jm.init_params(jax.random.key(1))
    tm = build_model(get_smoke_config(ARCH).replace(dtype="float32"))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return tm.cfg, tm, tparams, jm, jparams


def _trace(cfg, lens, gen, seed):
    rng = np.random.RandomState(seed)
    return [(i, tuple(rng.randint(0, cfg.vocab, n).tolist()), gen)
            for i, n in enumerate(lens)]


# --------------------------------------------------------------------------
# admission, scheduler, pool (the reference's cases)
# --------------------------------------------------------------------------

def test_bucket_len():
    assert (bucket_len(9), bucket_len(17), bucket_len(100)) == (16, 32, 128)
    assert bucket_len(0) == 8 and bucket_len(1) == 8
    assert bucket_len(7, lo=8) == 8 and bucket_len(3, lo=4) == 4
    for n in (8, 16, 32, 64, 1024):
        assert bucket_len(n) == n
    assert bucket_len(100, hi=128) == 128
    assert bucket_len(100, hi=100) == 100 and bucket_len(65, hi=100) == 100
    for bad in (dict(n=129, hi=128), dict(n=-1), dict(n=4, lo=0)):
        with pytest.raises(ValueError):
            bucket_len(**bad)


def test_admission_matrix():
    ac = AdmissionController(max_queue=2, cold_plan_occupancy=0.5)
    assert ac.decide(warm=True, queue_depth=0, active=4, max_batch=4) == \
        "admit"
    assert ac.decide(warm=True, queue_depth=2, active=0, max_batch=4) == \
        "reject"
    assert ac.decide(warm=False, queue_depth=0, active=1, max_batch=4) == \
        "admit"
    assert ac.decide(warm=False, queue_depth=1, active=4, max_batch=4) == \
        "queue"
    assert ac.can_plan_cold(active=2, max_batch=4)
    assert not ac.can_plan_cold(active=3, max_batch=4)


def test_scheduler_longest_waiting_first_across_buckets():
    sch = ContinuousBatchScheduler(max_batch=2)

    class R:
        def __init__(self, rid):
            self.rid, self.gen = rid, 4

    sch.enqueue(R("a"), bucket=16, now=0.0)
    sch.enqueue(R("b"), bucket=32, now=1.0)
    sch.enqueue(R("c"), bucket=16, now=2.0)
    assert sch.queue_depth() == 3
    w = sch.peek_next()
    assert w.request.rid == "a"
    assert sch.peek_next(warm_buckets={32}).request.rid == "b"
    sch.pop(w)
    assert sch.peek_next().request.rid == "b"
    st = sch.join(R("a"), pos=5, tok=7, first_out=7, now=3.0)
    assert sch.n_active() == 1 and st.slot == 0
    st2 = sch.join(R("b"), pos=9, tok=1, first_out=1, now=3.0)
    assert st2.slot == 1 and sch.free_slot() is None
    sch.leave(0)
    assert sch.free_slot() == 0


def test_kv_pool_pages_and_slots(smoke):
    _, tm, _, _, _ = smoke
    pool = PagedKVPool(tm, n_slots=2, max_seq=32, page_size=8, device="cpu")
    assert pool.pages_per_slot == 4 and pool.page_budget == 8
    pt = pool.alloc("r1", 9)
    assert len(pt.pages) == 2 and pt.covers(16) and not pt.covers(17)
    assert pool.extend("r1", 17) and len(pool.table("r1").pages) == 3
    assert not pool.extend("r1", 33)
    assert pool.alloc("r2", 30) is not None
    assert pool.alloc("r3", 1) is None
    occ = pool.occupancy()
    assert occ["slots_used"] == 2 and occ["pages_used"] == 7
    assert pool.free("r1") in (0, 1) and pool.pages_in_use == 4
    assert pool.alloc("r3", 1) is not None
    assert pool.holds("r3") and not pool.holds("r1")


def test_kv_pool_page_budget_gates_admission(smoke):
    _, tm, _, _, _ = smoke
    pool = PagedKVPool(tm, n_slots=4, max_seq=32, page_size=8,
                       page_budget=5, device="cpu")
    assert pool.alloc("a", 32) is not None
    assert not pool.can_admit(9) and pool.alloc("b", 9) is None
    assert pool.alloc("c", 8) is not None


def test_kv_pool_seed_writes_the_slot_in_place(smoke):
    _, tm, _, _, _ = smoke
    pool = PagedKVPool(tm, n_slots=3, max_seq=16, page_size=8, device="cpu")
    leaf = pool.cache["layers_0"]["b0_k"]
    pool.alloc("x", 5)
    pool.alloc("y", 5)
    kv = tuple(tuple((torch.full((2, 1, 8, 2, 16), 1.0 + j),
                      torch.full((2, 1, 8, 2, 16), -1.0 - j))
                     for j in range(len(g.blocks))) for g in tm.groups)
    slot = pool.seed("y", kv, 5)
    assert slot == 1 and pool.cache["layers_0"]["b0_k"] is leaf
    assert bool((leaf[:, 1, :8] == 1.0).all()) and not leaf[:, 1, 8:].any()
    assert not leaf[:, 0].any() and not leaf[:, 2].any()


# --------------------------------------------------------------------------
# the runtime end to end against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("engines", [("xla",), ("xla", "pallas")],
                         ids=["xla", "xla+pallas"])
def test_runtime_and_sequential_match_reference(smoke, engines):
    cfg, tm, tparams, jm, jparams = smoke
    trace = _trace(cfg, [5, 12, 8, 16, 3], 8, seed=0)
    lens = [len(p) for _, p, _ in trace]
    jreqs = [JRequest(*r) for r in trace]
    reqs = [ServeRequest(*r) for r in trace]
    jrt = JRuntime(jm, jparams, max_batch=2, max_seq=64,
                   plan_cache=JPlanCache())
    jrt.warmup(lens)
    want = [r.tokens for r in jrt.serve(jreqs, timeout_s=120)]

    pc = PlanCache()
    rt = AsyncServingRuntime(tm, tparams, max_batch=2, max_seq=64,
                             plan_cache=pc, engines=engines, device="cpu")
    rt.warmup(lens)
    misses0, hits0 = pc.stats()["misses"], pc.stats()["hits"]
    res = rt.serve(reqs, timeout_s=120)
    assert [r.status for r in res] == ["ok"] * len(reqs)
    assert [r.tokens for r in res] == want
    assert all(len(r.tokens) == 8 for r in res)
    # no warm-bucket re-plan: every serve-time plan fetch is a cache hit
    assert pc.stats()["misses"] == misses0
    assert pc.stats()["hits"] - hits0 >= len(reqs)
    s = rt.metrics.summary()
    assert s["completed"] == len(reqs) and s["generated_tokens"] == 40
    occ = rt.pool.occupancy()
    assert occ["slots_used"] == 0 and occ["pages_used"] == 0

    jseq = jsequential(jm, jparams, jreqs, max_seq=64,
                       plan_cache=JPlanCache())
    seq = serve_sequential(tm, tparams, reqs, max_seq=64, engines=engines,
                           plan_cache=PlanCache(), device="cpu")
    assert [r.tokens for r in seq] == [r.tokens for r in jseq] == want


def test_batched_prefill_identical_token_streams(smoke):
    """Same-bucket waiting requests prefill as ONE planned forward over a
    (w, bucket) batch: identical token streams to per-request prefill,
    and one forward per prefill call."""
    cfg, tm, tparams, _, _ = smoke
    trace = _trace(cfg, [7, 6, 5, 8], 6, seed=3)
    runs = {}
    for pb in (4, 1):
        rt = AsyncServingRuntime(tm, tparams, max_batch=4, max_seq=32,
                                 plan_cache=PlanCache(), prefill_batch=pb,
                                 device="cpu")
        rt.warmup([8])
        fwd0 = rt.registry.count("lm.prefill_forwards", 0)
        res = rt.serve([ServeRequest(*r) for r in trace], timeout_s=120)
        assert [r.status for r in res] == ["ok"] * 4
        runs[pb] = (res, rt.registry.count("lm.batched_prefills", 0),
                    rt.registry.count("lm.prefill_forwards", 0) - fwd0)
        occ = rt.pool.occupancy()
        assert occ["slots_used"] == 0 and occ["pages_used"] == 0
    (res_b, batched, fwd_b), (res_s, single, fwd_s) = runs[4], runs[1]
    assert batched >= 2 and single == 0
    assert fwd_s == 4 and fwd_b < 4
    assert [r.tokens for r in res_b] == [r.tokens for r in res_s]


def test_runtime_serves_trace_after_trace(smoke):
    """One runtime serves two traces in turn: each call returns its own
    requests' tokens (those of serve_sequential), a request id that an
    earlier call resolved is served anew, and an id given twice in one
    call is refused."""
    cfg, tm, tparams, _, _ = smoke
    first = [ServeRequest(*r) for r in _trace(cfg, [5, 12, 8], 6, seed=7)]
    second = [ServeRequest(i + 10, p, g) for i, p, g in
              _trace(cfg, [9, 4, 16, 7], 5, seed=8)]
    rt = AsyncServingRuntime(tm, tparams, max_batch=2, max_seq=64,
                             plan_cache=PlanCache(), device="cpu")
    rt.warmup([len(r.prompt) for r in first + second])
    for trace in (first, second, first):
        res = rt.serve(trace, timeout_s=120)
        seq = serve_sequential(tm, tparams, trace, max_seq=64,
                               plan_cache=PlanCache(), device="cpu")
        assert [r.rid for r in res] == [r.rid for r in trace]
        assert [r.status for r in res] == ["ok"] * len(trace)
        assert [r.tokens for r in res] == [r.tokens for r in seq]
        assert all(len(r.tokens) == trace[0].gen for r in res)
    with pytest.raises(ValueError, match="twice"):
        rt.serve(first + first[:1], timeout_s=120)
    occ = rt.pool.occupancy()
    assert occ["slots_used"] == 0 and occ["pages_used"] == 0


def test_runtime_page_pressure_queues_instead_of_truncating(smoke):
    cfg, tm, tparams, _, _ = smoke
    trace = _trace(cfg, [24, 8], 8, seed=5)
    rt = AsyncServingRuntime(tm, tparams, max_batch=2, max_seq=32,
                             page_size=8, page_budget=5,
                             plan_cache=PlanCache(), device="cpu")
    rt.warmup([24, 8])
    res = rt.serve([ServeRequest(*r) for r in trace], timeout_s=120)
    assert [r.status for r in res] == ["ok", "ok"]
    assert res[1].metrics.joined_at >= res[0].metrics.finished_at


def test_runtime_rejects_oversized_and_sheds_overload(smoke):
    cfg, tm, tparams, _, _ = smoke
    rt = AsyncServingRuntime(tm, tparams, max_batch=1, max_seq=32,
                             plan_cache=PlanCache(), device="cpu",
                             admission=AdmissionController(max_queue=2))
    rt.warmup([8])
    rt.submit(ServeRequest("big", tuple(range(40)), 8))
    assert rt._results["big"].status == "rejected"
    for i in range(4):
        rt.submit(ServeRequest(i, tuple(range(8)), 4))
    assert rt.metrics.rejected >= 2


def test_entry_points_need_a_card_unless_cpu(smoke, monkeypatch):
    """Without CUDA the runtime, serve_sequential and the CLI raise unless
    the caller asks for the CPU; nothing carries on on the CPU itself."""
    cfg, tm, tparams, _, _ = smoke
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AsyncServingRuntime(tm, tparams, max_seq=32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_sequential(tm, tparams, [ServeRequest(0, (1, 2), 2)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_cli.main(["--arch", ARCH, "--smoke", "--requests", "1"])
    res = serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                          "--requests", "3", "--gen", "4", "--max-batch",
                          "2", "--max-seq", "64"])
    assert [r.status for r in res] == ["ok"] * 3
    assert all(len(r.tokens) == 4 for r in res)
