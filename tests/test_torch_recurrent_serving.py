"""The port's serving runtime in replay mode against the reference, on the
CPU.

The recurrent families (rwkv6-3b, zamba2-7b; SMOKE width, float32) serve
through the replay fallback: a planned ``prefill`` forward gives the first
token, the prompt is replayed through the batch-1 decode step, and
``PagedKVPool.adopt`` writes the replayed cache into the request's slot.
The port's ``AsyncServingRuntime`` (both engine sets) and
``serve_sequential`` give the reference runtime's token streams token for
token, from the same numpy parameters, on the trace of
``tests/test_serving.py::test_runtime_replay_fallback_for_recurrent_family``
(prompts of 4 and 9 tokens, 5 generated, 2 slots) and with staggered
arrivals.  Also: ``adopt`` writes every leaf of the slot in place and
nothing else; replay mode never batches prefills; the constructor serves
these families and still raises without a card unless ``device="cpu"``;
``kv_mode`` follows the model (qwen3 seeds from ``prefill_kv``, the
recurrent families replay).
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
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.plan_cache import PlanCache  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.decode import init_cache  # noqa: E402
from repro_torch.models.lm import params_from_numpy  # noqa: E402
from repro_torch.serving import (AsyncServingRuntime,  # noqa: E402
                                 PagedKVPool, ServeRequest, serve_sequential)

ARCHS = ["rwkv6-3b", "zamba2-7b"]
LENS, GEN, MAX_BATCH, MAX_SEQ = [4, 9], 5, 2, 32


def _trace(cfg, lens, gen, seed=0, spacing=0.0):
    rng = np.random.RandomState(seed)
    return [(i, tuple(rng.randint(0, cfg.vocab, n).tolist()), gen,
             i * spacing) for i, n in enumerate(lens)]


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """(port model, port params, the trace, the reference runtime's token
    streams on it)."""
    arch = request.param
    jm = jbuild(jsmoke(arch).replace(dtype="float32"))
    jparams, _ = jm.init_params(jax.random.key(1))
    tm = build_model(get_smoke_config(arch).replace(dtype="float32"))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    trace = _trace(tm.cfg, LENS, GEN)
    jrt = JRuntime(jm, jparams, max_batch=MAX_BATCH, max_seq=MAX_SEQ,
                   plan_cache=JPlanCache())
    assert not jrt.kv_mode
    jrt.warmup(LENS)
    want = [r.tokens for r in jrt.serve([JRequest(*r) for r in trace],
                                        timeout_s=120)]
    return tm, tparams, trace, want


@pytest.mark.parametrize("engines", [("xla",), ("xla", "pallas")],
                         ids=["xla", "xla+pallas"])
def test_runtime_and_sequential_match_reference(served, engines):
    tm, tparams, trace, want = served
    reqs = [ServeRequest(*r) for r in trace]
    pc = PlanCache()
    rt = AsyncServingRuntime(tm, tparams, max_batch=MAX_BATCH,
                             max_seq=MAX_SEQ, plan_cache=pc, engines=engines,
                             device="cpu")
    assert not rt.kv_mode
    rt.warmup(LENS)
    misses0 = pc.stats()["misses"]
    res = rt.serve(reqs, timeout_s=120)
    assert [r.status for r in res] == ["ok"] * len(reqs)
    assert [r.tokens for r in res] == want
    assert pc.stats()["misses"] == misses0        # no re-plan after warmup
    assert rt.registry.count("lm.replay_steps", 0) == sum(LENS)
    assert all(r.metrics.replay_ms > 0 for r in res)
    occ = rt.pool.occupancy()
    assert occ["slots_used"] == 0 and occ["pages_used"] == 0
    seq = serve_sequential(tm, tparams, reqs, max_seq=MAX_SEQ,
                           engines=engines, plan_cache=PlanCache(),
                           device="cpu")
    assert [r.tokens for r in seq] == want


def test_staggered_arrivals_match_reference(served):
    """Late arrivals join mid-flight at token boundaries: the same token
    streams as the all-at-once trace (greedy decode is order-free)."""
    tm, tparams, _, want = served
    trace = _trace(tm.cfg, LENS, GEN, spacing=0.02)
    rt = AsyncServingRuntime(tm, tparams, max_batch=MAX_BATCH,
                             max_seq=MAX_SEQ, plan_cache=PlanCache(),
                             device="cpu")
    rt.warmup(LENS)
    res = rt.serve([ServeRequest(*r) for r in trace], timeout_s=120)
    assert [r.tokens for r in res] == want


def test_replay_mode_never_batches_prefills(served):
    """Same-bucket waiting requests prefill one at a time in replay mode
    (the batched forward exposes no recurrent state to seed from)."""
    tm, tparams, _, _ = served
    trace = _trace(tm.cfg, [7, 6, 5], 3, seed=3)
    rt = AsyncServingRuntime(tm, tparams, max_batch=4, max_seq=MAX_SEQ,
                             plan_cache=PlanCache(), prefill_batch=4,
                             device="cpu")
    rt.warmup([8])
    fwd0 = rt.registry.count("lm.prefill_forwards", 0)
    res = rt.serve([ServeRequest(*r) for r in trace], timeout_s=120)
    assert [r.status for r in res] == ["ok"] * 3
    assert rt.registry.count("lm.batched_prefills", 0) == 0
    assert rt.registry.count("lm.prefill_forwards", 0) - fwd0 == 3


def test_adopt_writes_every_leaf_of_the_slot(served):
    tm, _, _, _ = served
    pool = PagedKVPool(tm, n_slots=3, max_seq=16, page_size=8, device="cpu")
    before = {(g, k): v for g, gc in pool.cache.items()
              for k, v in gc.items()}
    for leaf in before.values():
        leaf.fill_(7.0)                    # an earlier occupant's state
    pool.alloc("x", 5)
    pool.alloc("y", 5)
    gen = torch.Generator().manual_seed(0)
    c1 = init_cache(tm, 1, 16, device="cpu")
    for gc in c1.values():
        for leaf in gc.values():
            leaf.copy_(torch.randn(leaf.shape, generator=gen))
    assert pool.adopt("y", c1) == 1
    for (g, k), leaf in before.items():
        assert pool.cache[g][k] is leaf, (g, k)           # in place
        assert torch.equal(leaf[:, 1], c1[g][k][:, 0].to(leaf.dtype)), k
        assert bool((leaf[:, 0] == 7.0).all()) and \
            bool((leaf[:, 2] == 7.0).all()), k
    assert pool.occupancy()["pages_used"] == 2
    with pytest.raises(ValueError, match="adopt"):
        pool.adopt("x", init_cache(tm, 2, 16, device="cpu"))


def test_entry_points_serve_recurrent_families_and_need_a_card(
        served, monkeypatch, capsys):
    """The constructor no longer refuses these families; without CUDA the
    runtime, serve_sequential and the CLI still raise unless the caller
    asks for the CPU."""
    tm, tparams, _, _ = served
    arch = tm.cfg.name.removesuffix("-smoke")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AsyncServingRuntime(tm, tparams, max_seq=32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_sequential(tm, tparams, [ServeRequest(0, (1, 2), 2)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_cli.main(["--arch", arch, "--smoke", "--requests", "1"])
    res = serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                          "--requests", "2", "--gen", "3", "--max-batch",
                          "2", "--max-seq", "64"])
    assert [len(r.tokens) for r in res if r.status == "ok"] == [3, 3]
    assert "mode=replay" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["qwen3-0.6b", *ARCHS])
def test_kv_mode_follows_the_model(arch):
    """The runtime seeds slots from a ``prefill_kv`` plan exactly when the
    model's whole decode state is attention K/V, and replays otherwise;
    no constructor argument overrides that."""
    tm = build_model(get_smoke_config(arch).replace(dtype="float32"))
    params = tm.init_params(torch.Generator().manual_seed(0))
    rt = AsyncServingRuntime(tm, params, max_batch=1, max_seq=16,
                             plan_cache=PlanCache(), device="cpu")
    assert rt.kv_mode == tm.supports_prefill_kv() == (arch == "qwen3-0.6b")
    assert (rt._cache1 is None) == rt.kv_mode     # the replay cache
