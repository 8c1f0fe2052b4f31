"""The port's serving runtime on the MoE family against the reference, on
the CPU.

dbrx-132b at SMOKE width in float32 (2 layers, 4 experts top-2), the
reference's parameters from ``jax.random.key(1)`` carried across as numpy.
The runtime seeds its paged pool from the planned ``prefill_kv`` forward,
as for qwen3.  Checked:

  * the port's ``AsyncServingRuntime`` gives the reference runtime's token
    streams token for token under the same engines: ``("xla",)`` plans
    ``moe_dropping`` (capacity factor 1.0), ``("xla", "pallas")`` plans
    ``moe_gmm_pallas`` (2.0), so each side compares like with like; no
    re-planning after warmup; the kernels' launches, each wrapper's plain
    version counted as a launch here: 3 gmm x 2 MoE layers and 2 flash per
    prefill forward with the kernel slot, none without;
  * runtime ≡ ``serve_sequential`` for every request whose prefill dropped
    no prompt token's assignment (counted by ``chip_smoke.prefill_drops``,
    which the card run prints).  The runtime seeds K/V from the prefill,
    whose capacity dispatch may drop; ``serve_sequential`` replays the
    prompt through the decode step (capacity 8 a row at s = 1, never
    dropping).  At capacity factor 1.0 this trace's 12-token prompt drops
    and its stream departs; at 2.0 nothing drops and every stream is equal;
  * ``python -m repro_torch.launch.serve --arch dbrx-132b --smoke --device
    cpu`` (and llama4-maverick) prints what ``repro.launch.serve`` prints:
    the mode ``prefill_kv``, the buckets, the plan-cache counts, the
    tokens; without a card it raises unless ``--device cpu``.
"""
import contextlib
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# two intra-op threads: the suite runs beside other test workers
torch.set_num_threads(2)

import jax  # noqa: E402

from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.core.plan_cache import PlanCache as JPlanCache  # noqa: E402
from repro.launch import serve as jserve_cli  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.serving import AsyncServingRuntime as JRuntime  # noqa: E402
from repro.serving import ServeRequest as JRequest  # noqa: E402
from repro.serving import runtime as jruntime  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.plan_cache import PlanCache  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.layers import attention as attention_layer  # noqa: E402
from repro_torch.layers import moe as moe_layer  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.lm import params_from_numpy  # noqa: E402
from repro_torch.serving import (AsyncServingRuntime,  # noqa: E402
                                 ServeRequest, serve_sequential)
from repro_torch.serving import runtime as truntime  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (its per-prefill drop counter)

ARCH = "dbrx-132b"
LENS, GEN, MAX_BATCH, MAX_SEQ = [5, 12, 8, 16, 3], 8, 2, 64
ENGINES = [("xla",), ("xla", "pallas")]


@pytest.fixture(scope="module")
def smoke():
    """(port model, port params, the trace, reference tokens by engines)."""
    jm = jbuild(jsmoke(ARCH).replace(dtype="float32"))
    jparams, _ = jm.init_params(jax.random.key(1))
    tm = build_model(get_smoke_config(ARCH).replace(dtype="float32"))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.RandomState(0)
    trace = [(i, tuple(rng.randint(0, tm.cfg.vocab, n).tolist()), GEN)
             for i, n in enumerate(LENS)]
    want = {}
    for engines in ENGINES:
        jrt = JRuntime(jm, jparams, max_batch=MAX_BATCH, max_seq=MAX_SEQ,
                       plan_cache=JPlanCache(), engines=engines)
        jrt.warmup(LENS)
        want[engines] = [r.tokens for r in jrt.serve(
            [JRequest(*r) for r in trace], timeout_s=300)]
    return tm, tparams, trace, want


@contextlib.contextmanager
def counted(module, name, counts, key):
    """Count the calls of ``module.name`` (a kernel wrapper, under the name
    the layer calls it by) in ``counts[key]``."""
    wrapped = getattr(module, name)

    def count(*args, **kwargs):
        counts[key] += 1
        return wrapped(*args, **kwargs)

    setattr(module, name, count)
    try:
        yield
    finally:
        setattr(module, name, wrapped)


@pytest.mark.parametrize("engines", ENGINES, ids=["xla", "xla+pallas"])
def test_runtime_matches_reference_and_counts_launches(smoke, engines):
    tm, tparams, trace, want = smoke
    pc = PlanCache()
    rt = AsyncServingRuntime(tm, tparams, max_batch=MAX_BATCH,
                             max_seq=MAX_SEQ, plan_cache=pc, engines=engines,
                             device="cpu")
    assert rt.kv_mode
    rt.warmup(LENS)
    misses0 = pc.stats()["misses"]
    fwd0 = rt.registry.count("lm.prefill_forwards", 0)
    counts = {"gmm": 0, "flash": 0}
    with counted(moe_layer, "grouped_matmul", counts, "gmm"), \
            counted(attention_layer, "flash_attention", counts, "flash"):
        res = rt.serve([ServeRequest(*r) for r in trace], timeout_s=300)
    assert [r.status for r in res] == ["ok"] * len(trace)
    assert [r.tokens for r in res] == want[engines]
    assert pc.stats()["misses"] == misses0        # no re-plan after warmup
    occ = rt.pool.occupancy()
    assert occ["slots_used"] == 0 and occ["pages_used"] == 0
    forwards = rt.registry.count("lm.prefill_forwards", 0) - fwd0
    assert forwards >= 3
    kernel = "pallas" in engines
    assert counts == {"gmm": 3 * tm.cfg.n_layers * forwards * kernel,
                      "flash": tm.cfg.n_layers * forwards * kernel}


@pytest.mark.parametrize("engines", ENGINES, ids=["xla", "xla+pallas"])
def test_runtime_equals_sequential_where_no_prompt_drops(smoke, engines):
    tm, tparams, trace, _ = smoke
    reqs = [ServeRequest(*r) for r in trace]
    rt = AsyncServingRuntime(tm, tparams, max_batch=1, max_seq=MAX_SEQ,
                             plan_cache=PlanCache(), engines=engines,
                             device="cpu")
    rt.warmup(LENS)
    prefills = []
    with chip_smoke.prefill_drops(rt, prefills):
        res = rt.serve(reqs, timeout_s=300)
    assert len(prefills) == len(reqs)             # one prefill each, in order
    drops = [p["prompt_drops"] for p in prefills]
    seq = serve_sequential(tm, tparams, reqs, max_seq=MAX_SEQ,
                           engines=engines, plan_cache=PlanCache(),
                           device="cpu")
    for r, q, n in zip(res, seq, drops):
        if n == 0:
            assert r.tokens == q.tokens, r.rid
        assert r.tokens[0] == q.tokens[0]         # both from the prefill
    if "pallas" in engines:
        assert drops == [0] * len(reqs)
    else:
        assert drops[1] > 0 and res[1].tokens != seq[1].tokens


def _serve_lines(out: str) -> list:
    return [ln for ln in out.splitlines() if ln.startswith("[serve]")]


@pytest.mark.parametrize("arch", [ARCH, "llama4-maverick-400b-a17b"])
def test_cli_prints_what_the_reference_prints(arch, monkeypatch, capsys):
    # each CLI on a fresh plan cache: the process-wide default one keeps
    # the counts of whatever ran before in this process
    monkeypatch.setattr(jruntime, "default_plan_cache", JPlanCache)
    monkeypatch.setattr(truntime, "default_plan_cache", PlanCache)
    argv = ["--arch", arch, "--smoke", "--requests", "3", "--gen", "4",
            "--max-batch", "2", "--max-seq", "64"]
    jres = jserve_cli.main(argv)
    want = _serve_lines(capsys.readouterr().out)
    res = serve_cli.main(argv + ["--device", "cpu"])
    got = _serve_lines(capsys.readouterr().out)
    assert [r.status for r in res] == [r.status for r in jres] == ["ok"] * 3
    assert [len(r.tokens) for r in res] == [len(r.tokens) for r in jres]
    assert len(got) == len(want)
    assert got[0] == want[0] + " device=cpu"
    assert "mode=prefill_kv" in got[0]
    assert got[1].split("buckets")[1] == want[1].split("buckets")[1]
    assert got[2].split(" in ")[0] == want[2].split(" in ")[0]   # tokens
    assert got[3] == want[3]                                     # plan cache
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_cli.main(argv)
