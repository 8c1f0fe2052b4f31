"""The port's root examples (``repro_torch.examples.{quickstart,
polisci_analysis,serve_async,serve_batched}``) and ``launch.serve``'s
sequential helpers (``planned_prefill``, ``serve_request``) against the
reference's, on the CPU.

Each reference example (``examples/*.py``) runs as it stands, loaded from
its file, with the names it imported wrapped to record what it made: its
parameters (drawn from ``jax.random.key(0)``), its planned function and
what each step or request returned.  The port's example then runs on
those parameters, carried across with ``models.lm.params_from_numpy``:

  * quickstart: the plan id and the planner's choices equal, the 20 AdamW
    losses within 1e-4;
  * polisci: the planner's decisions equal, the output within 1e-5;
  * serve_async: every request's token stream equal (float32 greedy);
  * serve_batched: the CLI's token streams equal for qwen3 and rwkv6;
  * serve_request: the tokens and ``planned_prefill``'s bucket equal.
"""
import asyncio
import importlib.util
import types
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.core import ir as jir  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models.decode import decode_step as jdecode_step  # noqa: E402
from repro_torch.configs import get_smoke_config as tsmoke  # noqa: E402
from repro_torch.core import ir as tir  # noqa: E402
from repro_torch.examples import polisci_analysis  # noqa: E402
from repro_torch.examples import quickstart, serve_async  # noqa: E402
from repro_torch.examples import serve_batched  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402
from repro_torch.models.decode import decode_step  # noqa: E402
from repro_torch.models.lm import params_from_numpy  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LOSS_TOL = 1e-4
POLISCI_TOL = 1e-5
CPU = ["--device", "cpu"]


def _ref_catalog():
    """The port's system catalog of the reference's default hardware (the
    port's default is an H100): the plan ids are then the reference's."""
    return tir.SystemCatalog(hardware=tir.HardwareSpec(**asdict(
        jir.HardwareSpec())))


def _reference_example(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _numpy(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


# --------------------------------------------------------------------------
# quickstart
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def quickstart_reference():
    mod = _reference_example("quickstart")
    rec = {"losses": []}
    plan_and_compile, init_state = mod.plan_and_compile, mod.init_state

    def planned(*a, **kw):
        rec["fwd"] = plan_and_compile(*a, **kw)
        return rec["fwd"]

    def state(params, opt):
        rec["params"] = jax.tree.map(np.asarray, params)
        return init_state(params, opt)

    def jit(fn):
        step = jax.jit(fn)

        def run(state, batch):
            state, m = step(state, batch)
            rec["losses"].append(float(m["loss"]))
            return state, m
        return run

    mod.plan_and_compile, mod.init_state = planned, state
    mod.jax = types.SimpleNamespace(jit=jit, random=jax.random)
    mod.main()
    return rec


def test_quickstart_matches_the_reference(quickstart_reference,
                                         monkeypatch):
    ref = quickstart_reference
    monkeypatch.setattr(quickstart, "SystemCatalog", _ref_catalog)
    got = quickstart.main(CPU, params=params_from_numpy(ref["params"]))
    assert got["plan_id"] == ref["fwd"].plan_id
    assert got["chosen"] == [(r["pattern"], r["chosen"])
                             for r in ref["fwd"].report]
    assert len(got["losses"]) == len(ref["losses"]) == quickstart.STEPS
    err = np.abs(np.array(got["losses"]) - np.array(ref["losses"]))
    assert float(err.max()) <= LOSS_TOL, (got["losses"], ref["losses"])
    assert got["losses"][-1] < got["losses"][0]


# --------------------------------------------------------------------------
# polisci
# --------------------------------------------------------------------------

def test_polisci_matches_the_reference(monkeypatch):
    mod = _reference_example("polisci_analysis")
    rec = {}

    class Recording(mod.Analysis):
        def compile(self, *a, **kw):
            fn = super().compile(*a, **kw)
            rec["fn"] = fn

            def run(params, inputs):
                rec["params"] = jax.tree.map(np.asarray, params)
                rec["out"] = np.asarray(fn(params, inputs))
                return rec["out"]
            run.report = fn.report
            return run

    mod.Analysis = Recording
    mod.main()
    monkeypatch.setattr(polisci_analysis, "SystemCatalog", _ref_catalog)
    got = polisci_analysis.main(CPU, params=params_from_numpy(rec["params"]))
    assert got["decisions"] == [(r["pattern"], r["chosen"])
                                for r in rec["fn"].report]
    assert got["plan_id"] == rec["fn"].plan_id
    out = got["output"].numpy()
    assert out.shape == rec["out"].shape == (2, 64, 512)
    top = float(np.abs(rec["out"]).max())
    assert float(np.abs(out - rec["out"]).max()) <= POLISCI_TOL * top
    # the port's own tree, drawn from an explicit torch.Generator, has the
    # reference tree's leaves and shapes
    mine = polisci_analysis.init_params(torch.Generator().manual_seed(0))
    assert {k: {n: tuple(v.shape) for n, v in sub.items()}
            for k, sub in mine.items()} == \
        {k: {n: v.shape for n, v in sub.items()}
         for k, sub in rec["params"].items()}


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def test_serve_async_matches_the_reference():
    mod = _reference_example("serve_async")
    rec = {}

    class Recording(mod.AsyncServingRuntime):
        def __init__(self, model, params, **kw):
            rec["params"] = jax.tree.map(np.asarray, params)
            super().__init__(model, params, **kw)

        async def run(self, requests, *a, **kw):
            rec["results"] = await super().run(requests, *a, **kw)
            return rec["results"]

    mod.AsyncServingRuntime = Recording
    asyncio.run(mod.main_async())
    got = serve_async.main(CPU, params=params_from_numpy(rec["params"]))
    want = {r.rid: list(r.tokens) for r in rec["results"]}
    assert len(want) == len(serve_async.LENS)
    assert {r.rid: list(r.tokens) for r in got} == want
    assert all(len(t) == serve_async.GEN for t in want.values())


def test_serve_batched_matches_the_reference(monkeypatch):
    mod = _reference_example("serve_batched")
    rec = {"params": [], "results": []}
    runtime, main = jserve.AsyncServingRuntime, jserve.main

    class Recording(runtime):
        def __init__(self, model, params, **kw):
            rec["params"].append(jax.tree.map(np.asarray, params))
            super().__init__(model, params, **kw)

    def recording_main(argv=None):
        rec["results"].append(main(argv))
        return rec["results"][-1]

    monkeypatch.setattr(jserve, "AsyncServingRuntime", Recording)
    monkeypatch.setattr(jserve, "main", recording_main)
    mod.main()
    archs = list(serve_batched.RUNS)
    got = serve_batched.main(CPU, params={
        a: params_from_numpy(p) for a, p in zip(archs, rec["params"])})
    assert list(got) == archs and len(rec["results"]) == 2
    for arch, want in zip(archs, rec["results"]):
        assert [list(r.tokens) for r in got[arch]] == \
            [list(r.tokens) for r in want], arch
        assert all(r.tokens for r in want)


def test_serve_request_matches_the_reference():
    """``planned_prefill`` gives the reference's bucket and ``serve_request``
    its tokens: a batch of two 7-token prompts, 6 tokens each."""
    gen, prompt_len = 6, 7
    jcfg = jsmoke("qwen3-0.6b").replace(dtype="float32")
    jmodel = jbuild(jcfg)
    jparams, _ = jmodel.init_params(jax.random.key(0))
    prompts = np.random.RandomState(3).randint(0, jcfg.vocab,
                                               (2, prompt_len))
    jfwd, jbucket = jserve.planned_prefill(jmodel, jir.SystemCatalog(), 2,
                                           prompt_len)
    jstep = jax.jit(lambda p, c, t, i: jdecode_step(jmodel, p, c, t, i))
    want, _, _ = jserve.serve_request(jmodel, jcfg, jparams, jstep, jfwd,
                                      jbucket, jnp.asarray(prompts, jnp.int32),
                                      gen)

    cfg = tsmoke("qwen3-0.6b").replace(dtype="float32")
    model = tbuild(cfg)
    fwd, bucket = tserve.planned_prefill(model, _ref_catalog(), 2,
                                         prompt_len, device="cpu")
    assert bucket == jbucket == 8
    assert fwd.plan_id == jfwd.plan_id

    def dstep(p, c, t, i):
        return decode_step(model, p, c, t, i)
    got, t_prefill, t_gen = tserve.serve_request(
        model, cfg, _numpy(jparams), dstep, fwd, bucket, prompts, gen,
        device="cpu")
    assert got.shape == (2, gen) and t_prefill >= 0 and t_gen >= 0
    np.testing.assert_array_equal(got, np.asarray(want))


def test_examples_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for main in (quickstart.main, polisci_analysis.main, serve_async.main,
                 serve_batched.main):
        with pytest.raises(RuntimeError, match="cuda"):
            main([])
