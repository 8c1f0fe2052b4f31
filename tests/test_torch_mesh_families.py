"""The rwkv, hybrid, vlm and encdec families' sharded train steps on gloo
worlds of CPU ranks, against the reference and the port's one rank.

One world of four ranks a mesh shape (2 x 2 and 1 x 4) runs
``repro_torch.examples.train_sharded``'s rank entry for rwkv6-3b,
zamba2-7b, llava-next-34b and seamless-m4t-medium in turn, at the smoke
size in float32 (batch 8, sequence 16; llava's 8 frontend positions and 8
text tokens), from the reference's ``init_params`` carried across as
numpy:

  * each family's loss within 1e-4 and ``grad_norm`` within 1e-3 of the
    reference's single-device step (the tolerances of the reference's
    ``test_sharded_step_matches_single_device``), its plan id the
    reference's on the same mesh catalog;
  * every gathered gradient leaf within 1e-6 of the port's one-rank
    gradients (this decides which leaves' gradients are partial sums over
    ``model``: the rwkv time mix's ``w0`` / ``wA`` / ``wB`` / ``u`` /
    ``mu`` / ``ln_scale``, the channel mix's receptance, the mamba block's
    per-head leaves, ``B`` / ``C`` and conv, the decoder's ``memory``), and
    within 1e-4 of the largest gradient of the reference's
    ``jax.value_and_grad`` (zamba2's weight-shared block, used in every
    period, included);
  * the kernels' entries see a rank's heads: wkv6 on H / model, ssd on
    the mamba heads / model, flash on the query heads / model, in the
    counts one layer forward and its remat recompute give
    (``chip_smoke.family_kernel_calls``, counted by
    ``chip_smoke.family_calls``, as on the card);
  * the ``model`` axis's collectives, calls and bytes, equal
    ``chip_smoke.model_axis_prediction``'s reckoning from the config;
  * zamba2 saved on 2 x 2 and restored onto 1 x 4 (``elastic.remesh``)
    bitwise, and the next step within 1e-5 of one rank's from the same
    checkpoint.

The full-width train plans of the four bind to a 2 x 2 mesh with the
reference's plan id, and ``concat_seq`` refuses a frontend prefix whose
rows are not the text's.  The ranks import this module to find their
entry, so the reference package is imported inside the functions that use
it.
"""
import contextlib
import sys
from collections import Counter
from dataclasses import asdict
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.configs import get_config as tconfig  # noqa: E402
from repro_torch.configs import get_smoke_config as tsmoke  # noqa: E402
from repro_torch.core import ir as tir  # noqa: E402
from repro_torch.core.executor import plan_and_compile  # noqa: E402
from repro_torch.examples import train_sharded as ts  # noqa: E402
from repro_torch.launch.mesh import make_cpu_mesh, run_ranks  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.lm import CATALOG, params_from_numpy  # noqa: E402
from repro_torch.train.checkpoint import restore_checkpoint  # noqa: E402
from repro_torch.train.optim import (cosine_schedule,  # noqa: E402
                                     make_optimizer)
from repro_torch.train.train_step import (init_state,  # noqa: E402
                                          loss_and_grads, make_train_step)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (a step's kernel calls and collectives)

B, S = 8, 16
ENGINES = ("xla", "pallas")
F32 = {"dtype": "float32"}
ARCHS = ["rwkv6-3b", "zamba2-7b", "llava-next-34b", "seamless-m4t-medium"]
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
GRAD_REL = 1e-4
HW = asdict(tir.HardwareSpec())           # the port's catalog, both sides


@contextlib.contextmanager
def _one_thread():
    """The ranks take the caller's intra-op thread count: one each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.array(tree.detach().float())        # a copy


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield ".".join(path), tree


def _max_diff(a, b) -> float:
    got, want = dict(_leaves(a)), dict(_leaves(b))
    assert got.keys() == want.keys()
    return max(float(np.abs(got[k] - want[k]).max()) for k in got)


def _job(arch, mesh, params, **kw):
    return {"arch": arch, "mesh": mesh, "params": params, "overrides": F32,
            "steps": 1, **kw}


# --------------------------------------------------------------------------
# the references: the JAX package's single-device step, the port's one rank
# --------------------------------------------------------------------------

def _reference(arch):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config
    from repro.core import ir as jir
    from repro.core.executor import plan_and_compile as jcompile
    from repro.data.pipeline import DataConfig, synth_batch
    from repro.models import build_model as jbuild
    from repro.models.lm import CATALOG as JCAT
    from repro.train import optim as jopt
    cfg = get_smoke_config(arch).replace(dtype="float32")
    model = jbuild(cfg)
    hw = jir.HardwareSpec(**HW)
    fwd = jcompile(model.build_plan(B, S, mode="train"), JCAT,
                   jir.SystemCatalog(hardware=hw), engines=ENGINES,
                   cache=False)
    plan_ids = {name: jcompile(
        model.build_plan(B, S, mode="train"), JCAT, jir.SystemCatalog(
            hardware=hw, mesh_axes=("data", "model"), mesh_shape=mesh),
        engines=ENGINES, cache=False).plan_id
        for name, mesh in MESHES.items()}
    params, _ = model.init_params(jax.random.key(0))
    batch = {k: jnp.asarray(v) for k, v in synth_batch(DataConfig(
        vocab=cfg.vocab, seq_len=S, global_batch=B,
        frontend_tokens=cfg.frontend_tokens, d_model=cfg.d_model,
        encdec=cfg.family == "encdec"), 0).items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: fwd(p, batch, {})))(params)
    _, gnorm = jopt.clip_by_global_norm(grads, 1.0)
    return {"params": jax.tree.map(np.asarray, params),
            "grads": jax.tree.map(np.asarray, grads), "loss": float(loss),
            "grad_norm": float(gnorm), "plan_ids": plan_ids}


@pytest.fixture(scope="module")
def reference():
    """Per family: the reference's smoke params (numpy), the loss,
    gradients and ``grad_norm`` of its single-device step on batch 0, and
    its train plan ids on the two mesh catalogs."""
    return {arch: _reference(arch) for arch in ARCHS}


def _one_rank(arch):
    """The port's one-rank model, plan, optimizer and step."""
    cfg = tsmoke(arch).replace(**F32)
    fwd = plan_and_compile(build_model(cfg).build_plan(B, S, mode="train"),
                           CATALOG, tir.SystemCatalog(), engines=ENGINES,
                           cache=False, device="cpu")
    opt = make_optimizer("adamw", cosine_schedule(1e-3, 1, 100))
    return cfg, fwd, opt, make_train_step(fwd, opt)


@pytest.fixture(scope="module")
def single(reference):
    """Per family: the port's one-rank gradients from the reference's
    params on batch 0."""
    out = {}
    for arch in ARCHS:
        cfg, fwd, _, _ = _one_rank(arch)
        job = {**ts.JOB, "arch": arch, "overrides": F32}
        _, grads = loss_and_grads(fwd, params_from_numpy(
            reference[arch]["params"]), ts.global_batch(cfg, job, 0))
        out[arch] = _np(grads)
    return out


# --------------------------------------------------------------------------
# the worlds: every family in turn on one mesh
# --------------------------------------------------------------------------

def _families_rank(world, jobs):
    """One rank of a families world: per job, the gathered gradients of
    batch 0, then ``rank_run``'s step report with the kernel entries'
    calls by heads (``heads``)."""
    from repro_torch.launch.mesh import gather_state, make_rank_mesh
    out = []
    for job in jobs:
        job = {**ts.JOB, **job}
        cfg = ts.job_config(job)
        mesh = make_rank_mesh(world, *job["mesh"])
        model, fwd, _opt, sh, _ = ts.build_step(cfg, job, mesh)
        params = ts.local_params(model, job, mesh, sh.params)
        _, grads = loss_and_grads(fwd, params, ts.batch_for(cfg, job, 0,
                                                            mesh))
        grads = _np(gather_state(grads, sh.params))
        world.barrier()
        heads = Counter()
        with chip_smoke.family_calls(heads):
            report = ts.rank_run(world, job)
        out.append({**report, "grads": grads, "heads": dict(heads)})
    return out


def _world(name, reference, tmp):
    mesh = MESHES[name]
    jobs = []
    for arch in ARCHS:
        extra = {}
        if arch == "zamba2-7b" and name == "2x2":
            extra = {"save_at": 1, "ckpt_dir": str(tmp / "ckpt"),
                     "remesh": {"min_model": 4}, "return_params": True}
        jobs.append(_job(arch, mesh, reference[arch]["params"], **extra))
    with _one_thread():
        ranks = run_ranks(_families_rank, 4, device="cpu",
                          init_file=Path(tmp) / "group", args=(jobs,),
                          timeout=400)
    return {arch: [r[i] for r in ranks] for i, arch in enumerate(ARCHS)}


@pytest.fixture(scope="module")
def worlds(reference, tmp_path_factory):
    return {name: _world(name, reference,
                         tmp_path_factory.mktemp(f"families{name}"))
            for name in MESHES}


CASES = [(m, a) for m in MESHES for a in ARCHS]


@pytest.mark.parametrize("mesh,arch", CASES)
def test_family_step_matches_single_device(worlds, reference, mesh, arch):
    ranks, ref = worlds[mesh][arch], reference[arch]
    for r in ranks:
        assert r["plan_id"] == ref["plan_ids"][mesh]
        assert abs(r["losses"][0] - ref["loss"]) < 1e-4, r["losses"]
        assert abs(r["grad_norms"][0] - ref["grad_norm"]) < 1e-3
        assert r["losses"][0] == ranks[0]["losses"][0]
        assert r["grad_norms"][0] == ranks[0]["grad_norms"][0]
        assert r["launches"][0] == {}         # the plain versions on a CPU
        assert r["state_bytes"] == r["spec_bytes"]


@pytest.mark.parametrize("mesh,arch", CASES)
def test_family_gradients_match_one_rank(worlds, single, mesh, arch):
    for r in worlds[mesh][arch]:
        assert _max_diff(r["grads"], single[arch]) < 1e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_family_gradients_match_reference(worlds, reference, arch):
    """The gathered gradients of 2 x 2 against ``jax.value_and_grad``'s,
    each leaf within GRAD_REL of its largest magnitude: zamba2's shared
    attention and MLP, applied in each of its two periods, sum both."""
    got = dict(_leaves(worlds["2x2"][arch][0]["grads"]))
    want = dict(_leaves(reference[arch]["grads"]))
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(
            got[k], w, rtol=0, atol=GRAD_REL * max(float(np.abs(w).max()),
                                                   1e-30), err_msg=k)
    if arch == "zamba2-7b":
        assert tsmoke(arch).n_layers // tsmoke(arch).shared_attn_period == 2
        assert all(np.abs(v).max() > 0 for k, v in got.items()
                   if k.startswith("shared."))


@pytest.mark.parametrize("mesh,arch", CASES)
def test_kernels_run_on_a_ranks_heads(worlds, mesh, arch):
    """Every step of the report: zamba2 on 2 x 2 takes its next step on
    the re-meshed 1 x 4."""
    for r in worlds[mesh][arch]:
        cfg = tsmoke(arch)
        want = Counter(chip_smoke.family_kernel_calls(cfg, r["mesh"][1]))
        if "after" in r:
            want += Counter(chip_smoke.family_kernel_calls(
                cfg, r["after"]["mesh"][1]))
        assert r["heads"] == dict(want)


@pytest.mark.parametrize("mesh,arch", CASES)
def test_model_axis_collectives_match_the_prediction(worlds, mesh, arch):
    d, m = MESHES[mesh]
    cfg = tsmoke(arch).replace(**F32)
    want = chip_smoke.model_axis_prediction(cfg, d, m, B, S)
    for r in worlds[mesh][arch]:
        got = {k: v for k, v in r["stats"][0].items()
               if k.startswith("model.")}
        assert got == want


def test_zamba2_restores_across_meshes_bitwise(worlds):
    ranks = worlds["2x2"]["zamba2-7b"]
    for r in ranks:
        assert r["after"]["mesh"] == (1, 4)
        assert r["after"]["restored_mismatches"] == []
        assert r["after"]["state_bytes"] == r["after"]["spec_bytes"]
    got = dict(_leaves(ranks[0]["after"]["restored_params"]))
    want = dict(_leaves(ranks[0]["saved_params"]))
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    # the next step on 1 x 4 is one rank's step from the checkpoint
    cfg, _fwd, opt, step = _one_rank("zamba2-7b")
    abstract = build_model(cfg).abstract_params()
    template = init_state(_cpu_like(abstract), opt)
    state = restore_checkpoint(ranks[0]["ckpt"], template)
    job = {**ts.JOB, "arch": "zamba2-7b", "overrides": F32}
    state, m = step(state, ts.global_batch(cfg, job, int(state.step)))
    for r in ranks:
        np.testing.assert_allclose(r["after"]["losses"][0], float(m["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(r["after"]["grad_norms"][0],
                                   float(m["grad_norm"]), rtol=1e-5)


def _cpu_like(tree):
    if isinstance(tree, dict):
        return {k: _cpu_like(v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype)


# --------------------------------------------------------------------------
# no ranks: full-width plans on a mesh, the vlm prefix's rows
# --------------------------------------------------------------------------

def _stub_mesh(n_data, n_model):
    layout = make_cpu_mesh(n_data, n_model)
    return SimpleNamespace(axis_names=layout.axis_names, shape=layout.shape,
                           device=torch.device("cpu"),
                           axis=lambda name: SimpleNamespace(world=2))


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_family_plans_bind_to_a_mesh(arch):
    from repro.configs import get_config as jconfig
    from repro.core import ir as jir
    from repro.core.executor import plan_and_compile as jcompile
    from repro.models import build_model as jbuild
    from repro.models.lm import CATALOG as JCAT
    kw = dict(mesh_axes=("data", "model"), mesh_shape=(2, 2))
    b, s = 8, 2048
    want = jcompile(jbuild(jconfig(arch)).build_plan(b, s, mode="train"),
                    JCAT, jir.SystemCatalog(hardware=jir.HardwareSpec(**HW),
                                            **kw),
                    engines=ENGINES, cache=False)
    model = build_model(tconfig(arch))
    got = plan_and_compile(model.build_plan(b, s, mode="train"), CATALOG,
                           tir.SystemCatalog(**kw), engines=ENGINES,
                           cache=False, device="cpu", mesh=_stub_mesh(2, 2),
                           param_specs=model.param_specs())
    assert got.plan_id == want.plan_id
    assert got.param_shardings is not None


def test_concat_seq_refuses_a_prefix_of_other_rows():
    cfg = tsmoke("llava-next-34b").replace(**F32)
    model = build_model(cfg)
    fwd = plan_and_compile(model.build_plan(2, S, mode="prefill"), CATALOG,
                           tir.SystemCatalog(), engines=ENGINES, cache=False,
                           device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    front = cfg.frontend_tokens
    tokens = torch.zeros((2, S - front), dtype=torch.int32)
    embeds = torch.zeros((1, front, cfg.d_model))
    with pytest.raises(ValueError, match="frontend_embeds"):
        fwd(params, {"tokens": tokens, "frontend_embeds": embeds})
