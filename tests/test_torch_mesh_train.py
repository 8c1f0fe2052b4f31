"""The port's sharded train step, elastic restore and sharded MoE forward on
gloo worlds of CPU ranks, against the reference and the port's one rank.

Each world is spawned by ``launch.mesh.run_ranks`` and runs
``repro_torch.examples.train_sharded``'s rank entries on CPU tensors at
the smoke size (float32, batch 8, sequence 16); the parameters are the
reference's ``init_params`` carried across as numpy.

  * qwen3 on 4 x 2 and 2 x 2: every rank's loss within 1e-4 and
    ``grad_norm`` within 1e-3 of the reference's single-device step (the
    reference's ``test_sharded_step_matches_single_device``), the gathered
    gradients within 1e-6 of the port's one-rank gradients, and the
    gathered updated parameters within 1e-5 of the port's one-rank step;
  * saved on 4 x 2 and restored onto 2 x 4 (``elastic.remesh``; the
    reference's ``test_elastic_reshard_restore``): the parameters bitwise,
    every rank's blocks bitwise the files', and the next step's loss and
    ``grad_norm`` within 1e-5 of one rank's step from that checkpoint;
  * dbrx on 1 x 2 and 2 x 2, ``pin_moe_layout`` False and True: the
    logits within 1e-5 of the unsharded port and within the MoE tests'
    1e-4 of the reference; each rank's expert calls see E / model experts;
  * bf16 live parameters with float32 masters gather at most 0.55 x the
    FSDP bytes of float32 ones (the port's form of the reference's
    ``test_bf16_master_params_cut_wire_bytes``);
  * a dim the rwkv, hybrid, vlm or encdec family cuts over ``model``
    that does not divide is refused when the plan is bound, with no rank
    started (their sharded steps: ``test_torch_mesh_families.py``).

The ranks import this module to find their entries, so the reference
package is imported inside the functions that use it.
"""
import contextlib
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.configs import get_smoke_config as tsmoke  # noqa: E402
from repro_torch.core.executor import plan_and_compile  # noqa: E402
from repro_torch.core.ir import SystemCatalog  # noqa: E402
from repro_torch.examples import train_sharded as ts  # noqa: E402
from repro_torch.layers import moe as tmoe  # noqa: E402
from repro_torch.launch.mesh import make_cpu_mesh, run_ranks  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.lm import CATALOG, params_from_numpy  # noqa: E402
from repro_torch.train.checkpoint import restore_checkpoint  # noqa: E402
from repro_torch.train.optim import (cosine_schedule,  # noqa: E402
                                     make_optimizer)
from repro_torch.train.train_step import (init_state,  # noqa: E402
                                          loss_and_grads, make_train_step)

B, S = 8, 16
ENGINES = ("xla", "pallas")
F32 = {"dtype": "float32"}


@contextlib.contextmanager
def _one_thread():
    """The ranks take the caller's intra-op thread count: one each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _world(fn, n, job, tmp):
    with _one_thread():
        return run_ranks(fn, n, device="cpu", init_file=Path(tmp) / "group",
                         args=(job,), timeout=300)


def _batch(cfg, step=0):
    from repro_torch.data.pipeline import DataConfig, synth_batch
    return {k: torch.from_numpy(v) for k, v in synth_batch(DataConfig(
        vocab=cfg.vocab, seq_len=S, global_batch=B), step).items()}


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


# --------------------------------------------------------------------------
# the references: the JAX package's single-device step, the port's one rank
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference():
    """The reference's qwen3 smoke params (numpy), and the loss and
    ``grad_norm`` of its single-device step on batch 0."""
    import jax
    from repro.configs import get_smoke_config
    from repro.core import ir as jir
    from repro.core.executor import plan_and_compile as jcompile
    from repro.data.pipeline import DataConfig, synth_batch
    from repro.models import build_model as jbuild
    from repro.models.lm import CATALOG as JCAT
    from repro.train import optim as jopt
    from repro.train import train_step as jstep
    cfg = get_smoke_config("qwen3-0.6b").replace(dtype="float32")
    model = jbuild(cfg)
    fwd = jcompile(model.build_plan(B, S, mode="train"), JCAT,
                   jir.SystemCatalog(), engines=ENGINES, cache=False)
    opt = jopt.make_optimizer("adamw", jopt.cosine_schedule(1e-3, 1, 100))
    params, _ = model.init_params(jax.random.key(0))
    state = jstep.init_state(params, opt)
    batch = synth_batch(DataConfig(vocab=cfg.vocab, seq_len=S,
                                   global_batch=B), 0)
    _, m = jax.jit(jstep.make_train_step(fwd, opt))(state, batch)
    return {"params": jax.tree.map(np.asarray, params),
            "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}


def _one_rank(job):
    """The port's one-rank model, plan, optimizer and step of a job."""
    job = {**ts.JOB, **job}
    cfg = ts.job_config(job)
    model = build_model(cfg)
    fwd = plan_and_compile(model.build_plan(B, S, mode="train"), CATALOG,
                           SystemCatalog(), engines=ENGINES, cache=False,
                           device="cpu")
    opt = make_optimizer(job["optimizer"], cosine_schedule(job["lr"], 1, 100),
                         master=job["master"])
    return cfg, model, fwd, opt, make_train_step(fwd, opt)


@pytest.fixture(scope="module")
def single(reference):
    """The port's one-rank step from the reference's params: gradients,
    loss, ``grad_norm`` and updated params."""
    cfg, model, fwd, opt, step = _one_rank({"overrides": F32})
    params = params_from_numpy(reference["params"])
    _, grads = loss_and_grads(fwd, params, _batch(cfg))
    state, m = step(init_state(params, opt), _batch(cfg))
    return {"grads": _np(grads), "params": _np(state.params),
            "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}


def _grads_rank(world, job):
    """A rank's step report, with its gathered gradients of batch 0."""
    from repro_torch.launch.mesh import gather_state, make_rank_mesh
    job = {**ts.JOB, **job}
    cfg = ts.job_config(job)
    mesh = make_rank_mesh(world, *job["mesh"])
    model, fwd, opt, sh, _ = ts.build_step(cfg, job, mesh)
    params = ts.local_params(model, job, mesh, sh.params)
    _, grads = loss_and_grads(fwd, params, ts.batch_for(cfg, job, 0, mesh))
    grads = _np(gather_state(grads, sh.params))
    world.barrier()
    return {"grads": grads, **ts.rank_run(world, job)}


# --------------------------------------------------------------------------
# the worlds
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world_42(reference, tmp_path_factory):
    """4 x 2: one step, saved, re-meshed onto 2 x 4, restored, one step."""
    tmp = tmp_path_factory.mktemp("mesh42")
    job = {"mesh": (4, 2), "params": reference["params"], "overrides": F32,
           "steps": 1, "save_at": 1, "ckpt_dir": str(tmp / "ckpt"),
           "remesh": {"min_model": 4, "prefer_model": 4},
           "return_params": True}
    return _world(_grads_rank, 8, job, tmp)


def _jobs_rank(world, jobs):
    """:func:`_grads_rank` for the first job, ``rank_run`` for the rest."""
    return [_grads_rank(world, jobs[0])] + [ts.rank_run(world, j)
                                            for j in jobs[1:]]


@pytest.fixture(scope="module")
def worlds_22(reference, tmp_path_factory):
    """2 x 2: one AdamW step, then two Adafactor steps."""
    job = {"mesh": (2, 2), "params": reference["params"], "overrides": F32,
           "steps": 1, "return_params": True}
    return _world(_jobs_rank, 4, [job, {**job, "optimizer": "adafactor",
                                        "steps": 2}],
                  tmp_path_factory.mktemp("mesh22"))


@pytest.fixture(scope="module")
def world_22(worlds_22):
    return [r[0] for r in worlds_22]


@pytest.mark.parametrize("name", ["world_42", "world_22"])
def test_sharded_step_matches_single_device(request, reference, single,
                                            name):
    ranks = request.getfixturevalue(name)
    for r in ranks:
        assert abs(r["losses"][0] - reference["loss"]) < 1e-4, r["losses"]
        assert abs(r["grad_norms"][0] - reference["grad_norm"]) < 1e-3
        assert r["losses"][0] == ranks[0]["losses"][0]
        assert r["grad_norms"][0] == ranks[0]["grad_norms"][0]
        assert r["launches"] == [{}]          # the plain versions on a CPU
        assert r["state_bytes"] == r["spec_bytes"]
    assert _max_diff(ranks[0]["grads"], single["grads"]) < 1e-6
    params = ranks[0].get("saved_params", ranks[0]["params"])
    assert _max_diff(params, single["params"]) < 1e-5


def test_adafactor_updates_shards_as_one_rank(reference, worlds_22):
    """Adafactor's factored means over cut dims sum over their axes: two
    sharded steps give one rank's losses, norms and params."""
    cfg, model, fwd, opt, step = _one_rank({"overrides": F32,
                                            "optimizer": "adafactor"})
    state = init_state(params_from_numpy(reference["params"]), opt)
    losses, norms = [], []
    for i in range(2):
        state, m = step(state, _batch(cfg, i))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    for r in (r[1] for r in worlds_22):
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(r["grad_norms"], norms, rtol=1e-5)
        assert r["state_bytes"] == r["spec_bytes"]
    assert _max_diff(worlds_22[0][1]["params"], _np(state.params)) < 1e-5


def test_layers_gather_their_data_shards_and_heads_reduce(world_42,
                                                          world_22):
    """One step's collectives by axis: FSDP gathers over ``data``, the
    row-parallel sums and the vocab-parallel loss over ``model``; on 2 x 2
    (KV heads divide) no gather over ``model``, on 2 x 4 (2 KV heads over
    4 ranks) the KV weights' gathers."""
    cfg = tsmoke("qwen3-0.6b")
    layers = cfg.n_layers
    for ranks in (world_42, world_22):
        st = ranks[0]["stats"][0]
        # each layer twice (forward, remat recompute), the table for the
        # embedding and the head, the final norm
        assert st["data.all_gather_calls"] == 2 * layers + 3
        assert st["model.all_reduce_calls"] > 0
        assert "model.all_gather_calls" not in st
    after = world_42[0]["after"]["stats"][0]
    assert after["model.all_gather_calls"] == 2 * layers


def test_elastic_restore_is_bitwise(world_42):
    for r in world_42:
        after = r["after"]
        assert after["mesh"] == (2, 4)
        assert after["restored_mismatches"] == []
        assert after["state_bytes"] == after["spec_bytes"]
    head = world_42[0]
    got, want = (dict(_leaves(head["after"]["restored_params"])),
                 dict(_leaves(head["saved_params"])))
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_next_step_after_restore_equals_one_rank(world_42):
    cfg, model, fwd, opt, step = _one_rank({"overrides": F32})
    state = restore_checkpoint(world_42[0]["ckpt"],
                               _cpu_template(model, opt))
    state, m = step(state, _batch(cfg, int(state.step)))
    for r in world_42:
        after = r["after"]
        np.testing.assert_allclose(after["losses"][0], float(m["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(after["grad_norms"][0],
                                   float(m["grad_norm"]), rtol=1e-5)


def _cpu_template(model, opt):
    """A one-rank state of the model's shapes and dtypes on the CPU."""
    def cpu(tree):
        if isinstance(tree, dict):
            return {k: cpu(v) for k, v in tree.items()}
        return torch.empty(tree.shape, dtype=tree.dtype)
    return init_state(cpu(model.abstract_params()), opt)


# --------------------------------------------------------------------------
# MoE on a mesh
# --------------------------------------------------------------------------

def _moe_rank(world, job):
    """``rank_forward`` under each ``pin_moe_layout``, recording how many
    experts each expert call saw."""
    seen = []
    experts = tmoe._experts

    def record(expert_in, *a, **k):
        seen.append(int(expert_in.shape[0]))
        return experts(expert_in, *a, **k)

    tmoe._experts = record
    out = {}
    try:
        for pin in (False, True):
            seen.clear()
            o = {**job, "overrides": {**job["overrides"],
                                      "pin_moe_layout": pin}}
            out[pin] = {**ts.rank_forward(world, o), "experts": list(seen)}
    finally:
        tmoe._experts = experts
    return out


@pytest.fixture(scope="module")
def dbrx():
    """The reference's dbrx smoke params (numpy) and its prefill logits on
    batch 0's tokens; the port's unsharded logits."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config
    from repro.core import ir as jir
    from repro.core.executor import plan_and_compile as jcompile
    from repro.models import build_model as jbuild
    from repro.models.lm import CATALOG as JCAT
    cfg = get_smoke_config("dbrx-132b").replace(dtype="float32")
    jm = jbuild(cfg)
    jparams, _ = jm.init_params(jax.random.key(1))
    tokens = _batch(tsmoke("dbrx-132b"))["tokens"]
    jfn = jcompile(jm.build_plan(B, S, "prefill"), JCAT, jir.SystemCatalog(),
                   engines=ENGINES, cache=False)
    ref = np.asarray(jfn(jparams, {"tokens": jnp.asarray(tokens.numpy())}))
    params = jax.tree.map(np.asarray, jparams)
    tm = build_model(tsmoke("dbrx-132b").replace(dtype="float32"))
    tfn = plan_and_compile(tm.build_plan(B, S, "prefill"), CATALOG,
                           SystemCatalog(), engines=ENGINES, cache=False,
                           device="cpu")
    with torch.inference_mode():
        port = tfn(params_from_numpy(params), {"tokens": tokens}).numpy()
    return {"params": params, "reference": ref, "port": port,
            "experts": cfg.experts}


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_moe_forward_on_a_mesh_matches_unsharded(dbrx, mesh,
                                                 tmp_path_factory):
    job = {"arch": "dbrx-132b", "mesh": mesh, "params": dbrx["params"],
           "overrides": F32}
    ranks = _world(_moe_rank, mesh[0] * mesh[1], job,
                   tmp_path_factory.mktemp("moe"))
    d, m = mesh
    for pin in (False, True):
        full = np.zeros_like(dbrx["port"])
        for r in ranks:
            o = r[pin]
            c, lg = o["coords"], o["logits"]
            b, _, v = lg.shape
            full[c["data"] * b:(c["data"] + 1) * b, :,
                 c["model"] * v:(c["model"] + 1) * v] = lg
            # 2 layers x 2 runs, each call on this rank's experts
            assert o["experts"] == [dbrx["experts"] // m] * 4, o["experts"]
        np.testing.assert_allclose(full, dbrx["port"], atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(full, dbrx["reference"], atol=1e-4,
                                   rtol=1e-4)


# --------------------------------------------------------------------------
# bf16 live params cut the FSDP bytes
# --------------------------------------------------------------------------

def _bytes_rank(world, job):
    out = {}
    for pd, master in (("float32", False), ("bfloat16", True)):
        o = {**job, "master": master,
             "overrides": {"dtype": "bfloat16", "param_dtype": pd}}
        out[pd] = ts.rank_run(world, o)["stats"][0]["data.all_gather_bytes"]
    return out


def test_bf16_master_params_cut_fsdp_bytes(tmp_path_factory):
    ranks = _world(_bytes_rank, 2, {"mesh": (2, 1), "steps": 1},
                   tmp_path_factory.mktemp("bytes"))
    for r in ranks:
        assert r["bfloat16"] <= 0.55 * r["float32"], r


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------

def _stub_mesh(n_data, n_model):
    layout = make_cpu_mesh(n_data, n_model)
    return SimpleNamespace(axis_names=layout.axis_names, shape=layout.shape,
                           device=torch.device("cpu"),
                           axis=lambda name: SimpleNamespace(world=2))


@pytest.mark.parametrize("arch,family,cut,n_model,dim", [
    ("rwkv6-3b", "rwkv", {}, 3, "heads"),
    ("zamba2-7b", "hybrid", {"ssm_state": 9}, 4, "inner_cat"),
    ("llava-next-34b", "vlm", {}, 3, "heads"),
    ("seamless-m4t-medium", "encdec", {}, 3, "heads.*cross_attention")])
def test_families_refuse_dims_that_do_not_divide(arch, family, cut, n_model,
                                                 dim):
    """A dim the family cuts over ``model`` that does not divide is refused
    when the plan is bound, before any rank starts (the stub mesh starts
    none)."""
    model = build_model(tsmoke(arch).replace(**cut))
    with pytest.raises(ValueError, match=f"{family} family cuts '{dim}"):
        plan_and_compile(model.build_plan(2, 16, mode="train"), CATALOG,
                         SystemCatalog(mesh_axes=("data", "model"),
                                       mesh_shape=(1, n_model)),
                         cache=False, device="cpu",
                         mesh=_stub_mesh(1, n_model),
                         param_specs=model.param_specs())


def test_an_lm_plan_on_a_mesh_needs_specs_and_a_rank_mesh():
    model = build_model(tsmoke("qwen3-0.6b"))
    plan = model.build_plan(2, 16, mode="train")
    with pytest.raises(ValueError, match="param_specs"):
        plan_and_compile(plan, CATALOG, SystemCatalog(), cache=False,
                         device="cpu", mesh=_stub_mesh(1, 2))
    data_mesh = SimpleNamespace(axis_names=("data", "model"),
                                shape={"data": 2, "model": 1},
                                device=torch.device("cpu"))
    with pytest.raises(ValueError, match="RankMesh"):
        plan_and_compile(plan, CATALOG, SystemCatalog(), cache=False,
                         device="cpu", mesh=data_mesh,
                         param_specs=model.param_specs())
    serving = model.build_plan(2, 16, mode="prefill_kv")
    with pytest.raises(ValueError, match="collect_kv"):
        plan_and_compile(serving, CATALOG, SystemCatalog(), cache=False,
                         device="cpu", mesh=_stub_mesh(2, 1),
                         param_specs=model.param_specs())
