"""The port's training path against the reference, on the CPU.

``softmax_xent``, the optimizers (``train/optim.py``), the train step
(``train/train_step.py``), checkpoints (``train/checkpoint.py``), the
resumable loop (``train/fault_tolerance.py``) and the CLI
(``launch/train.py``), at SMOKE width in float32 with the reference's
parameters from ``jax.random.key(0)`` carried across as numpy
(``params_from_numpy`` / ``train_state_from_numpy``).  Checked:

  * ``softmax_xent`` with and without ``-100`` labels;
  * ``cosine_schedule`` at every step 0 .. total + 2, ``clip_by_global_norm``
    below and above the bound, AdamW and Adafactor with and without
    ``master`` over 3 updates (the moments, the factored ``vr`` / ``vc``
    and the masters too);
  * one train step of each family (dense qwen3, moe dbrx, rwkv6, hybrid
    zamba2, vlm llava, encdec seamless; engines xla + pallas, the
    reference's Pallas kernels in interpret mode, the port's on their
    plain versions): the plan id, loss and ``grad_norm``, every gradient
    leaf, and the optimizer state after the step.  AdamW's first update is
    about ``lr * sign(g)``, so a gradient near 0 may flip the parameters'
    step: the parameters are checked as the optimizer's output on the
    reference's gradients, the moments against the reference's;
  * microbatched gradients equal full-batch ones; ``grad_dtype=
    "bfloat16"``; ``remat`` full / none / dots / dots_no_batch give
    bitwise-equal gradients; the loss falls over 30 steps on two
    alternating batches, as the reference's integration test;
  * checkpoints: round trip, resume, retention, a restore that casts, the
    supervisor under injected failures, the watchdog; a float32 / int32
    checkpoint written by the reference restores in the port leaf for
    leaf, and the reverse, under the reference's leaf names;
  * the CLI on the CPU: runs, resumes bitwise, trains the vlm and encdec
    families (their ``frontend_embeds`` from ``synth_batch``), refuses
    without a card; the example;
  * planning only: qwen3-0.6b's full-width train plan at 4 x 2048 has
    the reference's plan id and picks the flash kernel in its layers.

Tolerances: ``softmax_xent`` ``rtol=1e-6``; the optimizers ``rtol=1e-6,
atol=1e-7`` (one float32 formula in another operation order); a train
step's loss and ``grad_norm`` ``rtol=1e-4`` and each gradient within
``1e-4`` of its leaf's largest magnitude (float32 matmuls and softmaxes
summed in another order through the layers and their backward); with
``grad_dtype="bfloat16"`` each moment also within ``2^-7`` of itself (the
bfloat16 table's gradient is a bfloat16 sum of two parts, summed in
another order: one bfloat16 ulp apart).
"""
import os
import shutil
from dataclasses import asdict

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# two intra-op threads: the suite runs beside other test workers
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jconfig  # noqa: E402
from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.core import ir as jir  # noqa: E402
from repro.core.executor import plan_and_compile as jcompile  # noqa: E402
from repro.data.pipeline import DataConfig, synth_batch  # noqa: E402
from repro.layers import embedding as jemb  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models.lm import CATALOG as JCAT  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import optim as jopt  # noqa: E402
from repro.train import train_step as jstep  # noqa: E402
from repro_torch.configs import get_config as tconfig  # noqa: E402
from repro_torch.configs import get_smoke_config as tsmoke  # noqa: E402
from repro_torch.core import ir as tir  # noqa: E402
from repro_torch.core.executor import plan_and_compile as tcompile  # noqa
from repro_torch.examples import train_lm  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.layers import embedding as temb  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402
from repro_torch.models.lm import CATALOG as TCAT  # noqa: E402
from repro_torch.models.lm import (params_from_numpy,  # noqa: E402
                                   train_state_from_numpy)
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train import optim as topt  # noqa: E402
from repro_torch.train.fault_tolerance import (FailureInjector,  # noqa
                                               Watchdog, run_resumable)
from repro_torch.train.train_step import (TrainState,  # noqa: E402
                                          init_state, loss_and_grads,
                                          make_train_step)

REF_HW = asdict(jir.HardwareSpec())          # the reference's catalog
ENGINES = ("xla", "pallas")
OPT_TOL = dict(rtol=1e-6, atol=1e-7)
STEP_RTOL = 1e-4
GRAD_REL = 1e-4
ARCHS = ["qwen3-0.6b", "dbrx-132b", "rwkv6-3b", "zamba2-7b",
         "llava-next-34b", "seamless-m4t-medium"]
B, S = 2, 16


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def compile_pair(arch, b=B, s=S, engines=ENGINES, **cfg_kw):
    """(reference model, port model, reference fn, port fn) for the
    arch's SMOKE config in float32, planned for training."""
    jm = jbuild(jsmoke(arch).replace(dtype="float32", **cfg_kw))
    tm = tbuild(tsmoke(arch).replace(dtype="float32", **cfg_kw))
    jfn = jcompile(jm.build_plan(b, s, "train"), JCAT,
                   jir.SystemCatalog(hardware=jir.HardwareSpec(**REF_HW)),
                   engines=engines, cache=False)
    tfn = tcompile(tm.build_plan(b, s, "train"), TCAT,
                   tir.SystemCatalog(hardware=tir.HardwareSpec(**REF_HW)),
                   engines=engines, cache=False, device="cpu")
    return jm, tm, jfn, tfn


def batch_for(cfg, b=B, s=S, step=0):
    """``synth_batch``'s arrays: the reference's and the port's copies."""
    batch = synth_batch(DataConfig(
        vocab=cfg.vocab, seq_len=s, global_batch=b,
        frontend_tokens=cfg.frontend_tokens, d_model=cfg.d_model,
        encdec=cfg.family == "encdec"), step)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def named(tree) -> dict:
    return dict(tckpt.named_leaves(tree))


def assert_tree_close(got, want, rel, what, rtol=0.0):
    """Every leaf of ``got`` (port) within ``rel`` times the largest
    magnitude of the same leaf of ``want`` (reference), plus ``rtol``."""
    got, want = named(got), dict(
        (jckpt._leaf_path(p), np.asarray(v))
        for p, v in jax.tree_util.tree_flatten_with_path(want)[0])
    assert set(got) == set(want), what
    for name, w in want.items():
        np.testing.assert_allclose(
            got[name].detach().numpy(), w, rtol=rtol,
            atol=rel * max(float(np.abs(w).max()), 1e-30),
            err_msg=f"{what}: {name}")


# --------------------------------------------------------------------------
# the loss
# --------------------------------------------------------------------------

@pytest.mark.parametrize("ignored", [False, True], ids=["all", "ignore"])
def test_softmax_xent_matches_reference(ignored):
    rng = np.random.RandomState(0)
    logits = (3 * rng.standard_normal((3, 7, 50))).astype(np.float32)
    labels = rng.randint(0, 50, (3, 7)).astype(np.int32)
    if ignored:
        labels[:, -1] = -100
        labels[1, :4] = -100
    want = jemb.softmax_xent(jnp.asarray(logits), jnp.asarray(labels))
    got = temb.softmax_xent(torch.from_numpy(logits),
                            torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_softmax_xent_all_ignored_is_zero():
    logits = torch.randn(2, 3, 5)
    labels = torch.full((2, 3), -100, dtype=torch.int32)
    assert float(temb.softmax_xent(logits, labels)) == 0.0


# --------------------------------------------------------------------------
# optimizers
# --------------------------------------------------------------------------

def test_cosine_schedule_matches_reference():
    jlr, tlr = (m.cosine_schedule(3e-3, 5, 40) for m in (jopt, topt))
    for step in range(0, 43):
        np.testing.assert_allclose(
            float(tlr(torch.tensor(step, dtype=torch.int32))),
            float(jlr(jnp.asarray(step, jnp.int32))), **OPT_TOL)


def _grads_and_params(seed, scale):
    rng = np.random.RandomState(seed)
    return {"a": {"w": (scale * rng.standard_normal((4, 6, 5)))
                  .astype(np.float32),
                  "b": (scale * rng.standard_normal((5,))).astype(np.float32)},
            "c": (scale * rng.standard_normal((3, 8))).astype(np.float32)}


@pytest.mark.parametrize("max_norm", [1e3, 0.5], ids=["below", "clipped"])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _grads_and_params(1, 1.0)
    jt, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
    tt, tn = topt.clip_by_global_norm(params_from_numpy(g), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), **OPT_TOL)
    assert_tree_close(tt, jt, 1e-6, "clipped")


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("master", [False, True], ids=["plain", "master"])
def test_optimizer_three_updates_match_reference(name, master):
    params = _grads_and_params(2, 0.5)
    jo = jopt.make_optimizer(name, jopt.cosine_schedule(1e-2, 1, 10),
                             master=master)
    to = topt.make_optimizer(name, topt.cosine_schedule(1e-2, 1, 10),
                             master=master)
    jp = jax.tree.map(jnp.asarray, params)
    js = jo.init(jp)
    tp = params_from_numpy(params)
    ts = to.init(tp)
    for i in range(3):
        g = _grads_and_params(10 + i, 0.1 * (i + 1))
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = to.update(params_from_numpy(g), ts, tp)
    for got, want in ((tp, jp), (ts, js)):
        got, want = named(got), dict(
            (jckpt._leaf_path(p), np.asarray(v))
            for p, v in jax.tree_util.tree_flatten_with_path(want)[0])
        assert set(got) == set(want)
        for k, w in want.items():
            np.testing.assert_allclose(got[k].numpy(), w, err_msg=k,
                                       **OPT_TOL)
    assert int(ts["count"]) == 3 and ts["count"].dtype == torch.int32


# --------------------------------------------------------------------------
# the train step, one config of each family
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    jm, tm, jfn, tfn = compile_pair(arch)
    assert tfn.plan_id == jfn.plan_id
    assert tfn.chosen_impls() == [n.impl for n in jfn.concrete.topo()]
    jo = jopt.make_optimizer("adamw", jopt.cosine_schedule(1e-3, 2, 100))
    to = topt.make_optimizer("adamw", topt.cosine_schedule(1e-3, 2, 100))
    jparams, _ = jm.init_params(jax.random.key(0))
    js = jstep.init_state(jparams, jo)
    jb, tb = batch_for(jm.cfg)

    # the reference's step, component by component
    jl, jg = jax.value_and_grad(lambda p: jfn(p, jb, {}))(jparams)
    jcg, jn = jopt.clip_by_global_norm(jg, 1.0)
    jnp_params, jnopt = jo.update(jcg, js.opt_state, js.params)

    tl, tg = loss_and_grads(tfn, train_state_from_numpy(np_tree(js)).params,
                            tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=STEP_RTOL)
    assert_tree_close(tg, jg, GRAD_REL, f"{arch} gradients")

    ts = train_state_from_numpy(np_tree(js))
    ts, m = make_train_step(tfn, to)(ts, tb)
    np.testing.assert_allclose(float(m["loss"]), float(jl), rtol=STEP_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jn),
                               rtol=STEP_RTOL)
    assert int(m["step"]) == 1 and int(ts.step) == 1
    assert int(ts.opt_state["count"]) == 1
    for key in ("m", "v"):
        assert_tree_close(ts.opt_state[key], jnopt[key], GRAD_REL,
                          f"{arch} {key}")
    # the parameters: the port's optimizer on the reference's clipped
    # gradients gives the reference's updated parameters
    tp, _ = to.update(params_from_numpy(np_tree(jcg)),
                      to.init(params_from_numpy(np_tree(js.params))),
                      params_from_numpy(np_tree(js.params)))
    assert_tree_close(tp, jnp_params, 1e-6, f"{arch} updated params")


def test_microbatched_grads_match_full_batch(rng):
    """Two microbatches of equal valid counts: the accumulated mean equals
    the full batch's (the reference's test_integration check)."""
    _, tm, _, tfn = compile_pair("deepseek-7b", b=4, s=8)
    params = tm.init_params(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(rng.randint(0, tm.cfg.vocab, (4, 8))
                              .astype(np.int32))
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    opt = topt.make_optimizer("adamw", topt.cosine_schedule(1e-3, 5, 100))
    metrics, grads = [], []
    for n in (1, 2):
        state = init_state(topt.tree_map(torch.clone, params), opt)
        # clip_norm large: the clipped gradients are the raw ones
        step = make_train_step(tfn, opt, num_microbatches=n, clip_norm=1e9)
        state, m = step(state, batch)
        metrics.append(m)
        grads.append(state.opt_state["m"])       # 0.1 x the gradient
    assert abs(float(metrics[0]["loss"]) - float(metrics[1]["loss"])) < 1e-5
    np.testing.assert_allclose(float(metrics[1]["grad_norm"]),
                               float(metrics[0]["grad_norm"]), rtol=1e-5)
    for k, g in named(grads[0]).items():
        torch.testing.assert_close(named(grads[1])[k], g, rtol=1e-5,
                                   atol=1e-5 * float(g.abs().max()))


def test_bfloat16_grad_dtype_matches_reference():
    """``grad_dtype="bfloat16"``: float32 leaves of 2+ dimensions cast to
    bfloat16 for the forward and backward, the gradients in float32."""
    jm, tm, jfn, tfn = compile_pair("qwen3-0.6b")
    jo = jopt.make_optimizer("adamw", jopt.cosine_schedule(1e-3, 2, 100))
    to = topt.make_optimizer("adamw", topt.cosine_schedule(1e-3, 2, 100))
    jparams, _ = jm.init_params(jax.random.key(0))
    js = jstep.init_state(jparams, jo)
    jb, tb = batch_for(jm.cfg)
    js2, jm_ = jstep.make_train_step(jfn, jo, grad_dtype="bfloat16")(js, jb)
    ts = train_state_from_numpy(np_tree(js))
    tl, tg = loss_and_grads(tfn, ts.params, tb, grad_dtype="bfloat16")
    assert all(g.dtype == torch.float32 for g in topt.tree_leaves(tg))
    ts2, tm_ = make_train_step(tfn, to, grad_dtype="bfloat16")(ts, tb)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm_[key]), float(jm_[key]),
                                   rtol=STEP_RTOL)
    # the bfloat16 table's gradient is a bfloat16 sum of the gather's and
    # the head's parts, summed in another order: one bfloat16 ulp (2^-8
    # relative) apart at most, an element's moment with it
    for key in ("m", "v"):
        assert_tree_close(ts2.opt_state[key], js2.opt_state[key], GRAD_REL,
                          f"bfloat16 {key}", rtol=2 ** -7)


def test_remat_modes_give_bitwise_equal_gradients():
    grads = {}
    for remat in ("full", "none", "dots", "dots_no_batch"):
        _, tm, _, tfn = compile_pair("qwen3-0.6b", remat=remat)
        scans = [n for n in tfn.concrete.topo() if n.impl == "scan_layers_xla"]
        assert scans and all(n.attrs["remat"] == remat for n in scans)
        params = tm.init_params(torch.Generator().manual_seed(0))
        grads[remat] = named(loss_and_grads(
            tfn, params, batch_for(tm.cfg)[1])[1])
    for remat in ("none", "dots", "dots_no_batch"):
        for k, g in grads["full"].items():
            assert torch.equal(grads[remat][k], g), (remat, k)


def test_scan_refuses_a_gradient_through_a_serving_plan():
    """A ``collect_kv`` (``prefill_kv``) plan with parameters that require
    grad raises instead of running the layers without ``remat``; without
    a gradient it runs as before."""
    tm = tbuild(tsmoke("qwen3-0.6b").replace(dtype="float32"))
    fn = tcompile(tm.build_plan(1, 8, "prefill_kv"), TCAT,
                  tir.SystemCatalog(), cache=False, device="cpu")
    params = tm.init_params(torch.Generator().manual_seed(0))
    tokens = {"tokens": torch.zeros((1, 8), dtype=torch.int32)}
    assert len(fn(params, tokens)) == 2
    live = topt.tree_map(lambda p: p.detach().requires_grad_(), params)
    with pytest.raises(NotImplementedError, match="collect_kv"):
        fn(live, tokens)


def test_training_reduces_loss():
    _, tm, _, tfn = compile_pair("qwen3-0.6b", b=4, s=16)
    opt = topt.make_optimizer("adamw", topt.cosine_schedule(3e-3, 5, 200))
    step = make_train_step(tfn, opt)
    state = init_state(tm.init_params(torch.Generator().manual_seed(0)), opt)
    losses = []
    for i in range(30):
        state, m = step(state, batch_for(tm.cfg, 4, 16, step=i % 2)[1])
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses[::6]


# --------------------------------------------------------------------------
# checkpoints and the resumable loop
# --------------------------------------------------------------------------

def _setup():
    _, tm, _, tfn = compile_pair("qwen3-0.6b", b=2, s=8)
    opt = topt.make_optimizer("adamw", topt.cosine_schedule(1e-3, 2, 100))
    state = init_state(tm.init_params(torch.Generator().manual_seed(0)), opt)
    dc = DataConfig(vocab=tm.cfg.vocab, seq_len=8, global_batch=2)
    return state, make_train_step(tfn, opt), dc


def _run(state, step, dc, start, n):
    m = None
    for i in range(start, start + n):
        batch = {k: torch.from_numpy(v) for k, v in synth_batch(dc, i).items()}
        state, m = step(state, batch)
    return state, m


def test_checkpoint_roundtrip_identical(tmp_path):
    state, step, dc = _setup()
    state, _ = _run(state, step, dc, 0, 3)
    path = tckpt.save_checkpoint(str(tmp_path), 3, state)
    restored = tckpt.restore_checkpoint(path, state)
    assert isinstance(restored, TrainState)
    a, b = named(state), named(restored)
    assert set(a) == set(b) and "0" in a and "2.count" in a
    for k in a:
        assert torch.equal(a[k], b[k]) and a[k].dtype == b[k].dtype, k


def test_resume_is_deterministic(tmp_path):
    """6 straight steps == 3 steps + checkpoint / restore + 3 steps."""
    s1, step, dc = _setup()
    _, m1 = _run(s1, step, dc, 0, 6)
    s2, step2, _ = _setup()
    s2, _ = _run(s2, step2, dc, 0, 3)
    path = tckpt.save_checkpoint(str(tmp_path), 3, s2)
    s3 = tckpt.restore_checkpoint(path, s2)
    _, m3 = _run(s3, step2, dc, 3, 3)
    assert float(m1["loss"]) == float(m3["loss"])


def test_retention_keeps_last_n(tmp_path):
    state, _, _ = _setup()
    for k in (1, 2, 3, 4, 5):
        tckpt.save_checkpoint(str(tmp_path), k, state, keep=2)
    names = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert names == ["step_0000000004", "step_0000000005"]
    assert tckpt.checkpoint_step(tckpt.latest_checkpoint(str(tmp_path))) == 5
    assert tckpt.latest_checkpoint(str(tmp_path / "none")) is None


def test_restore_casts_dtype_and_keeps_bfloat16_bits(tmp_path):
    state, _, _ = _setup()
    path = tckpt.save_checkpoint(str(tmp_path), 1, state)
    tpl = topt.tree_map(lambda t: t.to(torch.bfloat16)
                        if t.dtype == torch.float32 and t.dim() >= 2 else t,
                        state.params)
    restored = tckpt.restore_checkpoint(path, TrainState(
        state.step, tpl, state.opt_state))
    leaves = topt.tree_leaves(restored.params)
    assert any(t.dtype == torch.bfloat16 for t in leaves)
    # a bfloat16 leaf is written as its bits and read back bitwise
    path = tckpt.save_checkpoint(str(tmp_path / "bf16"), 1, restored)
    back = tckpt.restore_checkpoint(path, restored)
    for k, t in named(restored).items():
        assert torch.equal(named(back)[k], t), k


def test_supervisor_survives_injected_failures(tmp_path):
    """The node-failure drill: the loop crashes at steps 4 and 9; the
    supervisor restarts from checkpoints and completes exactly 12 steps."""
    inj = FailureInjector(fail_at=(4, 9))
    state0, step, dc = _setup()
    ckpt = str(tmp_path)

    def make_loop(start):
        latest = tckpt.latest_checkpoint(ckpt)
        s = tckpt.restore_checkpoint(latest, state0) if latest else state0
        m = None
        for i in range(start, 12):
            inj.maybe_fail(i)
            batch = {k: torch.from_numpy(v)
                     for k, v in synth_batch(dc, i).items()}
            s, m = step(s, batch)
            if (i + 1) % 2 == 0:
                tckpt.save_checkpoint(ckpt, i + 1, s)
        return 12, {"loss": float(m["loss"])}

    out = run_resumable(12, make_loop=make_loop, ckpt_dir=ckpt)
    assert out["final_step"] == 12
    assert out["restarts"] == 2


def test_watchdog_flags_stragglers():
    wd = Watchdog(straggler_factor=2.0)
    for i in range(10):
        assert not wd.observe(i, 1.0)
    assert wd.observe(10, 5.0)           # 5x median
    assert wd.events and wd.events[0]["step"] == 10


def _reference_state():
    """A reference AdamW state after one update (moments nonzero)."""
    jm = jbuild(jsmoke("qwen3-0.6b").replace(dtype="float32"))
    jo = jopt.make_optimizer("adamw", jopt.cosine_schedule(1e-3, 2, 100))
    jparams, _ = jm.init_params(jax.random.key(0))
    js = jstep.init_state(jparams, jo)
    g = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), jparams)
    p2, o2 = jo.update(g, js.opt_state, js.params)
    return jstep.TrainState(js.step + 1, p2, o2)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    js = _reference_state()
    path = jckpt.save_checkpoint(str(tmp_path), 1, js)
    template = train_state_from_numpy(np_tree(js))
    restored = tckpt.restore_checkpoint(path, template)
    want = named(train_state_from_numpy(np_tree(js)))
    got = named(restored)
    # the reference's file names are the port's leaf names
    files = {f[:-4] for f in os.listdir(path) if f.endswith(".npy")}
    assert files == set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k
    assert tckpt.checkpoint_step(path) == 1


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    js = _reference_state()
    ts = train_state_from_numpy(np_tree(js))
    path = tckpt.save_checkpoint(str(tmp_path), 1, ts)
    restored = jckpt.restore_checkpoint(path, jax.eval_shape(lambda: js))
    for (p, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(js)[0],
                              jax.tree_util.tree_flatten_with_path(
                                  restored)[0]):
        assert a.dtype == b.dtype, p
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert jckpt.checkpoint_step(path) == 1


# --------------------------------------------------------------------------
# the CLI and the example
# --------------------------------------------------------------------------

def _cli(ckpt_dir, steps=6, *extra):
    return train_cli.main([
        "--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
        "--steps", str(steps), "--batch", "2", "--seq", "16",
        "--ckpt-every", "3", "--log-every", "1", "--cycle-batches", "2",
        "--lr", "3e-3",
        "--ckpt-dir", str(ckpt_dir), *extra])


def test_cli_runs_and_resumes_bitwise(tmp_path, capsys, monkeypatch):
    """6 steps straight against a run of 6 whose step-6 checkpoint is
    removed, then a fresh ``main()`` that resumes from step 3.  Each step
    is saved once (the reference saves step 6 twice, in the loop and at
    the end)."""
    saves = []

    def counted(ckpt_dir, step, state, **kw):
        saves.append(step)
        return tckpt.save_checkpoint(ckpt_dir, step, state, **kw)

    monkeypatch.setattr(train_cli, "save_checkpoint", counted)
    straight = _cli(tmp_path / "a", 6, "--explain", "--plan-cache-dir",
                    str(tmp_path / "plans"))
    assert saves == [3, 6]
    out = capsys.readouterr().out
    assert "attn_flash" in out and "StagedPhysicalPlan" in out
    assert os.listdir(tmp_path / "plans")
    assert straight["start"] == 0 and len(straight["losses"]) == 6
    assert all(np.isfinite(straight["losses"]))
    assert straight["losses"][-1] < straight["losses"][0]
    _cli(tmp_path / "b", 6)
    shutil.rmtree(tmp_path / "b" / "step_0000000006")
    resumed = _cli(tmp_path / "b", 6)
    assert resumed["start"] == 3 and len(resumed["losses"]) == 3
    assert resumed["losses"] == straight["losses"][3:]
    assert resumed["final_loss"] == straight["final_loss"]


@pytest.mark.parametrize("arch", ["llava-next-34b", "seamless-m4t-medium"])
def test_cli_trains_the_frontend_families(arch, tmp_path):
    """The vlm and encdec families train, as the reference's CLI trains
    them: ``synth_batch`` makes their ``frontend_embeds``."""
    out = train_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                          "--steps", "2", "--batch", "2", "--seq", "16",
                          "--ckpt-dir", str(tmp_path)])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert tckpt.checkpoint_step(tckpt.latest_checkpoint(str(tmp_path))) == 2


def test_cli_refuses_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--arch", "qwen3-0.6b", "--smoke", "--steps", "1",
                        "--ckpt-dir", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_example_trains_on_the_cpu(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    out = train_lm.main(["--steps", "2", "--device", "cpu"])
    assert len(out["losses"]) == 2 and np.isfinite(out["final_loss"])
    assert os.listdir(tmp_path / "checkpoints" / "qwen3-0.6b-smoke")


# --------------------------------------------------------------------------
# planning at full width
# --------------------------------------------------------------------------

def test_full_width_qwen3_train_plan_matches_reference():
    jm, tm = jbuild(jconfig("qwen3-0.6b")), tbuild(tconfig("qwen3-0.6b"))
    jfn = jcompile(jm.build_plan(4, 2048, "train"), JCAT,
                   jir.SystemCatalog(hardware=jir.HardwareSpec(**REF_HW)),
                   engines=ENGINES, cache=False)
    tfn = tcompile(tm.build_plan(4, 2048, "train"), TCAT,
                   tir.SystemCatalog(hardware=tir.HardwareSpec(**REF_HW)),
                   engines=ENGINES, cache=False, device="cpu")
    assert tfn.plan_id == jfn.plan_id
    assert ("fused_attention", "attn_flash") in [
        (r["pattern"], r["chosen"]) for r in tfn.report]
    (scan,) = [n for n in tfn.concrete.topo() if n.impl == "scan_layers_xla"]
    inner = [n.impl for n in scan.subplan.topo()]
    assert inner.count("attn_flash_pallas") == 1 and "sdpa_xla" not in inner
    assert scan.attrs["n_layers"] == 28 and scan.attrs["remat"] == "full"
    assert "softmax_xent_xla" in tfn.chosen_impls()
