"""The port's vlm and encdec families against the reference, on the CPU.

llava-next-34b (``family="vlm"``: the dense stack behind a prefix of
``frontend_tokens`` precomputed embeddings, joined by ``concat_seq``) and
seamless-m4t-medium (``family="encdec"``: a non-causal encoder over
precomputed frames, ``enc_norm``, and a decoder whose blocks cross-attend
to the encoder's output through ``cross_attention_xla``) at their SMOKE
widths in float32, the reference's parameters from ``jax.random.key(1)``
carried across as numpy.  Checked:

  * configs field for field; ``layer_groups``; the parameter tree's keys,
    shapes and dtypes (``lnx``, ``xattn``, ``enc_norm``);
  * plan ids and chosen impls for ``prefill`` and ``train`` at SMOKE 2 x
    16 and full width 4 x 2048 / 4 x 1024, both engine sets, under the
    reference's catalog and the H100 catalog; ``prefill_kv``'s refusal;
  * the planned forward's logits under ``("xla",)`` and ``("xla",
    "pallas")`` (the reference's Pallas kernel in interpret mode, the
    port's flash on its plain version), on ``synth_batch``'s inputs; the
    decoder's broadcast ``memory`` through the traced (``analyze``) and
    faulted executors, every layer reached;
  * ``concat_seq`` and ``cross_attention_xla`` alone;
  * ``init_cache``'s leaves; ``decode_step`` over several steps from an
    empty cache (every cross term exactly 0, the encoder's leaves
    untouched) and ``decode_step_batched`` on random caches (a nonzero
    cross term); ``prefill(frontend_embeds=)``;
  * ``synth_batch`` bitwise; the streamed inference tree bitwise
    ``inference_params(init_params(gen))`` for every family;
  * the serving runtime's, ``serve_sequential``'s and the CLI's refusal
    beside the reference runtime's ``KeyError: 'frontend_embeds'``.

Tolerances: ``atol = rtol = 1e-4`` for model outputs (float32 matmuls and
softmaxes summed in another order over up to 4 layers), ``rtol=1e-5,
atol=1e-6`` for one attention, as ``tests/test_torch_dense_lm.py``.
"""
from dataclasses import asdict
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# two intra-op threads: the suite runs beside other test workers
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jconfig  # noqa: E402
from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.core import executor as jexec  # noqa: E402
from repro.core import ir as jir  # noqa: E402
from repro.core.executor import plan_and_compile as jcompile  # noqa: E402
from repro.core.plan_cache import PlanCache as JPlanCache  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import decode as jdec  # noqa: E402
from repro.models.lm import CATALOG as JCAT  # noqa: E402
from repro.models.lm import layer_groups as jgroups  # noqa: E402
from repro.serving import AsyncServingRuntime as JRuntime  # noqa: E402
from repro_torch.configs import get_config as tconfig  # noqa: E402
from repro_torch.configs import get_smoke_config as tsmoke  # noqa: E402
from repro_torch.core import executor as texec  # noqa: E402
from repro_torch.core import ir as tir  # noqa: E402
from repro_torch.core.executor import plan_and_compile as tcompile  # noqa
from repro_torch.core.faults import FaultInjector  # noqa: E402
from repro_torch.core.plan_cache import PlanCache  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.layers import attention as tattn  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402
from repro_torch.models import decode as tdec  # noqa: E402
from repro_torch.models.lm import CATALOG as TCAT  # noqa: E402
from repro_torch.models.lm import layer_groups as tgroups  # noqa: E402
from repro_torch.models.lm import params_from_numpy  # noqa: E402
from repro_torch.serving import (AsyncServingRuntime,  # noqa: E402
                                 ServeRequest, serve_sequential)

TOL = dict(atol=1e-4, rtol=1e-4)
VLM, ENCDEC = "llava-next-34b", "seamless-m4t-medium"
ARCHS = [VLM, ENCDEC]
ENGINES = [("xla",), ("xla", "pallas")]
ENGINE_IDS = ["xla", "xla+pallas"]
REF_HW = asdict(jir.HardwareSpec())          # the reference's catalog
H100_HW = asdict(tir.HardwareSpec())         # the port's default: H100 SXM
B, S = 2, 16
# the full-width shapes chip_smoke.py plans: llava 576 + 1,472 at 2048,
# seamless 1024 frames and 1024 tokens
FULL_SHAPE = {VLM: (4, 2048), ENCDEC: (4, 1024)}


def _models(arch):
    jm = jbuild(jsmoke(arch).replace(dtype="float32"))
    tm = tbuild(tsmoke(arch).replace(dtype="float32"))
    jparams, _ = jm.init_params(jax.random.key(1))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jm, tm, jparams, tparams


_MODELS = {}


def models(arch):
    """(reference model, port model, reference params, port params), made
    once a module."""
    if arch not in _MODELS:
        _MODELS[arch] = _models(arch)
    return _MODELS[arch]


_JSTEPS = {}
_JDECODE = jdec.decode_step       # unpatched, for the jitted step


def jstep(jm):
    """The reference's ``decode_step`` under ``jax.jit``, once a model."""
    if id(jm) not in _JSTEPS:
        _JSTEPS[id(jm)] = (jm, jax.jit(
            lambda p, c, t, i: _JDECODE(jm, p, c, t, i)))
    return _JSTEPS[id(jm)][1]


def _impls(fn):
    """Impl names in topo order, each scan subplan's after its node."""
    out = []
    for n in fn.concrete.topo():
        out.append(n.impl)
        if n.subplan is not None:
            out.extend(m.impl for m in n.subplan.topo())
    return out


def _compile_pair(jm, tm, b, s, mode, engines, hw):
    jfn = jcompile(jm.build_plan(b, s, mode), JCAT,
                   jir.SystemCatalog(hardware=jir.HardwareSpec(**hw)),
                   engines=engines, cache=False)
    tfn = tcompile(tm.build_plan(b, s, mode), TCAT,
                   tir.SystemCatalog(hardware=tir.HardwareSpec(**hw)),
                   engines=engines, cache=False, device="cpu")
    return jfn, tfn


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def _data_config(cfg, pipe, seq=S, dtype="float32", seed=0):
    return pipe.DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=B,
                           seed=seed, frontend_tokens=cfg.frontend_tokens,
                           d_model=cfg.d_model,
                           encdec=cfg.family == "encdec", dtype=dtype)


def _inputs(cfg):
    """The planned forward's inputs from ``synth_batch`` (labels dropped),
    as the reference's arrays and the port's tensors."""
    batch = tpipe.synth_batch(_data_config(cfg, tpipe), step=0)
    batch.pop("labels")
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _assert_caches(jc, tc, tol=TOL):
    assert tc.keys() == jc.keys()
    for g in jc:
        assert tc[g].keys() == jc[g].keys(), g
        for key in jc[g]:
            assert tuple(tc[g][key].shape) == jc[g][key].shape, (g, key)
            np.testing.assert_allclose(_np(tc[g][key]), _np(jc[g][key]),
                                       err_msg=f"{g}/{key}", **tol)


def _tree_items(tree, prefix=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _tree_items(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


# --------------------------------------------------------------------------
# configs, groups, parameters and plans
# --------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_reference(arch, which):
    get_j, get_t = (jconfig, tconfig) if which == "full" else \
        (jsmoke, tsmoke)
    assert asdict(get_t(arch)) == asdict(get_j(arch))


@pytest.mark.parametrize("which", ["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_layer_groups_equal_reference(arch, which):
    cfg_j, cfg_t = ((jconfig(arch), tconfig(arch)) if which == "full"
                    else (jsmoke(arch), tsmoke(arch)))
    got = [(g.name, g.count, [(b.kind, b.window, b.causal, b.cross)
                              for b in g.blocks]) for g in tgroups(cfg_t)]
    want = [(g.name, g.count, [(b.kind, b.window, b.causal, b.cross)
                               for b in g.blocks]) for g in jgroups(cfg_j)]
    assert got == want
    if arch == ENCDEC:
        assert [g.name for g in tgroups(cfg_t)] == ["enc_0", "dec_0"]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_equals_reference(arch):
    """The port's ``init_params`` tree has the reference's keys, shapes
    and dtypes (the cross block's ``lnx`` / ``xattn``, ``enc_norm``), and
    ``params_from_numpy`` carries the reference's values across."""
    jm, tm, jparams, tparams = models(arch)
    own = tm.init_params(torch.Generator().manual_seed(0))
    want = {k: v for k, v in _tree_items(jparams)}
    for tree in (own, tparams):
        got = dict(_tree_items(tree))
        assert got.keys() == want.keys()
        for k, v in got.items():
            assert tuple(v.shape) == want[k].shape, k
            assert str(v.dtype).split(".")[1] == str(want[k].dtype), k
    for k, v in _tree_items(tparams):
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]))
    if arch == ENCDEC:
        assert {"b0_lnx", "b0_xattn"} <= own["dec_0"].keys()
        assert "b0_xattn" not in own["enc_0"]
        assert own["enc_norm"]["scale"].shape == (tm.cfg.d_model,)


@pytest.mark.parametrize("hw", [REF_HW, H100_HW], ids=["ref_hw", "h100"])
@pytest.mark.parametrize("engines", ENGINES, ids=ENGINE_IDS)
@pytest.mark.parametrize("mode", ["prefill", "train"])
@pytest.mark.parametrize("arch,which", [(a, w) for a in ARCHS
                                        for w in ("smoke", "full")])
def test_plan_id_and_impls_equal_reference(arch, which, mode, engines, hw):
    """Plan ids and impls equal the reference's; the kernel slot puts
    flash on every self-attention node (llava's one, seamless's encoder
    non-causal and decoder causal) and the decoder's cross-attention
    stays ``cross_attention_xla``; llava's prefix is one ``concat_seq``.
    ``train`` is planned only (its loss is the training slice's)."""
    if which == "smoke":
        jm, tm, (b, s) = jbuild(jsmoke(arch)), tbuild(tsmoke(arch)), (B, S)
    else:
        jm, tm = jbuild(jconfig(arch)), tbuild(tconfig(arch))
        b, s = FULL_SHAPE[arch]
    jfn, tfn = _compile_pair(jm, tm, b, s, mode, engines, hw)
    assert tfn.plan_id == jfn.plan_id
    impls = _impls(tfn)
    assert impls == _impls(jfn)
    attn = [i for i in impls if i.startswith(("sdpa", "attn_flash"))]
    assert len(attn) == sum(len(g.blocks) for g in tm.groups)
    if "pallas" in engines:
        assert set(attn) == {"attn_flash_pallas"}
    assert impls.count("concat_seq") == (arch == VLM)
    assert impls.count("cross_attention_xla") == (arch == ENCDEC)
    if arch == ENCDEC:
        causal = [m.attrs.get("causal", True) for n in tfn.concrete.topo()
                  if n.subplan is not None for m in n.subplan.topo()
                  if m.impl in attn]
        assert causal == [False, True]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_kv_refused_as_reference(arch):
    jm, tm = jbuild(jsmoke(arch)), tbuild(tsmoke(arch))
    assert not tm.supports_prefill_kv()
    with pytest.raises(ValueError, match="prefill_kv plans need") as je:
        jm.build_plan(B, S, "prefill_kv")
    with pytest.raises(ValueError, match="prefill_kv plans need") as te:
        tm.build_plan(B, S, "prefill_kv")
    assert str(te.value) == str(je.value)


# --------------------------------------------------------------------------
# the planned forward
# --------------------------------------------------------------------------

@pytest.mark.parametrize("engines", ENGINES, ids=ENGINE_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_forward_matches_reference(arch, engines):
    jm, tm, jparams, tparams = models(arch)
    jin, tin = _inputs(tm.cfg)
    if arch == VLM:
        assert tin["frontend_embeds"].shape == (B, 8, tm.cfg.d_model)
        assert tin["tokens"].shape == (B, S - 8)
    else:
        assert tin["frontend_embeds"].shape == (B, S, tm.cfg.d_model)
    jfn, tfn = _compile_pair(jm, tm, B, S, "prefill", engines, REF_HW)
    want, got = jfn(jparams, jin), tfn(tparams, tin)
    assert tuple(got.shape) == want.shape == (B, S, tm.cfg.padded_vocab)
    assert torch.isfinite(got[..., :tm.cfg.vocab]).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("run", ["analyze", "faulted"])
def test_encdec_memory_reaches_every_layer_traced_and_faulted(run):
    """The decoder scan's broadcast ``memory`` under the traced
    (``analyze``) and the faulted executor: outputs bitwise the fast
    path's, and each layer's cross-attention node ran (one span, one
    fault-site check a layer); a persistent fault at that node raises."""
    _, tm, _, tparams = models(ENCDEC)
    _, tin = _inputs(tm.cfg)
    tfn = tcompile(tm.build_plan(B, S, "prefill"), TCAT, tir.SystemCatalog(),
                   engines=("xla", "pallas"), cache=False, device="cpu")
    want = tfn(tparams, tin)
    layers = tm.cfg.dec_layers
    if run == "analyze":
        got = tfn.analyze(tparams, tin)
        spans = [s for s in tfn.last_run_trace.op_spans()
                 if s.attrs.get("impl") == "cross_attention_xla"]
        assert len(spans) == layers
    else:
        tfn.faults = FaultInjector(seed=0, rate=0.0)
        got = tfn(tparams, tin)
        sites = {site: n for site, n in tfn.faults._occurrence.items()
                 if site[2] == "cross_attention_xla"}
        assert list(sites.values()) == [layers]
        tfn.faults = FaultInjector(always_fail=("cross_attention_xla",))
        with pytest.raises(Exception, match="cross_attention_xla"):
            tfn(tparams, tin)
    assert torch.equal(got, want)


def test_concat_seq_matches_reference(rng):
    """``a`` cast to ``b``'s dtype, then joined: a bf16 prefix before
    float32 text, and a float32 prefix before bf16 text."""
    node = SimpleNamespace(attrs={"axis": 1})
    a = rng.randn(2, 3, 8).astype(np.float32)
    b = rng.randn(2, 5, 8).astype(np.float32)
    for da, db in (("bfloat16", "float32"), ("float32", "bfloat16")):
        want = jexec._i_concat_seq(None, [jnp.asarray(a).astype(da),
                                          jnp.asarray(b).astype(db)], node)
        got = texec._i_concat_seq(None, [
            torch.from_numpy(a).to(getattr(torch, da)),
            torch.from_numpy(b).to(getattr(torch, db))], node)
        assert str(got.dtype).split(".")[1] == str(want.dtype) == db
        assert tuple(got.shape) == want.shape == (2, 8, 8)
        np.testing.assert_array_equal(_np(got), _np(want))


def test_cross_attention_xla_matches_reference(rng):
    """q from x, K/V from memory of another length, no RoPE, non-causal,
    GQA 2."""
    h, k, d, e = 4, 2, 16, 64
    node = SimpleNamespace(attrs={"heads": h, "kv_heads": k, "head_dim": d})
    p = {"wq": rng.randn(e, h * d), "wk": rng.randn(e, k * d),
         "wv": rng.randn(e, k * d), "wo": rng.randn(h * d, e)}
    p = {n: (w / np.sqrt(w.shape[0])).astype(np.float32)
         for n, w in p.items()}
    x = rng.randn(2, 7, e).astype(np.float32)
    mem = rng.randn(2, 11, e).astype(np.float32)
    jctx = SimpleNamespace(params_for=lambda n: {
        q: jnp.asarray(w) for q, w in p.items()})
    tctx = SimpleNamespace(params_for=lambda n: {
        q: torch.from_numpy(w) for q, w in p.items()})
    want = jexec._i_xattn(jctx, [jnp.asarray(x), jnp.asarray(mem)], node)
    got = texec._i_xattn(tctx, [torch.from_numpy(x), torch.from_numpy(mem)],
                         node)
    assert tuple(got.shape) == want.shape == (2, 7, e)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("opts", [{}, {"kv_repeat_to": 8}],
                         ids=["full", "repeat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_equals_reference(arch, opts):
    jm, tm, _, _ = models(arch)
    jc = jdec.init_cache(jm, 2, 12, **opts)
    tc = tdec.init_cache(tm, 2, 12, device="cpu", **opts)
    assert tc.keys() == jc.keys()
    for g in jc:
        assert tc[g].keys() == jc[g].keys(), g
        for key in jc[g]:
            assert tuple(tc[g][key].shape) == jc[g][key].shape, (g, key)
            assert str(tc[g][key].dtype).split(".")[1] == \
                str(jc[g][key].dtype), (g, key)
            assert not tc[g][key].any()
    if arch == ENCDEC:
        assert set(tc["dec_0"]) == {"b0_k", "b0_v", "b0_xk", "b0_xv"}
        assert set(tc["enc_0"]) == {"b0_k", "b0_v"}


def _cross_outputs(monkeypatch):
    """Record every decode attention whose cache holds only zeros under
    an all-valid mask: the encdec decoder's cross term."""
    seen = []
    real = tattn.decode_attend_gqa

    def spy(q, cache_k, cache_v, valid, **kw):
        out = real(q, cache_k, cache_v, valid, **kw)
        if bool(valid.all()) and not cache_k.any() and not cache_v.any():
            seen.append(out.clone())
        return out
    monkeypatch.setattr(tattn, "decode_attend_gqa", spy)
    return seen


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch, rng, monkeypatch):
    """Six steps from an empty cache (max_seq 12, so no self-attention
    mask is all-valid): logits every step and the final caches.  encdec:
    every cross term is exactly 0 (one a decoder layer a step), the cross
    leaves stay 0 and the encoder's K/V are never written."""
    jm, tm, jparams, tparams = models(arch)
    b, max_seq, steps = 2, 12, 6
    jc = jdec.init_cache(jm, b, max_seq)
    tc = tdec.init_cache(tm, b, max_seq, device="cpu")
    seen = _cross_outputs(monkeypatch)
    for t in range(steps):
        toks = rng.randint(0, jm.cfg.vocab, (b, 1)).astype(np.int32)
        jl, jc = jstep(jm)(jparams, jc, jnp.asarray(toks), jnp.int32(t))
        tl, tc = tdec.decode_step(tm, tparams, tc, torch.from_numpy(toks), t)
        assert tuple(tl.shape) == (b, 1, tm.cfg.padded_vocab)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_caches(jc, tc)
    if arch == ENCDEC:
        assert len(seen) == tm.cfg.dec_layers * steps
        assert all(not o.any() for o in seen)
        for g, keys in (("dec_0", ("b0_xk", "b0_xv")),
                        ("enc_0", ("b0_k", "b0_v"))):
            assert not any(tc[g][k].any() for k in keys)
        assert tc["dec_0"]["b0_k"].any()
    else:
        assert not seen


def _random_cache_pair(jm, b, max_seq, rng):
    """Equal random caches on both sides (numpy-made), cross leaves too."""
    jc = jdec.init_cache(jm, b, max_seq)
    np_c = {g: {k: rng.randn(*leaf.shape).astype(np.float32)
                for k, leaf in gc.items()} for g, gc in jc.items()}
    jc = {g: {k: jnp.asarray(v) for k, v in gc.items()}
          for g, gc in np_c.items()}
    tc = {g: {k: torch.from_numpy(v.copy()) for k, v in gc.items()}
          for g, gc in np_c.items()}
    return jc, tc, np_c


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_batched_matches_reference(arch, rng):
    """Slots at different positions over random caches (a nonzero cross
    term): logits and every cache leaf; the cross leaves and the encoder's
    K/V come back unchanged."""
    jm, tm, jparams, tparams = models(arch)
    b, max_seq = 3, 24
    jc, tc, np_c = _random_cache_pair(jm, b, max_seq, rng)
    idx = np.array([0, 9, 23], np.int32)
    toks = rng.randint(0, jm.cfg.vocab, (b, 1)).astype(np.int32)
    jl, jc = jdec.decode_step_batched(jm, jparams, jc, jnp.asarray(toks),
                                      jnp.asarray(idx))
    tl, tc = tdec.decode_step_batched(tm, tparams, tc,
                                      torch.from_numpy(toks),
                                      torch.from_numpy(idx))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_caches(jc, tc)
    if arch == ENCDEC:
        for g, keys in (("dec_0", ("b0_xk", "b0_xv")),
                        ("enc_0", ("b0_k", "b0_v"))):
            for k in keys:
                np.testing.assert_array_equal(tc[g][k].numpy(), np_c[g][k])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch, rng, monkeypatch):
    """``prefill(frontend_embeds=)`` accepts the embeddings and ignores
    them, as the reference's (its decode step under ``jax.jit``, patched
    in: the same function, compiled once)."""
    jm, tm, jparams, tparams = models(arch)
    step = jstep(jm)
    monkeypatch.setattr(jdec, "decode_step",
                        lambda model, p, c, t, i, *, ring_local=False:
                        step(p, c, t, i))
    jin, tin = _inputs(tm.cfg)
    toks = rng.randint(0, jm.cfg.vocab, (B, 10)).astype(np.int32)
    jl, jc = jdec.prefill(jm, jparams, jnp.asarray(toks), 16,
                          frontend_embeds=jin["frontend_embeds"])
    tl, tc = tdec.prefill(tm, tparams, torch.from_numpy(toks), 16,
                          frontend_embeds=tin["frontend_embeds"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_caches(jc, tc)
    bare, _ = tdec.prefill(tm, tparams, torch.from_numpy(toks), 16)
    assert torch.equal(bare, tl)


# --------------------------------------------------------------------------
# the data pipeline and the streamed inference tree
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS + ["qwen3-0.6b"])
def test_synth_batch_bitwise_reference(arch, dtype):
    """The same arrays for the same (seed, step); a bfloat16 array comes
    as float32 holding the reference's bfloat16 values, whose cast to a
    torch bfloat16 tensor is exact."""
    cfg = tsmoke(arch)
    for seed, step in ((0, 0), (3, 7)):
        want = jpipe.synth_batch(_data_config(cfg, jpipe, 24, dtype, seed),
                                 step)
        got = tpipe.synth_batch(_data_config(cfg, tpipe, 24, dtype, seed),
                                step)
        assert got.keys() == want.keys()
        assert ("frontend_embeds" in got) == (cfg.frontend != "none")
        for k, w in want.items():
            w = np.asarray(w)
            if w.dtype.name == "bfloat16":
                w32 = w.astype(np.float32)
                assert got[k].dtype == np.float32
                np.testing.assert_array_equal(got[k].view(np.uint32),
                                              w32.view(np.uint32))
                t = torch.from_numpy(got[k]).to(torch.bfloat16)
                np.testing.assert_array_equal(t.float().numpy(), w32)
            else:
                assert got[k].dtype == w.dtype, k
                np.testing.assert_array_equal(got[k], w)


def test_prefetch_pipeline_yields_synth_batches():
    cfg = _data_config(tsmoke(VLM), tpipe)
    pipe = tpipe.PrefetchPipeline(cfg, start_step=3)
    try:
        for step in (3, 4, 5):
            got_step, batch = next(pipe)
            assert got_step == step
            want = tpipe.synth_batch(cfg, step)
            for k in want:
                np.testing.assert_array_equal(batch[k], want[k])
    finally:
        pipe.close()
    assert not pipe._thread.is_alive()


@pytest.mark.parametrize("arch", ARCHS + ["qwen3-0.6b", "rwkv6-3b",
                                          "zamba2-7b", "dbrx-132b"])
def test_streamed_inference_tree_bitwise(arch):
    """``init_inference_params(gen)`` is bitwise ``inference_params(
    init_params(gen))`` from the same seed: every leaf, dtype and key."""
    tm = tbuild(tsmoke(arch))
    want = tm.inference_params(tm.init_params(
        torch.Generator().manual_seed(5)))
    got = tm.init_inference_params(torch.Generator().manual_seed(5))
    want_items, got_items = dict(_tree_items(want)), dict(_tree_items(got))
    assert got_items.keys() == want_items.keys()
    cast = 0
    for k, v in got_items.items():
        assert v.dtype == want_items[k].dtype, k
        assert torch.equal(v, want_items[k]), k
        cast += v.dtype == torch.bfloat16
    assert cast > 0


# --------------------------------------------------------------------------
# serving refuses both families
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_runtime_refuses_as_reference_fails(arch, monkeypatch):
    """The port's runtime, ``serve_sequential`` and CLI refuse a model
    whose forward needs ``frontend_embeds`` when they are built; the
    reference's runtime is built and fails at its first prefill with
    ``KeyError: 'frontend_embeds'``."""
    jm, tm, jparams, tparams = models(arch)
    jrt = JRuntime(jm, jparams, max_batch=2, max_seq=32,
                   plan_cache=JPlanCache())
    with pytest.raises(KeyError, match="frontend_embeds"):
        jrt.warmup([8])
    with pytest.raises(ValueError, match="'frontend_embeds'"):
        AsyncServingRuntime(tm, tparams, max_batch=2, max_seq=32,
                            plan_cache=PlanCache(), device="cpu")
    req = ServeRequest(0, (1, 2, 3), 2)
    with pytest.raises(ValueError, match="'frontend_embeds'"):
        serve_sequential(tm, tparams, [req], max_seq=32,
                         plan_cache=PlanCache(), device="cpu")
    made = []
    monkeypatch.setattr(tm.__class__, "init_params",
                        lambda self, gen: made.append(gen))
    with pytest.raises(ValueError, match="'frontend_embeds'"):
        serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu"])
    assert not made                  # refused before any parameter is made
