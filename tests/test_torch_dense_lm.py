"""The port's other dense configs against the reference, on the CPU.

deepseek-7b (MHA), stablelm-12b (GQA 4, head_dim 160 at full width) and
gemma3-27b (5:1 local:global sliding-window attention, GELU,
``embed_scale``, tied embeddings) at their SMOKE widths in float32, the
reference's parameters from ``jax.random.key(1)`` carried across as
numpy.  Checked:

  * ``get_config`` / ``get_smoke_config`` resolve the three, field for
    field the reference's;
  * plan ids and chosen impls for ``prefill`` / ``prefill_kv`` at 1 x 16
    and 1 x 64 (SMOKE) and 1 x 2048 (full width; gemma3 also 1 x 4096),
    both engine sets, under the reference's catalog; gemma3 under the H100
    catalog, where ``("xla",)`` picks ``sdpa_banded_xla`` at 1 x 4096 and
    at SMOKE 4 x 128, and the latter runs;
  * the ``prefill_kv`` forward's logits and K/V, the banded plan included;
  * ``decode_step`` / ``decode_step_batched``; the ring-buffer, int8 and
    replicated-KV caches (layouts, 40 decode steps at gemma3 SMOKE's
    window 16, so the ring wraps; the batched step on random caches),
    ``prefill(ring_local=)``, ``seed_cache_from_prefill``'s refusals; the
    port's ring decode against its own full-cache windowed decode;
  * ``sdpa_banded`` and ``quantize_kv`` op by op;
  * the runtime serving gemma3 SMOKE, token for token ``serve_sequential``
    and the reference runtime; the serving CLI for the three.

Tolerances: ``atol = rtol = 1e-4`` for model outputs (float32 matmuls and
softmaxes summed in another order over up to 6 layers); ``sdpa_banded``
``rtol=1e-5, atol=1e-6`` (one float32 attention); ``quantize_kv``'s scales
bitwise and its int8 values equal (at most one off where x / scale lies
within float rounding of a half-integer: counted, 0 on these inputs).
"""
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
from repro.core.plan_cache import PlanCache as JPlanCache  # noqa: E402
from repro.layers import attention as jattn  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import decode as jdec  # noqa: E402
from repro.models.lm import CATALOG as JCAT  # noqa: E402
from repro.serving import AsyncServingRuntime as JRuntime  # noqa: E402
from repro.serving import ServeRequest as JRequest  # noqa: E402
from repro_torch.configs import get_config as tconfig  # noqa: E402
from repro_torch.configs import get_smoke_config as tsmoke  # noqa: E402
from repro_torch.core import ir as tir  # noqa: E402
from repro_torch.core.executor import plan_and_compile as tcompile  # noqa
from repro_torch.core.plan_cache import PlanCache  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.layers import attention as tattn  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402
from repro_torch.models import decode as tdec  # noqa: E402
from repro_torch.models.lm import CATALOG as TCAT  # noqa: E402
from repro_torch.models.lm import params_from_numpy  # noqa: E402
from repro_torch.serving import (AsyncServingRuntime,  # noqa: E402
                                 ServeRequest, serve_sequential)
from repro_torch.serving import runtime as truntime  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["deepseek-7b", "stablelm-12b", "gemma3-27b"]
GEMMA = "gemma3-27b"
ENGINES = [("xla",), ("xla", "pallas")]
ENGINE_IDS = ["xla", "xla+pallas"]
REF_HW = asdict(jir.HardwareSpec())          # the reference's catalog
H100_HW = asdict(tir.HardwareSpec())         # the port's default: H100 SXM
# the cache variants of init_cache (gemma3 SMOKE: 2 KV heads -> 4)
CACHE_OPTS = {"ring": dict(ring_local=True), "int8": dict(quantize_kv=True),
              "repeat": dict(kv_repeat_to=4),
              "ring+int8+repeat": dict(ring_local=True, quantize_kv=True,
                                       kv_repeat_to=4)}


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


def jstep(jm, ring=False):
    """The reference's ``decode_step`` under ``jax.jit`` (one compile per
    model and ring flag), with its signature."""
    key = (id(jm), ring)
    if key not in _JSTEPS:
        step = jax.jit(lambda p, c, t, i: _JDECODE(
            jm, p, c, t, i, ring_local=ring))
        _JSTEPS[key] = (jm, step)
    return _JSTEPS[key][1]


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


def _assert_caches(jc, tc, tol=TOL):
    assert tc.keys() == jc.keys()
    for g in jc:
        assert tc[g].keys() == jc[g].keys(), g
        for key in jc[g]:
            got, want = tc[g][key], jc[g][key]
            assert tuple(got.shape) == want.shape, (g, key)
            if got.dtype == torch.int8:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                              err_msg=f"{g}/{key}")
            else:
                np.testing.assert_allclose(_np(got), _np(want),
                                           err_msg=f"{g}/{key}", **tol)


# --------------------------------------------------------------------------
# configs and plans
# --------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_reference(arch, which):
    get_j, get_t = (jconfig, tconfig) if which == "full" else \
        (jsmoke, tsmoke)
    assert asdict(get_t(arch)) == asdict(get_j(arch))


@pytest.mark.parametrize("engines", ENGINES, ids=ENGINE_IDS)
@pytest.mark.parametrize("mode", ["prefill", "prefill_kv"])
@pytest.mark.parametrize("arch,cfg,bucket", [
    (arch, cfg, bucket) for arch in ARCHS
    for cfg, bucket in (("smoke", 16), ("smoke", 64), ("full", 2048))]
    + [(GEMMA, "full", 4096)])
def test_plan_id_and_impls_equal_reference(arch, cfg, bucket, mode,
                                           engines):
    if cfg == "smoke":
        jm, tm = jbuild(jsmoke(arch)), tbuild(tsmoke(arch))
    else:
        jm, tm = jbuild(jconfig(arch)), tbuild(tconfig(arch))
    jfn, tfn = _compile_pair(jm, tm, 1, bucket, mode, engines, REF_HW)
    assert tfn.plan_id == jfn.plan_id
    assert _impls(tfn) == _impls(jfn)
    n_attn = sum(len(g.blocks) for g in tm.groups)
    got = [i for i in _impls(tfn) if i.startswith(("sdpa", "attn_flash"))]
    assert len(got) == n_attn
    if "pallas" in engines:
        assert set(got) == {"attn_flash_pallas"}


@pytest.mark.parametrize("engines", ENGINES, ids=ENGINE_IDS)
@pytest.mark.parametrize("cfg,batch,bucket", [("full", 1, 4096),
                                              ("smoke", 4, 128)])
def test_gemma3_banded_plan_under_the_h100_catalog(cfg, batch, bucket,
                                                   engines):
    """Under the H100 catalog ``("xla",)`` bands every windowed layer at
    full width from 1 x 4096 and at SMOKE 4 x 128; the kernel slot takes
    flash on every layer.  Plan ids equal the reference's."""
    get_j, get_t = (jconfig, tconfig) if cfg == "full" else (jsmoke, tsmoke)
    jm, tm = jbuild(get_j(GEMMA)), tbuild(get_t(GEMMA))
    jfn, tfn = _compile_pair(jm, tm, batch, bucket, "prefill_kv", engines,
                             H100_HW)
    assert tfn.plan_id == jfn.plan_id
    assert _impls(tfn) == _impls(jfn)
    windowed = [blk.window > 0 for g in tm.groups for blk in g.blocks]
    got = [i for i in _impls(tfn) if i.startswith(("sdpa", "attn_flash"))]
    if "pallas" in engines:
        assert got == ["attn_flash_pallas"] * len(windowed)
    else:
        assert got == ["sdpa_banded_xla" if w else "sdpa_xla"
                       for w in windowed]


# --------------------------------------------------------------------------
# the planned prefill_kv forward
# --------------------------------------------------------------------------

def _check_prefill_kv(arch, b, s, engines, hw, rng):
    jm, tm, jparams, tparams = models(arch)
    toks = rng.randint(0, jm.cfg.vocab, (b, s)).astype(np.int32)
    jfn, tfn = _compile_pair(jm, tm, b, s, "prefill_kv", engines, hw)
    assert tfn.plan_id == jfn.plan_id
    jouts = jfn(jparams, {"tokens": jnp.asarray(toks)})
    touts = tfn(tparams, {"tokens": torch.from_numpy(toks)})
    assert len(touts) == len(jouts) == 1 + len(tm.groups)
    np.testing.assert_allclose(touts[0].numpy(), np.asarray(jouts[0]), **TOL)
    cfg = tm.cfg
    for g, jg, tg in zip(tm.groups, jouts[1:], touts[1:]):
        assert len(tg) == len(jg) == len(g.blocks)
        for jkv, tkv in zip(jg, tg):
            for j, t in zip(jkv, tkv):
                assert tuple(t.shape) == j.shape == (
                    g.count, b, s, cfg.kv_heads, cfg.resolved_head_dim)
                np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    return tfn


@pytest.mark.parametrize("engines", ENGINES, ids=ENGINE_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_kv_forward_matches_reference(arch, engines, rng):
    _check_prefill_kv(arch, 2, 16, engines, REF_HW, rng)


def test_gemma3_banded_prefill_kv_matches_reference(rng):
    """gemma3 SMOKE at 4 x 128 under the H100 catalog with ``("xla",)``:
    the five local layers run ``sdpa_banded_xla`` (W = 16, 8 chunks)."""
    tfn = _check_prefill_kv(GEMMA, 4, 128, ("xla",), H100_HW, rng)
    assert _impls(tfn).count("sdpa_banded_xla") == 5


# --------------------------------------------------------------------------
# sdpa_banded and quantize_kv op by op
# --------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,h,kv,w", [
    (2, 64, 4, 2, 16),      # S a multiple of W, GQA 2
    (2, 70, 4, 2, 16),      # S not a multiple of W
    (1, 45, 4, 4, 8),       # GQA 1
    (1, 12, 4, 2, 16),      # W >= S: the full fallback
    (1, 30, 4, 2, 0),       # no window: the full fallback
], ids=["multiple", "ragged", "gqa1", "w_ge_s", "w0"])
def test_sdpa_banded_matches_reference(b, s, h, kv, w, rng):
    q = rng.randn(b, s, h, 16).astype(np.float32)
    k = rng.randn(b, s, kv, 16).astype(np.float32)
    v = rng.randn(b, s, kv, 16).astype(np.float32)
    want = jax.jit(jattn.sdpa_banded, static_argnames=("window",))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=w)
    got = tattn.sdpa_banded(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), window=w)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    # the banding computes exactly the sliding-window attention
    full = tattn.sdpa_full(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), window=w)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_matches_reference(dtype, rng):
    x = (rng.randn(3, 7, 4, 16) * rng.uniform(0.01, 10, (3, 7, 4, 1))) \
        .astype(np.float32)
    x[0, 0, 0] = 0.0                        # an all-zero head: scale 1e-6/127
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = jattn.quantize_kv(jx)
    tq, ts = tattn.quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    assert tuple(tq.shape) == jq.shape and tuple(ts.shape) == js.shape
    np.testing.assert_array_equal(ts.float().numpy(),
                                  np.asarray(js.astype(jnp.float32)))
    diff = np.abs(tq.numpy().astype(np.int32) - np.asarray(jq, np.int32))
    assert diff.max() <= 1
    assert int((diff > 0).sum()) == 0       # no tie lands apart on these


def test_decode_attend_matches_reference(rng):
    q = rng.randn(2, 1, 4, 16).astype(np.float32)
    ck = rng.randn(2, 20, 2, 16).astype(np.float32)
    cv = rng.randn(2, 20, 2, 16).astype(np.float32)
    for index, window in ((13, 0), (13, 5), (20, 8)):
        want = jattn.decode_attend(jnp.asarray(q), jnp.asarray(ck),
                                   jnp.asarray(cv), index, window=window)
        got = tattn.decode_attend(torch.from_numpy(q), torch.from_numpy(ck),
                                  torch.from_numpy(cv), index, window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


def test_decode_attend_gqa_scales_match_reference(rng):
    """int8 K/V with bfloat16 scales: the k-scale on the logits, the
    v-scale on the softmax weights."""
    q = rng.randn(2, 1, 4, 16).astype(np.float32)
    ck = rng.randint(-127, 128, (2, 20, 2, 16)).astype(np.int8)
    cv = rng.randint(-127, 128, (2, 20, 2, 16)).astype(np.int8)
    ks, vs = (rng.uniform(1e-3, 3e-2, (2, 20, 2, 1)).astype(np.float32)
              for _ in range(2))
    valid = np.arange(20)[None, :] < np.array([[9], [20]])
    want = jattn.decode_attend_gqa(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(valid),
        k_scale=jnp.asarray(ks).astype(jnp.bfloat16),
        v_scale=jnp.asarray(vs).astype(jnp.bfloat16))
    got = tattn.decode_attend_gqa(
        torch.from_numpy(q), torch.from_numpy(ck), torch.from_numpy(cv),
        torch.from_numpy(valid),
        k_scale=torch.from_numpy(ks).to(torch.bfloat16),
        v_scale=torch.from_numpy(vs).to(torch.bfloat16))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# --------------------------------------------------------------------------
# decode: full caches (the three configs), then gemma3's cache variants
# --------------------------------------------------------------------------

def _random_cache_pair(jm, b, max_seq, rng, **opts):
    """Equal random caches on both sides (numpy-made), in the layout
    ``init_cache(**opts)`` gives: int8 leaves in [-127, 127], scales
    positive."""
    jc = jdec.init_cache(jm, b, max_seq, **opts)
    np_c = {}
    for g, gc in jc.items():
        np_c[g] = {}
        for key, leaf in gc.items():
            if leaf.dtype == jnp.int8:
                val = rng.randint(-127, 128, leaf.shape).astype(np.int8)
            elif key.endswith("sc"):
                val = rng.uniform(1e-3, 3e-2, leaf.shape).astype(np.float32)
            else:
                val = rng.randn(*leaf.shape).astype(np.float32)
            np_c[g][key] = val
    jc = {g: {k: jnp.asarray(v).astype(jc[g][k].dtype)
              for k, v in gc.items()} for g, gc in np_c.items()}
    tc = {g: {k: (torch.from_numpy(v).to(torch.bfloat16) if k.endswith("sc")
                  else torch.from_numpy(v.copy()))
              for k, v in gc.items()} for g, gc in np_c.items()}
    return jc, tc


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch, rng):
    jm, tm, jparams, tparams = models(arch)
    b, max_seq = 2, 12
    jc = jdec.init_cache(jm, b, max_seq)
    tc = tdec.init_cache(tm, b, max_seq, device="cpu")
    for t in range(5):
        toks = rng.randint(0, jm.cfg.vocab, (b, 1)).astype(np.int32)
        jl, jc = jstep(jm)(jparams, jc, jnp.asarray(toks), jnp.int32(t))
        tl, tc = tdec.decode_step(tm, tparams, tc, torch.from_numpy(toks), t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_caches(jc, tc)


@pytest.mark.parametrize("arch,opts", [(arch, "full") for arch in ARCHS]
                         + [(GEMMA, opts) for opts in CACHE_OPTS])
def test_decode_step_batched_matches_reference(arch, opts, rng):
    """Slots at different positions (the continuous batch) over random
    caches: logits and every cache leaf; gemma3 also over each cache
    variant (a ring slot past the window: 37 % 16)."""
    jm, tm, jparams, tparams = models(arch)
    kw = CACHE_OPTS.get(opts, {})
    ring = kw.get("ring_local", False)
    b, max_seq = 3, 40
    jc, tc = _random_cache_pair(jm, b, max_seq, rng, **kw)
    idx = np.array([0, 11, 37], np.int32)
    toks = rng.randint(0, jm.cfg.vocab, (b, 1)).astype(np.int32)
    jl, jc = jdec.decode_step_batched(jm, jparams, jc, jnp.asarray(toks),
                                      jnp.asarray(idx), ring_local=ring)
    tl, tc = tdec.decode_step_batched(tm, tparams, tc,
                                      torch.from_numpy(toks),
                                      torch.from_numpy(idx), ring_local=ring)
    assert tuple(tl.shape) == (b, 1, tm.cfg.padded_vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_caches(jc, tc)


@pytest.mark.parametrize("opts", list(CACHE_OPTS))
def test_init_cache_variants_equal_reference(opts):
    jm, tm, _, _ = models(GEMMA)
    kw = CACHE_OPTS[opts]
    jc = jdec.init_cache(jm, 2, 40, **kw)
    tc = tdec.init_cache(tm, 2, 40, device="cpu", **kw)
    assert tc.keys() == jc.keys()
    for g in jc:
        assert tc[g].keys() == jc[g].keys()
        for key in jc[g]:
            assert tuple(tc[g][key].shape) == jc[g][key].shape, (g, key)
            assert str(tc[g][key].dtype).split(".")[1] == \
                str(jc[g][key].dtype), (g, key)
            assert not tc[g][key].any()
    if kw.get("ring_local"):      # the local leaves hold the window only
        assert tc["layers_0"]["b0_k"].shape[2] == tm.cfg.window
        assert tc["layers_0"]["b5_k"].shape[2] == 40


@pytest.mark.parametrize("opts", list(CACHE_OPTS))
def test_gemma3_cache_variant_decode_matches_reference(opts, rng):
    """40 decode steps from an empty cache at window 16 (the ring wraps
    twice): logits every step and the final caches."""
    jm, tm, jparams, tparams = models(GEMMA)
    kw = CACHE_OPTS[opts]
    ring = kw.get("ring_local", False)
    b, steps = 2, 40
    step = jstep(jm, ring)
    jc = jdec.init_cache(jm, b, steps, **kw)
    tc = tdec.init_cache(tm, b, steps, device="cpu", **kw)
    toks = rng.randint(0, jm.cfg.vocab, (b, steps)).astype(np.int32)
    for t in range(steps):
        jl, jc = step(jparams, jc, jnp.asarray(toks[:, t:t + 1]),
                      jnp.int32(t))
        tl, tc = tdec.decode_step(tm, tparams, tc,
                                  torch.from_numpy(toks[:, t:t + 1]), t,
                                  ring_local=ring)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"step {t}")
    _assert_caches(jc, tc)


def test_ring_decode_equals_full_cache_windowed_decode(rng):
    """The port's ring caches against its own full-length caches under
    the window mask, 40 steps: the same keys in other slots."""
    _, tm, _, tparams = models(GEMMA)
    b, steps = 2, 40
    rc = tdec.init_cache(tm, b, steps, device="cpu", ring_local=True)
    fc = tdec.init_cache(tm, b, steps, device="cpu")
    toks = torch.from_numpy(rng.randint(0, tm.cfg.vocab, (b, steps)))
    for t in range(steps):
        rl, _ = tdec.decode_step(tm, tparams, rc, toks[:, t:t + 1], t,
                                 ring_local=True)
        fl, _ = tdec.decode_step(tm, tparams, fc, toks[:, t:t + 1], t)
        torch.testing.assert_close(rl, fl, atol=1e-5, rtol=1e-5)
    # the ring holds the last 16 positions of the full cache
    w = tm.cfg.window
    pos = torch.arange(steps - w, steps)
    for key in ("b0_k", "b0_v"):
        torch.testing.assert_close(rc["layers_0"][key][:, :, pos % w],
                                   fc["layers_0"][key][:, :, pos])
    # the global block keeps every position
    torch.testing.assert_close(rc["layers_0"]["b5_k"], fc["layers_0"]["b5_k"])


@pytest.mark.parametrize("ring", [False, True], ids=["full", "ring"])
def test_prefill_matches_reference(ring, rng, monkeypatch):
    """The reference's ``prefill`` runs its decode step under ``jax.jit``
    (patched in: the same function, compiled once)."""
    jm, tm, jparams, tparams = models(GEMMA)
    step = jstep(jm, ring)
    monkeypatch.setattr(jdec, "decode_step",
                        lambda model, p, c, t, i, *, ring_local=False:
                        step(p, c, t, i))
    toks = rng.randint(0, jm.cfg.vocab, (2, 24)).astype(np.int32)
    jl, jc = jdec.prefill(jm, jparams, jnp.asarray(toks), 32,
                          ring_local=ring)
    tl, tc = tdec.prefill(tm, tparams, torch.from_numpy(toks), 32,
                          ring_local=ring)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_caches(jc, tc)


@pytest.mark.parametrize("opts", ["ring", "int8"])
def test_seed_cache_from_prefill_refuses_ring_and_int8(opts, rng):
    jm, tm, jparams, tparams = models(GEMMA)
    s = 24                                   # past the window of 16
    toks = rng.randint(0, jm.cfg.vocab, (1, s)).astype(np.int32)
    jfn, tfn = _compile_pair(jm, tm, 1, s, "prefill_kv", ("xla",), REF_HW)
    jkv = jfn(jparams, {"tokens": jnp.asarray(toks)})[1:]
    tkv = tfn(tparams, {"tokens": torch.from_numpy(toks)})[1:]
    kw = CACHE_OPTS[opts]
    with pytest.raises(ValueError, match="full-length, unquantized"):
        jdec.seed_cache_from_prefill(jm, jdec.init_cache(jm, 1, 32, **kw),
                                     jkv, s)
    with pytest.raises(ValueError, match="full-length, unquantized"):
        tdec.seed_cache_from_prefill(
            tm, tdec.init_cache(tm, 1, 32, device="cpu", **kw), tkv, s)


# --------------------------------------------------------------------------
# serving gemma3
# --------------------------------------------------------------------------

def _trace(cfg, lens, gen, seed):
    rng = np.random.RandomState(seed)
    return [(i, tuple(rng.randint(0, cfg.vocab, n).tolist()), gen)
            for i, n in enumerate(lens)]


_SERVED = {}


def reference_tokens(jm, jparams, trace):
    """The reference runtime's token streams for ``trace``, once."""
    key = tuple(trace)
    if key not in _SERVED:
        lens = [len(p) for _, p, _ in trace]
        jrt = JRuntime(jm, jparams, max_batch=2, max_seq=64,
                       plan_cache=JPlanCache())
        jrt.warmup(lens)
        _SERVED[key] = [r.tokens for r in jrt.serve(
            [JRequest(*r) for r in trace], timeout_s=120)]
    return _SERVED[key]


@pytest.mark.parametrize("engines", ENGINES, ids=ENGINE_IDS)
def test_gemma3_runtime_equals_sequential_and_reference(engines):
    """Prompts past the window (20 and 40 tokens at W = 16) and decode
    past it: the runtime's tokens are ``serve_sequential``'s and the
    reference runtime's (``("xla",)``: its flash in interpret mode is
    slow, and the two attentions agree on every row a prefill
    produces)."""
    jm, tm, jparams, tparams = models(GEMMA)
    trace = _trace(tm.cfg, [20, 5, 40], 8, seed=0)
    lens = [len(p) for _, p, _ in trace]
    want = reference_tokens(jm, jparams, trace)
    reqs = [ServeRequest(*r) for r in trace]
    pc = PlanCache()
    rt = AsyncServingRuntime(tm, tparams, max_batch=2, max_seq=64,
                             plan_cache=pc, engines=engines, device="cpu")
    assert rt.kv_mode
    rt.warmup(lens)
    misses0 = pc.stats()["misses"]
    res = rt.serve(reqs, timeout_s=120)
    assert [r.status for r in res] == ["ok"] * len(reqs)
    assert pc.stats()["misses"] == misses0
    seq = serve_sequential(tm, tparams, reqs, max_seq=64, engines=engines,
                           plan_cache=PlanCache(), device="cpu")
    assert [r.tokens for r in res] == [r.tokens for r in seq] == want


@pytest.mark.parametrize("arch,engines", [
    (GEMMA, "xla"), (GEMMA, "xla,pallas"), ("deepseek-7b", "xla,pallas"),
    ("stablelm-12b", "xla,pallas")])
def test_cli_serves_the_three(arch, engines, monkeypatch, capsys):
    """``python -m repro_torch.launch.serve --arch ... --smoke --device
    cpu`` in ``prefill_kv`` mode, with the reference CLI's engines
    (``xla``: gemma3's windowed layers band at bucket 64) and the
    port's default (the kernel slot); without a card it raises."""
    monkeypatch.setattr(truntime, "default_plan_cache", PlanCache)
    argv = ["--arch", arch, "--smoke", "--requests", "3", "--gen", "4",
            "--prompt-lens", "5,27,40", "--max-batch", "2", "--max-seq",
            "64", "--engines", engines]
    res = serve_cli.main(argv + ["--device", "cpu"])
    assert [r.status for r in res] == ["ok"] * 3
    assert all(len(r.tokens) == 4 for r in res)
    out = capsys.readouterr().out
    assert "mode=prefill_kv" in out and "device=cpu" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_cli.main(argv)
