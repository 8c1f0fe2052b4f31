"""The port's qwen3 language model against the reference, on the CPU.

qwen3-0.6b's SMOKE config in float32 (2 layers, d_model 64, 4 heads / 2 KV
heads, head_dim 16, vocab 512); the reference's parameters from
``jax.random.key(1)`` carried across as numpy.  Checked: the parameter
round trip; plan ids and chosen impls (SMOKE at two buckets, the full
config at 2048, planning only); the planned ``prefill_kv`` forward's logits
and every layer's K/V; ``decode_step`` / ``decode_step_batched``; and
``seed_cache_from_prefill``.  Tolerance ``atol = rtol = 1e-4``: float32
matmuls and softmaxes summed in another order over two layers.
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
from repro.layers import attention as jattn  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import decode as jdec  # noqa: E402
from repro.models.lm import CATALOG as JCAT  # noqa: E402
from repro_torch.configs import get_config as tconfig  # noqa: E402
from repro_torch.configs import get_smoke_config as tsmoke  # noqa: E402
from repro_torch.core import ir as tir  # noqa: E402
from repro_torch.core.executor import plan_and_compile as tcompile  # noqa
from repro_torch.layers import attention as tattn  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402
from repro_torch.models import decode as tdec  # noqa: E402
from repro_torch.models.lm import CATALOG as TCAT  # noqa: E402
from repro_torch.models.lm import params_from_numpy  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "qwen3-0.6b"
ENGINES = [("xla",), ("xla", "pallas")]


@pytest.fixture(scope="module")
def models():
    jcfg = jsmoke(ARCH).replace(dtype="float32")
    tcfg = tsmoke(ARCH).replace(dtype="float32")
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jparams, _ = jm.init_params(jax.random.key(1))
    np_params = jax.tree.map(np.asarray, jparams)
    return jm, tm, jparams, params_from_numpy(np_params, "cpu"), np_params


def _impls(fn):
    """Impl names in topo order, each scan subplan's after its node."""
    out = []
    for n in fn.concrete.topo():
        out.append(n.impl)
        if n.subplan is not None:
            out.extend(m.impl for m in n.subplan.topo())
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_params_from_numpy_round_trip(models):
    _, tm, _, tparams, np_params = models
    want = dict(_flat(np_params))
    got = dict(_flat(tparams))
    assert got.keys() == want.keys()
    for key, arr in want.items():
        assert got[key].dtype == torch.float32
        np.testing.assert_array_equal(got[key].numpy(), arr, err_msg=key)
    # the port's own init makes the same tree, shapes and dtypes
    own = dict(_flat(tm.init_params(torch.Generator().manual_seed(0))))
    assert own.keys() == want.keys()
    for key, arr in want.items():
        assert tuple(own[key].shape) == arr.shape, key


@pytest.mark.parametrize("engines", ENGINES, ids=["xla", "xla+pallas"])
@pytest.mark.parametrize("mode", ["prefill", "prefill_kv", "train"])
@pytest.mark.parametrize("cfg,bucket", [("smoke", 16), ("smoke", 64),
                                        ("full", 2048)])
def test_plan_id_and_impls_equal_reference(cfg, bucket, mode, engines):
    if cfg == "smoke":
        jm, tm = jbuild(jsmoke(ARCH)), tbuild(tsmoke(ARCH))
    else:
        jm, tm = jbuild(jconfig(ARCH)), tbuild(tconfig(ARCH))
    hw = asdict(jir.HardwareSpec())          # an equal SystemCatalog
    jfn = jcompile(jm.build_plan(1, bucket, mode), JCAT,
                   jir.SystemCatalog(hardware=jir.HardwareSpec(**hw)),
                   engines=engines, cache=False)
    tfn = tcompile(tm.build_plan(1, bucket, mode), TCAT,
                   tir.SystemCatalog(hardware=tir.HardwareSpec(**hw)),
                   engines=engines, cache=False, device="cpu")
    assert tfn.plan_id == jfn.plan_id
    assert _impls(tfn) == _impls(jfn)
    want = "attn_flash_pallas" if "pallas" in engines else "sdpa_xla"
    assert _impls(tfn).count(want) == 1


@pytest.mark.parametrize("engines", ENGINES, ids=["xla", "xla+pallas"])
def test_prefill_kv_forward_matches_reference(models, rng, engines):
    jm, tm, jparams, tparams, _ = models
    b, s = 2, 16
    toks = rng.randint(0, jm.cfg.vocab, (b, s)).astype(np.int32)
    jfn = jcompile(jm.build_plan(b, s, "prefill_kv"), JCAT,
                   jir.SystemCatalog(), engines=engines, cache=False)
    tfn = tcompile(tm.build_plan(b, s, "prefill_kv"), TCAT,
                   tir.SystemCatalog(), engines=engines, cache=False,
                   device="cpu")
    jouts = jfn(jparams, {"tokens": jnp.asarray(toks)})
    touts = tfn(tparams, {"tokens": torch.from_numpy(toks)})
    assert len(touts) == len(jouts) == 1 + len(tm.groups)
    np.testing.assert_allclose(touts[0].numpy(), np.asarray(jouts[0]), **TOL)
    for jg, tg in zip(jouts[1:], touts[1:]):
        assert len(tg) == len(jg) == 1
        for jkv, tkv in zip(jg[0], tg[0]):
            assert tuple(tkv.shape) == jkv.shape == (2, b, s, 2, 16)
            np.testing.assert_allclose(tkv.numpy(), np.asarray(jkv), **TOL)


def test_inference_params_cast_projections_once(models, rng):
    """The cast-once parameters hold bf16 projection matrices and keep
    norms and the embedding table in float32; a bf16 forward over them
    equals, bitwise, the forward that casts per call."""
    _, _, _, tparams, _ = models
    tm = tbuild(tsmoke(ARCH))                       # bfloat16 activations
    cast = tm.inference_params(tparams)
    attn, mlp = cast["layers_0"]["b0_attn"], cast["layers_0"]["b0_mlp"]
    assert {attn[k].dtype for k in ("wq", "wk", "wv", "wo")} == \
        {mlp[k].dtype for k in ("wi", "wg", "wo")} == {torch.bfloat16}
    assert attn["q_norm"].dtype == torch.float32
    assert cast["embed"]["table"] is tparams["embed"]["table"]
    assert cast["final_norm"]["scale"] is tparams["final_norm"]["scale"]
    toks = torch.from_numpy(rng.randint(0, tm.cfg.vocab, (2, 16)))
    fn = tcompile(tm.build_plan(2, 16, "prefill_kv"), TCAT,
                  tir.SystemCatalog(), engines=("xla", "pallas"),
                  cache=False, device="cpu")
    a, b = fn(tparams, {"tokens": toks}), fn(cast, {"tokens": toks})
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(x, y) for x, y in zip(a[1][0], b[1][0]))


def _cache_pair(jm, tm, b, max_seq, rng):
    """Equal random caches on both sides (numpy-made)."""
    jc = jdec.init_cache(jm, b, max_seq)
    np_c = {g: {k: rng.randn(*v.shape).astype(np.float32)
                for k, v in gc.items()} for g, gc in jc.items()}
    jc = {g: {k: jnp.asarray(v) for k, v in gc.items()}
          for g, gc in np_c.items()}
    tc = params_from_numpy(np_c, "cpu")
    return jc, tc


def _assert_caches(jc, tc):
    for g in jc:
        for key in jc[g]:
            np.testing.assert_allclose(tc[g][key].numpy(),
                                       np.asarray(jc[g][key]),
                                       err_msg=f"{g}/{key}", **TOL)


def test_cache_update_matches_reference(rng):
    """The in-place cache write against the reference's functional one."""
    ck, cv = (rng.randn(2, 10, 2, 4).astype(np.float32) for _ in range(2))
    nk, nv = (rng.randn(2, 3, 2, 4).astype(np.float32) for _ in range(2))
    jk, jv = jattn.cache_update(jnp.asarray(ck), jnp.asarray(cv),
                                jnp.asarray(nk), jnp.asarray(nv), 5)
    tk, tv = (torch.from_numpy(x.copy()) for x in (ck, cv))
    out = tattn.cache_update(tk, tv, torch.from_numpy(nk),
                             torch.from_numpy(nv), 5)
    assert out[0] is tk and out[1] is tv               # written in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_init_cache_layout(models):
    jm, tm, _, _, _ = models
    jc = jdec.init_cache(jm, 3, 12)
    tc = tdec.init_cache(tm, 3, 12, device="cpu")
    assert tc.keys() == jc.keys()
    for g in jc:
        assert tc[g].keys() == jc[g].keys()
        for key in jc[g]:
            assert tuple(tc[g][key].shape) == jc[g][key].shape
            assert not tc[g][key].any()
    # int8 K/V with bfloat16 scales: the reference's leaves and dtypes
    jq = jdec.init_cache(jm, 1, 8, quantize_kv=True)
    tq = tdec.init_cache(tm, 1, 8, device="cpu", quantize_kv=True)
    for g in jq:
        assert tq[g].keys() == jq[g].keys()
        for key in jq[g]:
            assert tuple(tq[g][key].shape) == jq[g][key].shape
            assert str(tq[g][key].dtype).split(".")[1] == \
                str(jq[g][key].dtype)
    assert tq["layers_0"]["b0_k"].dtype == torch.int8
    assert tq["layers_0"]["b0_ksc"].dtype == torch.bfloat16


def test_decode_step_matches_reference(models, rng):
    jm, tm, jparams, tparams, _ = models
    b, max_seq = 2, 12
    jc = jdec.init_cache(jm, b, max_seq)
    tc = tdec.init_cache(tm, b, max_seq, device="cpu")
    for t in range(5):
        toks = rng.randint(0, jm.cfg.vocab, (b, 1)).astype(np.int32)
        jl, jc = jdec.decode_step(jm, jparams, jc, jnp.asarray(toks),
                                  jnp.int32(t))
        tl, tc = tdec.decode_step(tm, tparams, tc, torch.from_numpy(toks), t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_caches(jc, tc)


def test_decode_step_batched_matches_reference(models, rng):
    """Slots at different positions (the continuous batch) over random
    caches: logits and every cache leaf."""
    jm, tm, jparams, tparams, _ = models
    b, max_seq = 3, 12
    jc, tc = _cache_pair(jm, tm, b, max_seq, rng)
    idx = np.array([0, 3, 11], np.int32)
    toks = rng.randint(0, jm.cfg.vocab, (b, 1)).astype(np.int32)
    jl, jc = jdec.decode_step_batched(jm, jparams, jc, jnp.asarray(toks),
                                      jnp.asarray(idx))
    tl, tc = tdec.decode_step_batched(tm, tparams, tc,
                                      torch.from_numpy(toks),
                                      torch.from_numpy(idx))
    assert tuple(tl.shape) == (b, 1, tm.cfg.padded_vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_caches(jc, tc)


@pytest.mark.parametrize("slot", [None, 1])
def test_seed_cache_from_prefill_matches_reference(models, rng, slot):
    jm, tm, jparams, tparams, _ = models
    s, max_seq = 8, 12
    b = 2 if slot is None else 1
    toks = rng.randint(0, jm.cfg.vocab, (b, s)).astype(np.int32)
    jfn = jcompile(jm.build_plan(b, s, "prefill_kv"), JCAT,
                   jir.SystemCatalog(), cache=False)
    tfn = tcompile(tm.build_plan(b, s, "prefill_kv"), TCAT,
                   tir.SystemCatalog(), cache=False, device="cpu")
    jkv = jfn(jparams, {"tokens": jnp.asarray(toks)})[1:]
    tkv = tfn(tparams, {"tokens": torch.from_numpy(toks)})[1:]
    jc, tc = _cache_pair(jm, tm, 2, max_seq, rng)
    jc = jdec.seed_cache_from_prefill(jm, jc, jkv, s - 2, slot=slot)
    tc = tdec.seed_cache_from_prefill(tm, tc, tkv, s - 2, slot=slot)
    _assert_caches(jc, tc)
