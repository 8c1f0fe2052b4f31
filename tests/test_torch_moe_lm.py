"""The port's mixture-of-experts language models against the reference, on
the CPU.

dbrx-132b (every layer an attention + MoE block, 16 experts top-4) and
llama4-maverick (every other layer MoE, 128 experts top-1).  At full width,
planning only: plan ids and chosen impls equal the reference's at buckets
128 and 2048 in ``prefill``, ``prefill_kv`` and ``train`` modes under both
engine sets, for both full configs and for dbrx at the 2 layers one H100
serves; each MoE block picks ``moe_gmm_pallas`` with the kernel slot and
``moe_dropping`` without.  At SMOKE width in float32, the reference's
parameters from ``jax.random.key(1)`` carried across as numpy: the layer
functions (``moe_dense``, ``moe_dropping``, ``moe_gmm``,
``moe_reference_dense``) on the same input, with routing, ``keep`` and
``dest`` exact, in a case that forces capacity drops and in the all-zero
router case where every logit ties; the planned ``prefill`` and
``prefill_kv`` forwards (logits and every layer's K/V); ``decode_step``,
``decode_step_batched`` and ``seed_cache_from_prefill``; the cast list of
``inference_params`` (the router stays float32).  Tolerance ``atol = rtol
= 1e-4`` in float32: matmuls summed in other orders over a few layers;
bfloat16 layer outputs ``1e-2``: the expert matmuls, ``act(gate) * up``,
the routing-weight scaling and the combine round to bfloat16 at the same
points on both sides, from float32 sums taken in other orders, so the
outputs land an ulp (2^-8 relative) or so apart.
"""
import functools
from collections import Counter
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
from repro.layers import moe as jmoe  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import decode as jdec  # noqa: E402
from repro.models.lm import CATALOG as JCAT  # noqa: E402
from repro_torch.configs import get_config as tconfig  # noqa: E402
from repro_torch.configs import get_smoke_config as tsmoke  # noqa: E402
from repro_torch.core import ir as tir  # noqa: E402
from repro_torch.core.executor import plan_and_compile as tcompile  # noqa
from repro_torch.layers import moe as tmoe  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402
from repro_torch.models import decode as tdec  # noqa: E402
from repro_torch.models.lm import CATALOG as TCAT  # noqa: E402
from repro_torch.models.lm import params_from_numpy  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=1e-2, rtol=1e-2)
ARCHS = ["dbrx-132b", "llama4-maverick-400b-a17b"]
ENGINES = [("xla",), ("xla", "pallas")]
LAYER_FNS = ["moe_dense", "moe_dropping", "moe_gmm", "moe_reference_dense"]


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    arch = request.param
    jm = jbuild(jsmoke(arch).replace(dtype="float32"))
    tm = tbuild(tsmoke(arch).replace(dtype="float32"))
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


def _moe_params(np_params):
    """The first MoE block's parameters (numpy), as one layer's tree."""
    for g in sorted(k for k in np_params if k.startswith("layers_")):
        for key, leaf in np_params[g].items():
            if key.endswith("_moe"):
                return {k: v[0] for k, v in leaf.items()}
    raise AssertionError("no moe block")


def test_params_from_numpy_round_trip(models):
    _, tm, _, tparams, np_params = models
    want = dict(_flat(np_params))
    got = dict(_flat(tparams))
    assert got.keys() == want.keys()
    for key, arr in want.items():
        np.testing.assert_array_equal(got[key].numpy(), arr, err_msg=key)
    assert any(k.endswith("_moe/router") for k in want)
    # the port's own init makes the same tree, shapes and dtypes
    own = dict(_flat(tm.init_params(torch.Generator().manual_seed(0))))
    assert own.keys() == want.keys()
    for key, arr in want.items():
        assert tuple(own[key].shape) == arr.shape, key
        assert own[key].dtype == torch.float32, key


@pytest.mark.parametrize("engines", ENGINES, ids=["xla", "xla+pallas"])
@pytest.mark.parametrize("mode", ["prefill", "prefill_kv", "train"])
@pytest.mark.parametrize("bucket", [128, 2048])
@pytest.mark.parametrize("arch,layers", [("dbrx-132b", None),
                                         ("dbrx-132b", 2),
                                         ("llama4-maverick-400b-a17b", None)])
def test_plan_id_and_impls_equal_reference(arch, layers, bucket, mode,
                                           engines):
    jcfg, tcfg = jconfig(arch), tconfig(arch)
    if layers:
        jcfg, tcfg = (c.replace(n_layers=layers) for c in (jcfg, tcfg))
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    hw = asdict(jir.HardwareSpec())          # an equal SystemCatalog
    jfn = jcompile(jm.build_plan(1, bucket, mode), JCAT,
                   jir.SystemCatalog(hardware=jir.HardwareSpec(**hw)),
                   engines=engines, cache=False)
    tfn = tcompile(tm.build_plan(1, bucket, mode), TCAT,
                   tir.SystemCatalog(hardware=tir.HardwareSpec(**hw)),
                   engines=engines, cache=False, device="cpu")
    assert tfn.plan_id == jfn.plan_id
    assert _impls(tfn) == _impls(jfn)
    got = Counter(_impls(tfn))
    kernel = "pallas" in engines
    # one MoE block in each scan group's subplan
    assert got["moe_gmm_pallas" if kernel else "moe_dropping"] == 1
    assert got["attn_flash_pallas" if kernel else "sdpa_xla"] == \
        tcfg.moe_every


def _layer_inputs(rng, cfg, b, s):
    return rng.randn(b, s, cfg.d_model).astype(np.float32)


def _layer_pair(fn, jp, tp, x, cfg, dtype=None):
    kw = dict(top_k=cfg.top_k, experts=cfg.experts, act=cfg.act)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if dtype is not None:
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    want = jax.jit(functools.partial(getattr(jmoe, fn), **kw))(jp, jx)
    got = getattr(tmoe, fn)(tp, tx, **kw)
    assert got.dtype == tx.dtype and tuple(got.shape) == want.shape
    return got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32))


@pytest.mark.parametrize("fn", LAYER_FNS)
def test_layer_functions_match_reference(models, rng, fn):
    jm, tm, _, _, np_params = models
    mp = _moe_params(np_params)
    jp = {k: jnp.asarray(v) for k, v in mp.items()}
    tp = params_from_numpy(mp)
    x = _layer_inputs(rng, tm.cfg, 2, 24)
    got, want = _layer_pair(fn, jp, tp, x, tm.cfg)
    np.testing.assert_allclose(got, want, **TOL)
    got, want = _layer_pair(fn, jp, tp, x, tm.cfg, dtype="bfloat16")
    np.testing.assert_allclose(got, want, **BF16)


def _reference_slots(jp, x, top_k, experts, cf):
    """The reference's routing and its (keep, dest), computed with its
    ``_route`` and the lines of its ``moe_capacity_dispatch``."""
    b, s, _ = x.shape
    cap = max(8, int(s * top_k * cf / experts))
    weights, idx = jmoe._route(jp, jnp.asarray(x), top_k)
    flat_i = idx.reshape(b, s * top_k)
    onehot = jax.nn.one_hot(flat_i, experts, dtype=jnp.int32)
    rank = jnp.sum(jnp.cumsum(onehot, axis=1) * onehot, axis=-1) - 1
    keep = rank < cap
    dest = jnp.where(keep, flat_i * cap + rank, experts * cap)
    return (np.asarray(weights), np.asarray(idx), np.asarray(keep),
            np.asarray(dest), cap)


def _port_slots(tp, x, top_k, experts, cap):
    weights, idx = tmoe._route(tp, torch.from_numpy(x), top_k)
    keep, dest = tmoe.capacity_slots(idx.reshape(x.shape[0], -1), experts,
                                     cap)
    return weights.numpy(), idx.numpy(), keep.numpy(), dest.numpy()


@pytest.mark.parametrize("cf", [1.0, 2.0])
def test_capacity_drops_keep_and_dest_exact(rng, cf):
    """Four experts, top-2, a 64-token row whose router sends every token
    to experts 0 and 1 first: cap 32 (cf 1.0) or 64 (cf 2.0) slots an
    expert, so cf 1.0 drops the later half of those assignments.  Routing,
    ``keep`` and ``dest`` equal the reference's exactly; the dispatched
    outputs (the dropped assignments' share missing) agree."""
    e, k, s, d, f = 4, 2, 64, 16, 24
    x = rng.randn(2, s, d).astype(np.float32)
    x[..., 0] = 3.0 + rng.rand(2, s)             # a shared component
    p = {"router": rng.randn(d, e).astype(np.float32) * 0.1,
         "wi": rng.randn(e, d, f).astype(np.float32) / 4,
         "wg": rng.randn(e, d, f).astype(np.float32) / 4,
         "wo": rng.randn(e, f, d).astype(np.float32) / 5}
    p["router"][0, :2] = (4.0, 3.0)              # experts 0 and 1 first
    jp = {kk: jnp.asarray(v) for kk, v in p.items()}
    tp = params_from_numpy(p)
    jw, ji, jkeep, jdest, cap = _reference_slots(jp, x, k, e, cf)
    tw, ti, tkeep, tdest = _port_slots(tp, x, k, e, cap)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tkeep, jkeep)
    np.testing.assert_array_equal(tdest, jdest)
    np.testing.assert_allclose(tw, jw, **TOL)
    dropped = int((~jkeep).sum())
    assert dropped == (2 * 2 * (s - cap) if cf == 1.0 else 0)
    fn = "moe_dropping" if cf == 1.0 else "moe_dense"
    kw = dict(top_k=k, experts=e)
    want = getattr(jmoe, fn)(jp, jnp.asarray(x), **kw)
    got = getattr(tmoe, fn)(tp, torch.from_numpy(x), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    got = tmoe.moe_gmm(tp, torch.from_numpy(x), capacity_factor=cf, **kw)
    want = jmoe.moe_gmm(jp, jnp.asarray(x), capacity_factor=cf, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_all_zero_router_ties_pick_the_lowest_experts(models, rng):
    """Every logit ties: the reference (``lax.top_k``) picks experts 0 ..
    k-1 with weight 1/k each, and so does the port."""
    _, tm, _, _, np_params = models
    cfg = tm.cfg
    mp = dict(_moe_params(np_params))
    mp["router"] = np.zeros_like(mp["router"])
    jp = {k: jnp.asarray(v) for k, v in mp.items()}
    tp = params_from_numpy(mp)
    x = _layer_inputs(rng, cfg, 2, 9)
    jw, ji, jkeep, jdest, cap = _reference_slots(jp, x, cfg.top_k,
                                                 cfg.experts, 2.0)
    tw, ti, tkeep, tdest = _port_slots(tp, x, cfg.top_k, cfg.experts, cap)
    assert (ti == np.arange(cfg.top_k)).all() and (ji == ti).all()
    np.testing.assert_array_equal(tkeep, jkeep)
    np.testing.assert_array_equal(tdest, jdest)
    np.testing.assert_allclose(tw, 1.0 / cfg.top_k, rtol=1e-6)
    for fn in LAYER_FNS:
        got, want = _layer_pair(fn, jp, tp, x, cfg)
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("mode", ["prefill", "prefill_kv"])
@pytest.mark.parametrize("engines", ENGINES, ids=["xla", "xla+pallas"])
def test_prefill_forwards_match_reference(models, rng, engines, mode):
    jm, tm, jparams, tparams, _ = models
    b, s = 2, 16
    toks = rng.randint(0, jm.cfg.vocab, (b, s)).astype(np.int32)
    jfn = jcompile(jm.build_plan(b, s, mode), JCAT, jir.SystemCatalog(),
                   engines=engines, cache=False)
    tfn = tcompile(tm.build_plan(b, s, mode), TCAT, tir.SystemCatalog(),
                   engines=engines, cache=False, device="cpu")
    inner = Counter(m.impl for n in tfn.concrete.topo()
                    if n.subplan is not None for m in n.subplan.topo())
    assert inner["moe_gmm_pallas" if "pallas" in engines
                 else "moe_dropping"] == 1
    jouts = jfn(jparams, {"tokens": jnp.asarray(toks)})
    touts = tfn(tparams, {"tokens": torch.from_numpy(toks)})
    if mode == "prefill":
        np.testing.assert_allclose(touts.numpy(), np.asarray(jouts), **TOL)
        return
    assert len(touts) == len(jouts) == 1 + len(tm.groups)
    np.testing.assert_allclose(touts[0].numpy(), np.asarray(jouts[0]), **TOL)
    n_attn = 1 + (tm.cfg.moe_every > 1)
    for jg, tg in zip(jouts[1:], touts[1:]):
        assert len(tg) == len(jg) == n_attn
        for jkv_pair, tkv_pair in zip(jg, tg):
            for jkv, tkv in zip(jkv_pair, tkv_pair):
                assert tuple(tkv.shape) == jkv.shape
                np.testing.assert_allclose(tkv.numpy(), np.asarray(jkv),
                                           **TOL)


def _cache_pair(jm, b, max_seq, rng):
    """Equal random caches on both sides (numpy-made)."""
    jc = jdec.init_cache(jm, b, max_seq)
    np_c = {g: {k: rng.randn(*v.shape).astype(np.float32)
                for k, v in gc.items()} for g, gc in jc.items()}
    jc = {g: {k: jnp.asarray(v) for k, v in gc.items()}
          for g, gc in np_c.items()}
    return jc, params_from_numpy(np_c, "cpu")


def _assert_caches(jc, tc):
    assert tc.keys() == jc.keys()
    for g in jc:
        assert tc[g].keys() == jc[g].keys()
        for key in jc[g]:
            np.testing.assert_allclose(tc[g][key].numpy(),
                                       np.asarray(jc[g][key]),
                                       err_msg=f"{g}/{key}", **TOL)


def test_decode_step_matches_reference(models, rng):
    """Five steps from zero caches: logits at each, every leaf after."""
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
    """Slots at different positions over random caches: logits and every
    cache leaf."""
    jm, tm, jparams, tparams, _ = models
    b, max_seq = 3, 12
    jc, tc = _cache_pair(jm, b, max_seq, rng)
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
    jc, tc = _cache_pair(jm, 2, max_seq, rng)
    jc = jdec.seed_cache_from_prefill(jm, jc, jkv, s - 2, slot=slot)
    tc = tdec.seed_cache_from_prefill(tm, tc, tkv, s - 2, slot=slot)
    _assert_caches(jc, tc)


# the leaves the layers cast to the activation dtype per call
_ATTN = ("wq", "wk", "wv", "wo")
_EXPERTS = ("wi", "wg", "wo")
CAST = {
    "dbrx-132b": {f"/layers_0/b0_attn/{k}" for k in _ATTN}
    | {f"/layers_0/b0_moe/{k}" for k in _EXPERTS},
    "llama4-maverick-400b-a17b": {f"/layers_0/b{i}_attn/{k}" for i in (0, 1)
                                  for k in _ATTN}
    | {f"/layers_0/b0_mlp/{k}" for k in _EXPERTS}
    | {f"/layers_0/b1_moe/{k}" for k in _EXPERTS},
}


def test_inference_params_cast_list(models, rng):
    """The cast-once parameters hold bf16 exactly where the reference
    casts per call: attention projections and the expert weights; the
    router (read in float32 by ``_route``), norm scales and the embedding
    stay float32; a bf16 prefill over them equals, bitwise, the one that
    casts per call."""
    _, tm32, _, tparams, _ = models
    arch = tm32.cfg.name.removesuffix("-smoke")
    arch = "llama4-maverick-400b-a17b" if arch.startswith("llama4") else arch
    tm = tbuild(tsmoke(arch))                        # bfloat16 activations
    leaves = dict(_flat(tm.inference_params(tparams)))
    bf16 = {k for k, v in leaves.items() if v.dtype == torch.bfloat16}
    assert bf16 == CAST[arch]
    assert all(v.dtype == torch.float32 for k, v in leaves.items()
               if k not in bf16)
    assert any(k.endswith("_moe/router") for k in leaves)
    toks = torch.from_numpy(rng.randint(0, tm.cfg.vocab, (2, 16)))
    fn = tcompile(tm.build_plan(2, 16, "prefill_kv"), TCAT,
                  tir.SystemCatalog(), engines=("xla", "pallas"),
                  cache=False, device="cpu")
    cast = tm.inference_params(tparams)
    a, b = fn(tparams, {"tokens": toks}), fn(cast, {"tokens": toks})
    assert torch.equal(a[0], b[0])
