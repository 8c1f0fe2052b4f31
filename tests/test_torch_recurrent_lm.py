"""The port's recurrent language models against the reference, on the CPU.

rwkv6-3b (family ``rwkv``) and zamba2-7b (family ``hybrid``: mamba blocks
and a weight-shared attention block).  At full width, planning only: plan
ids and chosen impls equal the reference's at buckets 128 and 2048, in
``prefill`` and ``train`` modes, under both engine sets; ``prefill_kv``
refused by both.  At SMOKE width in float32, the reference's parameters
from ``jax.random.key(1)`` carried across as numpy (the hybrid's root
``shared`` subtree included): the planned prefill's logits under both
engine sets; ``decode_step`` and ``decode_step_batched`` logits and every
cache leaf (K/V, rwkv state and last inputs, mamba state and conv inputs);
``inference_params``' cast list for each family.  Tolerance ``atol = rtol
= 1e-4``: float32 matmuls and recurrences summed in other orders over a
few layers.
"""
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
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import decode as jdec  # noqa: E402
from repro.models.lm import CATALOG as JCAT  # noqa: E402
from repro_torch.configs import get_config as tconfig  # noqa: E402
from repro_torch.configs import get_smoke_config as tsmoke  # noqa: E402
from repro_torch.core import ir as tir  # noqa: E402
from repro_torch.core.executor import plan_and_compile as tcompile  # noqa
from repro_torch.models import build_model as tbuild  # noqa: E402
from repro_torch.models import decode as tdec  # noqa: E402
from repro_torch.models.lm import CATALOG as TCAT  # noqa: E402
from repro_torch.models.lm import params_from_numpy  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["rwkv6-3b", "zamba2-7b"]
ENGINES = [("xla",), ("xla", "pallas")]
# the recurrence impl of each family, and its launches per forward at
# full width (rwkv6-3b: 32 layers; zamba2-7b: 13 x 6 + 3 mamba blocks)
KERNEL_IMPL = {"rwkv6-3b": ("wkv6_scan_xla", "wkv6_pallas", 1),
               "zamba2-7b": ("ssd_chunked_xla", "ssd_pallas", 7)}


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


def test_params_from_numpy_round_trip(models):
    _, tm, _, tparams, np_params = models
    want = dict(_flat(np_params))
    got = dict(_flat(tparams))
    assert got.keys() == want.keys()
    for key, arr in want.items():
        np.testing.assert_array_equal(got[key].numpy(), arr, err_msg=key)
    if tm.cfg.family == "hybrid":
        assert {k.split("/")[1] for k in want} >= {"shared"}
    # the port's own init makes the same tree, shapes and dtypes
    own = dict(_flat(tm.init_params(torch.Generator().manual_seed(0))))
    assert own.keys() == want.keys()
    for key, arr in want.items():
        assert tuple(own[key].shape) == arr.shape, key
        assert own[key].dtype == torch.float32, key


@pytest.mark.parametrize("engines", ENGINES, ids=["xla", "xla+pallas"])
@pytest.mark.parametrize("mode", ["prefill", "train"])
@pytest.mark.parametrize("bucket", [128, 2048])
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_id_and_impls_equal_reference(arch, bucket, mode, engines):
    jm, tm = jbuild(jconfig(arch)), tbuild(tconfig(arch))
    hw = asdict(jir.HardwareSpec())          # an equal SystemCatalog
    jfn = jcompile(jm.build_plan(1, bucket, mode), JCAT,
                   jir.SystemCatalog(hardware=jir.HardwareSpec(**hw)),
                   engines=engines, cache=False)
    tfn = tcompile(tm.build_plan(1, bucket, mode), TCAT,
                   tir.SystemCatalog(hardware=tir.HardwareSpec(**hw)),
                   engines=engines, cache=False, device="cpu")
    assert tfn.plan_id == jfn.plan_id
    assert _impls(tfn) == _impls(jfn)
    xla, kernel, per_group = KERNEL_IMPL[arch]
    want = kernel if "pallas" in engines else xla
    assert Counter(_impls(tfn))[want] == per_group


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_kv_rejected_as_by_the_reference(arch):
    jm, tm = jbuild(jsmoke(arch)), tbuild(tsmoke(arch))
    assert not tm.supports_prefill_kv() and not jm.supports_prefill_kv()
    with pytest.raises(ValueError, match="prefill_kv"):
        jm.build_plan(1, 16, mode="prefill_kv")
    with pytest.raises(ValueError, match="prefill_kv"):
        tm.build_plan(1, 16, mode="prefill_kv")


@pytest.mark.parametrize("engines", ENGINES, ids=["xla", "xla+pallas"])
def test_prefill_forward_matches_reference(models, rng, engines):
    jm, tm, jparams, tparams, _ = models
    b, s = 2, 16
    toks = rng.randint(0, jm.cfg.vocab, (b, s)).astype(np.int32)
    jfn = jcompile(jm.build_plan(b, s, "prefill"), JCAT,
                   jir.SystemCatalog(), engines=engines, cache=False)
    tfn = tcompile(tm.build_plan(b, s, "prefill"), TCAT,
                   tir.SystemCatalog(), engines=engines, cache=False,
                   device="cpu")
    want = jfn(jparams, {"tokens": jnp.asarray(toks)})
    got = tfn(tparams, {"tokens": torch.from_numpy(toks)})
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _cache_pair(jm, tm, b, max_seq, rng):
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


def test_init_cache_layout(models):
    jm, tm, _, _, _ = models
    jc = jdec.init_cache(jm, 3, 12)
    tc = tdec.init_cache(tm, 3, 12, device="cpu")
    assert tc.keys() == jc.keys()
    for g in jc:
        assert tc[g].keys() == jc[g].keys()
        for key in jc[g]:
            assert tuple(tc[g][key].shape) == jc[g][key].shape, key
            want = torch.float32 if key.endswith("_state") else tm.dtype
            assert tc[g][key].dtype == want and not tc[g][key].any()


def test_decode_step_matches_reference(models, rng):
    """Five steps from zero caches: logits at each, every leaf after."""
    jm, tm, jparams, tparams, _ = models
    b, max_seq = 2, 12
    jc = jdec.init_cache(jm, b, max_seq)
    tc = tdec.init_cache(tm, b, max_seq, device="cpu")
    leaves = [id(x) for gc in tc.values() for x in gc.values()]
    for t in range(5):
        toks = rng.randint(0, jm.cfg.vocab, (b, 1)).astype(np.int32)
        jl, jc = jdec.decode_step(jm, jparams, jc, jnp.asarray(toks),
                                  jnp.int32(t))
        tl, tc = tdec.decode_step(tm, tparams, tc, torch.from_numpy(toks), t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_caches(jc, tc)
    # every leaf written in place: the same tensors as before the steps
    assert [id(x) for gc in tc.values() for x in gc.values()] == leaves


def test_decode_step_batched_matches_reference(models, rng):
    """Slots at different positions over random caches (random recurrent
    states too): logits and every cache leaf."""
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


# the leaves each family's layers cast to the activation dtype per call
_MAMBA = ("w_in", "conv", "d_skip", "w_out")
CAST = {
    "rwkv6-3b": {f"/layers_0/b0_tm/{k}" for k in (
        "wr", "wk", "wv", "wg", "wo", "wA", "wB", "mu")}
    | {f"/layers_0/b0_cm/{k}" for k in ("wk", "wv", "wr", "mu")},
    "zamba2-7b": {f"/layers_0/b{i}_mamba/{k}" for i in (0, 1)
                  for k in _MAMBA}
    | {f"/shared/attn/{k}" for k in ("wq", "wk", "wv", "wo")}
    | {f"/shared/mlp/{k}" for k in ("wi", "wg", "wo")},
}


def test_inference_params_cast_list(models, rng):
    """The cast-once parameters hold bf16 exactly where the reference
    casts per call; everything it reads in float32 (``w0``, ``u``,
    ``a_log``, ``dt_bias``, norm scales, the embedding) stays float32; a
    bf16 prefill over them equals, bitwise, the one that casts per call."""
    _, tm32, _, tparams, _ = models
    arch = tm32.cfg.name.removesuffix("-smoke")
    tm = tbuild(tsmoke(arch))                        # bfloat16 activations
    leaves = dict(_flat(tm.inference_params(tparams)))
    bf16 = {k for k, v in leaves.items() if v.dtype == torch.bfloat16}
    assert bf16 == CAST[arch]
    assert all(v.dtype == torch.float32 for k, v in leaves.items()
               if k not in bf16)
    toks = torch.from_numpy(rng.randint(0, tm.cfg.vocab, (2, 16)))
    fn = tcompile(tm.build_plan(2, 16, "prefill"), TCAT,
                  tir.SystemCatalog(), engines=("xla", "pallas"),
                  cache=False, device="cpu")
    cast = tm.inference_params(tparams)
    assert torch.equal(fn(tparams, {"tokens": toks}),
                       fn(cast, {"tokens": toks}))
