"""The sharded decode step (``models.decode.decode_step(..., mesh=)``) and
the ``pod`` axis on gloo worlds of CPU ranks, against the port's one rank.

One world of four ranks builds a 2 x 2 and a 1 x 4 mesh in turn and
decodes, at the smoke size in float32 from one seed, every family's
config: qwen3-0.6b (dense), dbrx-132b (MoE, experts over ``model``),
rwkv6-3b, zamba2-7b (mamba heads, the conv channels' contiguous cache
block, the weight-shared attention), llava-next-34b (vlm) and
seamless-m4t-medium (encdec cross attention); gemma3-27b with its local
layers as rings, qwen3 with int8 caches and with K/V replicated to 4
heads; and two configs whose heads do not divide over 4 ranks (qwen3
with 6 query heads, rwkv6 with 6 heads: the first ranks take one head
more, and a rank's query heads may straddle two KV groups).  Each rank's
logits block (its rows over ``(pod, data)``, its vocab columns over
``model``) must stay within 1e-5 of one rank's ``decode_step``, relative
to the largest |logit|, at every step; the parameters are cut by the
default rules (FSDP over ``data``, gathered a layer at a time) and the
caches by ``cache_shardings``.  The same world runs the uneven-heads
qwen3 train step on 1 x 4.

The reference's decode caches for KV heads that do not divide ``model``
(``cache_shardings(kv_shard_seq=, kv_shard_dim=)``): qwen3, dbrx, llava,
seamless with 2 KV heads (its cross leaves) and the uneven-heads qwen3,
each under the sequence cut, the channel cut and int8 with the sequence
cut, qwen3 also int8 with the channel cut, and gemma3's rings of 4 slots
under the sequence cut (the slot's owner wraps to rank 0), each at
positions 4-8, which cross from rank 0's slots to rank 1's.  On 1 x 4 their
2 KV heads do not divide and the K/V leaves are cut on the positions or
the channels; on 2 x 2 they divide and the options change nothing.  Each
is held to one rank within the same 1e-5.

A world of eight ranks takes a train step of qwen3-0.6b on 2 x 2 x 2
(``pod``, ``data``, ``model``: the batch over ``(pod, data)``, FSDP over
``data``, every gradient summed over ``pod``), held to one rank's step
within the tolerances of the reference's
``test_sharded_step_matches_single_device`` (loss 1e-4, ``grad_norm``
1e-3); so is the uneven-heads step.
"""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.configs import ShapeConfig  # noqa: E402
from repro_torch.configs import get_smoke_config as tsmoke  # noqa: E402
from repro_torch.core.executor import (ShardingRules,  # noqa: E402
                                       params_sharding)
from repro_torch.examples import train_sharded as ts  # noqa: E402
from repro_torch.launch.mesh import (make_rank_mesh, run_ranks,  # noqa: E402
                                     shard_params)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.decode import (cache_shardings,  # noqa: E402
                                       decode_step, init_cache)
from repro_torch.train.train_step import init_state  # noqa: E402

B, CACHE, STEPS = 4, 24, 5
F32 = {"dtype": "float32"}
UNEVEN_QWEN3 = {"heads": 6, "kv_heads": 2}
UNEVEN_RWKV = {"d_model": 96, "heads": 6, "head_dim": 16}
# name -> (arch, config overrides, init_cache keywords)
DECODES = {
    "qwen3": ("qwen3-0.6b", {}, {}),
    "dbrx": ("dbrx-132b", {}, {}),
    "rwkv6": ("rwkv6-3b", {}, {}),
    "zamba2": ("zamba2-7b", {}, {}),
    "llava": ("llava-next-34b", {}, {}),
    "seamless": ("seamless-m4t-medium", {}, {}),
    "gemma3-ring": ("gemma3-27b", {"window": 8}, {"ring_local": True}),
    "qwen3-int8": ("qwen3-0.6b", {}, {"quantize_kv": True}),
    "qwen3-kv-repeat": ("qwen3-0.6b", {}, {"kv_repeat_to": 4}),
    "qwen3-6-heads": ("qwen3-0.6b", UNEVEN_QWEN3, {}),
    "rwkv6-6-heads": ("rwkv6-3b", UNEVEN_RWKV, {}),
}
# the reference's decode caches for KV heads that do not divide ``model``
# (2 KV heads on 1 x 4; on 2 x 2 they divide and the options change
# nothing): name -> cache_shardings keywords
SEQ, DIM = {"kv_shard_seq": True}, {"kv_shard_dim": True}
KV_CUTS = {"seq": ({}, SEQ), "dim": ({}, DIM),
           "int8-seq": ({"quantize_kv": True}, SEQ)}
CUT_BASES = {"qwen3": ("qwen3-0.6b", {}),
             "dbrx": ("dbrx-132b", {}),
             "llava": ("llava-next-34b", {}),
             "seamless-kv2": ("seamless-m4t-medium", {"kv_heads": 2}),
             "qwen3-6-heads": ("qwen3-0.6b", UNEVEN_QWEN3)}
SHARD_OPTS = {}
for _base, (_arch, _over) in CUT_BASES.items():
    for _cut, (_kw, _opts) in KV_CUTS.items():
        DECODES[f"{_base}-{_cut}"] = (_arch, _over, _kw)
        SHARD_OPTS[f"{_base}-{_cut}"] = _opts
DECODES["qwen3-int8-dim"] = ("qwen3-0.6b", {}, {"quantize_kv": True})
SHARD_OPTS["qwen3-int8-dim"] = DIM
# a ring of 4 slots, one a rank: position 4 wraps to rank 0's slot
DECODES["gemma3-ring-seq"] = ("gemma3-27b", {"window": 4},
                              {"ring_local": True})
SHARD_OPTS["gemma3-ring-seq"] = SEQ
# the cut caches decode positions 4-8: across ranks 0 and 1 of the
# sequence cut (6 slots each on 1 x 4); those before hold zeros on both
# sides
START = {name: 4 for name in SHARD_OPTS}
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
TOL = 1e-5
LOSS_TOL, GNORM_TOL = 1e-4, 1e-3


def _cfg(name):
    arch, over, _ = DECODES[name]
    return tsmoke(arch).replace(**F32, **over)


def _tokens(cfg, step):
    rng = np.random.default_rng(100 + step)
    return torch.from_numpy(rng.integers(0, cfg.vocab, (B, 1)))


def _params(model):
    return model.init_params(torch.Generator().manual_seed(0))


def _one_rank_logits(name) -> list:
    cfg = _cfg(name)
    model = build_model(cfg)
    params = _params(model)
    cache = init_cache(model, B, CACHE, device="cpu", **DECODES[name][2])
    out = []
    for t in range(STEPS):
        logits, cache = decode_step(model, params, cache, _tokens(cfg, t),
                                    t + START.get(name, 0),
                                    ring_local=DECODES[name][2].get(
                                        "ring_local", False))
        out.append(logits.numpy())
    return out


def _decode_on(mesh, name) -> dict:
    """This rank's logits blocks over the steps, its coordinates and the
    rows / columns they hold."""
    cfg = _cfg(name)
    model = build_model(cfg)
    kw = DECODES[name][2]
    p_sh = params_sharding(model.param_specs(), mesh, ShardingRules())
    params = shard_params(_params(model), p_sh)
    full = init_cache(model, B, CACHE, device="cpu", **kw)
    c_sh = cache_shardings(mesh, model, full, ShapeConfig("d", CACHE, B,
                                                          "decode"),
                           **SHARD_OPTS.get(name, {}))
    cache = shard_params(full, c_sh)
    rows = B // (mesh.shape["data"])
    d = mesh.coords["data"]
    logits = []
    for t in range(STEPS):
        tok = _tokens(cfg, t)[d * rows:(d + 1) * rows]
        out, cache = decode_step(model, params, cache, tok,
                                 t + START.get(name, 0),
                                 ring_local=kw.get("ring_local", False),
                                 mesh=mesh, shardings=p_sh, cache_sh=c_sh)
        logits.append(out.numpy())
    return {"coords": dict(mesh.coords), "rows": rows, "logits": logits}


def _train_on(mesh, arch, overrides):
    """One train step on ``mesh`` from the job's seeded params: loss and
    grad norm."""
    job = {**ts.JOB, "arch": arch, "mesh": None, "overrides": overrides,
           "steps": 1}
    cfg = ts.job_config(job)
    model, fwd, opt, sh, step = ts.build_step(cfg, job, mesh)
    state = init_state(ts.local_params(model, job, mesh, sh.params), opt)
    batch = ts.batch_for(cfg, job, 0, mesh)
    _, metrics = step(state, batch)
    return {"loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "stats": dict(mesh.stats)}


def _decode_rank(world, names):
    out = {}
    for shape, (n_data, n_model) in MESHES.items():
        mesh = make_rank_mesh(world, n_data, n_model)
        for name in names:
            out[(shape, name)] = _decode_on(mesh, name)
    mesh = make_rank_mesh(world, 1, 4)
    out["uneven-train"] = _train_on(mesh, "qwen3-0.6b",
                                    {**F32, **UNEVEN_QWEN3})
    return out


def _pod_rank(world, _):
    mesh = make_rank_mesh(world, 2, 2, 2)
    return {"coords": dict(mesh.coords),
            "layout": (mesh.axis_names, mesh.layout.sizes),
            **_train_on(mesh, "qwen3-0.6b", F32)}


def _world(fn, n, arg, tmp):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return run_ranks(fn, n, device="cpu", init_file=Path(tmp) / "group",
                         args=(arg,), timeout=300)
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def decoded(tmp_path_factory):
    return _world(_decode_rank, 4, list(DECODES),
                  tmp_path_factory.mktemp("decode"))


@pytest.fixture(scope="module")
def single():
    return {name: _one_rank_logits(name) for name in DECODES}


@pytest.mark.parametrize("shape", list(MESHES))
@pytest.mark.parametrize("name", list(DECODES))
def test_sharded_decode_matches_one_rank(decoded, single, shape, name):
    want = single[name]
    top = max(float(np.abs(w).max()) for w in want)
    vocab = want[0].shape[-1]
    n_model = MESHES[shape][1]
    for rank in decoded:
        r = rank[(shape, name)]
        d, m = r["coords"]["data"], r["coords"]["model"]
        cols = vocab // n_model
        assert len(r["logits"]) == STEPS
        for t, got in enumerate(r["logits"]):
            block = want[t][d * r["rows"]:(d + 1) * r["rows"], :,
                            m * cols:(m + 1) * cols]
            assert got.shape == block.shape, (t, got.shape, block.shape)
            err = float(np.abs(got - block).max()) / top
            assert err <= TOL, (shape, name, r["coords"], t, err)


@pytest.mark.parametrize("name", list(SHARD_OPTS))
def test_kv_shard_options_cut_only_what_does_not_divide(name):
    """On 2 x 2 the 2 KV heads divide ``model`` and each option leaves
    the layout as it is; on 1 x 4 every K/V leaf is cut on the option's
    dim and every other leaf is as without it."""
    from repro_torch.launch.mesh import MeshLayout
    cfg = _cfg(name)
    model = build_model(cfg)
    full = init_cache(model, B, CACHE, device="meta", **DECODES[name][2])
    shape = ShapeConfig("d", CACHE, B, "decode")
    opts = SHARD_OPTS[name]
    dim = 4 if opts.get("kv_shard_dim") else 2

    def specs(sizes, **kw):
        sh = cache_shardings(MeshLayout(sizes, ("data", "model")), model,
                             full, shape, **kw)
        return {(g, k): v.spec for g, gc in sh.items()
                for k, v in gc.items()}

    assert specs((2, 2), **opts) == specs((2, 2))
    cut, whole = specs((1, 4), **opts), specs((1, 4))
    for (g, k), spec in cut.items():
        if k.endswith(("_k", "_v", "_xk", "_xv")):
            want = list(whole[(g, k)])
            want[dim] = "model"
            assert list(spec) == want, (g, k)
        else:
            assert spec == whole[(g, k)], (g, k)


def _single_step(arch, overrides):
    """One rank's train step on the job's seeded params and batch 0."""
    from repro_torch.core.executor import plan_and_compile
    from repro_torch.core.ir import SystemCatalog
    from repro_torch.models.lm import CATALOG
    from repro_torch.train.optim import cosine_schedule, make_optimizer
    from repro_torch.train.train_step import make_train_step
    job = {**ts.JOB, "arch": arch, "overrides": overrides}
    cfg = ts.job_config(job)
    model = build_model(cfg)
    fwd = plan_and_compile(model.build_plan(job["batch"], job["seq"],
                                            mode="train"), CATALOG,
                           SystemCatalog(), engines=tuple(job["engines"]),
                           cache=False, device="cpu")
    opt = make_optimizer("adamw", cosine_schedule(job["lr"], 1, 100))
    state = init_state(model.init_params(torch.Generator().manual_seed(
        job["seed"])), opt)
    _, metrics = make_train_step(fwd, opt)(state,
                                           ts.global_batch(cfg, job, 0))
    return float(metrics["loss"]), float(metrics["grad_norm"])


def test_uneven_heads_train_step_matches_one_rank(decoded):
    loss, gnorm = _single_step("qwen3-0.6b", {**F32, **UNEVEN_QWEN3})
    for rank in decoded:
        r = rank["uneven-train"]
        assert abs(r["loss"] - loss) <= LOSS_TOL, (r, loss)
        assert abs(r["grad_norm"] - gnorm) <= GNORM_TOL, (r, gnorm)
        assert r["stats"]["model.all_gather_calls"] > 0


def test_multi_pod_train_step_matches_one_rank(tmp_path):
    ranks = _world(_pod_rank, 8, None, tmp_path)
    loss, gnorm = _single_step("qwen3-0.6b", F32)
    coords = {tuple(sorted(r["coords"].items())) for r in ranks}
    assert len(coords) == 8
    for r in ranks:
        assert r["layout"] == (("pod", "data", "model"), (2, 2, 2))
        assert abs(r["loss"] - loss) <= LOSS_TOL, (r, loss)
        assert abs(r["grad_norm"] - gnorm) <= GNORM_TOL, (r, gnorm)
        # every gradient leaf summed over pod, one collective a leaf; the
        # loss's two sums and the global norm's one
        assert r["stats"]["pod.all_reduce_calls"] > 3
