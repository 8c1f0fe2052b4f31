"""The port's dry run (``repro_torch.launch.dryrun``) and its op analysis
(``launch/op_analysis.py``) on the CPU.

  * A placeholder rank (``launch.mesh.placeholder_rank_mesh``) calls and
    counts exactly the collectives of a live gloo rank at the same
    coordinates: train, prefill and decode cells on 2 x 2, a train cell on
    2 x 2 x 2 with a ``pod`` axis, key for key on every rank.
  * Against the reference: in a subprocess with 4 host devices (the mesh
    built with ``AxisType.Auto``: the reference's ``jax.make_mesh`` makes
    ``Explicit`` axes on this JAX, which its ``with_sharding_constraint``
    refuses), the reference lowers the qwen3-0.6b and dbrx-132b SMOKE
    prefill and train cells at 8 x 16 on 2 x 2; the port's
    ``argument_bytes`` equal its ``argument_size_in_bytes`` and the qwen3
    prefill's dot FLOPs its ``analyze_hlo`` count, 7,077,888.
  * The analysis rules: the dot count equals ``FlopCounterMode``'s mm /
    bmm total, views cost no bytes, an in-place write its written bytes,
    and a zeros tensor filled out of place right after it is made (a
    backward formula's branch under a dispatch mode) one storage.
  * The CLI writes an ``ok`` record of a production cell.

The ranks import this module to find their entry, so the reference
package is imported only inside the subprocess.
"""
import json
import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.configs import ShapeConfig, get_smoke_config  # noqa: E402
from repro_torch.core.executor import resolve_device  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import (MeshLayout, make_rank_mesh,  # noqa: E402
                                     placeholder_rank_mesh, run_ranks)
from repro_torch.launch.op_analysis import OpAnalysis  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CELLS = {"train": ShapeConfig("train", 16, 8, "train"),
         "prefill": ShapeConfig("prefill", 16, 8, "prefill"),
         "decode": ShapeConfig("decode", 32, 8, "decode")}
# (arch, cell, mesh sizes): (data, model) or (pod, data, model)
LIVE_JOBS = [("qwen3-0.6b", "train", (2, 2)),
             ("qwen3-0.6b", "prefill", (2, 2)),
             ("qwen3-0.6b", "decode", (2, 2)),
             ("qwen3-0.6b", "train", (2, 2, 2)),
             ("dbrx-132b", "train", (2, 2)),
             ("zamba2-7b", "decode", (2, 2)),
             ("seamless-m4t-medium", "prefill", (2, 2, 2)),
             ("qwen3-0.6b", "decode", (1, 4), "kv_shard_seq"),
             ("qwen3-0.6b", "decode", (1, 4), "kv_shard_dim")]
# the reference's decode caches for KV heads that do not divide ``model``
KV_OPTS = {"none": {}, "seq": {"kv_shard_seq": True},
           "dim": {"kv_shard_dim": True},
           "both": {"kv_shard_seq": True, "kv_shard_dim": True}}
# (name, arch, config overrides, init_cache keywords) whose every cache
# leaf's spec is held against the reference's
SPEC_CACHES = (("qwen3-int8", "qwen3-0.6b", {}, {"quantize_kv": True}),
               ("seamless-kv2", "seamless-m4t-medium", {"kv_heads": 2}, {}),
               ("zamba2", "zamba2-7b", {}, {}),
               ("rwkv6", "rwkv6-3b", {}, {}),
               ("gemma3-ring", "gemma3-27b", {}, {"ring_local": True}))
SPEC_MESHES = ((1, 4), (2, 2))
REF_FLOPS_QWEN3_PREFILL = 7_077_888


def _layout(sizes) -> MeshLayout:
    names = ("pod", "data", "model") if len(sizes) == 3 else ("data",
                                                              "model")
    return MeshLayout(tuple(sizes), names)


def _live_rank(world, jobs):
    """One rank of the live world: per job, this rank's coordinates and
    ``RankMesh.stats`` after one step of the cell (None past the mesh)."""
    out = []
    for arch, kind, sizes, *opt in jobs:
        n_pod = sizes[0] if len(sizes) == 3 else 1
        mesh = make_rank_mesh(world, sizes[-2], sizes[-1], n_pod)
        if mesh is None:
            out.append(None)
            continue
        run, _, _ = dryrun.build_cell(get_smoke_config(arch), CELLS[kind],
                                      mesh, opts={o: True for o in opt})
        mesh.reset_stats()
        run()
        out.append({"coords": dict(mesh.coords), "stats": dict(mesh.stats)})
    return out


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    """Every job on a live gloo world of 8 CPU ranks, one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return run_ranks(_live_rank, 8, device="cpu",
                         init_file=tmp_path_factory.mktemp("dr") / "group",
                         args=(LIVE_JOBS,), timeout=300)
    finally:
        torch.set_num_threads(n)


def _placeholder_stats(arch, kind, sizes, coords, opts=None) -> Counter:
    mesh = placeholder_rank_mesh(_layout(sizes), coords)
    run, _, _ = dryrun.build_cell(get_smoke_config(arch), CELLS[kind], mesh,
                                  opts=opts)
    mesh.reset_stats()
    run()
    return mesh.stats


@pytest.mark.parametrize("job", range(len(LIVE_JOBS)),
                         ids=["-".join(map(str, (a, k, "x".join(
                             map(str, s)), *o))) for a, k, s, *o in LIVE_JOBS])
def test_placeholder_collectives_equal_a_live_mesh(live, job):
    torch = pytest.importorskip("torch")  # noqa: F841
    arch, kind, sizes, *opt = LIVE_JOBS[job]
    ranks = [r[job] for r in live if r[job] is not None]
    assert len(ranks) == int(torch.tensor(sizes).prod())
    for r in ranks:
        want = Counter(r["stats"])
        assert want, r
        got = _placeholder_stats(arch, kind, sizes, r["coords"],
                                 {o: True for o in opt})
        assert got == want, (r["coords"], dict(got), dict(want))


def test_placeholder_rank_mesh_shapes_and_counts():
    torch = pytest.importorskip("torch")
    mesh = placeholder_rank_mesh(_layout((2, 16, 16)), {"pod": 1,
                                                         "model": 3})
    assert mesh.coords == {"pod": 1, "data": 0, "model": 3}
    assert mesh.rank == (1 * 16 + 0) * 16 + 3
    x = torch.empty((4, 8), dtype=torch.bfloat16, device="meta")
    assert mesh.axis("model").all_gather(x).shape == (64, 8)
    y = mesh.axis("data").all_reduce(x)
    assert y.shape == x.shape and y.dtype == x.dtype and y.is_meta
    assert mesh.axis("pod").all_to_all(x).shape == x.shape
    assert mesh.stats == Counter({
        "model.all_gather_calls": 1, "model.all_gather_bytes": 64,
        "data.all_reduce_calls": 1, "data.all_reduce_bytes": 64,
        "pod.all_to_all_calls": 1, "pod.all_to_all_bytes": 64})


# --------------------------------------------------------------------------
# against the reference's lowering
# --------------------------------------------------------------------------

_REFERENCE = r'''
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, jax.numpy as jnp
from repro.configs import get_smoke_config
from repro.configs.base import ShapeConfig
from repro.core.executor import ShardingRules, params_sharding, plan_and_compile
from repro.launch.hlo_analysis import analyze_hlo
from repro.launch.mesh import input_shardings, state_shardings, syscat_for_mesh
from repro.models import build_model
from repro.models.lm import CATALOG
from repro.train.optim import cosine_schedule, make_optimizer
from repro.train.train_step import TrainState, make_train_step

mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
out = {}
for arch in sys.argv[1].split(","):
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    rules = ShardingRules()
    for kind in ("prefill", "train"):
        shape = ShapeConfig("cell", 16, 8, kind)
        fwd = plan_and_compile(model.build_plan(8, 16, mode=kind), CATALOG,
                               syscat_for_mesh(mesh), mesh=mesh, rules=rules,
                               engines=("xla",))
        in_sds = model.input_specs(shape)
        in_sh = input_shardings(mesh, in_sds)
        p_abs = model.abstract_params()
        if kind == "train":
            opt = make_optimizer(cfg.optimizer,
                                 cosine_schedule(3e-4, 100, 10000))
            step = make_train_step(fwd, opt, grad_dtype="bfloat16",
                                   num_microbatches=1)
            st_sh = state_shardings(mesh, model, opt, rules)
            st_abs = jax.eval_shape(lambda p: TrainState(
                jnp.zeros((), jnp.int32), p, opt.init(p)), p_abs)
            lowered = jax.jit(step, in_shardings=(st_sh, in_sh),
                              out_shardings=(st_sh, None),
                              donate_argnums=(0,)).lower(st_abs, in_sds)
        else:
            p_sh = params_sharding(model.param_specs(), mesh, rules)
            lowered = jax.jit(lambda p, i: fwd(p, i),
                              in_shardings=(p_sh, in_sh)).lower(p_abs,
                                                                in_sds)
        compiled = lowered.compile()
        out[arch + "/" + kind] = {
            "argument_bytes":
                int(compiled.memory_analysis().argument_size_in_bytes),
            "flops": analyze_hlo(compiled.as_text())["flops"]}

# the decode cell of qwen3 on 1 x 4 (2 KV heads over 4 ranks) under the
# reference's cache layouts, and every cache leaf's spec
from repro.models.decode import decode_step, init_cache
P = jax.sharding.PartitionSpec
meshes = {"1x4": jax.make_mesh((1, 4), ("data", "model"),
                               axis_types=(jax.sharding.AxisType.Auto,) * 2),
          "2x2": mesh}
# imported once the backend is up: the module sets XLA_FLAGS for 512
# host devices, which a live backend ignores
from repro.launch.dryrun import _batch_axes, cache_shardings
kv_opts = json.loads(sys.argv[2])
m14 = meshes["1x4"]
cfg = get_smoke_config("qwen3-0.6b")
model = build_model(cfg)
shape = ShapeConfig("cell", 32, 8, "decode")
for name, opts in kv_opts.items():
    p_sh = params_sharding(model.param_specs(), m14, ShardingRules())
    cache_abs = init_cache(model, 8, 32, abstract=True)
    c_sh = cache_shardings(m14, model, cache_abs, shape, **opts)
    in_sds = model.input_specs(shape)
    tok = jax.sharding.NamedSharding(m14, P(_batch_axes(m14, 8)))
    repl = jax.sharding.NamedSharding(m14, P())
    lowered = jax.jit(lambda p, c, t, i: decode_step(model, p, c, t, i),
                      in_shardings=(p_sh, c_sh, tok, repl),
                      donate_argnums=(1,)).lower(
        model.abstract_params(), cache_abs, in_sds["tokens"],
        in_sds["index"])
    out["qwen3-0.6b/decode/" + name] = {"argument_bytes": int(
        lowered.compile().memory_analysis().argument_size_in_bytes)}
specs = {}
for cname, arch, over, kw in json.loads(sys.argv[3]):
    smodel = build_model(get_smoke_config(arch).replace(**over))
    cache_abs = init_cache(smodel, 8, 32, abstract=True, **kw)
    for mname, m in meshes.items():
        for name, opts in kv_opts.items():
            sh = cache_shardings(m, smodel, cache_abs, shape, **opts)
            specs[f"{cname}/{mname}/{name}"] = {
                f"{g}/{k}": [list(a) if isinstance(a, tuple) else a
                             for a in v.spec]
                for g, gc in sh.items() for k, v in gc.items()}
out["cache_specs"] = specs
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def reference_cells():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _REFERENCE,
                          "qwen3-0.6b,dbrx-132b",
                          json.dumps(KV_OPTS),
                          json.dumps(SPEC_CACHES)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _port_cell(arch, kind) -> dict:
    return dryrun.trace_cell(get_smoke_config(arch), CELLS[kind],
                             placeholder_rank_mesh(_layout((2, 2))))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "dbrx-132b"])
@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_argument_bytes_equal_the_reference(reference_cells, arch, kind):
    torch = pytest.importorskip("torch")  # noqa: F841
    ref = reference_cells[f"{arch}/{kind}"]
    rec = _port_cell(arch, kind)
    print(f"{arch} {kind}: dot flops port {rec['flops']:.0f} reference "
          f"{ref['flops']:.0f}; argument bytes "
          f"{rec['memory']['argument_bytes']} / {ref['argument_bytes']}")
    assert rec["memory"]["argument_bytes"] == ref["argument_bytes"]


@pytest.mark.parametrize("opt", list(KV_OPTS))
def test_decode_argument_bytes_equal_the_reference(reference_cells, opt):
    """The qwen3 decode cell on 1 x 4, where its 2 KV heads do not divide
    ``model``, under the reference's cache layouts."""
    torch = pytest.importorskip("torch")  # noqa: F841
    ref = reference_cells[f"qwen3-0.6b/decode/{opt}"]
    rec = dryrun.trace_cell(get_smoke_config("qwen3-0.6b"), CELLS["decode"],
                            placeholder_rank_mesh(_layout((1, 4))),
                            opts=KV_OPTS[opt])
    assert rec["memory"]["argument_bytes"] == ref["argument_bytes"]


def test_cache_shardings_equal_the_reference(reference_cells):
    """Every leaf's spec of five smoke caches (int8 scales, cross leaves,
    recurrent state and conv, rings) on 1 x 4 and 2 x 2 under each of the
    reference's cache options."""
    from repro_torch.models import build_model
    from repro_torch.models.decode import cache_shardings, init_cache
    want = reference_cells["cache_specs"]
    shape = ShapeConfig("cell", 32, 8, "decode")
    n = 0
    for cname, arch, over, kw in SPEC_CACHES:
        model = build_model(get_smoke_config(arch).replace(**over))
        cache = init_cache(model, 8, 32, device="meta", **kw)
        for sizes in SPEC_MESHES:
            for name, opts in KV_OPTS.items():
                sh = cache_shardings(_layout(sizes), model, cache, shape,
                                     **opts)
                got = {f"{g}/{k}": [list(a) if isinstance(a, tuple) else a
                                    for a in v.spec]
                       for g, gc in sh.items() for k, v in gc.items()}
                key = f"{cname}/{'x'.join(map(str, sizes))}/{name}"
                assert got == want[key], key
                n += len(got)
    assert n > 0


def test_kv_shard_options_reach_the_decode_cell():
    """``lower_cell``'s ``opts`` reach ``cache_shardings``: on 1 x 4, where
    qwen3's 2 KV heads do not divide ``model``, either cut holds a quarter
    of the K/V a rank, and on 2 x 2, where they divide, neither changes the
    step."""
    torch = pytest.importorskip("torch")  # noqa: F841
    cfg = get_smoke_config("qwen3-0.6b")

    def arg_bytes(sizes, opts):
        rec = dryrun.trace_cell(cfg, CELLS["decode"],
                                placeholder_rank_mesh(_layout(sizes)),
                                opts=opts)
        return rec["memory"]["argument_bytes"]

    whole = arg_bytes((1, 4), {})
    # the whole cache: K and V (layers, B, S, KV, D) of every layer
    from repro_torch.models import build_model
    from repro_torch.models.decode import init_cache
    kv = sum(leaf.numel() * leaf.element_size() for gc in init_cache(
        build_model(cfg), 8, 32, device="meta").values()
        for leaf in gc.values())
    for name in ("seq", "dim", "both"):
        assert arg_bytes((1, 4), KV_OPTS[name]) == whole - kv + kv // 4, name
        assert arg_bytes((2, 2), KV_OPTS[name]) == arg_bytes((2, 2), {})


def test_qwen3_prefill_flops_equal_analyze_hlo(reference_cells):
    torch = pytest.importorskip("torch")  # noqa: F841
    rec = _port_cell("qwen3-0.6b", "prefill")
    assert reference_cells["qwen3-0.6b/prefill"]["flops"] == \
        REF_FLOPS_QWEN3_PREFILL
    assert rec["flops"] == REF_FLOPS_QWEN3_PREFILL


# --------------------------------------------------------------------------
# the analysis rules
# --------------------------------------------------------------------------

def test_dot_flops_equal_flop_counter_mode():
    torch = pytest.importorskip("torch")
    from torch.utils.flop_counter import FlopCounterMode
    aten = torch.ops.aten
    cfg = get_smoke_config("qwen3-0.6b")
    for kind in ("train", "prefill", "decode"):
        run, args, _ = dryrun.build_cell(
            cfg, CELLS[kind], placeholder_rank_mesh(_layout((2, 2))))
        with OpAnalysis(args) as oa:
            run()
        run, _, _ = dryrun.build_cell(
            cfg, CELLS[kind], placeholder_rank_mesh(_layout((2, 2))))
        fc = FlopCounterMode(display=False)
        with fc:
            run()
        counts = fc.get_flop_counts()["Global"]
        dots = sum(counts.get(op, 0) for op in (aten.mm, aten.bmm,
                                                aten.addmm, aten.baddbmm))
        assert oa.flops == dots == fc.get_total_flops() > 0, kind


def test_views_cost_nothing_and_in_place_writes_their_bytes():
    torch = pytest.importorskip("torch")
    x = torch.empty((64, 32), dtype=torch.float32, device="meta")
    v = torch.empty((4, 32), dtype=torch.float32, device="meta")
    rows = torch.empty((4,), dtype=torch.long, device="meta")
    with OpAnalysis((x, v, rows)) as oa:
        x.view(32, 64)
        x.t()
        x[8:16]
        x.reshape(-1)
    assert oa.written == 0 and oa.peak == 0
    with OpAnalysis((x, v, rows)) as oa:
        x.add_(1.0)
    assert oa.written == x.numel() * 4 and oa.peak == 0
    with OpAnalysis((x, v, rows)) as oa:
        x[rows] = v
    assert oa.written == v.numel() * 4
    with OpAnalysis((x, v, rows)) as oa:
        y = x * 2.0
        z = y + 1.0
        del y
        w = z + 1.0                                # y's storage is free
    rec = oa.result(outputs=w)
    assert rec["hbm_bytes"] == 2 * 3 * x.numel() * 4
    # a backward formula's zeros filled out of place (its branch under a
    # dispatch mode) counts as the in-place fill it is without one
    idx = torch.empty((4, 32), dtype=torch.long, device="meta")
    with OpAnalysis((x, v, idx)) as oa:
        torch.zeros_like(x).scatter_add(0, idx, v)
    assert oa.peak == x.numel() * 4
    assert oa.written == x.numel() * 4 + v.numel() * 4
    assert rec["memory"] == {"argument_bytes": (64 * 32 + 4 * 32) * 4 + 32,
                             "output_bytes": x.numel() * 4,
                             "temp_bytes": 2 * x.numel() * 4}


def test_meta_is_taken_only_when_named_and_no_kernel_accepts_it():
    torch = pytest.importorskip("torch")
    assert resolve_device("meta").type == "meta"
    assert resolve_device("cpu").type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device()
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gmm import gmm
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.wkv6 import wkv6
    m = dict(device="meta", dtype=torch.bfloat16)
    q = torch.empty((1, 64, 2, 64), **m)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, q, q)
    r = torch.empty((1, 64, 2, 16), **m)
    with pytest.raises(ValueError, match="CUDA"):
        wkv6(r, r, r, r, torch.empty((2, 16), **m))
    with pytest.raises(ValueError, match="CUDA"):
        ssd(r, torch.empty((1, 64, 2), **m), r, r)
    with pytest.raises(ValueError, match="CUDA"):
        gmm(torch.empty((2, 8, 16), **m), torch.empty((2, 16, 8), **m))


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

def test_cli_writes_an_ok_record(tmp_path):
    torch = pytest.importorskip("torch")  # noqa: F841
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-0.6b", "--shape", "train_4k", "--out", str(tmp_path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads((tmp_path / "qwen3-0.6b__train_4k__singlepod.json")
                     .read_text())
    assert rec["status"] == "ok", rec.get("error")
    assert rec["mesh"] == {"data": 16, "model": 16} and rec["devices"] == 256
    assert rec["flops"] > 0 and rec["wire_bytes"] > 0
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["memory"]["generated_code_bytes"] is None
    assert rec["collectives"]["all_gather"]["by_axis"]["data"]["count"] > 0
