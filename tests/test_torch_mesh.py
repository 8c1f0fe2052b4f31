"""The port's model-side mesh against the reference's, with no ranks.

  * ``LM.param_specs()`` is the reference's specs tree for all ten archs at
    the smoke and the full config, and makes no tensor; ``abstract_params``
    gives the reference's shapes and dtypes as meta tensors;
  * ``ShardingRules.act_spec`` / ``param_spec`` equal the reference's for
    every dim tuple the models and the reference's constraints use (and
    every pair of dim names), on (data, model) and (pod, data, model)
    layouts, with ``no_fsdp_experts`` False and True (the reference's
    methods read only ``mesh.axis_names``, so a stub stands in);
  * ``state_shardings`` equals the reference's ``state_shardings`` on a
    1 x 1 ``jax`` mesh leaf by leaf (AdamW and Adafactor, with and without
    a master copy), and its shard shapes on 4 x 2 and 2 x 4 layouts are the
    global shapes over the axis sizes;
  * ``input_shardings`` and ``data_spec`` equal the reference's;
  * qwen3 train and dbrx prefill plan ids on 2 x 2 and 4 x 2 equal the
    reference's under equal ``SystemCatalog(mesh_axes=, mesh_shape=)``;
  * ``largest_mesh_shape`` / ``min_model_axis`` equal the reference's on a
    grid, and ``make_production_mesh`` gives the reference's layouts;
  * a dim that does not divide over its axes raises ``ValueError`` naming
    the leaf and the dim.
"""
import itertools
from dataclasses import asdict
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jconfig  # noqa: E402
from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.core import executor as jexec  # noqa: E402
from repro.core import ir as jir  # noqa: E402
from repro.launch import elastic as jelastic  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models.lm import CATALOG as JCAT  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import optim as jopt  # noqa: E402
from repro_torch.configs import get_config as tconfig  # noqa: E402
from repro_torch.configs import get_smoke_config as tsmoke  # noqa: E402
from repro_torch.core import executor as texec  # noqa: E402
from repro_torch.core import ir as tir  # noqa: E402
from repro_torch.launch import elastic as telastic  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402
from repro_torch.models.lm import CATALOG as TCAT  # noqa: E402
from repro_torch.train import optim as topt  # noqa: E402
from repro_torch.train.checkpoint import sharded_leaves  # noqa: E402
from repro_torch.train.train_step import init_state  # noqa: E402

LAYOUTS = {"dm": ("data", "model"), "pdm": ("pod", "data", "model")}
ACT_DIMS = (("batch", None, None), ("batch", None, "heads", None),
            ("batch", None, "kv_heads", None), ("batch", None, "vocab"),
            ("experts", "batch", None), ("batch", "seq"),
            ("batch", "seq", "embed"))


def _is_spec(s):
    return isinstance(s, tuple) and all(isinstance(x, str) for x in s)


def _spec_leaves(tree):
    if _is_spec(tree):
        return [tree]
    return [s for v in tree.values() for s in _spec_leaves(v)]


@pytest.fixture(scope="module")
def specs():
    """``{(arch, smoke): (reference specs, port specs)}``."""
    out = {}
    for arch in ARCH_IDS:
        for smoke, jget, tget in ((True, jsmoke, tsmoke),
                                  (False, jconfig, tconfig)):
            out[arch, smoke] = (jbuild(jget(arch)).param_specs(),
                                tbuild(tget(arch)).param_specs())
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference(specs, arch):
    for smoke in (True, False):
        want, got = specs[arch, smoke]
        assert got == want, (arch, smoke)


def test_param_specs_make_no_tensor(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("param_specs made a tensor")
    for name in ("empty", "zeros", "ones", "full", "randn", "tensor"):
        monkeypatch.setattr(torch, name, refuse)
    for arch in ARCH_IDS:
        tbuild(tconfig(arch)).param_specs()


@pytest.mark.parametrize("arch", ("qwen3-0.6b", "llama4-maverick-400b-a17b",
                                  "zamba2-7b", "seamless-m4t-medium",
                                  "rwkv6-3b", "dbrx-132b"))
def test_abstract_params_are_the_reference_shapes_on_meta(arch):
    want = jbuild(jconfig(arch)).abstract_params()
    got = tbuild(tconfig(arch)).abstract_params()

    def walk(w, g, path):
        if isinstance(w, dict):
            assert set(w) == set(g), path
            for k in w:
                walk(w[k], g[k], path + (k,))
            return
        assert g.device.type == "meta", path
        assert tuple(g.shape) == tuple(w.shape), path
        assert str(g.dtype).split(".")[1] == str(w.dtype), path
    walk(want, got, ())


def _dim_tuples(specs) -> list:
    names = sorted({d for w, _ in specs.values() for s in _spec_leaves(w)
                    for d in s} | {"batch", "heads", "kv_heads", "seq"})
    tuples = {s for w, _ in specs.values() for s in _spec_leaves(w)}
    tuples |= set(ACT_DIMS)
    tuples |= set(itertools.product(names, repeat=2))
    return sorted(tuples, key=str)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("no_fsdp", (False, True))
def test_rule_specs_equal_reference(specs, layout, no_fsdp):
    stub = SimpleNamespace(axis_names=LAYOUTS[layout])
    jr = jexec.ShardingRules(no_fsdp_experts=no_fsdp)
    tr = texec.ShardingRules(no_fsdp_experts=no_fsdp)
    for dims in _dim_tuples(specs):
        assert tr.act_spec(dims, stub) == tuple(jr.act_spec(dims, stub)), dims
        assert tr.param_spec(dims, stub) == tuple(
            jr.param_spec(dims, stub)), dims


def _optimizers(pkg, name, master):
    return pkg.make_optimizer(name, pkg.cosine_schedule(1e-3, 2, 100),
                              master=master)


@pytest.mark.parametrize("name,master", [("adamw", False), ("adamw", True),
                                         ("adafactor", False),
                                         ("adafactor", True)])
def test_state_shardings_equal_reference(name, master):
    for arch in ("qwen3-0.6b", "dbrx-132b"):
        jm, tm = jbuild(jsmoke(arch)), tbuild(tsmoke(arch))
        jsh = jmesh.state_shardings(jax.make_mesh((1, 1), ("data", "model")),
                                    jm, _optimizers(jopt, name, master))
        want = {jckpt._leaf_path(p): tuple(s.spec) for p, s in
                jax.tree_util.tree_flatten_with_path(jsh)[0]}
        topt_ = _optimizers(topt, name, master)
        abstract = init_state(tm.abstract_params(), topt_)
        for sizes in ((1, 1), (4, 2), (2, 4)):
            layout = tmesh.make_cpu_mesh(*sizes)
            tsh = tmesh.state_shardings(layout, tm, topt_)
            leaves = sharded_leaves(abstract, tsh)
            got = {n: tuple(s.spec) for n, _, s in leaves}
            # the reference's (1, 1) specs name the same axes at any size
            assert got == want, (arch, name, master, sizes)
            shape = dict(zip(("data", "model"), sizes))
            for n, leaf, s in leaves:
                full = tuple(leaf.shape)
                div = [int(np.prod([shape[a] for a in (
                    (ax,) if isinstance(ax, str) else (ax or ()))]))
                    for ax in want[n] + (None,) * (len(full) - len(want[n]))]
                assert s.shard_shape(full) == tuple(
                    g // d for g, d in zip(full, div)), (n, sizes)


def test_input_shardings_and_data_spec_equal_reference():
    cfg = tsmoke("qwen3-0.6b")
    inputs = {"tokens": torch.empty((8, 16), dtype=torch.int32,
                                    device="meta"),
              "labels": torch.empty((8, 16), dtype=torch.int32,
                                    device="meta"),
              "frontend_embeds": torch.empty((8, 4, cfg.d_model),
                                             device="meta")}
    for axes in LAYOUTS.values():
        jm = jax.make_mesh((1,) * len(axes), axes)
        want = jmesh.input_shardings(jm, {
            k: jax.ShapeDtypeStruct(tuple(v.shape), np.float32)
            for k, v in inputs.items()})
        got = tmesh.input_shardings(tmesh.MeshLayout((1,) * len(axes), axes),
                                    inputs)
        assert {k: v.spec for k, v in got.items()} == {
            k: tuple(v.spec) for k, v in want.items()}
        assert tmesh.data_spec(tmesh.MeshLayout((1,) * len(axes), axes)) == \
            tuple(jmesh.data_spec(jm))


@pytest.mark.parametrize("sizes", ((2, 2), (4, 2)))
@pytest.mark.parametrize("arch,mode", (("qwen3-0.6b", "train"),
                                       ("dbrx-132b", "prefill")))
def test_plan_ids_on_a_mesh_equal_reference(sizes, arch, mode):
    kw = dict(mesh_axes=("data", "model"), mesh_shape=sizes)
    hw = asdict(jir.HardwareSpec())          # an equal SystemCatalog
    jm, tm = jbuild(jsmoke(arch)), tbuild(tsmoke(arch))
    want = jexec.plan_and_compile(
        jm.build_plan(8, 16, mode=mode), JCAT,
        jir.SystemCatalog(hardware=jir.HardwareSpec(**hw), **kw),
        engines=("xla", "pallas"), cache=False)
    got = texec.plan_and_compile(
        tm.build_plan(8, 16, mode=mode), TCAT,
        tir.SystemCatalog(hardware=tir.HardwareSpec(**hw), **kw),
        engines=("xla", "pallas"), cache=False, device="cpu")
    assert got.plan_id == want.plan_id
    assert got.chosen_impls() == [n.impl for n in want.concrete.topo()]
    layout = tmesh.make_cpu_mesh(*sizes)
    assert tmesh.syscat_for_mesh(layout) == tir.SystemCatalog(**kw)


def test_elastic_shapes_equal_reference():
    for n in range(1, 70):
        for min_model in (1, 2, 4, 8, 16, 32):
            for prefer in (1, 4, 16):
                try:
                    want = jelastic.largest_mesh_shape(
                        n, min_model=min_model, prefer_model=prefer)
                except ValueError:
                    with pytest.raises(ValueError):
                        telastic.largest_mesh_shape(
                            n, min_model=min_model, prefer_model=prefer)
                    continue
                assert telastic.largest_mesh_shape(
                    n, min_model=min_model, prefer_model=prefer) == want
    for pb in (1e6, 2.4e9, 1.6e10, 5.3e11, 1.6e12):
        for hbm in (16e9, 80e9):
            assert telastic.min_model_axis(pb, hbm) == \
                jelastic.min_model_axis(pb, hbm)


def test_production_layouts_are_the_reference_shapes():
    for multi in (False, True):
        got = tmesh.make_production_mesh(multi_pod=multi)
        shape = (2, 16, 16) if multi else (16, 16)
        assert got.sizes == shape and got.size == int(np.prod(shape))
        assert got.axis_names == (("pod", "data", "model") if multi
                                  else ("data", "model"))
    # shard shapes at 512 ranks without starting any
    model = tbuild(tconfig("llama4-maverick-400b-a17b"))
    layout = tmesh.make_production_mesh(multi_pod=True)
    sh = texec.params_sharding(model.param_specs(), layout,
                               texec.ShardingRules())
    wi = sh["layers_0"]["b1_moe"]["wi"]
    full = tuple(model.abstract_params()["layers_0"]["b1_moe"]["wi"].shape)
    assert wi.spec == (None, "model", "data", None)
    assert wi.shard_shape(full) == (full[0], full[1] // 16, full[2] // 16,
                                    full[3])


def test_a_dim_that_does_not_divide_raises():
    model = tbuild(tsmoke("qwen3-0.6b"))          # d_model 64
    sh = texec.params_sharding(model.param_specs(), tmesh.make_cpu_mesh(3, 1),
                               texec.ShardingRules())
    wq = sh["layers_0"]["b0_attn"]["wq"]
    with pytest.raises(ValueError, match=r"layers_0\.b0_attn\.wq.*'embed'"):
        wq.shard_shape((2, 64, 64))
    sh = texec.params_sharding(model.param_specs(), tmesh.make_cpu_mesh(1, 3),
                               texec.ShardingRules())
    with pytest.raises(ValueError, match="'vocab'"):
        sh["embed"]["table"].shard_shape((512, 64))
