"""Training on a (data, model) mesh of ranks: the port's sharded train step
end to end.

Every rank builds the model and its global parameters from one seed (or
takes the caller's), keeps its blocks (``state_shardings`` ->
``shard_params``) and its rows of each batch (``input_shardings``; the
vlm's and encdec's ``frontend_embeds`` too), plans the train step with
``plan_and_compile(..., mesh=, param_specs=)`` and steps: the flash,
wkv6 and ssd kernels run on the rank's heads, the layers' collectives go
through the mesh's sub-groups.  After ``save_at`` steps it saves the
state (the global leaves, written once), re-meshes the same world
(``launch.elastic.remesh``), restores the checkpoint onto the new mesh and
steps on.  :func:`rank_forward` is the prefill forward on a mesh (the MoE
family's experts cut over ``model``).

    PYTHONPATH=src python -m repro_torch.examples.train_sharded \\
        --arch qwen3-0.6b --smoke --mesh 2x2 --remesh-min-model 4 \\
        --device cpu

``--arch`` takes every family (rwkv6-3b, zamba2-7b, llava-next-34b,
seamless-m4t-medium, dbrx-132b, ...).
"""
from __future__ import annotations

import argparse
import statistics
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from .. import kernels
from ..configs import get_config, get_smoke_config
from ..core import tracing
from ..core.executor import plan_and_compile
from ..data.pipeline import DataConfig, synth_batch
from ..launch.elastic import remesh
from ..layers.common import torch_dtype
from ..launch.train import device_batch
from ..launch.mesh import (gather_state, input_shardings, make_rank_mesh,
                           run_ranks, shard_params, state_shardings,
                           syscat_for_mesh)
from ..models import build_model
from ..models.lm import CATALOG, params_from_numpy
from ..train.checkpoint import (restore_checkpoint, save_checkpoint,
                                sharded_leaves)
from ..train.optim import cosine_schedule, make_optimizer
from ..train.train_step import init_state, make_train_step

# a job's defaults: the model, the mesh, the batch, the optimizer, the
# steps; ``params`` (a numpy tree) replaces the seeded draw; ``save_at``
# saves after that step, then ``remesh`` (elastic.remesh's keywords)
# restores onto a new mesh for the remaining steps
JOB = {"arch": "qwen3-0.6b", "smoke": True, "overrides": {},
       "mesh": (2, 2), "batch": 8, "seq": 16, "engines": ("xla", "pallas"),
       "seed": 0, "params": None, "optimizer": "adamw", "master": False,
       "lr": 1e-3, "steps": 2, "save_at": None, "ckpt_dir": None,
       "remesh": None, "return_params": False, "staggered_init": False}


def job_config(job):
    cfg = (get_smoke_config if job["smoke"] else get_config)(job["arch"])
    return cfg.replace(**job["overrides"]) if job["overrides"] else cfg


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def global_params(model, job, mesh, *, inference=False):
    """The global parameters on the rank's device: the job's numpy tree,
    or drawn from its seed (``inference``: the cast tree of
    ``init_inference_params``)."""
    if job["params"] is not None:
        return params_from_numpy(job["params"], mesh.device)
    gen = torch.Generator(device=mesh.device).manual_seed(int(job["seed"]))
    return (model.init_inference_params(gen) if inference
            else model.init_params(gen))


def local_params(model, job, mesh, shardings, *, inference=False):
    """This rank's blocks of the global parameters.  With
    ``staggered_init`` the ranks draw the global tree one after another, so
    only one global tree is alive on a shared card at a time."""
    def draw():
        return shard_params(global_params(model, job, mesh,
                                          inference=inference), shardings)
    if not job["staggered_init"]:
        return draw()
    out = None
    for r in range(int(mesh.world.world)):
        if mesh.rank == r:
            out = draw()
            _sync(mesh.device)
            if mesh.device.type == "cuda":
                torch.cuda.empty_cache()
        mesh.barrier()
    return out


def data_config(cfg, job) -> DataConfig:
    """The job's ``synth_batch`` stream: its seed, batch and sequence,
    and the config's frontend (the vlm's prefix embeddings, the encdec
    frames), as the train CLI's."""
    return DataConfig(vocab=cfg.vocab, seq_len=int(job["seq"]),
                      global_batch=int(job["batch"]), seed=int(job["seed"]),
                      frontend_tokens=cfg.frontend_tokens,
                      d_model=cfg.d_model, encdec=cfg.family == "encdec",
                      dtype=cfg.dtype)


def global_batch(cfg, job, step: int, device="cpu") -> dict:
    """``synth_batch``'s global batch at ``step`` as tensors on ``device``,
    the frontend embeddings in the config's dtype (the train CLI's
    ``device_batch``)."""
    return device_batch(synth_batch(data_config(cfg, job), step), device,
                        torch_dtype(cfg.dtype))


def batch_for(cfg, job, step: int, mesh, in_sh=None):
    """This rank's rows of ``synth_batch`` (the job's seed) at ``step``."""
    glob = global_batch(cfg, job, step)
    in_sh = in_sh or input_shardings(mesh, glob)
    return {k: in_sh[k].block(v).to(mesh.device) for k, v in glob.items()}


def build_step(cfg, job, mesh):
    """``(model, fwd, optimizer, shardings, step)`` of the job on
    ``mesh``."""
    model = build_model(cfg)
    fwd = plan_and_compile(
        model.build_plan(int(job["batch"]), int(job["seq"]), mode="train"),
        CATALOG, syscat_for_mesh(mesh), engines=tuple(job["engines"]),
        cache=False, device=mesh.device, mesh=mesh,
        param_specs=model.param_specs())
    opt = make_optimizer(job["optimizer"],
                         cosine_schedule(float(job["lr"]), 1, 100),
                         master=bool(job["master"]))
    shardings = state_shardings(mesh, model, opt)
    return model, fwd, opt, shardings, make_train_step(fwd, opt)


def state_spec_bytes(model, opt, shardings) -> int:
    """The bytes of one rank's params + optimizer state, counted from the
    specs: each leaf's shard shape (of its global meta shape) times its
    dtype's size."""
    abstract = init_state(model.abstract_params(), opt)
    return sum(int(np.prod(sh.shard_shape(leaf.shape))) * leaf.element_size()
               for part in ("params", "opt_state")
               for _, leaf, sh in sharded_leaves(
                   getattr(abstract, part), getattr(shardings, part)))


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.array(tree.detach().float().cpu())           # a copy


def run_steps(mesh, cfg, job, state, step_fn, steps, report):
    """``steps`` train steps from the state's step count; appends each
    step's loss, grad norm, wall, the mesh's collective counts and the
    kernels' launches (both set to 0 just before the step) to
    ``report``."""
    dev = mesh.device
    in_sh = None
    for _ in range(int(steps)):
        i = int(state.step)
        batch = batch_for(cfg, job, i, mesh, in_sh)
        mesh.barrier()
        _sync(dev)
        mesh.reset_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        _sync(dev)
        report["walls_s"].append(time.perf_counter() - t0)
        report["losses"].append(loss)
        report["grad_norms"].append(gnorm)
        report["stats"].append(dict(mesh.stats))
        report["launches"].append(
            {k: v for k, v in kernels.launches().items() if v})
    return state


def rank_run(world, job: dict) -> dict:
    """One rank of the sharded training job ``job`` (:data:`JOB`'s keys).
    Returns this rank's report: coordinates, plan id, per step loss /
    grad norm / wall / collectives / launches, the state's bytes against
    the specs' count, peak memory on a card; after a re-mesh the same for
    the new mesh under ``after``; with ``return_params`` the gathered
    params (numpy, float32) at the end of each mesh."""
    job = {**JOB, **job}
    cfg = job_config(job)
    mesh = make_rank_mesh(world, *job["mesh"])
    model, fwd, opt, shardings, step_fn = build_step(cfg, job, mesh)
    state = init_state(local_params(model, job, mesh, shardings.params), opt)
    report = _report(mesh, fwd, state, model, opt, shardings)
    first = job["save_at"] or job["steps"]
    state = run_steps(mesh, cfg, job, state, step_fn, first, report)
    if job["save_at"]:
        t0 = time.perf_counter()
        report["ckpt"] = save_checkpoint(job["ckpt_dir"], int(state.step),
                                         state, shardings=shardings)
        report["save_s"] = time.perf_counter() - t0
        if job["return_params"]:
            report["saved_params"] = _numpy_tree(
                gather_state(state.params, shardings.params))
        state = run_steps(mesh, cfg, job, state, step_fn,
                          int(job["steps"]) - first, report)
    if job["return_params"]:
        report["params"] = _numpy_tree(gather_state(state.params,
                                                    shardings.params))
    _peak(mesh, report)
    if job["remesh"] is None:
        return report
    del state
    mesh2 = remesh(world, **job["remesh"])
    job2 = {**job, "mesh": tuple(mesh2.layout.sizes)}
    model, fwd, opt, shardings, step_fn = build_step(cfg, job2, mesh2)
    template = init_state(shard_params(model.abstract_params(),
                                       shardings.params), opt)
    t0 = time.perf_counter()
    state = restore_checkpoint(report["ckpt"], template, shardings=shardings)
    after = _report(mesh2, fwd, state, model, opt, shardings)
    after["restore_s"] = time.perf_counter() - t0
    after["restored_mismatches"] = restored_mismatches(report["ckpt"],
                                                       state, shardings)
    if job["return_params"]:
        after["restored_params"] = _numpy_tree(
            gather_state(state.params, shardings.params))
    state = run_steps(mesh2, cfg, job, state, step_fn, 1, after)
    if job["return_params"]:
        after["params"] = _numpy_tree(gather_state(state.params,
                                                   shardings.params))
    _peak(mesh2, after)
    report["after"] = after
    return report


def _report(mesh, fwd, state, model, opt, shardings) -> dict:
    return {"rank": mesh.rank, "coords": dict(mesh.coords),
            "mesh": tuple(mesh.layout.sizes), "plan_id": fwd.plan_id,
            "state_bytes": tracing.tree_bytes(state.params)
            + tracing.tree_bytes(state.opt_state),
            "spec_bytes": state_spec_bytes(model, opt, shardings),
            "losses": [], "grad_norms": [], "walls_s": [], "stats": [],
            "launches": []}


def _peak(mesh, report):
    if mesh.device.type == "cuda":
        report["peak_gb"] = torch.cuda.max_memory_allocated(mesh.device) / 1e9


def restored_mismatches(path, state, shardings) -> list:
    """The leaves of the restored ``state`` that are not this rank's block
    of the checkpoint's file bit for bit (read again from the files)."""
    bad = []
    for name, leaf, sh in sharded_leaves(state, shardings):
        arr = np.load(f"{path}/{name}.npy", mmap_mode="r")
        want = np.array(arr[sh.index(arr.shape)])
        got = leaf.detach().cpu()
        got = (got.view(torch.int16).numpy().view(np.uint16)
               if got.dtype == torch.bfloat16 else got.numpy())
        if got.dtype != want.dtype or not np.array_equal(got, want):
            bad.append(name)
    return bad


def rank_forward(world, job: dict) -> dict:
    """One rank of the prefill forward on a mesh: the job's model (its
    parameters cast as the serving tree), planned with ``mode="prefill"``
    and run on this rank's rows of ``synth_batch``'s inputs (the tokens,
    and the vlm's and encdec's ``frontend_embeds``), twice.
    Returns the plan id, the chosen impls, the launches, wall and
    collectives of the second run (counts set to 0 just before it) and
    this rank's logits block (rows over ``data``, vocab over ``model``) as
    numpy — or, when the job has ``check_logits`` (a module-level
    ``fn(logits, mesh, job)``), only that function's result."""
    job = {**JOB, **job}
    cfg = job_config(job)
    mesh = make_rank_mesh(world, *job["mesh"])
    model = build_model(cfg)
    fwd = plan_and_compile(
        model.build_plan(int(job["batch"]), int(job["seq"]), mode="prefill"),
        CATALOG, syscat_for_mesh(mesh), engines=tuple(job["engines"]),
        cache=False, device=mesh.device, mesh=mesh,
        param_specs=model.param_specs())
    p_sh = state_shardings(mesh, model, make_optimizer(
        "adamw", cosine_schedule(1e-3, 1, 100))).params
    params = local_params(model, job, mesh, p_sh, inference=True)
    inputs = {k: v for k, v in batch_for(cfg, job, 0, mesh).items()
              if k != "labels"}
    with torch.inference_mode():
        fwd(params, inputs)
        mesh.barrier()
        _sync(mesh.device)
        mesh.reset_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        logits = fwd(params, inputs)
        _sync(mesh.device)
        wall = time.perf_counter() - t0
    out = {"rank": mesh.rank, "coords": dict(mesh.coords),
           "plan_id": fwd.plan_id, "impls": fwd.chosen_impls(),
           "wall_s": wall, "stats": dict(mesh.stats),
           "launches": {k: v for k, v in kernels.launches().items() if v},
           "logits_shape": tuple(logits.shape)}
    check = job.get("check_logits")
    if check is not None:
        out["logits_err"] = check(logits, mesh, job)
    else:
        out["logits"] = logits.float().cpu().numpy()
    _peak(mesh, out)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--mesh", default="2x2", help="data x model")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--remesh-min-model", type=int, default=None,
                    help="after step 2, save, re-mesh with this model axis "
                         "at least, restore and take one more step")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    d, m = (int(x) for x in args.mesh.split("x"))
    with tempfile.TemporaryDirectory() as tmp:
        job = {"arch": args.arch, "smoke": args.smoke, "mesh": (d, m),
               "batch": args.batch, "seq": args.seq, "steps": args.steps,
               "staggered_init": args.device != "cpu"}
        if args.remesh_min_model:
            job.update(save_at=min(2, args.steps), ckpt_dir=f"{tmp}/ckpt",
                       remesh={"min_model": args.remesh_min_model})
        ranks = run_ranks(rank_run, d * m, device=args.device,
                          init_file=Path(tmp) / "group", args=(job,))
    head = ranks[0]
    print(f"{args.arch} on a {d} x {m} mesh ({args.device}): plan "
          f"{head['plan_id'][:12]}")
    print("losses: " + ", ".join(f"{x:.5f}" for x in head["losses"]))
    print("grad norms: " + ", ".join(f"{x:.5f}" for x in head["grad_norms"]))
    print(f"step wall (median) {statistics.median(head['walls_s']):.3f} s; "
          f"state bytes a rank {head['state_bytes']} (specs: "
          f"{head['spec_bytes']})")
    print(f"collectives of the last step: {head['stats'][-1]}")
    if "after" in head:
        a = head["after"]
        bitwise = not any(r["after"]["restored_mismatches"] for r in ranks)
        print(f"re-meshed onto {a['mesh'][0]} x {a['mesh'][1]}: restored "
              f"bitwise {bitwise}, next loss {a['losses'][0]:.5f}")


if __name__ == "__main__":
    main()
