"""The dry run: every (architecture x input shape) cell traced for one rank
of the production meshes, with no card and nothing allocated.

The port's counterpart of the reference package's ``launch/dryrun.py``.
The reference lowers and compiles each cell's step for 256 or 512
placeholder devices and reads XLA's memory analysis and the post-SPMD
HLO.  The port has no compiler and no partitioner: its ranks run the
sharded step themselves (the layers call their collectives), so a cell
here is one rank's step, planned with ``engines=("xla",)`` as the
reference's, run through the port's own code on the meta device
(``launch/op_analysis.py`` records its ops) on a rank with no world behind
it (``launch.mesh.placeholder_rank_mesh``: its collectives return tensors
of the right shapes and count what a live rank's would).  The rank traced
is the one at coordinates 0: a dim cut over a mesh axis must divide (no
padded uneven shards), so every rank holds blocks of one shape, and where
the heads do not divide over ``model`` rank 0 takes a largest block
(``layers.attention.head_block``).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
  python -m repro_torch.launch.dryrun --all --both-meshes [--out DIR]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from ..configs import ARCH_IDS, SHAPES, get_config, shape_cells
from ..core.executor import (Sharding, ShardingRules, params_sharding,
                             plan_and_compile)
from ..models import build_model
from ..models.decode import (batch_spec, cache_shardings, decode_step,
                             init_cache)
from ..models.lm import CATALOG
from ..train.optim import cosine_schedule, make_optimizer
from ..train.train_step import init_state, make_train_step
from .mesh import (input_shardings, make_production_mesh,
                   placeholder_rank_mesh, shard_params, state_shardings,
                   syscat_for_mesh)
from .op_analysis import OpAnalysis, storage_bytes

INFERENCE_RULES = ShardingRules(param=tuple(
    (d, ax) for d, ax in ShardingRules().param if d != "embed"))
# inference: no optimizer state exists, so there is no reason to FSDP the
# weights over ``data``: dropping the "embed" -> data rule removes the
# per-layer weight all-gathers (weights tensor-parallel, whole over data)


def cell_rules(opts: dict, kind: str) -> ShardingRules:
    """The sharding rules of a cell under ``opts``, as the reference
    reads them (``rules``, ``inference_rules``, ``no_fsdp``,
    ``expert_nofsdp``)."""
    rules = opts.get("rules") or ShardingRules()
    if opts.get("inference_rules") and kind != "train":
        rules = INFERENCE_RULES
    if opts.get("no_fsdp"):
        rules = INFERENCE_RULES
    if opts.get("expert_nofsdp"):
        rules = ShardingRules(act=rules.act, param=rules.param,
                              no_fsdp_experts=True)
    return rules


def cell_config(arch: str, opts: dict):
    """``arch``'s config with the cell's ``cfg_overrides``."""
    cfg = get_config(arch)
    if opts.get("cfg_overrides"):
        cfg = cfg.replace(**opts["cfg_overrides"])
    return cfg


def build_cell(cfg, shape, mesh, *, opts=None):
    """One rank's step of a cell on ``mesh`` (a rank mesh, live or a
    placeholder), built as the reference's ``lower_cell`` builds it.
    Returns ``(run, arguments, fwd)``: ``run()`` takes the step and
    returns its outputs, ``arguments`` are the rank's blocks it reads
    (the train state or the params, the inputs, the cache), made on the
    mesh's device (meta tensors on a placeholder; zeros elsewhere)."""
    opts = opts or {}
    model = build_model(cfg)
    rules = cell_rules(opts, shape.kind)
    dev = mesh.device
    syscat = syscat_for_mesh(mesh)
    p_sh = params_sharding(model.param_specs(), mesh, rules)

    def blocks(tree, shardings):
        """The rank's blocks of a global meta tree, on the rank's device."""
        out = shard_params(tree, shardings)
        return on_device(out, dev)

    if shape.kind in ("train", "prefill"):
        mode = "train" if shape.kind == "train" else "prefill"
        fwd = plan_and_compile(
            model.build_plan(shape.global_batch, shape.seq_len, mode=mode),
            CATALOG, syscat, engines=("xla",), device=dev, mesh=mesh,
            rules=rules, param_specs=model.param_specs())
        specs = model.input_specs(shape)
        in_sh = input_shardings(mesh, specs)
        inputs = {k: on_device(in_sh[k].block(v), dev)
                  for k, v in specs.items()}
        if shape.kind == "train":
            okw = {"master": True} if opts.get("master") else {}
            opt = make_optimizer(cfg.optimizer,
                                 cosine_schedule(3e-4, 100, 10000), **okw)
            step = make_train_step(
                fwd, opt, grad_dtype=opts.get("grad_dtype", "bfloat16"),
                num_microbatches=opts.get("num_microbatches", 1))
            st_sh = state_shardings(mesh, model, opt, rules)
            state = blocks(init_state(model.abstract_params(), opt), st_sh)
            return (lambda: step(state, inputs)), (state, inputs), fwd
        params = blocks(model.abstract_params(), p_sh)

        def prefill():
            with torch.inference_mode():
                return fwd(params, inputs)
        return prefill, (params, inputs), fwd
    ring = opts.get("ring_local", False)
    params = blocks(model.abstract_params(), p_sh)
    cache = init_cache(model, shape.global_batch, shape.seq_len,
                       device="meta", ring_local=ring,
                       kv_repeat_to=opts.get("kv_repeat_tp", 0),
                       quantize_kv=opts.get("quantize_kv", False))
    c_sh = cache_shardings(mesh, model, cache, shape,
                           kv_shard_seq=opts.get("kv_shard_seq", False),
                           kv_shard_dim=opts.get("kv_shard_dim", False))
    cache = blocks(cache, c_sh)
    specs = model.input_specs(shape)
    tok_sh = Sharding(mesh, (batch_spec(mesh, shape.global_batch), None),
                      "tokens")
    tokens = on_device(tok_sh.block(specs["tokens"]), dev)
    index = on_device(specs["index"], dev)

    def serve_step():
        return decode_step(model, params, cache, tokens, index,
                           ring_local=ring, mesh=mesh, shardings=p_sh,
                           cache_sh=c_sh)
    return serve_step, (params, cache, tokens, index), None


def on_device(tree, dev):
    """A meta tree as zeros on ``dev`` (itself on meta)."""
    if isinstance(tree, dict):
        return {k: on_device(v, dev) for k, v in tree.items()}
    if hasattr(tree, "params") and hasattr(tree, "opt_state"):
        return type(tree)(on_device(tree.step, dev),
                          on_device(tree.params, dev),
                          on_device(tree.opt_state, dev))
    if dev.type == "meta":
        return tree
    return torch.zeros(tree.shape, dtype=tree.dtype, device=dev)


def trace_cell(cfg, shape, mesh, *, opts=None) -> dict:
    """Build and run one rank's step of a cell under :class:`OpAnalysis`
    (``mesh``'s counters are reset first and hold the step's after);
    returns the analysis record with ``state_bytes`` (those of the train
    state or the params), ``selected`` (the plan's choices) and
    ``t_trace_s``."""
    t0 = time.perf_counter()
    run, arguments, fwd = build_cell(cfg, shape, mesh, opts=opts)
    mesh.reset_stats()
    with OpAnalysis(arguments) as oa:
        out = run()
    rec = oa.result(outputs=out, mesh=mesh)
    rec["state_bytes"] = storage_bytes(arguments[0])
    rec["selected"] = ([(r["pattern"], r["chosen"]) for r in fwd.report]
                       if fwd is not None else [])
    rec["t_trace_s"] = round(time.perf_counter() - t0, 3)
    return rec


def lower_cell(arch: str, shape_name: str, layout, *, opts=None) -> dict:
    """Trace one (arch x shape) cell for the rank at coordinates 0 of
    ``layout`` (a ``MeshLayout``) on the meta device; return the record,
    keyed as the reference's (``t_lower_s`` / ``t_compile_s`` are
    ``t_trace_s``; no XLA, so its raw cost terms and the generated code
    size are null)."""
    opts = opts or {}
    cfg = cell_config(arch, opts)
    shape = SHAPES[shape_name]
    mesh = placeholder_rank_mesh(layout)
    rec = trace_cell(cfg, shape, mesh, opts=opts)
    rec["memory"]["generated_code_bytes"] = None
    return {"arch": arch, "shape": shape_name,
            "mesh": {a: int(s) for a, s in layout.shape.items()},
            "devices": int(layout.size), "coords": dict(mesh.coords),
            "flops": rec["flops"], "hbm_bytes": rec["hbm_bytes"],
            "collectives": rec["collectives"],
            "wire_bytes": rec["wire_bytes"],
            "xla_flops_raw": None, "xla_bytes_raw": None,
            "memory": rec["memory"], "selected": rec["selected"],
            "aten_ops": rec["ops"], "t_trace_s": rec["t_trace_s"],
            "opts": {k: v for k, v in opts.items() if k != "rules"}}


# --------------------------------------------------------------------------
# every cell of a layout
# --------------------------------------------------------------------------

def run_all(out_dir: str, *, multi_pod: bool, only_arch=None,
            only_shape=None, opts=None) -> list:
    """Every cell on the single- or multi-pod layout, one JSON record a
    cell in ``out_dir``; a cell that raises is recorded with its
    traceback (``status: "fail"``)."""
    os.makedirs(out_dir, exist_ok=True)
    layout = make_production_mesh(multi_pod=multi_pod)
    tag = "multipod" if multi_pod else "singlepod"
    results = []
    for arch in ARCH_IDS:
        if only_arch and arch != only_arch:
            continue
        for shape in shape_cells(get_config(arch)):
            if only_shape and shape.name != only_shape:
                continue
            name = f"{arch}__{shape.name}__{tag}"
            print(f"[dryrun] {name} ...", flush=True)
            try:
                rec = lower_cell(arch, shape.name, layout, opts=opts)
                rec["status"] = "ok"
                mem = rec["memory"]
                print(f"  ok: flops={rec['flops']:.3e} "
                      f"args={mem['argument_bytes']:.3e} "
                      f"temp={mem['temp_bytes']:.3e} "
                      f"coll_wire={rec['wire_bytes']:.3e} "
                      f"trace={rec['t_trace_s']}s", flush=True)
            except Exception as e:
                rec = {"arch": arch, "shape": shape.name, "status": "fail",
                       "error": "".join(
                           traceback.format_exception(e))[-4000:]}
                print(f"  FAIL: {e}", flush=True)
            with open(os.path.join(out_dir, name + ".json"), "w") as fh:
                json.dump(rec, fh, indent=1)
            results.append(rec)
    ok = sum(1 for r in results if r.get("status") == "ok")
    print(f"[dryrun] {ok}/{len(results)} cells ok ({tag})", flush=True)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--ring-local", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)

    opts = {"ring_local": args.ring_local} if args.ring_local else {}
    if not (args.all or args.arch):
        ap.print_help()
        return []
    results = run_all(args.out, multi_pod=args.multi_pod,
                      only_arch=args.arch, only_shape=args.shape, opts=opts)
    if args.both_meshes:
        results += run_all(args.out, multi_pod=True, only_arch=args.arch,
                           only_shape=args.shape, opts=opts)
    return results


if __name__ == "__main__":
    main()
