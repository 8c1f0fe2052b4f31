"""The sharded tri-store on the port: the influencer rollup with every store
partitioned over a mesh of ranks.

The port's copy of the sharded half of the reference's
``benchmarks/tri_store_sharded.py``: the tweet table and the influencer
table row-partitioned, the hashtag graph dst-block partitioned and the
corpus document-partitioned (``with_shards``), planned with
``syscat_for_mesh`` so the planner stamps ``dist`` attrs and kinds the
xfers, and run through ``repro_torch.compile(..., mesh=)`` on every rank
of a ``torch.distributed`` world (:func:`~repro_torch.launch.mesh.
run_ranks`).  Every rank returns the same global output.  The one-shard
case is :mod:`.tri_influence`.

:func:`build_workload` draws from the numpy ``RandomState`` in the
reference's order, so one seed gives the reference's arrays.

    PYTHONPATH=src python -m repro_torch.examples.tri_sharded \\
        [--world 2] [--device cuda|cpu] [--engines xla|xla,pallas]
"""
from __future__ import annotations

import argparse
import statistics
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from .. import compile as compile_analysis
from .. import kernels
from ..core.executor import ExecContext, run_plan_subset
from ..launch.mesh import run_ranks, shard_store_inputs, syscat_for_mesh
from ..stores import store_engines
from ..stores.column_store import hash_join_nonunique
from ..stores.sharded import sharded_partitioned_join
from .tri_influence import (SMOKE, influence_arrays, influence_rollup,
                            inputs_for, stores_from_arrays)

ENGINES = {"xla": False, "xla,pallas": True}   # engine set -> pallas
# the node outputs a rank reports beside the plan output
GRAPH_IMPLS = {"graph_expand_csr": "expand", "graph_expand_pallas": "expand",
               "graph_pagerank_csr": "pagerank",
               "graph_pagerank_pallas": "pagerank"}


def build_workload(rng, shards, **size):
    """Stores (``with_shards(shards)`` when ``shards > 1``), analysis and
    query in the reference's RandomState order: ``(analysis, (table,
    graph, corpus, infl), query)``."""
    stores = stores_from_arrays(influence_arrays(rng, **size), **size)
    if shards > 1:
        stores = tuple(s.with_shards(shards) for s in stores)
    analysis = influence_rollup(*stores, iters=size["iters"],
                                capacity=size["tweets"],
                                name=f"tri_sharded_s{shards}")
    query = stores[2].query_vector(rng.randint(0, size["vocab"], 6))
    return analysis, stores, query


def _join_check(fn, env, mesh) -> dict:
    """The plan's partitioned join run again on its own inputs, against the
    dense bounded join on this rank's device: count, overflow and whether
    the match sets are equal."""
    (node,) = [n for n in fn.concrete.topo()
               if n.attrs.get("dist") == "partitioned"]
    a = node.attrs
    left, right = env[node.inputs[0]], env[node.inputs[1]]
    keys = (left.cols[a["left_on"]], left.valid, right.cols[a["right_on"]],
            right.valid, int(a["capacity"]))
    got = sharded_partitioned_join(*keys, mesh, int(a["bucket_cap"]))
    want = hash_join_nonunique(*keys)

    def pairs(lidx, ridx, valid, *_):
        return torch.sort(lidx[valid].long() * right.capacity
                          + ridx[valid].long()).values

    return {"count": int(got[3]), "overflow": bool(got[4]),
            "dense_count": int(want[3]), "dense_overflow": bool(want[4]),
            "same_set": bool(torch.equal(pairs(*got), pairs(*want))),
            "bucket_cap": int(a["bucket_cap"])}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def rank_run(mesh, size: dict, engine_sets=("xla",), seed: int = 0,
             reps: int = 1) -> dict:
    """One rank of the sharded rollup: build the workload from ``seed``
    and, for each engine set (``"xla"`` or ``"xla,pallas"``), compile it
    for the mesh, run it once with the kernels' launch counts and the
    mesh's collective counts set to 0 just before, then ``reps`` timed runs
    (a barrier before each), one ``analyze`` run and the join check.
    Returns ``{engine set: summary}``: plan id, chosen impls, ``dist``
    nodes and xfer kinds, the output, the timings and counts as host
    values; rank 0 adds the expand / PageRank / top-k outputs and the join
    check."""
    t0 = time.perf_counter()
    analysis, stores, query = build_workload(np.random.RandomState(seed),
                                             mesh.world, **size)
    inputs = shard_store_inputs(mesh, inputs_for(*stores, query, "cpu"))
    _sync(mesh.device)
    data_s = time.perf_counter() - t0
    return {name: _engine_run(mesh, analysis, inputs, ENGINES[name], reps,
                              data_s)
            for name in engine_sets}


def _engine_run(mesh, analysis, inputs, pallas, reps, data_s) -> dict:
    fn = compile_analysis(analysis, syscat_for_mesh(mesh),
                          engines=store_engines(pallas=pallas),
                          device=mesh.device, mesh=mesh, cache=False)
    topo = fn.concrete.topo()
    kernels.reset_launches()
    mesh.stats.clear()
    out = fn({}, inputs)
    _sync(mesh.device)
    launches = {k: v for k, v in kernels.launches().items() if v}
    stats = dict(mesh.stats)
    walls = []
    for _ in range(int(reps)):
        mesh.barrier()
        t0 = time.perf_counter()
        fn({}, inputs)
        _sync(mesh.device)
        walls.append(time.perf_counter() - t0)
    fn.analyze({}, inputs)
    spans = [(sp.name, sp.attrs.get("impl"), sp.attrs.get("dist"),
              sp.attrs.get("coll"))
             for sp in fn.last_run_trace.spans if sp.attrs.get("dist")]
    summary = {
        "rank": mesh.rank, "plan_id": fn.plan_id,
        "impls": fn.chosen_impls(),
        "dist": [(n.impl, n.attrs["dist"], n.attrs.get("bucket_cap"))
                 for n in topo if n.attrs.get("dist")],
        "xfers": [n.impl[len("xfer_"):] for n in topo
                  if n.impl.startswith("xfer_")],
        "out": out.cpu().numpy(), "launches": launches, "stats": stats,
        "walls_s": walls,
        "wall_s": statistics.median(walls) if walls else None,
        "data_s": data_s, "spans": spans}
    ctx = ExecContext(root={}, scope={}, device=fn.device, mesh=mesh)
    env = run_plan_subset(fn.concrete, ctx, inputs, [n.id for n in topo])
    join = _join_check(fn, env, mesh)
    if mesh.rank == 0:
        summary.update(nodes=node_outputs(fn, env), join=join)
    return summary


def node_outputs(fn, env) -> dict:
    """The expansion's, PageRank's and the top-k's outputs in one run's
    environment ``env`` of ``fn``'s plan, as numpy arrays: ``expand``,
    ``pagerank``, ``topk_doc`` and ``topk_score``."""
    topo = fn.concrete.topo()
    out = {GRAPH_IMPLS[n.impl]: env[n.id].cpu().numpy()
           for n in topo if n.impl in GRAPH_IMPLS}
    (hits,) = [env[n.id] for n in topo if n.impl == "text_topk_inv"]
    out["topk_doc"] = hits.cols["doc"].cpu().numpy()
    out["topk_score"] = hits.cols["score"].cpu().numpy()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--tweets", type=int, default=SMOKE["tweets"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--engines", default="xla", choices=tuple(ENGINES))
    args = ap.parse_args(argv)

    size = {**SMOKE, "tweets": args.tweets}
    with tempfile.TemporaryDirectory() as tmp:
        ranks = run_ranks(rank_run, args.world, device=args.device,
                          init_file=Path(tmp) / "group",
                          args=(size, (args.engines,), args.seed, 3))
    head = ranks[0][args.engines]
    print(f"plan {head['plan_id'][:12]} on {args.world} ranks "
          f"({args.device}, engines {args.engines})")
    print("dist nodes: " + ", ".join(f"{i}:{d}" for i, d, _ in head["dist"]))
    print("xfers: " + ", ".join(head["xfers"]))
    same = all(np.array_equal(r[args.engines]["out"], head["out"])
               for r in ranks)
    print(f"every rank's output equal: {same}; partitioned join "
          f"{head['join']}")
    print(f"wall per run {head['wall_s'] * 1e3:.1f} ms; collectives "
          f"{head['stats']}")
    score = head["out"]
    print("top hashtags (PageRank + text relevance + influence):")
    for h in np.argsort(-score, kind="stable")[:10]:
        print(f"  #{h:<6} score={float(score[h]):.4f}")


if __name__ == "__main__":
    main()
