"""One run of one cell: set-up, the measured window, the check, the result.

``main`` reads the cell from ``BENCHMARK.json``, finds its configuration
and traffic mix by name (:mod:`tribench.registry`) and:

  1. set-up (``setup_s`` runs from the harness's first statement to the
     first timed analysis; its parts go to standard error as one JSON
     line): the configuration's data drawn on the device from ``--seed``
     (``draws_s``), copied to the host (``host_copy_s``), handed to the
     program's own constructors (``store_build_s``) and payloads
     (``h2d_s``); the configuration's CUDA kernels built or loaded
     (``kernel_load_s``);
     the serving runtime (``runtime_s``); one plan per analysis the mix
     sends (``plan_compile_s``); the mix's path warmed up with queries of
     a stream of their own (``warmup_s``);
  2. the window: the mix's closed loop for ``--seconds``, each analysis
     timed from its submission until its result is on the host; with
     ``--trace 1`` a traced window of :data:`TRACE_SECONDS` follows;
  3. the check, once the window has closed, the peak memory has been read
     and the program's state is freed: the plain reference
     (:mod:`tribench.reference`) recomputes a sample of the window's
     analyses, drawn from the seed, from the raw arrays, and each
     analysis kind's two numbers (:func:`tribench.reference.gaps`) are
     held to their limits in the configuration (``limits``);
  4. the result: the cell's end-to-end metrics (``--trace 0``) or its
     per-layer metrics (``--trace 1``), as the last line of standard
     output.
"""
from __future__ import annotations

import argparse
import gc
import json
import random
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from tribench import gen
from tribench.reference import Reference, gaps
from tribench.registry import ROOT, Registry, cell as find_cell, load_manifest

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # top-level module names
TRACE_SECONDS = 2.0        # the traced window of a --trace 1 run
SERVE_TIMEOUT_S = 120.0    # one round's serve_analyses deadline
WARMUP_ROUNDS = 2          # the first fills the subplan cache
EXIT_NO_CHIP, EXIT_FORBIDDEN = 2, 3


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def log(err, **fields) -> None:
    print(json.dumps(fields), file=err, flush=True)


def forbidden_modules(names=None) -> list:
    """Loaded modules (or ``names``) whose top-level name is JAX's or the
    JAX package's, compared whole (``repro_torch`` is not ``repro``)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def host_arrays(raw: dict) -> dict:
    """The generator's device arrays as host numpy arrays."""
    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else x
    return {"table": {k: host(v) for k, v in raw["table"].items()},
            "edges": tuple(host(x) for x in raw["edges"]),
            "nodes": raw["nodes"], "terms": host(raw["terms"]),
            "lens": host(raw["lens"]), "vocab": raw["vocab"]}


def build_stores(raw: dict) -> dict:
    """The program's stores, through its own constructors, as a user's
    load would build them."""
    from repro_torch.stores import ColumnStore, GraphStore, TextStore
    src, dst = raw["edges"]
    return {"tweets": ColumnStore(raw["table"]),
            "g": GraphStore.from_edges(src, dst, raw["nodes"],
                                       symmetric=True),
            "cx": TextStore.from_flat(raw["terms"], raw["lens"],
                                      raw["vocab"])}


def make_runtime(cfg: dict, mix: dict, seed: int, device):
    """The serving runtime; its language-model half (the config's ``lm``)
    stays idle.  A mix that bypasses the multi-query layer gets no
    subplan cache."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.lm import build_model
    from repro_torch.serving.runtime import AsyncServingRuntime
    rtc = cfg["runtime"]
    lm = rtc["lm"]
    model = build_model(get_smoke_config(lm["arch"]).replace(
        dtype=lm["dtype"]))
    params = model.init_params(gen.generator(seed, device, gen.STREAM_DATA))
    budget = (int(rtc["subplan_budget_bytes"])
              if mix.get("subplan_cache", True) else None)
    return AsyncServingRuntime(model, params, max_batch=lm["max_batch"],
                               max_seq=lm["max_seq"], device=device,
                               subplan_budget=budget,
                               analysis_tick=int(rtc["analysis_tick"]))


@dataclass
class Plan:
    name: str
    params: dict
    module: object
    analysis: object
    fn: object
    compile_ms: float


@dataclass
class Data:
    """A configuration's data drawn from a seed: the raw host arrays, the
    program's stores and their payloads on the device."""
    raw: dict
    stores: dict
    payloads: dict
    parts: dict


@dataclass
class Session:
    """A traffic mix set up over a configuration's data: the runtime, one
    plan per analysis it sends, and its query stream."""
    device: torch.device
    mix: dict
    data: Data
    rt: object
    plans: dict                  # (name, params items) -> Plan
    queries: gen.QueryStream
    setup: dict = field(default_factory=dict)
    rid: int = 0

    def inputs(self, plan: Plan, q) -> dict:
        return {**{k: self.data.payloads[k] for k in plan.module.INPUTS
                   if k != "q"}, "q": q}

    def q(self, terms):
        return torch.from_numpy(self.queries.vector(terms)).to(self.device)


def load_kernels(names) -> None:
    """Build (one ``nvcc`` each, all started together) and load the CUDA
    kernels ``names``: the configuration's, and no others."""
    from repro_torch.kernels import build
    jobs = {n: build._start(n) for n in names}
    for n, job in jobs.items():
        if job is not None:
            build._finish(n, job)
        build.load(n)


def load_data(reg: Registry, cfg: dict, seed: int, device) -> Data:
    """Draw, copy to the host, build the program's stores and payloads,
    and build or load the kernels; each part timed."""
    device = torch.device(device)
    parts = {}
    t = time.perf_counter()
    raw_dev = reg.dataset(cfg["dataset"]).draw(
        cfg["sizes"], gen.generator(seed, device), device)
    sync(device)
    parts["draws_s"] = time.perf_counter() - t
    t = time.perf_counter()
    raw = host_arrays(raw_dev)
    del raw_dev
    parts["host_copy_s"] = time.perf_counter() - t
    t = time.perf_counter()
    stores = build_stores(raw)
    parts["store_build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    payloads = {k: s.payload(device) for k, s in stores.items()}
    sync(device)
    parts["h2d_s"] = time.perf_counter() - t
    t = time.perf_counter()
    if device.type == "cuda":
        load_kernels(cfg["kernels"])
    parts["kernel_load_s"] = time.perf_counter() - t
    return Data(raw, stores, payloads, parts)


def prepare(reg: Registry, cfg: dict, mix: dict, data: Data, seed: int,
            device, err) -> Session:
    """The runtime, the plans (compiled) and the warm-up of ``mix`` over
    ``data``; each part timed into ``Session.setup``."""
    import repro_torch
    device = torch.device(device)
    parts = dict(data.parts)
    t = time.perf_counter()
    rt = make_runtime(cfg, mix, seed, device)
    sync(device)
    parts["runtime_s"] = time.perf_counter() - t
    plans = {}
    t = time.perf_counter()
    for name, items in gen.variants(mix):
        mod = reg.analysis(name)
        analysis = mod.build(data.stores, dict(items))
        t1 = time.perf_counter()
        fn = repro_torch.compile(analysis, device=device)
        ms = (time.perf_counter() - t1) * 1e3
        plans[(name, items)] = Plan(name, dict(items), mod, analysis, fn, ms)
        log(err, plan=name, params=dict(items), plan_id=fn.plan_id[:12],
            compile_ms=ms, impls=sorted(fn.chosen_impls()))
    parts["plan_compile_s"] = time.perf_counter() - t
    sess = Session(device, mix, data, rt, plans,
                   gen.QueryStream(seed, gen.STREAM_WARMUP,
                                   data.raw["vocab"], mix["query_terms"]))
    t = time.perf_counter()
    warm = (len(mix["cycle"]) if mix["loop"] == "sequential"
            else WARMUP_ROUNDS)
    drive(sess, None, count=warm)
    sync(device)
    parts["warmup_s"] = time.perf_counter() - t
    sess.queries = gen.QueryStream(seed, gen.STREAM_WINDOW,
                                   data.raw["vocab"], mix["query_terms"])
    sess.setup = parts
    return sess


class Sample:
    """A seeded reservoir of ``size`` items from a stream of unknown
    length."""

    def __init__(self, size: int, seed: int):
        self.size, self.items, self.seen = int(size), [], 0
        self.rng = random.Random(int(seed) % gen.SEED_MOD * 8
                                 + gen.STREAM_SAMPLE)

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.size:
                self.items[j] = item


def drive(sess: Session, seconds, *, count=None, sample=None) -> dict:
    """The mix's closed loop for ``seconds`` (or ``count`` analyses or
    rounds): each analysis's latency from submission to its result on the
    host.  A sequential mix sends one analysis after another through
    ``run_analysis``; a rounds mix sends a round through
    ``serve_analyses`` and the next when it returns."""
    mix, rt = sess.mix, sess.rt
    c0 = rt.metrics.analytics_summary()
    lat, done, failed, errors = [], 0, 0, []
    t0 = time.perf_counter()
    i = 0
    while (time.perf_counter() - t0 < seconds) if count is None \
            else i < count:
        if mix["loop"] == "sequential":
            name, items = gen.solo_spec(mix, i)
            plan = sess.plans[(name, items)]
            terms = sess.queries.terms_next()
            ts = time.perf_counter()
            try:
                out = rt.run_analysis(plan.fn, {},
                                      sess.inputs(plan, sess.q(terms)))
                value = out.cpu()
            except Exception as exc:       # counted, and the run goes on
                failed += 1
                errors.append(repr(exc)[:300])
                continue
            finally:
                i += 1
            lat.append((time.perf_counter() - ts) * 1e3)
            done += 1
            if sample is not None:
                sample.offer([(name, plan.params, terms, value, "solo")])
        else:
            n, f, round_lat, kept = serve_round(sess)
            i += 1
            done += n
            failed += f
            lat.extend(round_lat)
            if sample is not None:
                sample.offer(kept)
    wall = time.perf_counter() - t0
    c1 = rt.metrics.analytics_summary()
    delta = {k: c1[k] - c0[k] for k in ("requests", "deduped", "batched")}
    return {"analyses": done, "failed": failed, "errors": errors[:5],
            "seconds": wall, "lat_ms": lat, "counters": delta, "units": i}


def serve_round(sess: Session):
    """One round: every analyst's query through one ``serve_analyses``.
    Returns ``(completed, failed, latencies ms, kept results)``."""
    from repro_torch.serving.runtime import AnalysisRequest
    specs = gen.round_specs(sess.mix, sess.queries)
    qcache, reqs = {}, []
    for j, (name, items, bp, terms) in enumerate(specs):
        plan = sess.plans[(name, items)]
        key = tuple(int(t) for t in terms)
        if key not in qcache:
            qcache[key] = sess.q(terms)
        sess.rid += 1
        reqs.append(AnalysisRequest(
            rid=sess.rid, planned=plan.fn, params={},
            inputs=sess.inputs(plan, qcache[key]), tenant=f"analyst{j}",
            batch_param=bp, store_versions=plan.analysis.store_versions()))
    ts = time.perf_counter()
    res = sess.rt.serve_analyses(reqs, timeout_s=SERVE_TIMEOUT_S)
    lat, kept, ok = [], [], 0
    for (name, items, _bp, terms), r in zip(specs, res):
        if not r.ok:
            continue
        value = r.value.cpu()
        lat.append((time.perf_counter() - ts) * 1e3)
        ok += 1
        how = ("deduped" if r.deduped else "batched" if r.batched
               else "cached" if r.shared_hits else "ran")
        kept.append((name, dict(items), terms, value, how))
    return ok, len(res) - ok, lat, kept


def check(reg: Registry, raw: dict, kept: list, device,
          control: bool = False) -> tuple:
    """The reference's numbers for the sampled analyses: ``({"<analysis>.
    graph_err" / ".text_err": the largest over the sample}, Reference,
    counts by how each was answered)``.  With ``control`` the reference
    computed in bfloat16 stands in the program's place: its outputs are
    judged instead of the program's."""
    ref = Reference(raw, device)
    ctl = Reference(raw, device, control=True) if control else None
    worst, memo, hows = {}, {}, {}
    for name, params, terms, value, how in kept:
        key = (name, tuple(sorted(params.items())),
               tuple(int(t) for t in terms))
        mod = reg.analysis(name)
        q = gen.query_vector(terms, raw["vocab"])
        if key not in memo:
            memo[key] = mod.reference(ref, params, q)
        if ctl is not None:
            value = sum(p for p in mod.reference(ctl, params, q)
                        if p is not None)
        for k, v in gaps(value, *memo[key]).items():
            k = f"{name}.{k}"
            worst[k] = max(worst.get(k, 0.0), v)
        hows[how] = hows.get(how, 0) + 1
    return worst, ref, hows


def device_info(device, chips: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def applies(metric: dict, cell_name: str, manifest: dict) -> bool:
    """Whether ``cell_name`` reports ``metric``: the cells its
    ``workloads`` lists, else (a per-layer metric) every cell that reports
    the end-to-end metric it moves, else every cell."""
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    if "moves" in metric:
        e2e_metric = next(m for m in manifest["end_to_end"]
                          if m["name"] == metric["moves"])
        return applies(e2e_metric, cell_name, manifest)
    return True


def e2e(name: str, win: dict, setup_s: float) -> float:
    """An end-to-end metric of the window: every analysis completed over
    the whole window's wall time; the tail over every analysis."""
    if name == "analyses_per_s":
        return win["analyses"] / win["seconds"]
    if name == "analysis_p95_ms":
        return float(np.percentile(win["lat_ms"], 95))
    if name == "setup_s":
        return setup_s
    raise KeyError(f"no end-to-end metric {name!r}")


def parse(argv):
    ap = argparse.ArgumentParser(description="Run one tribench cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, *, t_start=None, root: Path = ROOT, roots=(),
         device=None, out=None, err=None, preloaded=()) -> int:
    """Run one cell once; returns the exit code.  ``device`` skips the
    look for a chip (the CPU tests pass ``"cpu"``); ``preloaded`` names
    forbidden modules that a test process loaded before the run."""
    t_start = time.perf_counter() if t_start is None else t_start
    out = sys.stdout if out is None else out
    err = sys.stderr if err is None else err
    args = parse(argv)
    manifest = load_manifest(root)
    w = find_cell(manifest, args.workload)
    reg = Registry(roots)
    cfg, mix = reg.config(w["config"]), reg.traffic(w["traffic"])
    gen.check_mix(mix)
    if device is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < int(w["chips"]):
            print(f"tribench: {args.workload} needs {w['chips']} CUDA "
                  f"device(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=err)
            return EXIT_NO_CHIP
        device = "cuda"
    device = torch.device(device)

    sess = prepare(reg, cfg, mix, load_data(reg, cfg, args.seed, device),
                   args.seed, device, err)
    setup_s = time.perf_counter() - t_start
    log(err, setup={**sess.setup, "setup_s": setup_s})
    sample = Sample(mix["check_sample"], args.seed)
    win = drive(sess, args.seconds, sample=sample)
    traced = None
    if args.trace:
        from tribench.trace import profiled
        traced = profiled(lambda: drive(sess, TRACE_SECONDS))
    dev_info = device_info(device, int(w["chips"]))
    bad = sorted(set(forbidden_modules()) - set(preloaded))
    if bad:
        print(f"tribench: forbidden modules loaded: {bad}", file=err)
        return EXIT_FORBIDDEN
    facts = SimpleNamespace(
        registry=reg, cfg=cfg, mix=mix, cell=w, setup=sess.setup,
        compile_ms=[p.compile_ms for p in sess.plans.values()],
        plans=[(p.name, p.params) for p in sess.plans.values()],
        window=win, trace=None, trace_window_s=None, trace_analyses=0,
        ref=None)
    raw = sess.data.raw
    del sess
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    kept = [a for rnd in sample.items for a in rnd]
    worst, facts.ref, hows = check(reg, raw, kept, device)
    limits = cfg["limits"]
    compared = {k: {"value": v, "limit": limits.get(k)}
                for k, v in sorted(worst.items())}
    correct = (win["failed"] == 0 and bool(compared)
               and all(c["limit"] is not None and c["value"] <= c["limit"]
                       for c in compared.values()))
    metrics = {}
    result = {"correct": correct,
              "attempted": win["analyses"] + win["failed"],
              "failed": win["failed"]}
    if args.trace:
        tr_win, facts.trace, facts.trace_window_s = traced
        facts.trace_analyses = tr_win["analyses"]
        for m in manifest["per_layer"]:
            if applies(m, w["name"], manifest):
                value = reg.metric(m["name"]).read(facts)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_info.update(busy_s=facts.trace.busy_s,
                        window_s=facts.trace_window_s)
        result["breakdown"] = {"device_ops": facts.trace.top_ops(),
                               "idle_gaps": facts.trace.idle_gaps()}
    else:
        for m in manifest["end_to_end"]:
            if applies(m, w["name"], manifest):
                metrics[m["name"]] = {"value": e2e(m["name"], win, setup_s),
                                      "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = dev_info
    result["compared"] = compared
    log(err, window={k: win[k] for k in ("analyses", "failed", "errors",
                                          "seconds", "counters", "units")},
        checked=hows, power=power_limit() if device.type == "cuda" else "")
    for k, c in compared.items():
        print(f"compared {k} = {c['value']!r} limit {c['limit']!r}",
              file=err)
    print(f"correct {correct}", file=err, flush=True)
    print(json.dumps(result), file=out, flush=True)
    return 0
