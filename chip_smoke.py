#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

Run from the repository root, on a machine with a CUDA card, ``nvcc`` and
PyTorch built for CUDA:

    python3 chip_smoke.py

It imports only the port (``src/repro_torch``), never JAX or the JAX
package.  Phases, one line each; any failure raises and exits non-zero:

  1. device   — the card's name and power limit (``nvidia-smi``), PyTorch
     and CUDA versions; fails without a card;
  2. build    — both CUDA kernels from ``src/repro_torch/kernels/csrc``,
     one ``nvcc`` each, started together;
  3. data     — the example's tweets / co-mention graph / corpus at full
     size from seed 0, and their copy to the card (set-up time);
  4. kernels  — each kernel's wrapper against its plain PyTorch version on
     the card, at the main path's shapes and at edge cases; CUDA-event
     medians of the kernel, the plain version and one PyTorch library call,
     beside the byte bound at 3.35 TB/s;
  5. main     — ``hashtag_pulse`` compiled through ``repro_torch.compile``
     and run through the planned function: the chosen impls, the kernel
     launches of one run (counts set to 0 just before it), the median wall
     time of 5 runs;
  6. check    — the card's result against the port's plain path on the CPU
     at the same size (top-64 doc ids exact, fused scores allclose, top-10
     hashtags equal wherever their scores are apart), and a second card run
     (top-64 ids and the TF-IDF scores behind them bitwise equal);
  7. the kernels' JSON line, then ``{"ok": true, "device": ...}`` last.

With ``--profile`` it also runs the main path once under
``torch.profiler`` and prints the device time of the 15 costliest ops and
the device's idle share of that run.

Tolerances: counts, ids and top-k order exact; float sums
``rtol=1e-5, atol=1e-6`` (atomics add in a run-dependent order).
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.core.adil_parser import parse_adil  # noqa: E402
from repro_torch.core.executor import ExecContext, run_plan_subset  # noqa
from repro_torch.core.ir import (SystemCatalog, hardware_for_device,  # noqa
                                 standard_catalog)
from repro_torch.examples.tri_model_analysis import (  # noqa: E402
    adil_script, build_social_data, inputs_for)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.graph_kernels import (  # noqa: E402
    scatter_add, scatter_add_plain)
from repro_torch.kernels.masked_kernels import (  # noqa: E402
    masked_segment_agg, masked_segment_agg_plain)
from repro_torch.stores.text_store import tfidf_scores  # noqa: E402

FULL = {"tweets": 10_000_000, "users": 500_000, "hashtags": 131_072,
        "vocab": 65_536}
SEED = 0
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
FP64_FLOPS = 34e12              # H100 SXM data sheet, outside tensor cores
RTOL, ATOL = 1e-5, 1e-6
REPS = 21
RUNS = 5
EXPECTED_IMPLS = Counter({
    "rel_fused_agg_pallas": 2, "graph_expand_pallas": 1,
    "graph_pagerank_pallas": 1, "text_topk_inv": 1, "col_tensor_rel": 2,
    "xfer_pin": 5, "residual_add_xla": 1, "store": 1})
EXPECTED_LAUNCHES = {"scatter_add": 10, "masked_segment_agg": 2}


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def phase(tag, /, **fields):
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def cuda_ms(fn, reps=REPS, warmup=3) -> float:
    """Median CUDA-event time of ``fn`` in milliseconds."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes, nops, ops_rate):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = nops / ops_rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# -- phase 4: kernels against their plain versions ------------------------


def check_scatter(dev, gen, g, n_nodes):
    """scatter_add at the main path's shape (the graph's E and N) and at
    the edge cases; returns its JSON record."""
    x = torch.rand(n_nodes, generator=gen, device=dev)
    vals = (x[g["src"]] * g["weights"]).contiguous()
    dst = g["indices"]
    got, want = scatter_add(vals, dst, n_nodes), scatter_add_plain(
        vals, dst, n_nodes)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    err = float((got - want).abs().max())
    # edge cases: no edges; -1 and out-of-range padding; N % 128 != 0
    for e, n in ((0, 1000), (5000, 1000), (777, 131_073)):
        v = torch.rand(e, generator=gen, device=dev)
        d = torch.randint(-1, n + 2, (e,), generator=gen, device=dev,
                          dtype=torch.int32)
        torch.testing.assert_close(scatter_add(v, d, n),
                                   scatter_add_plain(v, d, n),
                                   rtol=RTOL, atol=ATOL)
    ms = cuda_ms(lambda: scatter_add(vals, dst, n_nodes))
    plain_ms = cuda_ms(lambda: scatter_add_plain(vals, dst, n_nodes))
    lib_ms = cuda_ms(lambda: torch.zeros(n_nodes, device=dev).index_add_(
        0, dst, vals))
    e = int(dst.shape[0])
    landed = int(((dst >= 0) & (dst < n_nodes)).sum())
    bound_ms, bound_by = bound(4 * e + 4 * landed + 4 * n_nodes, landed,
                               FP64_FLOPS)
    phase("kernel", name="scatter_add", E=e, N=n_nodes, max_abs_err=err,
          ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
          share_of_bound=bound_ms / ms)
    return {"name": "scatter_add", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/scatter_add.cu",
            "replaces": "src/repro/stores/graph_kernels.py:69",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}


def check_segment_agg(dev, gen, rel, n_groups):
    """masked_segment_agg at the main path's shape (the filter->count
    group-by over the tweets: R rows, G groups, engagement as a float
    value column) and at the edge cases; returns its JSON record."""
    keys = rel.cols["hashtag"]
    mw = (rel.cols["engagement"] >= 30.0).to(torch.float32)
    vals = rel.cols["engagement"]
    for v in (mw, vals):
        s, c = masked_segment_agg(v, keys, mw, n_groups)
        ps, pc = masked_segment_agg_plain(v, keys, mw, n_groups)
        torch.testing.assert_close(s, ps, rtol=RTOL, atol=ATOL)
        check(torch.equal(c, pc), "masked_segment_agg: counts differ")
    err = float((s - ps).abs().max())
    # edge cases: no rows; -1 and out-of-range keys; all-zero mask;
    # G % 128 != 0
    for r, gg, p in ((0, 1000, 0.5), (5000, 1000, 0.5), (5000, 1000, 0.0),
                     (777, 131_073, 0.3)):
        v = torch.rand(r, generator=gen, device=dev)
        k = torch.randint(-1, gg + 2, (r,), generator=gen, device=dev,
                          dtype=torch.int32)
        w = (torch.rand(r, generator=gen, device=dev) < p).to(torch.float32)
        s2, c2 = masked_segment_agg(v, k, w, gg)
        ps2, pc2 = masked_segment_agg_plain(v, k, w, gg)
        torch.testing.assert_close(s2, ps2, rtol=RTOL, atol=ATOL)
        check(torch.equal(c2, pc2), "masked_segment_agg: edge counts differ")
        if p == 0.0:
            check(not bool(c2.any()), "all-zero mask gave counts")
    ms = cuda_ms(lambda: masked_segment_agg(vals, keys, mw, n_groups))
    plain_ms = cuda_ms(
        lambda: masked_segment_agg_plain(vals, keys, mw, n_groups))
    vw = vals * mw

    def library():
        torch.zeros(n_groups, device=dev).index_add_(0, keys, vw)
        torch.zeros(n_groups, device=dev).index_add_(0, keys, mw)

    lib_ms = cuda_ms(library)
    r = int(keys.shape[0])
    active = int((mw != 0).sum())
    bound_ms, bound_by = bound(4 * r + 8 * active + 8 * n_groups,
                               3 * active, FP64_FLOPS)
    phase("kernel", name="masked_segment_agg", R=r, R_active=active,
          G=n_groups, max_abs_err=err, ms=ms, plain_ms=plain_ms,
          library_ms=lib_ms, bound_ms=bound_ms, share_of_bound=bound_ms / ms)
    return {"name": "masked_segment_agg", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/masked_segment_agg.cu",
            "replaces": "src/repro/stores/masked_kernels.py:311",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}


# -- phases 5-6: the main path --------------------------------------------


def launches() -> dict:
    return {"scatter_add": scatter_add.launches,
            "masked_segment_agg": masked_segment_agg.launches}


def run_env(fn, inputs) -> dict:
    """Every node's output of one run of ``fn``'s concrete plan (for the
    comparisons; the timed runs go through ``fn`` itself)."""
    ctx = ExecContext(root={}, scope={}, device=fn.device)
    return run_plan_subset(fn.concrete, ctx, inputs,
                           [n.id for n in fn.concrete.topo()])


def hits_and_score(fn, env):
    (topk,) = [n.id for n in fn.concrete.topo() if n.impl == "text_topk_inv"]
    return env[topk].cols["doc"], env[fn.concrete.outputs[0]]


def top10_agrees(cpu, card) -> bool:
    """The card's top-10 hashtags equal the CPU's within every run of
    ranks whose CPU scores lie within the tolerance of each other and
    apart from the ranks around them."""
    order_cpu = np.argsort(-cpu, kind="stable")[:11]
    order_card = np.argsort(-card, kind="stable")[:11]
    s = cpu[order_cpu]
    apart = np.abs(s[:-1] - s[1:]) > ATOL + RTOL * np.abs(s[1:])
    start = 0
    for i in range(10):
        if apart[i]:
            if set(order_cpu[start:i + 1]) != set(order_card[start:i + 1]):
                return False
            start = i + 1
    return True


def profile_run(fn, inputs):
    """One main-path run under ``torch.profiler``: device time per CUDA
    kernel (summed over its launches) and the device's idle share of the
    run's wall time.  Only kernel events count; the PyTorch operators that
    launch them would count the same time twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn({}, inputs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    phase("profile", wall_ms=wall_ms, device_busy_ms=busy,
          idle_share=1.0 - busy / wall_ms, ops=len(rows))
    for ms, count, key in rows[:15]:
        phase("profile-op", device_ms=ms, launches=count,
              share=ms / busy, op=json.dumps(key[:90]))


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one main-path run (torch.profiler)")
    args = ap.parse_args(argv)

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    phase("device", name=repr(name), torch=torch.__version__,
          cuda=torch.version.cuda, allow_tf32=False,
          count=torch.cuda.device_count())

    # 2. build
    built = build.build_all()
    regs = [ln.strip() for log in built["logs"].values()
            for ln in log.splitlines() if "registers" in ln]
    phase("build", seconds=round(built["seconds"], 3),
          kernels=",".join(built["logs"]), ptxas=json.dumps(regs))

    # 3. data (set-up)
    t0 = time.perf_counter()
    rng = np.random.RandomState(SEED)
    table, graph, corpus = build_social_data(rng, **FULL)
    query = corpus.query_vector(rng.randint(0, FULL["vocab"], 6))
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    inputs = inputs_for(table, graph, corpus, query, dev)
    torch.cuda.synchronize()
    t_h2d = time.perf_counter() - t0
    phase("data", tweets=table.rows, hashtags=graph.n_nodes,
          edges=graph.n_edges, docs=corpus.n_docs,
          postings=corpus.n_postings, build_s=round(t_build, 3),
          h2d_s=round(t_h2d, 3))

    # 4. kernels against their plain versions on the card
    gen = torch.Generator(device=dev).manual_seed(SEED)
    records = [check_scatter(dev, gen, inputs["g"], graph.n_nodes),
               check_segment_agg(dev, gen, inputs["tweets"], graph.n_nodes)]

    # 5. the main path through the entry points
    analysis = parse_adil(adil_script(table, graph, corpus),
                          standard_catalog())
    syscat = SystemCatalog(hardware=hardware_for_device(name))
    fn = repro_torch.compile(analysis, syscat, device="cuda")
    impls = Counter(fn.chosen_impls())
    check(impls == EXPECTED_IMPLS, f"chosen impls {dict(impls)} != "
                                   f"{dict(EXPECTED_IMPLS)}")
    kernels.reset_launches()
    score = fn({}, inputs)
    torch.cuda.synchronize()
    counted = launches()
    check(counted == EXPECTED_LAUNCHES,
          f"kernel launches of one run {counted} != {EXPECTED_LAUNCHES}")
    check(score.shape == (graph.n_nodes,) and bool(score.isfinite().all()),
          "fused score is not a finite (hashtags,) vector")
    walls = []
    for _ in range(RUNS):
        kernels.reset_launches()
        t0 = time.perf_counter()
        fn({}, inputs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        check(launches() == EXPECTED_LAUNCHES, "launches changed")
    phase("main", plan_id=fn.plan_id[:12], impls=json.dumps(dict(impls)),
          launches=json.dumps(counted), run_ms=statistics.median(walls) * 1e3,
          runs=RUNS, setup_s=round(t_build + t_h2d, 3),
          peak_mem_gb=round(torch.cuda.max_memory_allocated() / 1e9, 3))
    for rec in records:
        rec["launches"] = counted[rec["name"]]
    if args.profile:
        profile_run(fn, inputs)

    # 6. against the port's plain path on the CPU, and run to run
    hits_a, score_a = hits_and_score(fn, run_env(fn, inputs))
    hits_b, score_b = hits_and_score(fn, run_env(fn, inputs))
    check(torch.equal(hits_a, hits_b), "top-64 ids differ between two runs")
    # the ordered per-document TF-IDF sum that decides the top-64's ties
    tf_a = tfidf_scores(inputs["cx"], inputs["q"])
    check(torch.equal(tf_a, tfidf_scores(inputs["cx"], inputs["q"])),
          "TF-IDF scores differ bitwise between two card runs")
    fn_cpu = repro_torch.compile(analysis, syscat, device="cpu")
    check(fn_cpu.plan_id == fn.plan_id, "CPU plan differs from the card's")
    inputs_cpu = inputs_for(table, graph, corpus, query, "cpu")
    t0 = time.perf_counter()
    hits_c, score_c = hits_and_score(fn_cpu, run_env(fn_cpu, inputs_cpu))
    t_cpu = time.perf_counter() - t0
    check(torch.equal(hits_a.cpu(), hits_c), "top-64 ids differ from CPU")
    torch.testing.assert_close(score_a.cpu(), score_c, rtol=RTOL, atol=ATOL)
    check(top10_agrees(score_c.numpy(), score_a.cpu().numpy()),
          "top-10 hashtags differ from CPU")
    tf_c = tfidf_scores(inputs_cpu["cx"], inputs_cpu["q"])
    phase("check", top64_equal_cpu=True, top64_equal_rerun=True,
          tfidf_bitwise_rerun=True,
          tfidf_bitwise_cpu=bool(torch.equal(tf_a.cpu(), tf_c)),
          score_bitwise_rerun=bool(torch.equal(score_a, score_b)),
          score_max_abs_err_cpu=float((score_a.cpu() - score_c).abs().max()),
          top10=json.dumps([int(h) for h in
                            np.argsort(-score_c.numpy(), kind="stable")[:10]]),
          cpu_plain_s=round(t_cpu, 3))

    # 7. results
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
