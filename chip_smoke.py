#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA card and check them.

Run from the repository root, on a machine with a CUDA card, ``nvcc`` and
PyTorch built for CUDA:

    python3 chip_smoke.py

It imports only the port (``src/repro_torch``), never JAX or the JAX
package.  Phases, one line each; any failure raises and exits non-zero:

  1. device   — the card's name and power limit (``nvidia-smi``), PyTorch
     and CUDA versions; fails without a card;
  2. build    — every CUDA kernel of ``src/repro_torch/kernels/csrc``, one
     ``nvcc`` each, all started together;

  ``hashtag_pulse`` (tri-model analysis, slice 1):

  3. data     — the example's tweets / co-mention graph / corpus at full
     size from seed 0, and their copy to the card (set-up time);
  4. kernel   — scatter_add and masked_segment_agg against their plain
     PyTorch versions on the card, at the path's shapes and at edge cases;
     CUDA-event medians of the kernel, the plain version and one PyTorch
     library call, beside the byte bound at 3.35 TB/s;
  5. main     — ``hashtag_pulse`` compiled through ``repro_torch.compile``
     and run through the planned function: the chosen impls, the kernel
     launches of one run (counts set to 0 just before it), the median wall
     time of 5 runs;
  6. check    — the card's result against the port's plain path on the CPU
     at the same size (top-64 doc ids exact, fused scores allclose, top-10
     hashtags equal wherever their scores are apart), and a second card run
     (top-64 ids and the TF-IDF scores behind them bitwise equal);

  ``tri_selective_0.01`` (time-windowed ranking, the pushdown path):

  7. data     — the windowed-ranking stores at 10M tweets from seed 0 and
     their copy to the card (set-up time);
  8. kernel   — masked_tfidf, join_probe and compact_prefix against their
     plain versions on the card, at the path's shapes and at edge cases, as
     in phase 4; scatter_add and masked_segment_agg again, on the very
     arguments one run of the default plan gives them;
  9. pushdown — the analysis compiled with the default pipeline, without
     ``fuse_store_ops`` and without pushdown (``UNPUSHED_PIPELINE``): each
     plan's impls and kernel launches of one run (counts set to 0 just
     before it), the median wall time of 5 runs; then the registered
     ``compact_prefix_pallas`` impl through the engine dispatch on the 1 %
     window, against ``compact_prefix_col``;
 10. check    — the default plan on the card against the port's plain path
     on the CPU (top-64 doc ids exact, output allclose); pushed against
     unpushed (top-64 ids and scores bitwise); default against unfused
     (top-64 equal, output allclose); two card runs (top-64 bitwise);

 11. the kernels' JSON line, then ``{"ok": true, "device": ...}`` last.

With ``--profile`` it also runs each path's default plan once under
``torch.profiler`` and prints the device time of the 15 costliest kernels
and the device's idle share of that run.

Tolerances: counts, ids and top-k order exact; float sums
``rtol=1e-5, atol=1e-6`` (atomics add in a run-dependent order).
"""
from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.core.adil_parser import parse_adil  # noqa: E402
from repro_torch.core.engines import dispatch  # noqa: E402
from repro_torch.core.executor import ExecContext, run_plan_subset  # noqa
from repro_torch.core.ir import (SystemCatalog, hardware_for_device,  # noqa
                                 standard_catalog)
from repro_torch.core.rewrite import (DEFAULT_PIPELINE,  # noqa: E402
                                      UNPUSHED_PIPELINE)
from repro_torch.examples import windowed_ranking  # noqa: E402
from repro_torch.examples.tri_model_analysis import (  # noqa: E402
    adil_script, build_social_data, inputs_for)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.graph_kernels import (  # noqa: E402
    scatter_add, scatter_add_plain)
from repro_torch.kernels.masked_kernels import (  # noqa: E402
    compact_prefix, compact_prefix_plain, join_probe, join_probe_plain,
    masked_segment_agg, masked_segment_agg_plain, masked_tfidf,
    masked_tfidf_plain)
from repro_torch.stores import TextStore, graph_store, runtime  # noqa: E402
from repro_torch.stores.text_store import tfidf_scores  # noqa: E402

FULL = {"tweets": 10_000_000, "users": 500_000, "hashtags": 131_072,
        "vocab": 65_536}
# tri_store_eff.py's selective workload, its table scaled to slice 1's 10M
# tweets: 0.6 edges and 12-19 terms per tweet, hashtags and vocab as FULL
WINDOW = {"tweets": 10_000_000, "hashtags": 131_072, "edges": 6_000_000,
          "vocab": 65_536, "terms_lo": 12, "terms_hi": 20}
SELECTIVITY = 0.01
SEED = 0
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
FP64_FLOPS = 34e12              # H100 SXM data sheet, outside tensor cores
FP32_FLOPS = 67e12              # H100 SXM data sheet, outside tensor cores
RTOL, ATOL = 1e-5, 1e-6
REPS = 21
RUNS = 5
TOPK_IMPLS = ("text_topk_inv", "text_topk_skip_inv", "text_topk_masked_pallas",
              "masked_topk_xla")
# the table's float columns: what the compaction kernel may carry
FLOAT_COLS = ("engagement",) + tuple(f"metric{i}" for i in range(8))


def launch_counts(**counts) -> dict:
    """A full launch-count dict: the named kernels' counts, 0 for others."""
    return {**{k.__name__: 0 for k in kernels.KERNELS}, **counts}


EXPECTED_IMPLS = Counter({
    "rel_fused_agg_pallas": 2, "graph_expand_pallas": 1,
    "graph_pagerank_pallas": 1, "text_topk_inv": 1, "col_tensor_rel": 2,
    "xfer_pin": 5, "residual_add_xla": 1, "store": 1})
EXPECTED_LAUNCHES = launch_counts(scatter_add=10, masked_segment_agg=2)
# the windowed ranking's plans at 10M tweets (planned for the H100 SXM):
# pipeline, chosen impls, kernel launches of one run
WINDOW_PLANS = {
    "default": (DEFAULT_PIPELINE, Counter({
        "rel_fused_col": 1, "sel_mask_rel": 1, "xfer_pin": 6,
        "text_topk_masked_pallas": 1, "rel_fused_agg_pallas": 1,
        "rel_group_agg_col": 1, "col_tensor_rel": 2,
        "graph_expand_pallas": 1, "residual_add_xla": 1, "store": 1}),
        launch_counts(masked_tfidf=1, scatter_add=2, masked_segment_agg=1)),
    "unfused": (tuple(p for p in DEFAULT_PIPELINE if p != "fuse_store_ops"),
                Counter({
        "rel_scan_col": 1, "rel_filter_col": 1, "compact_prefix_col": 1,
        "sel_mask_rel": 1, "xfer_pin": 6, "text_topk_masked_pallas": 1,
        "rel_join_probe_pallas": 1, "rel_group_agg_col": 2,
        "col_tensor_rel": 2, "graph_expand_pallas": 1,
        "residual_add_xla": 1, "store": 1}),
        launch_counts(masked_tfidf=1, join_probe=1, scatter_add=2)),
    "unpushed": (UNPUSHED_PIPELINE, Counter({
        "rel_scan_col": 1, "rel_filter_col": 1, "sel_mask_rel": 1,
        "xfer_pin": 7, "text_scores_inv": 1, "masked_topk_xla": 1,
        "rel_hash_join": 1, "rel_group_agg_col": 2, "col_tensor_rel": 2,
        "graph_expand_pallas": 1, "residual_add_xla": 1, "store": 1}),
        launch_counts(scatter_add=2)),
}


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


def check_scatter(dev, gen, calls):
    """scatter_add on each of ``calls``, the ``(vals, dst, n_nodes)`` the
    path gives it, and at the edge cases; the first call is timed.
    Returns its JSON record."""
    err = 0.0
    for vals, dst, n_nodes in calls:
        got, want = scatter_add(vals, dst, n_nodes), scatter_add_plain(
            vals, dst, n_nodes)
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        err = max(err, float((got - want).abs().max()))
    vals, dst, n_nodes = calls[0]
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
    phase("kernel", name="scatter_add", E=e, N=n_nodes, calls=len(calls),
          max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
          bound_ms=bound_ms, share_of_bound=bound_ms / ms)
    return {"name": "scatter_add", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/scatter_add.cu",
            "replaces": "src/repro/stores/graph_kernels.py:69",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}


def check_segment_agg(dev, gen, calls):
    """masked_segment_agg on each of ``calls``, the ``(vals, keys, mw,
    n_groups)`` the path gives it, and at the edge cases; the first call is
    timed.  Returns its JSON record."""
    err = 0.0
    for vals, keys, mw, n_groups in calls:
        s, c = masked_segment_agg(vals, keys, mw, n_groups)
        ps, pc = masked_segment_agg_plain(vals, keys, mw, n_groups)
        torch.testing.assert_close(s, ps, rtol=RTOL, atol=ATOL)
        check(torch.equal(c, pc), "masked_segment_agg: counts differ")
        err = max(err, float((s - ps).abs().max()))
    vals, keys, mw, n_groups = calls[0]
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
          G=n_groups, calls=len(calls), max_abs_err=err, ms=ms,
          plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
          share_of_bound=bound_ms / ms)
    return {"name": "masked_segment_agg", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/masked_segment_agg.cu",
            "replaces": "src/repro/stores/masked_kernels.py:311",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}


# -- phases 5-6: the main path --------------------------------------------


def run_env(fn, inputs) -> dict:
    """Every node's output of one run of ``fn``'s concrete plan (for the
    comparisons; the timed runs go through ``fn`` itself)."""
    ctx = ExecContext(root={}, scope={}, device=fn.device)
    return run_plan_subset(fn.concrete, ctx, inputs,
                           [n.id for n in fn.concrete.topo()])


def hits_and_score(fn, env):
    """The top-k relation and the plan output of one run's environment."""
    (topk,) = [n.id for n in fn.concrete.topo() if n.impl in TOPK_IMPLS]
    return env[topk], env[fn.concrete.outputs[0]]


@contextlib.contextmanager
def recording(module, name, calls):
    """Append the arguments of every call of ``module.name`` (a kernel
    wrapper, under the name the path's code calls it by) to ``calls``."""
    wrapped = getattr(module, name)

    def record(*args):
        calls.append(args)
        return wrapped(*args)

    setattr(module, name, record)
    try:
        yield
    finally:
        setattr(module, name, wrapped)


def node_out(fn, env, impl):
    (nid,) = [n.id for n in fn.concrete.topo() if n.impl == impl]
    return env[nid]


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


def profile_run(fn, inputs, path):
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
    phase("profile", path=path, wall_ms=wall_ms, device_busy_ms=busy,
          idle_share=1.0 - busy / wall_ms, ops=len(rows))
    for ms, count, key in rows[:15]:
        phase("profile-op", path=path, device_ms=ms, launches=count,
              share=ms / busy, op=json.dumps(key[:90]))


# -- phase 8: the pushdown path's kernels against their plain versions ----


def check_masked_tfidf(dev, cx, q, doc_mask):
    """masked_tfidf at the path's shape (the whole corpus, the window's doc
    mask) and at edge cases; returns its JSON record."""
    w = (q * cx["idf"]).contiguous()
    args = (cx["doc_ptr"], cx["term_ids"], cx["tf"], cx["doc_len"], w,
            doc_mask, cx["max_doc_postings"])
    got, want = masked_tfidf(*args), masked_tfidf_plain(*args)
    check(torch.equal(got, want), "masked_tfidf differs from its plain "
                                  "version")
    err = float((got - want).abs().max())
    check(torch.equal(got[doc_mask], tfidf_scores(cx, q)[doc_mask]),
          "masked_tfidf differs from the dense scores on kept documents")
    check(not bool(got[~doc_mask].any()), "a masked document scored")
    # edge cases: no postings; no documents; all masked; D % 128 != 0
    rng = np.random.RandomState(SEED)
    for docs, terms_hi, keep in ((1000, 0, 0.5), (0, 4, 0.5),
                                 (5000, 20, 0.0), (777, 20, 0.3),
                                 (131_073, 20, 1.0)):
        lens = (rng.randint(0, terms_hi, docs) if terms_hi
                else np.zeros(docs, np.int64))
        c = TextStore.from_flat(rng.randint(0, 512, int(lens.sum())), lens,
                                512).payload(dev)
        m = torch.from_numpy(rng.rand(docs) < keep).to(dev)
        a = (c["doc_ptr"], c["term_ids"], c["tf"], c["doc_len"], c["idf"],
             m, c["max_doc_postings"])
        g2 = masked_tfidf(*a)
        check(torch.equal(g2, masked_tfidf_plain(*a)),
              f"masked_tfidf edge case ({docs}, {terms_hi}, {keep}) differs")
        check(keep > 0 or not bool(g2.any()), "all-masked corpus scored")
    ms = cuda_ms(lambda: masked_tfidf(*args))
    plain_ms = cuda_ms(lambda: masked_tfidf_plain(*args))
    # one library call over pre-gathered, pre-masked contributions
    docs_of = cx["doc_ids"].long()
    contrib = torch.where(doc_mask[docs_of],
                          w[cx["term_ids"]] * cx["tf"] / cx["doc_len"][docs_of],
                          torch.zeros((), device=dev))
    offsets = cx["doc_ptr"].long()
    lib_ms = cuda_ms(lambda: torch.segment_reduce(
        contrib, "sum", offsets=offsets, unsafe=True))
    del contrib, docs_of, offsets
    d, v = int(doc_mask.shape[0]), int(w.shape[0])
    kept = int(doc_mask.sum())
    per_doc = (cx["doc_ptr"][1:] - cx["doc_ptr"][:-1])
    e_kept = int(per_doc[doc_mask].sum())
    # bytes: mask byte + score per doc; doc_ptr pair + doc_len per kept
    # doc; term + tf per kept posting; the query weights once
    bound_ms, bound_by = bound(5 * d + 12 * kept + 8 * e_kept + 4 * v,
                               3 * e_kept, FP32_FLOPS)
    phase("kernel", name="masked_tfidf", D=d, D_kept=kept,
          E=int(cx["term_ids"].shape[0]), E_kept=e_kept, max_abs_err=err,
          ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
          share_of_bound=bound_ms / ms)
    return {"name": "masked_tfidf", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/masked_tfidf.cu",
            "replaces": "src/repro/stores/masked_kernels.py:94",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}


def check_join_probe(dev, gen, lkeys, rkeys, rvalid):
    """join_probe at the path's shape (the compacted window probing the
    top-64 hits) and at edge cases; returns its JSON record."""
    gi, gm = join_probe(lkeys, rkeys, rvalid)
    wi, wm = join_probe_plain(lkeys, rkeys, rvalid)
    check(torch.equal(gi, wi) and torch.equal(gm, wm),
          "join_probe differs from its plain version")
    err = float((gi - wi).abs().max()) if gi.numel() else 0.0
    # edge cases: no probe rows; no build rows; invalid build rows; the
    # largest build side the planner admits; sizes % 128 != 0
    for p, nr, share in ((0, 64, 1.0), (1000, 0, 1.0), (5000, 130, 0.5),
                         (777, 4096, 0.7), (131_073, 1, 1.0),
                         (100_000, 300, 0.0)):
        rk = torch.randperm(4 * nr + 8, generator=gen, device=dev)[:nr].to(
            torch.int32)
        rv = torch.rand(nr, generator=gen, device=dev) < share
        lk = torch.randint(0, 4 * nr + 8, (p,), generator=gen, device=dev,
                           dtype=torch.int32)
        a, b = join_probe(lk, rk, rv), join_probe_plain(lk, rk, rv)
        check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
              f"join_probe edge case ({p}, {nr}, {share}) differs")
        check(share > 0 or not bool(a[1].any()), "an invalid row matched")
    ms = cuda_ms(lambda: join_probe(lkeys, rkeys, rvalid))
    plain_ms = cuda_ms(lambda: join_probe_plain(lkeys, rkeys, rvalid))
    sorted_keys = torch.sort(rkeys[rvalid]).values
    lib_ms = cuda_ms(lambda: torch.searchsorted(sorted_keys, lkeys))
    p, nr = int(lkeys.shape[0]), int(rkeys.shape[0])
    # bytes: probe key in, index + flag out per probe row; key + validity
    # per build row; one hash and one compare per probe row
    bound_ms, bound_by = bound(9 * p + 5 * nr, 2 * p, FP32_FLOPS)
    phase("kernel", name="join_probe", P=p, NR=nr,
          NR_valid=int(rvalid.sum()), matched=int(gm.sum()),
          max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
          bound_ms=bound_ms, share_of_bound=bound_ms / ms)
    return {"name": "join_probe", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/join_probe.cu",
            "replaces": "src/repro/stores/masked_kernels.py:233",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}


def check_compact(dev, window, cap):
    """compact_prefix at the path's shape (the table's float columns over
    the 1 % window, the planner's capacity) and at edge cases; returns its
    JSON record."""
    vals = torch.stack([window.cols[c] for c in FLOAT_COLS])
    valid = window.valid
    keep = valid.to(torch.float32)
    pos = torch.where(valid, torch.cumsum(valid.to(torch.int32), 0,
                                          dtype=torch.int32) - 1,
                      torch.full_like(valid, -1, dtype=torch.int32))
    got = compact_prefix(vals, pos, keep, cap)
    want = compact_prefix_plain(vals, pos, keep, cap)
    check(torch.equal(got, want), "compact_prefix differs from its plain "
                                  "version")
    kept = int(valid.sum())
    check(torch.equal(got[:, :min(kept, cap)],
                      vals[:, valid][:, :cap]),
          "compact_prefix did not keep the window's rows in order")
    err = float((got - want).abs().max())
    # edge cases: no rows; out_capacity 0; capacity overflow; all masked;
    # R % 128 != 0
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for c, r, share, cp in ((3, 0, 0.5, 16), (3, 5000, 0.5, 0),
                            (9, 5000, 0.5, 1000), (2, 5000, 0.0, 64),
                            (9, 777, 0.3, 777)):
        v = torch.randn(c, r, generator=gen, device=dev)
        k = torch.rand(r, generator=gen, device=dev) < share
        ps = torch.where(k, torch.cumsum(k.to(torch.int32), 0,
                                         dtype=torch.int32) - 1,
                         torch.full_like(k, -1, dtype=torch.int32))
        kf = k.to(torch.float32)
        a = compact_prefix(v, ps, kf, cp)
        check(torch.equal(a, compact_prefix_plain(v, ps, kf, cp)),
              f"compact_prefix edge case ({c}, {r}, {share}, {cp}) differs")
        check(share > 0 or not bool(a.any()), "an all-masked input moved")
    ms = cuda_ms(lambda: compact_prefix(vals, pos, keep, cap))
    plain_ms = cuda_ms(lambda: compact_prefix_plain(vals, pos, keep, cap))
    lib_ms = cuda_ms(lambda: vals[:, valid][:, :cap])
    c, r = int(vals.shape[0]), int(vals.shape[1])
    # bytes: keep per row; pos and C values per kept row; the output once
    bound_ms, bound_by = bound(4 * r + 4 * kept + 4 * c * kept + 4 * c * cap,
                               0, FP32_FLOPS)
    phase("kernel", name="compact_prefix", C=c, R=r, R_kept=kept, cap=cap,
          max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
          bound_ms=bound_ms, share_of_bound=bound_ms / ms)
    return {"name": "compact_prefix", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/compact_prefix.cu",
            "replaces": "src/repro/stores/masked_kernels.py:173",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}


def compact_impl(dev, window, cap) -> dict:
    """The registered ``compact_prefix_pallas`` impl through the engine
    dispatch, on the 1 % window projected to its float columns (the
    planner never picks it: its gate and cost, see PERF.md), against
    ``compact_prefix_col``.  Returns the launch counts of its run."""
    rel = window.with_cols({c: window.cols[c] for c in FLOAT_COLS})
    ctx = ExecContext(root={}, scope={}, device=dev)
    node = SimpleNamespace(attrs={"capacity": cap})
    kernels.reset_launches()
    got = dispatch("compact_prefix_pallas", "pallas")(ctx, [rel], node)
    torch.cuda.synchronize()
    counted = kernels.launches()
    check(counted == launch_counts(compact_prefix=1),
          f"compact_prefix_pallas launches {counted}")
    want = dispatch("compact_prefix_col", "rel")(ctx, [rel], node)
    check(torch.equal(got.valid, want.valid)
          and int(got.count) == int(want.count), "compaction counts differ")
    for c in FLOAT_COLS:
        check(torch.equal(got.cols[c][want.valid], want.cols[c][want.valid]),
              f"compact_prefix_pallas column {c} differs on valid rows")
    phase("pushdown", plan="compact_prefix_pallas impl", cap=cap,
          count=int(got.count), overflow=bool(got.overflow),
          launches=json.dumps({k: v for k, v in counted.items() if v}),
          valid_rows_bitwise_gather=True)
    return counted


def pulse_path(args, dev, syscat) -> list:
    """Phases 3-6: ``hashtag_pulse``.  Returns its kernels' records."""
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
    phase("data", path="hashtag_pulse", tweets=table.rows,
          hashtags=graph.n_nodes, edges=graph.n_edges, docs=corpus.n_docs,
          postings=corpus.n_postings, build_s=round(t_build, 3),
          h2d_s=round(t_h2d, 3))

    # 4. kernels against their plain versions on the card
    # (an SpMV over the whole graph; the filter->count group-by over the
    # tweets, engagement as a float value column)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    g, rel, n = inputs["g"], inputs["tweets"], graph.n_nodes
    x = torch.rand(n, generator=gen, device=dev)
    keys, eng = rel.cols["hashtag"], rel.cols["engagement"]
    mw = (eng >= 30.0).to(torch.float32)
    records = [
        check_scatter(dev, gen, [((x[g["src"]] * g["weights"]).contiguous(),
                                  g["indices"], n)]),
        check_segment_agg(dev, gen, [(eng, keys, mw, n), (mw, keys, mw, n)])]
    del x, mw

    # 5. the main path through the entry points
    analysis = parse_adil(adil_script(table, graph, corpus),
                          standard_catalog())
    fn = repro_torch.compile(analysis, syscat, device="cuda")
    impls = Counter(fn.chosen_impls())
    check(impls == EXPECTED_IMPLS, f"chosen impls {dict(impls)} != "
                                   f"{dict(EXPECTED_IMPLS)}")
    counted, run_ms = drive(fn, inputs, EXPECTED_LAUNCHES)
    phase("main", plan_id=fn.plan_id[:12], impls=json.dumps(dict(impls)),
          launches=json.dumps(counted), run_ms=run_ms,
          runs=RUNS, setup_s=round(t_build + t_h2d, 3),
          peak_mem_gb=round(torch.cuda.max_memory_allocated() / 1e9, 3))
    for rec in records:
        rec["launches"] = counted[rec["name"]]
        rec["path"] = "hashtag_pulse"
    if args.profile:
        profile_run(fn, inputs, "hashtag_pulse")

    # 6. against the port's plain path on the CPU, and run to run
    hits_a, score_a = hits_and_score(fn, run_env(fn, inputs))
    hits_b, score_b = hits_and_score(fn, run_env(fn, inputs))
    hits_a, hits_b = hits_a.cols["doc"], hits_b.cols["doc"]
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
    hits_c = hits_c.cols["doc"]
    t_cpu = time.perf_counter() - t0
    check(torch.equal(hits_a.cpu(), hits_c), "top-64 ids differ from CPU")
    torch.testing.assert_close(score_a.cpu(), score_c, rtol=RTOL, atol=ATOL)
    check(top10_agrees(score_c.numpy(), score_a.cpu().numpy()),
          "top-10 hashtags differ from CPU")
    tf_c = tfidf_scores(inputs_cpu["cx"], inputs_cpu["q"])
    phase("check", path="hashtag_pulse", top64_equal_cpu=True,
          top64_equal_rerun=True, tfidf_bitwise_rerun=True,
          tfidf_bitwise_cpu=bool(torch.equal(tf_a.cpu(), tf_c)),
          score_bitwise_rerun=bool(torch.equal(score_a, score_b)),
          score_max_abs_err_cpu=float((score_a.cpu() - score_c).abs().max()),
          top10=json.dumps([int(h) for h in
                            np.argsort(-score_c.numpy(), kind="stable")[:10]]),
          cpu_plain_s=round(t_cpu, 3))
    return records


def drive(fn, inputs, expected):
    """One run of ``fn`` with every launch count set to 0 just before it
    and read just after (they must equal ``expected``), then the median
    wall time of RUNS more.  Returns ``(counts, run_ms)``."""
    kernels.reset_launches()
    out = fn({}, inputs)
    torch.cuda.synchronize()
    counted = kernels.launches()
    check(counted == expected,
          f"kernel launches of one run {counted} != {expected}")
    check(bool(out.isfinite().all()), "plan output is not finite")
    walls = []
    for _ in range(RUNS):
        kernels.reset_launches()
        t0 = time.perf_counter()
        fn({}, inputs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        check(kernels.launches() == expected, "launches changed")
    return counted, statistics.median(walls) * 1e3


def window_path(args, dev, syscat) -> list:
    """Phases 7-10: ``tri_selective_0.01``.  Returns its kernels'
    records."""
    # 7. data (set-up)
    t0 = time.perf_counter()
    rng = np.random.RandomState(SEED)
    analysis, stores, query = windowed_ranking.build_selective_workload(
        rng, SELECTIVITY, **WINDOW)
    table, graph, corpus = stores
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    inputs = windowed_ranking.inputs_for(*stores, query, dev)
    torch.cuda.synchronize()
    t_h2d = time.perf_counter() - t0
    phase("data", path="tri_selective", tweets=table.rows,
          hashtags=graph.n_nodes, edges=graph.n_edges, docs=corpus.n_docs,
          postings=corpus.n_postings, window=SELECTIVITY,
          build_s=round(t_build, 3), h2d_s=round(t_h2d, 3))

    plans = {}
    for plan, (pipe, want, _launches) in WINDOW_PLANS.items():
        fn = repro_torch.compile(analysis, syscat, device="cuda",
                                 rewrite_pipeline=pipe)
        impls = Counter(fn.chosen_impls())
        check(impls == want, f"{plan} plan: chosen impls {dict(impls)} != "
                             f"{dict(want)}")
        plans[plan] = fn

    # 8. kernels at the path's shapes: the unfused plan's intermediates,
    # and the arguments the default plan's run gives its graph and
    # group-by kernels (the sparse seed frontier's two hops; the joined
    # top-64 rows, summed per hashtag)
    unfused = plans["unfused"]
    env = run_env(unfused, inputs)
    window = node_out(unfused, env, "rel_filter_col")
    compacted = node_out(unfused, env, "compact_prefix_col")
    doc_mask = node_out(unfused, env, "sel_mask_rel")
    hits, _ = hits_and_score(unfused, env)
    (cap,) = [int(n.attrs["capacity"]) for n in unfused.concrete.topo()
              if n.impl == "compact_prefix_col"]
    del env
    calls = {"scatter_add": [], "masked_segment_agg": []}
    with recording(graph_store, "scatter_add", calls["scatter_add"]), \
            recording(runtime, "masked_segment_agg",
                      calls["masked_segment_agg"]):
        run_env(plans["default"], inputs)
    torch.cuda.synchronize()
    check(len(calls["scatter_add"]) == 2
          and len(calls["masked_segment_agg"]) == 1,
          f"default plan's kernel calls: "
          f"{ {k: len(v) for k, v in calls.items()} }")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    records = [
        ("default", check_masked_tfidf(dev, inputs["cx"], inputs["q"],
                                       doc_mask)),
        ("default", check_scatter(dev, gen, calls["scatter_add"])),
        ("default", check_segment_agg(dev, gen,
                                      calls["masked_segment_agg"])),
        ("unfused", check_join_probe(dev, gen, compacted.cols["doc"],
                                     hits.cols["doc"], hits.valid)),
        ("compact", check_compact(dev, window, cap))]
    del calls

    # 9. the plans through the entry points; the compaction impl
    torch.cuda.reset_peak_memory_stats()
    counts = {}
    for plan, fn in plans.items():
        counted, run_ms = drive(fn, inputs, WINDOW_PLANS[plan][2])
        counts[plan] = counted
        phase("pushdown", plan=plan, plan_id=fn.plan_id[:12],
              impls=json.dumps(dict(Counter(fn.chosen_impls()))),
              launches=json.dumps({k: v for k, v in counted.items() if v}),
              run_ms=run_ms, runs=RUNS)
    counts["compact"] = compact_impl(dev, window, cap)
    phase("pushdown", setup_s=round(t_build + t_h2d, 3),
          peak_mem_gb=round(torch.cuda.max_memory_allocated() / 1e9, 3))
    for plan, rec in records:
        rec["launches"] = counts[plan][rec["name"]]
        rec["path"] = f"tri_selective/{plan}"
    if args.profile:
        profile_run(plans["default"], inputs, "tri_selective")

    # 10. checks: CPU plain path, pushed vs unpushed, fused vs unfused, rerun
    runs = {plan: hits_and_score(fn, run_env(fn, inputs))
            for plan, fn in plans.items()}
    hits_a, score_a = runs["default"]
    hits_b, score_b = hits_and_score(plans["default"],
                                     run_env(plans["default"], inputs))
    for col in ("doc", "score"):
        check(torch.equal(hits_a.cols[col], hits_b.cols[col]),
              f"top-64 {col} differ between two card runs")
        check(torch.equal(hits_a.cols[col], runs["unpushed"][0].cols[col]),
              f"pushed and unpushed top-64 {col} differ")
        check(torch.equal(hits_a.cols[col], runs["unfused"][0].cols[col]),
              f"default and unfused top-64 {col} differ")
    check(int(hits_a.count) == 64, "the window gave fewer than 64 hits")
    torch.testing.assert_close(score_a, runs["unfused"][1], rtol=RTOL,
                               atol=ATOL)
    torch.testing.assert_close(score_a, runs["unpushed"][1], rtol=RTOL,
                               atol=ATOL)
    fn_cpu = repro_torch.compile(analysis, syscat, device="cpu")
    check(fn_cpu.plan_id == plans["default"].plan_id,
          "CPU plan differs from the card's")
    inputs_cpu = windowed_ranking.inputs_for(*stores, query, "cpu")
    t0 = time.perf_counter()
    hits_c, score_c = hits_and_score(fn_cpu, run_env(fn_cpu, inputs_cpu))
    t_cpu = time.perf_counter() - t0
    check(torch.equal(hits_a.cols["doc"].cpu(), hits_c.cols["doc"]),
          "top-64 ids differ from the CPU plain path")
    torch.testing.assert_close(score_a.cpu(), score_c, rtol=RTOL, atol=ATOL)
    phase("check", path="tri_selective", top64_equal_cpu=True,
          top64_bitwise_unpushed=True, top64_equal_unfused=True,
          top64_bitwise_rerun=True,
          top64_scores_bitwise_cpu=bool(torch.equal(
              hits_a.cols["score"].cpu(), hits_c.cols["score"])),
          score_bitwise_rerun=bool(torch.equal(score_a, score_b)),
          score_max_abs_err_cpu=float((score_a.cpu() - score_c).abs().max()),
          cpu_plain_s=round(t_cpu, 3))
    return [rec for _plan, rec in records]


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one run of each path (torch.profiler)")
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

    syscat = SystemCatalog(hardware=hardware_for_device(name))
    records = pulse_path(args, dev, syscat)
    torch.cuda.empty_cache()
    records += window_path(args, dev, syscat)

    # 11. results
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "path")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
