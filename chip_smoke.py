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
     ``nvcc`` each, all started together; ``ptxas -v``'s registers, and
     the count of HGMMA (``wgmma``), HMMA (``mma.sync``), MATCH, ATOMS
     and ATOMS.CAST.SPIN instructions in each library's SASS
     (``cuobjdump -sass``): flash_attention and moe_gmm must have HGMMA,
     ssd and wkv6 HMMA, masked_segment_agg MATCH and shared-memory ATOMS;
     none of the five spills;

  ``hashtag_pulse`` (tri-model analysis, slice 1):

  3. data     — the example's tweets / co-mention graph / corpus at full
     size from seed 0, and their copy to the card (set-up time);
  4. kernel   — scatter_add and masked_segment_agg against their plain
     PyTorch versions on the card, at the path's shapes and at edge cases
     (one line each, ``[kernel-edge]``; the group-by's include every row
     on one key, the path's keys at the top ids, uniform keys over 131,072
     and 2^22 + 3 groups that overflow its CTA tables, G = 1, views off
     16-byte alignment and dyadic weights); call and device times
     (``ms``, ``device_ms``, as in phase 8) of the kernel and of one
     PyTorch library call, the plain version's CUDA-event median, beside
     the byte bound at 3.35 TB/s (the group-by also prints an estimate of
     its traffic at 32-byte sectors, ``sectors_mb_est``, computed from
     its inputs, not measured).  scatter_add is timed on the
     dst-ordered edge copy the path hands it and on the same SpMV in CSR
     order (``csr_*``), with ``index_add_`` on each;
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
     arguments one run of the default plan gives them.  For the five
     tri-store kernels ``ms`` is the call as a path sees it (one event
     pair around one call, host dispatch included) and ``device_ms`` the
     card's work alone: 64 calls captured
     in one CUDA graph, replayed between an event pair, over 64 (where a
     call cannot be captured, its kernels' time under ``torch.profiler``,
     and the line says so); the library call gets both too;
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

  ``tri_influence`` (the influencer rollup: the tri-model analysis with a
  non-unique, capacity-bounded join, slice 10):

 10a. data    — ``benchmarks/tri_store_sharded.py``'s one-shard workload
     from seed 0 (``repro_torch.examples.tri_influence``): 8M tweets (cut
     from 10M: the join's ``capacity = tweets`` must stay below its 2^23
     guard), 1M documents, 131,072 hashtags with 1,310,720 random pairs
     made symmetric, 65,536 influencer rows with non-unique ``user`` keys;
     their copy to the card (set-up time);
 10b. main    — the analysis through ``repro_torch.compile``: the chosen
     impls (the bounded join fused into a group-by chain,
     ``rel_fused_agg_pallas``) and the kernel launches of one run, both
     exact, and the median wall time of 5 runs, as in phase 5;
 10c. check   — the card against the port's plain path on the CPU at the
     same size: the three per-hashtag rollups and the output allclose, the
     top-64 doc ids exact, the bounded join (``hash_join_nonunique`` on the
     plan's viral tweets and the influencer table) equal in every slot,
     count and overflow; a second card run bitwise equal to the first;
 10d. kernel  — masked_segment_agg and scatter_add on the very arguments
     one run gives them (the join-fed group-by first: R = 8M slots, the
     join's ~3M matches a valid prefix), timed as in phase 8; their edge
     cases ran in phases 4 and 8;
 10e. join-edge — ``hash_join_nonunique`` on the card equal to the CPU in
     every slot: the path's join at capacity 2^20 (overflow, count =
     capacity), 5,000 x 5,000 equal keys at capacity 1,000 (25M true
     matches, past 2^24), an empty probe side, an empty build side, and
     invalid build rows among equal keys;
 10f. append  — 80,000 tweets and 10,000 documents (1 %, seed 1) appended
     on the host: versions bump, recompiling misses the plan cache with a
     new plan id and then hits; the run over the appended stores bitwise
     equal to the same analysis over stores built fresh from the
     concatenated arrays (join capacity still 8M);
 10g. tricount — ``graph_tricount`` planned (``graph_tricount_csr``: one
     dense float32 n x n product) on a symmetric random graph of 16,384
     nodes, 10 pairs a node: exactly equal to the host's int64 count by
     edge-list intersection, divided by 6 in float32; its time;
 10h. collections — an ADIL program that maps a one-op subplan (relu²)
     over a ListT of 8 float32 vectors of 131,072 values, filters them by
     their max and folds the kept ones: card bitwise equal to the CPU;

  ``qwen3_serve`` (qwen3-0.6b served by the async runtime, slice 3):

 11. data     — qwen3-0.6b at full width (28 layers, d_model 1024, 16 / 8
     heads, head_dim 128, vocab 151,936; bfloat16 activations, float32
     parameters) from ``he_init`` on a seeded generator on the card;
 12. serve-kernel — flash_attention against its plain version on the card
     at the prefill's shapes (causal bfloat16 at each bucket 128-2048: the
     batched-prefill width 4 that the serve launches, its two pad rows and
     the prompts' pad tails built as the runtime builds them, and batch 1,
     the shape warmup also runs) and at edge cases
     (float32, non-causal, window, ragged lengths, q_len < kv_len, MQA,
     fully-masked rows, the heads-major entry, head_dim 160 and 256 in
     both dtypes, 72 and 112 with GQA 6 in bfloat16); CUDA-event medians
     of the kernel, the plain version and ``scaled_dot_product_attention``
     (timed only, never called by the port), beside the bound; also
     stablelm-12b's prefill shape (4 x 2048, 32 / 8 heads of 160), which
     no path here serves;
 13. serve    — ``AsyncServingRuntime`` (engines xla + pallas, 4 decode
     slots, max_seq 2048, page size 16) on 8 requests of 100 / 500 / 1000 /
     2000 prompt tokens, 32 generated each: warmup, then serve with the
     launch counts set to 0 just before it; chosen impls per bucket, TTFT
     per request, decode and total tokens/s, plan-cache hit rate, pool
     occupancy;
 14. check    — flash launches = 28 x the prefill forwards; 100 % plan-cache
     hits after warmup; a float32 run of the same trace token for token
     equal to ``serve_sequential``; a 2-request float32 sub-trace (prompts
     100 and 500, 8 generated) on the card against the port's plain path on
     the CPU (first-token logits allclose, token streams equal up to the
     first step whose top-2 logit margin is within the tolerance);

 ``rwkv6_serve`` and ``zamba2_serve`` (the recurrent families served by the
  async runtime through its replay fallback, slice 4), each in turn, the
  model before it freed:

 15./19. data — rwkv6-3b (32 layers, d_model 2560, 40 heads of 64, vocab
     65,536) / zamba2-7b (81 mamba blocks, d_model 3584, 112 SSD heads of
     64, state 64, and a shared attention block of 32 heads of 112 every 6
     blocks; vocab 32,000) at full width and depth, bfloat16 activations,
     float32 parameters from ``he_init`` on a seeded generator on the card:
     parameter count, bytes, seconds;
 16./20. serve — ``AsyncServingRuntime`` (engines xla + pallas, 4 decode
     slots, max_seq 2048, page size 16; replay mode) on 4 requests of 100 /
     500 / 1000 / 2000 prompt tokens, 16 generated each: warmup, then serve
     with the launch counts set to 0 just before it and the kernel's (and
     flash attention's) arguments recorded at each bucket; chosen impls per
     bucket; prefill, replay and adopt ms per request; TTFT; decode and
     total tokens/s; plan-cache hits; pool occupancy;
 17./21. kernel — wkv6 / ssd against its plain version (the sequential
     recurrence) on the card on the very arguments each bucket's planned
     prefill gave it, and at edge cases (T = 1, T = 300, B = 2, float32 and
     bfloat16, decay 1.0 exactly, 1e-6 and mixed per channel / per head,
     T around the kernels' chunk of 64 and sub-chunk of 16 (63, 65, 33),
     inputs as views 2 bytes past 16-byte alignment, ssd's b and c shared
     over heads with stride 0 and per head); at each bucket the call's
     CUDA-event median (``ms``, host dispatch included), its device time
     (``device_ms``, 64 calls in one CUDA graph) and the plain version's,
     beside the bound: bytes at 3.35 TB/s against the chunked form's
     matrix products at the tensor-core rate of the operands' type plus
     its other operations at the float32 rate (``seq_bound_ms``: the
     sequential form's operations at the float32 rate, the bound before
     the kernels moved to the tensor cores).  No single PyTorch call
     computes either recurrence: ``library_ms`` is null.  zamba2-7b:
     flash attention at head_dim 112 on the arguments its prefills gave
     it, timed beside ``scaled_dot_product_attention``;
 18./22. check — wkv6 launches = 32 x the prefill forwards, ssd launches =
     81 x, flash launches = 13 x the zamba2 forwards whose plan picked
     ``attn_flash_pallas``; 100 % plan-cache hits after warmup; a float32
     run of a 2-request sub-trace (prompts 100 and 500, 8 generated)
     through the runtime token for token equal to ``serve_sequential``;
     the float32 planned prefill at bucket 512 with the kernel (xla +
     pallas) against the chunked plain engine (xla): last-position logits
     within 2e-3; rwkv6-3b only: one float32 request (prompt 48, 4
     generated; each CPU decode step reads 12.3 GB of float32 weights, so
     the prompt is cut from 100 to keep the run near 6 minutes) on the
     card against the port's plain path on the CPU, as the qwen3
     sub-trace.  zamba2-7b's CPU side would hold 26.5 GB of
     float32 parameters, so its card-against-CPU check stays with the CPU
     tests at SMOKE width (``tests/test_torch_recurrent_*.py``);

  ``dbrx_serve`` (dbrx-132b served by the async runtime through its
  planned ``prefill_kv``, slice 5), after the recurrent models are freed:

 23. data     — dbrx-132b at full width (d_model 6144, 48 / 8 heads of
     128, 16 experts top-4 of d_ff 10752, vocab 100,352; bfloat16
     activations, float32 parameters from ``he_init`` on a seeded generator
     on the card) and **2 of its 40 layers**: every dbrx layer is MoE, so 2
     layers are 2 whole periods of its pattern; the float32 tree holds 31.0
     GB at 2 layers and 44.0 GB at 3, where the runtime's bf16 copies of
     the projections and experts add 19.6 GB, so a third layer does not fit
     the card's 80 GB beside the activations of a width-4 prefill at 2048.
     Parameter count (the tree's, and ``param_count()`` without the norm
     scales), bytes, seconds, peak memory;
 24. serve    — ``AsyncServingRuntime`` (engines xla + pallas, 4 decode
     slots, max_seq 2048, page size 16; ``prefill_kv`` mode) on 8 requests
     of 100 / 500 / 1000 / 2000 prompt tokens, 16 generated each: warmup,
     then serve with the launch counts set to 0 just before it, the gmm and
     flash arguments recorded at each bucket, and each prefill's dropped
     MoE assignments (``~keep``, of prompt tokens and of all tokens) and
     host time; chosen impls per bucket (``moe_gmm_pallas``,
     ``attn_flash_pallas``), TTFT, decode and total tokens/s, plan-cache
     hits, pool occupancy;
 25. serve-kernel — gmm against its plain version (a float32 einsum) on
     the card on the very arguments each bucket's planned prefill gave it,
     in both shapes (``wi`` / ``wg``: (16, C, 6144) @ (16, 6144, 10752);
     ``wo``: (16, C, 10752) @ (16, 10752, 6144); C = width x capacity), and
     at edge cases (float32; C, D and F no multiple of a tile: 20, 12, 28
     and 300, 1000, 600; E = 1; C = 1; all-zero capacity rows; a weight
     view at an offset in a stacked tree, read in place, and one 8 bytes
     off the TMA alignment, copied first; a non-contiguous x); CUDA-event
     medians (5 launches where one
     takes over 50 ms) of the kernel, the plain version and ``torch.bmm``
     (timed only, never called by the port) beside the bound, which counts
     every capacity slot (E x C rows) the kernel computes.  Flash attention
     on the arguments dbrx's prefills gave it (GQA 48 / 8, head_dim 128),
     timed beside ``scaled_dot_product_attention``;
 26. check    — gmm launches = 3 x 2 MoE layers x the prefill forwards and
     flash launches = 2 x them, exactly; 100 % plan-cache hits after
     warmup; a float32 sub-trace (prompts 100 and 500, 8 generated)
     through the runtime token for token equal to ``serve_sequential``
     for every request whose prefill dropped no prompt token's assignment
     (the runtime seeds K/V from its capacity-dispatched prefill, the
     sequential path replays the prompt through the decode step, which
     never drops); otherwise first tokens equal and the first-token logits
     of the two planned forwards (``prefill_kv``, ``prefill``) within
     ``2e-3``; ``moe_gmm`` against
     ``moe_dense`` at capacity factor 2.0 on layer 0's recorded float32 MoE
     input at bucket 512 (the same dispatch: ``keep`` and ``dest`` equal,
     outputs within the float32 tolerance); the CUDA-graph decode step,
     with the capacity dispatch inside it, bitwise equal to the eager
     step on random caches.  A card-against-CPU check at
     full width would need 31 GB of float32 parameters on the host and is
     left out; the CPU tests hold the port against the reference at SMOKE
     width (``tests/test_torch_moe_*.py``);

  ``multi_query`` (many analysts over one tri-store, and the resilience
  layer, slice 12):

 28. data     — hashtag_pulse's stores at full size from seed 0 (10M
     tweets, 131,072 hashtags) and the 11 query vectors (6 random terms
     each) of ``benchmarks/multi_query.py``'s 16 clients; their copy to the
     card (set-up time);
 29. [mq]     — the benchmark's programs (``repro_torch.examples.
     multi_query``: the heavy tri-query at its full iters=24, the light
     text-relevance one), planned with the kernel slot: the heavy plan's
     impls are hashtag_pulse's.  16 clients (4 exact twins, 2 x 2 heavy
     queries that differ only in ``q``, 8 light queries batched on ``q``;
     tenants ``client{i % 4}``): each alone through ``__call__`` (its
     launches its plan's), then one at a time through ``run_analysis`` on
     a runtime without a subplan cache (the sequential wall), then all
     through ``serve_analyses`` on a runtime whose subplan budget is twice
     the bytes a probe pass caches (the multi-query wall, warm).  Checked:
     the deduped / batched / shared_hits counters equal the reference
     runtime's for the same workload (``mq.SMOKE_COUNTERS``, held on the
     CPU by ``tests/test_torch_mqo.py``), no ``batch_fallback``, every
     deduped or cache-served result bitwise its isolated run, batched ones
     bitwise or within ``rtol=1e-5, atol=1e-6`` (max error printed), the
     kernel launches equal the executed nodes' (each residual's, one light
     plan a batched row), one host copy a query (``content_key``), the
     cache within its budget, its ledger bytes the cache's and gone after
     ``clear()``.  ``[mq-batched]``: the group-by's batching rule on the
     light queries' recorded arguments under ``torch.func.vmap`` (one
     launch a row) against a loop of unbatched calls and the plain version;
     then scatter_add and masked_segment_agg timed on the heavy and light
     runs' arguments, as in phase 8;
 30. [resilience] — hashtag_pulse's plan under a ``ResilientExecutor``: a
     persistent fault at ``rel_fused_agg_pallas`` opens the breaker and
     re-plans without the kernel slot (a new plan id, no ``_pallas`` impl,
     0 launches, output within the float tolerance); the chaos spec
     ``seed=0,rate=0.05`` over 8 runs retries the same plan to the
     fault-free output bitwise; a ``KernelError`` raised in the group-by
     impl fails in one attempt with the breaker closed, and a plain
     ``RuntimeError`` there is retried 3 times on the base plan with the
     breaker closed (only an injected fault re-plans);
 31. [degrade] — the heavy query through ``run_analysis(degrade=2)``: k
     64 -> 8 and iters 24 -> 3 under a new plan id, the impls and the
     bitwise output of a direct compile of the clamped program, scatter_add
     launches 26 -> 5;
 32. [serve-faults] — qwen3-0.6b at full width serving phase 13's 8
     requests under the chaos spec, twice (one schedule), against a
     fault-free run at ``prefill_batch`` 1: every request terminates, ok
     ones token for token the fault-free run's, flash launches 28 x the
     prefill forwards, the pool empty and no ledger leak; then a request
     whose deadline has passed at submit and, through ``serve()`` on a
     fresh runtime, one whose budget (request 0's prefill plus 2.5
     fault-free decode steps) runs out mid-decode: cut at a token
     boundary, its partial tokens a prefix of the fault-free run's, its
     pages returned;

 33. the kernels' JSON line, then ``{"ok": true, "device": ...}`` last.

Observability (EXPLAIN ANALYZE and the resource ledger, slice 11), inside
the paths above:

  [ledger]     — in phases 3, 7 and 10a, the default memory ledger reset
     just before the inputs are built: each store's entry holds its
     payload's tensor bytes (plus 4 bytes a host int, as the reference
     counts a host leaf), each kind's total is its stores' sum, and the
     rise of ``torch.cuda.memory_allocated()`` over the build lies between
     the payload and query tensors' bytes rounded up to the allocator's
     512-byte blocks and that plus 1 MiB for each tensor over 1 MiB (a
     cached block is handed out whole when the rest would be 1 MiB or
     less); predicted / actual bytes a store.  After phase 13: the
     runtime's telemetry snapshot, the KV pool's entry equal to the pool's
     tensor bytes, every kept prefill plan in the ledger, no leaks;
  [analyze]    — after phases 6, 10 and 10c, on ``hashtag_pulse``,
     ``tri_selective_0.01``'s default plan and ``tri_influence``:
     ``fn.analyze`` driven as in phase 5 (its kernel launches those of
     ``__call__``), its output bitwise ``__call__``'s, one device->host
     copy a run (the tracer's one copy, counted), each op span's count /
     overflow / capacity and the count sink equal to the CPU port's traced
     run of the same plan, the Chrome export valid (written under a
     temporary directory); the synchronizing calls of one ``__call__`` and
     one ``analyze`` under ``torch.cuda.set_sync_debug_mode("warn")``;
     untraced and traced wall times as interleaved medians of 11 pairs and
     the overhead beside the reference's 5 % bar (reported, not gated);
  [analyze-op] — one line per concrete node of those plans: impl, the cost
     model's prediction, the span's dispatch ms (median over the pairs) and
     the node's synced ms (the plan run one node at a time through
     ``run_plan_subset``, a ``torch.cuda.synchronize()`` before and after
     each node, median of 5);
  [observe]    — after phase 10: ``observe`` on the card and on the CPU
     port give one feedback fingerprint, re-planning with it one plan id,
     and the re-planned run the first run's top-64.

``--paths a,b`` runs only the named paths (``[time]`` lines name them).
With ``--profile`` it also runs each path's default plan (a second serve
of the qwen3 and dbrx traces on the same runtime; for each recurrent
family a serve of one request of 100 prompt tokens) once under
``torch.profiler`` and prints the device time of the 15 costliest kernels
and the device's idle share of that run.

Tolerances: counts, ids and top-k order exact; float sums
``rtol=1e-5, atol=1e-6`` (atomics add in a run-dependent order).  Flash
attention against its plain version: ``8 x 2e-5`` in float32 (the
reference's kernel-test tolerance: the same float32 math in another
summation order) and ``1e-2`` absolute and relative in bfloat16.  The
reference's ``8 x 2e-2`` would be no test here: with unit-normal q, k and
v an output row over n keys has a spread of about sqrt(e / n), 0.05 at
n = 2048, so 0.16 would pass a kernel that drops a key tile or reads
another row's K/V.  Both sides round one float32 result to bfloat16, so
they differ by about one bfloat16 ulp (0.0039 at |x| ~ 1), which 1e-2
still clears; the tensor-core kernel's one further rounding (P to
bfloat16 before P V) moves the float32 result by at most ~2e-3 at the
served shape (``tests/test_torch_flash_attention.py::
test_p_rounding_stays_inside_bfloat16_tolerance``).
Logits card against CPU: ``2e-3`` absolute and relative (float32 end to
end; cuBLAS and the kernel against MKL and the plain softmax, summed in
other orders through 28 layers); the same for the kernel's prefill
against the chunked engine's.  WKV6 and SSD against their sequential
plain versions: ``1e-4`` absolute and relative in float32 (one float32
sum order against another over up to 2048 steps: the kernel sums a
column's terms in index order, the plain version through einsum), ``1e-2``
in bfloat16 (both round one float32 result to bfloat16: one ulp apart at
most, 2^-8 relative).  gmm against its plain version: ``1e-4`` absolute
and relative in float32 (the kernel's FMA sums over up to 10,752 terms in
ascending order against cuBLAS's order) and ``1e-2`` in bfloat16 (both
round one float32 sum to bfloat16: one ulp apart at most); ``moe_gmm``
against ``moe_dense`` in float32: ``1e-4``, the same sums again.
"""
from __future__ import annotations

import contextlib
import gc
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core.adil import Analysis  # noqa: E402
from repro_torch.core.adil_parser import parse_adil  # noqa: E402
from repro_torch.core import mqo, tracing  # noqa: E402
from repro_torch.core.engines import dispatch  # noqa: E402
from repro_torch.core.executor import (ExecContext,  # noqa: E402
                                       plan_and_compile, run_plan_subset)
from repro_torch.core.faults import FaultInjector  # noqa: E402
from repro_torch.core.feedback import SelectivityFeedback  # noqa: E402
from repro_torch.core.ir import (ListT, Plan, SystemCatalog,  # noqa: E402
                                 TensorT, hardware_for_device,
                                 standard_catalog)
from repro_torch.core.ledger import (FlightRecorder,  # noqa: E402
                                     MemoryLedger, default_ledger,
                                     reset_default_ledger)
from repro_torch.core.resilience import (CircuitBreaker,  # noqa: E402
                                         ExecError, ResilientExecutor,
                                         RetryPolicy)
from repro_torch.core.rewrite import (DEFAULT_PIPELINE,  # noqa: E402
                                      UNPUSHED_PIPELINE)
from repro_torch.examples import multi_query as mq  # noqa: E402
from repro_torch.examples import tri_influence  # noqa: E402
from repro_torch.examples import windowed_ranking  # noqa: E402
from repro_torch.examples.tri_model_analysis import (  # noqa: E402
    adil_script, build_social_data, inputs_for)
from repro_torch.kernels import build, masked_kernels  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_mask, flash_attention, flash_attention_hmajor,
    flash_attention_plain)
from repro_torch.kernels.graph_kernels import (  # noqa: E402
    scatter_add, scatter_add_plain)
from repro_torch.kernels.ssd import ssd, ssd_reference  # noqa: E402
from repro_torch.kernels.wkv6 import wkv6, wkv6_reference  # noqa: E402
from repro_torch.layers import attention as attention_layer  # noqa: E402
from repro_torch.layers import mamba as mamba_layer  # noqa: E402
from repro_torch.layers import moe as moe_layer  # noqa: E402
from repro_torch.layers import rwkv as rwkv_layer  # noqa: E402
from repro_torch.layers.common import rope  # noqa: E402
from repro_torch.kernels.moe_gmm import gmm, gmm_reference  # noqa: E402
from repro_torch.kernels.masked_kernels import (  # noqa: E402
    compact_prefix, compact_prefix_plain, join_probe, join_probe_plain,
    masked_segment_agg, masked_segment_agg_plain, masked_tfidf,
    masked_tfidf_plain)
from repro_torch.core.plan_cache import PlanCache  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.lm import CATALOG  # noqa: E402
from repro_torch.models.decode import (DecodeGraph,  # noqa: E402
                                       decode_step_batched, init_cache)
from repro_torch.serving import (AnalysisRequest,  # noqa: E402
                                 AsyncServingRuntime, DegradePolicy,
                                 ServeRequest, bucket_len, serve_sequential)
from repro_torch.stores import (BoundedRel, ColumnStore,  # noqa: E402
                                GraphStore, TextStore, graph_store, runtime,
                                store_engines)
from repro_torch.stores.column_store import (  # noqa: E402
    hash_join_nonunique)
from repro_torch.stores.text_store import tfidf_scores  # noqa: E402

FULL = {"tweets": 10_000_000, "users": 500_000, "hashtags": 131_072,
        "vocab": 65_536}
# tri_store_eff.py's selective workload, its table scaled to slice 1's 10M
# tweets: 0.6 edges and 12-19 terms per tweet, hashtags and vocab as FULL
WINDOW = {"tweets": 10_000_000, "hashtags": 131_072, "edges": 6_000_000,
          "vocab": 65_536, "terms_lo": 12, "terms_hi": 20}
SELECTIVITY = 0.01
# tri_influence: benchmarks/tri_store_sharded.py's one-shard workload at
# the recipe's sizes (7.5 tweets a document, ~10 graph pairs a hashtag)
INFLUENCE = {"tweets": 8_000_000, "docs": 1_000_000, "hashtags": 131_072,
             "edges": 1_310_720, "vocab": 65_536, "terms_hi": 8, "iters": 3,
             "influencers": 65_536,
             "cut": "tweets 10M -> 8M: the join's capacity = tweets must "
                    "stay below its 2^23 guard (8,388,608)"}
APPEND = {"tweets": 80_000, "docs": 10_000, "seed": 1}
JOIN_EDGE_CAP = 1 << 20       # below the path's ~3.0M matches: overflow
TRICOUNT = {"nodes": 16_384, "pairs_per_node": 10}
COLLECTION = {"vectors": 8, "length": 131_072}
SEED = 0
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
FP64_FLOPS = 34e12              # H100 SXM data sheet, outside tensor cores
FP32_FLOPS = 67e12              # H100 SXM data sheet, outside tensor cores
BF16_FLOPS = 989e12             # H100 SXM data sheet, dense tensor cores
RTOL, ATOL = 1e-5, 1e-6
REPS = 21
RUNS = 5
PAIRS = 11             # interleaved untraced / traced runs of [analyze]
NODE_REPS = 5          # node-at-a-time synced runs of [analyze-op]
ALLOC_BLOCK = 512      # the caching allocator's block granularity (bytes)
ALLOC_SLACK = 1 << 20  # a cached block it hands out whole: up to 1 MiB more
# the plan inputs that are store payloads, and the ledger kind of each
STORE_KINDS = {"tweets": "column_store", "infl": "column_store",
               "g": "graph_store", "cx": "text_store"}
GRAPH_CALLS = 64       # calls captured in one CUDA graph for device_ms
TOPK_IMPLS = ("text_topk_inv", "text_topk_skip_inv", "text_topk_masked_pallas",
              "masked_topk_xla")
# the table's float columns: what the compaction kernel may carry
FLOAT_COLS = ("engagement",) + tuple(f"metric{i}" for i in range(8))
# qwen3_serve: the served model and trace, and the CPU sub-trace
SERVE = {"arch": "qwen3-0.6b", "requests": 8,
         "prompt_lens": (100, 500, 1000, 2000), "gen": 32, "max_batch": 4,
         "max_seq": 2048, "page_size": 16}
SUBTRACE = {"prompt_lens": (100, 500), "gen": 8, "max_seq": 1024}
FLASH_TOL = {torch.float32: 8 * 2e-5, torch.bfloat16: 1e-2}
LOGIT_TOL = 2e-3
# rwkv6_serve / zamba2_serve: the served trace, the float32 sub-trace
# (runtime against serve_sequential; the kernel's prefill against the
# chunked engine's at engine_bucket) and rwkv6-3b's CPU request
RSERVE = {"requests": 4, "prompt_lens": (100, 500, 1000, 2000), "gen": 16,
          "max_batch": 4, "max_seq": 2048}
RSUB = {"prompt_lens": (100, 500), "gen": 8, "engine_bucket": 512}
RCPU = {"prompt_lens": (48,), "gen": 4, "max_seq": 256}
RECURRENT_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# dbrx_serve: dbrx-132b at full width, 2 of its 40 layers; the served
# trace, the float32 sub-trace and the bucket of the moe_gmm / moe_dense
# comparison
DBRX = {"arch": "dbrx-132b", "n_layers": 2, "requests": 8,
        "prompt_lens": (100, 500, 1000, 2000), "gen": 16, "max_batch": 4,
        "max_seq": 2048,
        "cut": "n_layers 40 -> 2: float32 parameters 31.0 GB at 2 layers, "
               "44.0 GB at 3, with 19.6 GB of bf16 expert copies: 3 do not "
               "fit 80 GB"}
DSUB = {"prompt_lens": (100, 500), "gen": 8, "moe_bucket": 512}
# multi_query: benchmarks/multi_query.py's 16 clients and programs (the
# heavy one at its full iters=24) over hashtag_pulse's stores; the subplan
# budget is budget_factor x the bytes a probe pass caches (room for all)
MQ = {"iters": 24, "probe_budget": 8 << 30, "budget_factor": 2}
MQ_LIGHT_IMPLS = Counter({"xfer_pin": 3, "text_topk_inv": 1,
                          "rel_fused_agg_pallas": 1, "col_tensor_rel": 1,
                          "store": 1})
CHAOS = "seed=0,rate=0.05"    # benchmarks/serving_throughput.py's chaos spec
RESILIENCE_RUNS = 8           # runs of hashtag_pulse under the chaos spec
DEGRADE_LEVEL = 2             # DegradePolicy's survival rung: k 8, iters 3
GMM_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
RECURRENT = {
    "rwkv6-3b": {
        "name": "wkv6", "path": "rwkv6_serve", "kernel": wkv6,
        "plain": wkv6_reference, "module": rwkv_layer,
        "entry": "wkv6_kernel", "impl": "wkv6_pallas",
        "xla": "wkv6_scan_xla",
        "source": "src/repro_torch/kernels/csrc/wkv6.cu",
        "replaces": "src/repro/kernels/wkv6/wkv6.py:70", "cpu_check": True},
    "zamba2-7b": {
        "name": "ssd", "path": "zamba2_serve", "kernel": ssd,
        "plain": ssd_reference, "module": mamba_layer,
        "entry": "ssd_kernel", "impl": "ssd_pallas",
        "xla": "ssd_chunked_xla",
        "source": "src/repro_torch/kernels/csrc/ssd.cu",
        "replaces": "src/repro/kernels/ssd/ssd.py:76", "cpu_check": False},
}


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


# the influencer rollup's plan at 8M tweets: chosen impls (the bounded
# join fused into a group-by chain, rel_fused_agg_pallas) and the kernel
# launches of one run (2 expansion hops + 3 PageRank iterations; the
# text join's and the bounded join's group-bys)
INFLUENCE_IMPLS = Counter({
    "rel_scan_col": 1, "rel_fused_col": 1, "rel_group_agg_col": 1,
    "col_tensor_rel": 3, "xfer_pin": 6, "graph_expand_pallas": 1,
    "graph_pagerank_pallas": 1, "text_topk_inv": 1,
    "rel_fused_agg_pallas": 2, "residual_add_xla": 2, "store": 1})
INFLUENCE_LAUNCHES = launch_counts(scatter_add=5, masked_segment_agg=2)


# the SASS opcodes each library must hold: the tensor-core kernels'
# bfloat16 path (HGMMA: wgmma; HMMA: mma.sync) and the group-by's on-chip
# reduction (MATCH: the warp match; ATOMS: its shared-memory table); ptxas
# must report no spills for them
SASS_REQUIRED = {"flash_attention": ("HGMMA",), "moe_gmm": ("HGMMA",),
                 "ssd": ("HMMA",), "wkv6": ("HMMA",),
                 "masked_segment_agg": ("MATCH", "ATOMS")}
# counted beside them, not required: the shared float64 add compiled as a
# compare-and-swap loop (ATOMS.CAST.SPIN.64)
SASS_COUNTED = ("ATOMS.CAST.SPIN",)


def sass_counts(opcodes) -> dict:
    """How often each of ``opcodes`` (an opcode, or its first modifiers:
    ``ATOMS`` counts ``ATOMS.CAS`` too) appears in each built library's
    SASS, from the toolkit's ``cuobjdump -sass`` (or Triton's copy of it):
    ``{library: {opcode: count}}``."""
    tool = Path(build.nvcc_path()).parent / "cuobjdump"
    if not tool.exists():
        import triton
        tool = Path(triton.__file__).parent / "backends/nvidia/bin/cuobjdump"
    out = {}
    for name in build.sources():
        text = subprocess.run(
            [str(tool), "-sass", str(build.lib_path(name))],
            capture_output=True, text=True, check=True, timeout=120).stdout
        out[name] = {op: len(re.findall(rf"\b{re.escape(op)}\b", text))
                     for op in opcodes}
    return out


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


def device_ms(fn, calls=GRAPH_CALLS, reps=5, capture=True):
    """Device time of one call of ``fn`` in milliseconds, without its host
    dispatch: ``calls`` calls captured in one CUDA graph, replayed between
    an event pair (median of ``reps`` replays), over ``calls``.  Warmed up
    first on a side stream, so one-time set-up (a kernel's shared-memory
    attribute, a library's handles) runs outside the capture.  Where the
    call cannot be captured (``capture=False``: it synchronizes, or the
    capture fails), the CUDA kernels' device time of ``calls`` calls under
    ``torch.profiler``, over ``calls``.  Returns ``(ms, via)``, ``via``
    "graph" or "profiler"."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    if capture:
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                for _ in range(calls):
                    fn()
        except RuntimeError as exc:
            phase("device-ms", via="profiler",
                  reason=json.dumps(str(exc).splitlines()[0][:120]))
        else:
            graph.replay()
            torch.cuda.synchronize()
            times = []
            for _ in range(reps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                graph.replay()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            del graph
            return statistics.median(times) / calls, "graph"
        del graph
        torch.cuda.synchronize()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) == DeviceType.CUDA:
            t = getattr(ev, "self_device_time_total", None)
            us += t if t is not None else getattr(ev, "self_cuda_time_total",
                                                   0)
    return us / 1e3 / calls, "profiler"


def timings(kernel, library, capture_library=True) -> dict:
    """The call and device times of a kernel's wrapper and of its library
    call, on the same inputs: ``ms`` / ``library_ms`` are CUDA-event
    medians of one call each (host dispatch included, as a path sees it);
    ``device_ms`` / ``library_device_ms`` are from :func:`device_ms`."""
    out = {"ms": cuda_ms(kernel), "library_ms": cuda_ms(library)}
    out["device_ms"], out["device_ms_via"] = device_ms(kernel)
    out["library_device_ms"], out["library_device_ms_via"] = device_ms(
        library, capture=capture_library)
    return out


def free_memory():
    """Collect a path's dead objects (a runtime whose methods were wrapped
    in ``timed`` sits in a reference cycle and holds its cast parameters)
    and return the cached blocks to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def bound(nbytes, nops, ops_rate):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = nops / ops_rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# -- phase 4: kernels against their plain versions ------------------------


def scatter_edges(dev, gen) -> list:
    """scatter_add's edge cases: ``(case, vals, dst, n_nodes)``."""
    def rand(e):
        return torch.rand(e, generator=gen, device=dev)

    def ints(lo, hi, e):
        return torch.randint(lo, hi, (e,), generator=gen, device=dev,
                             dtype=torch.int32)

    def ordered(lo, hi, e):
        return torch.sort(ints(lo, hi, e)).values

    # padding: -1 at the front, both -1 and >= N inside a run, >= N at the
    # end; the run of node 500 goes on after its padding
    pad = ordered(0, 1000, 100_003)
    pad[:100] = -1
    run = torch.nonzero(pad == 500).flatten()
    pad[int(run[len(run) // 3])] = -1
    pad[int(run[len(run) // 2])] = 1000
    pad[-77:] = 1000
    big = ints(-1, 1002, 6_000)
    v5m = rand(5_000_000)
    d_aligned = ordered(0, 300, 10_001)
    v_aligned = rand(10_001)
    return [
        ("no edges", rand(0), ints(0, 1000, 0), 1000),
        ("random -1 and >= N padding", rand(5000), ints(-1, 1002, 5000),
         1000),
        ("random, N 131,073", rand(777), ints(-1, 131_075, 777), 131_073),
        ("every edge on one node, E 5M", v5m,
         torch.full((5_000_000,), 7, dtype=torch.int32, device=dev), 1000),
        ("sorted, padding at front / inside a run / at the end",
         rand(100_003), pad, 1000),
        ("sorted, E % 2048 and E % 4 != 0", rand(3 * 2048 + 3),
         ordered(0, 50, 3 * 2048 + 3), 50),
        ("misaligned views vals[1:], dst[1:]", v_aligned[1:],
         d_aligned[1:], 300),
        ("E < 32", rand(17), ordered(-1, 5, 17), 4),
        ("random unsorted", rand(6000), big, 1000),
        ("sorted, N 131,073", rand(300_000), ordered(0, 131_073, 300_000),
         131_073),
    ]


def check_scatter(dev, gen, calls, unordered=None, edges=True):
    """scatter_add on each of ``calls``, the ``(vals, dst, n_nodes)`` the
    path gives it (the dst-ordered edge copy), and at the edge cases unless
    ``edges`` is false; the first call is timed, and so is ``unordered``,
    the same SpMV's arguments in CSR (source) order, where given.  Returns
    its JSON record."""
    err = 0.0
    for vals, dst, n_nodes in calls + ([unordered] if unordered else []):
        got, want = scatter_add(vals, dst, n_nodes), scatter_add_plain(
            vals, dst, n_nodes)
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        err = max(err, float((got - want).abs().max()))
    for case, v, d, n in scatter_edges(dev, gen) if edges else ():
        got, want = scatter_add(v, d, n), scatter_add_plain(v, d, n)
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        phase("kernel-edge", name="scatter_add", case=json.dumps(case),
              E=int(d.shape[0]), N=n,
              max_abs_err=float((got - want).abs().max()))
    vals, dst, n_nodes = calls[0]
    t = timings(lambda: scatter_add(vals, dst, n_nodes),
                lambda: torch.zeros(n_nodes, device=dev).index_add_(
                    0, dst, vals))
    plain_ms = cuda_ms(lambda: scatter_add_plain(vals, dst, n_nodes))
    e = int(dst.shape[0])
    landed = int(((dst >= 0) & (dst < n_nodes)).sum())
    runs = int((dst[1:] != dst[:-1]).sum()) + 1 if e else 0
    bound_ms, bound_by = bound(4 * e + 4 * landed + 4 * n_nodes, landed,
                               FP64_FLOPS)
    csr = {}
    if unordered:
        uv, ud, un = unordered
        csr = {f"csr_{k}": v for k, v in timings(
            lambda: scatter_add(uv, ud, un),
            lambda: torch.zeros(un, device=dev).index_add_(0, ud, uv)
        ).items()}
    phase("kernel", name="scatter_add", E=e, N=n_nodes, runs=runs,
          calls=len(calls), max_abs_err=err, plain_ms=plain_ms,
          bound_ms=bound_ms, share_of_bound=bound_ms / t["device_ms"], **t,
          **csr)
    return {"name": "scatter_add", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/scatter_add.cu",
            "replaces": "src/repro/stores/graph_kernels.py:69",
            "max_abs_err": err, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, **t, **csr}


def segment_agg_edges(dev, gen, call) -> list:
    """masked_segment_agg's edge cases: ``(case, vals, keys, mw,
    n_groups)``.  ``call``: the path's arguments, whose keys and values two
    cases reuse.  Several break the kernel's CTA table: one key for every
    row, hot keys at the top ids, more distinct keys a CTA than slots (the
    rows spill to the global atomics), G = 1, views off mw's 16-byte
    alignment (single rows before the first quad and after the last)."""
    def rand(r):
        return torch.rand(r, generator=gen, device=dev)

    def ints(lo, hi, r):
        return torch.randint(lo, hi, (r,), generator=gen, device=dev,
                             dtype=torch.int32)

    def mask(r, p):
        return (rand(r) < p).to(torch.float32)

    vals, keys, mw, n = call
    big = 2 ** 22 + 3
    vb, kb, wb = rand(100_004), ints(-1, 1002, 100_004), mask(100_004, 0.5)
    dyadic = torch.tensor([0.0, 0.5, 1.0, 2.0], device=dev)[
        ints(0, 4, min(300_000, int(keys.shape[0])))]
    r_dy = int(dyadic.shape[0])
    return [
        ("no rows", rand(0), ints(0, 1000, 0), mask(0, 0.5), 1000),
        ("random -1 and >= G padding", rand(5000), ints(-1, 1002, 5000),
         mask(5000, 0.5), 1000),
        ("all-zero mask", rand(5000), ints(-1, 1002, 5000),
         mask(5000, 0.0), 1000),
        ("G 131,073 (G % 128 != 0)", rand(777), ints(-1, 131_075, 777),
         mask(777, 0.3), 131_073),
        ("every row active on one key, R 5M", rand(5_000_000),
         torch.full((5_000_000,), 7, dtype=torch.int32, device=dev),
         mask(5_000_000, 1.0), 1000),
        ("the path's keys at the top ids, G - 1 - k", vals,
         (n - 1 - keys).to(torch.int32), mw, n),
        ("uniform keys over G 131,072, R 4M", rand(4_000_000),
         ints(0, 131_072, 4_000_000), mask(4_000_000, 0.5), 131_072),
        ("uniform keys over G 2^22 + 3, R 4M", rand(4_000_000),
         ints(0, big, 4_000_000), mask(4_000_000, 0.5), big),
        ("G 1, keys -1 / 0 / 1", rand(5000), ints(-1, 2, 5000),
         mask(5000, 0.5), 1),
        ("misaligned views vals[1:], keys[1:], mw[1:], R % 4 == 3",
         vb[1:], kb[1:], wb[1:], 1000),
        ("views at rows 3 / 2 / 1, R 100,001 (R % 4 == 1)",
         vb[3:100_004], kb[2:100_003], wb[1:100_002], 1000),
        ("R 3, views at row 1", vb[1:4], kb[1:4], wb[1:4], 1000),
        ("dyadic weights 0 / 0.5 / 1 / 2 on the path's keys", vals[:r_dy],
         keys[:r_dy], dyadic, n),
    ]


def sector_bytes(t, rows) -> int:
    """Bytes of the 32-byte DRAM sectors of 4-byte ``t`` that hold the
    sorted ``rows``."""
    sec = (t.data_ptr() % 32 + 4 * rows) // 32
    return 32 * int(torch.unique_consecutive(sec).numel())


def check_segment_agg(dev, gen, calls, edges=True):
    """masked_segment_agg on each of ``calls``, the ``(vals, keys, mw,
    n_groups)`` the path gives it, and at the edge cases unless ``edges``
    is false (one line each, ``[kernel-edge]``); the first call is timed.
    Returns its JSON record."""
    err = 0.0
    for vals, keys, mw, n_groups in calls:
        s, c = masked_segment_agg(vals, keys, mw, n_groups)
        ps, pc = masked_segment_agg_plain(vals, keys, mw, n_groups)
        torch.testing.assert_close(s, ps, rtol=RTOL, atol=ATOL)
        check(torch.equal(c, pc), "masked_segment_agg: counts differ")
        err = max(err, float((s - ps).abs().max()))
    for case, v, k, w, gg in (segment_agg_edges(dev, gen, calls[0])
                              if edges else ()):
        s2, c2 = masked_segment_agg(v, k, w, gg)
        ps2, pc2 = masked_segment_agg_plain(v, k, w, gg)
        torch.testing.assert_close(s2, ps2, rtol=RTOL, atol=ATOL)
        check(torch.equal(c2, pc2),
              f"masked_segment_agg: edge counts differ ({case})")
        if not bool(w.any()):
            check(not bool(c2.any()), "all-zero mask gave counts")
        phase("kernel-edge", name="masked_segment_agg",
              case=json.dumps(case), R=int(k.shape[0]), G=gg,
              R_active=int((w != 0).sum()),
              max_abs_err=float((s2 - ps2).abs().max()))
    vals, keys, mw, n_groups = calls[0]
    vw = vals * mw

    def library():
        torch.zeros(n_groups, device=dev).index_add_(0, keys, vw)
        torch.zeros(n_groups, device=dev).index_add_(0, keys, mw)

    t = timings(lambda: masked_segment_agg(vals, keys, mw, n_groups),
                library)
    plain_ms = cuda_ms(
        lambda: masked_segment_agg_plain(vals, keys, mw, n_groups))
    # the same launch through the torch.library op that only a vmapped
    # call enters: the op's dispatch cost is op_ms - ms
    op_ms = cuda_ms(
        lambda: masked_kernels._segment_agg_op(vals, keys, mw, n_groups))
    r = int(keys.shape[0])
    rows = torch.nonzero(mw != 0).flatten()
    active = int(rows.numel())
    bound_ms, bound_by = bound(4 * r + 8 * active + 8 * n_groups,
                               3 * active, FP64_FLOPS)
    # an estimate, computed and not measured: the same traffic at DRAM's
    # 32-byte sectors (every sector of mw, the sectors of keys and vals
    # that hold an active row, the outputs)
    sectors_mb_est = (32 * ((mw.data_ptr() % 32 + 4 * r + 31) // 32)
                      + sector_bytes(keys, rows) + sector_bytes(vals, rows)
                      + 8 * n_groups) / 1e6
    phase("kernel", name="masked_segment_agg", R=r, R_active=active,
          G=n_groups, calls=len(calls), max_abs_err=err, plain_ms=plain_ms,
          bound_ms=bound_ms, share_of_bound=bound_ms / t["device_ms"],
          sectors_mb_est=sectors_mb_est, op_ms=op_ms, **t)
    return {"name": "masked_segment_agg", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/masked_segment_agg.cu",
            "replaces": "src/repro/stores/masked_kernels.py:311",
            "max_abs_err": err, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, **t}


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
    """One main-path run under ``torch.profiler`` (see profile_call)."""
    profile_call(lambda: fn({}, inputs), path)


def profile_call(run, path):
    """``run()`` under ``torch.profiler``: device time per CUDA kernel
    (summed over its launches) and the device's idle share of the run's
    wall time.  Only kernel events count; the PyTorch operators that
    launch them would count the same time twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
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
    plain_ms = cuda_ms(lambda: masked_tfidf_plain(*args))
    # one library call over pre-gathered, pre-masked contributions
    docs_of = cx["doc_ids"].long()
    contrib = torch.where(doc_mask[docs_of],
                          w[cx["term_ids"]] * cx["tf"] / cx["doc_len"][docs_of],
                          torch.zeros((), device=dev))
    offsets = cx["doc_ptr"].long()
    t = timings(lambda: masked_tfidf(*args),
                lambda: torch.segment_reduce(contrib, "sum", offsets=offsets,
                                             unsafe=True))
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
          plain_ms=plain_ms, bound_ms=bound_ms,
          share_of_bound=bound_ms / t["device_ms"], **t)
    return {"name": "masked_tfidf", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/masked_tfidf.cu",
            "replaces": "src/repro/stores/masked_kernels.py:94",
            "max_abs_err": err, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, **t}


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
                         (100_000, 300, 0.0), (1, 64, 1.0),
                         (200_001, 64, 1.0)):
        rk = torch.randperm(4 * nr + 8, generator=gen, device=dev)[:nr].to(
            torch.int32)
        rv = torch.rand(nr, generator=gen, device=dev) < share
        lk = torch.randint(0, 4 * nr + 8, (p,), generator=gen, device=dev,
                           dtype=torch.int32)
        a, b = join_probe(lk, rk, rv), join_probe_plain(lk, rk, rv)
        check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
              f"join_probe edge case ({p}, {nr}, {share}) differs")
        check(share > 0 or not bool(a[1].any()), "an invalid row matched")
    # a probe side at a 4-byte offset (scalar loads)
    lk = lkeys.repeat(2)[1:lkeys.shape[0] + 1]
    a, b = join_probe(lk, rkeys, rvalid), join_probe_plain(lk, rkeys, rvalid)
    check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
          "join_probe on a misaligned probe side differs")
    plain_ms = cuda_ms(lambda: join_probe_plain(lkeys, rkeys, rvalid))
    sorted_keys = torch.sort(rkeys[rvalid]).values
    t = timings(lambda: join_probe(lkeys, rkeys, rvalid),
                lambda: torch.searchsorted(sorted_keys, lkeys))
    p, nr = int(lkeys.shape[0]), int(rkeys.shape[0])
    # bytes: probe key in, index + flag out per probe row; key + validity
    # per build row; one hash and one compare per probe row
    bound_ms, bound_by = bound(9 * p + 5 * nr, 2 * p, FP32_FLOPS)
    phase("kernel", name="join_probe", P=p, NR=nr,
          NR_valid=int(rvalid.sum()), matched=int(gm.sum()),
          max_abs_err=err, plain_ms=plain_ms, bound_ms=bound_ms,
          share_of_bound=bound_ms / t["device_ms"], **t)
    return {"name": "join_probe", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/join_probe.cu",
            "replaces": "src/repro/stores/masked_kernels.py:233",
            "max_abs_err": err, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, **t}


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
    plain_ms = cuda_ms(lambda: compact_prefix_plain(vals, pos, keep, cap))
    # the boolean gather synchronizes (its row count), so no graph holds it
    t = timings(lambda: compact_prefix(vals, pos, keep, cap),
                lambda: vals[:, valid][:, :cap], capture_library=False)
    c, r = int(vals.shape[0]), int(vals.shape[1])
    # bytes: keep per row; pos and C values per kept row; the output once
    bound_ms, bound_by = bound(4 * r + 4 * kept + 4 * c * kept + 4 * c * cap,
                               0, FP32_FLOPS)
    phase("kernel", name="compact_prefix", C=c, R=r, R_kept=kept, cap=cap,
          max_abs_err=err, plain_ms=plain_ms, bound_ms=bound_ms,
          share_of_bound=bound_ms / t["device_ms"], **t)
    return {"name": "compact_prefix", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/compact_prefix.cu",
            "replaces": "src/repro/stores/masked_kernels.py:173",
            "max_abs_err": err, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, **t}


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
    inputs, t_h2d, rise = timed_inputs(
        lambda: inputs_for(table, graph, corpus, query, dev))
    phase("data", path="hashtag_pulse", tweets=table.rows,
          hashtags=graph.n_nodes, edges=graph.n_edges, docs=corpus.n_docs,
          postings=corpus.n_postings, build_s=round(t_build, 3),
          h2d_s=round(t_h2d, 3))
    check_ledger("hashtag_pulse", {"tweets": table, "g": graph,
                                   "cx": corpus}, inputs, rise)

    # 4. kernels against their plain versions on the card
    # (an SpMV over the whole graph; the filter->count group-by over the
    # tweets, engagement as a float value column)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    g, rel, n = inputs["g"], inputs["tweets"], graph.n_nodes
    x = torch.rand(n, generator=gen, device=dev)
    keys, eng = rel.cols["hashtag"], rel.cols["engagement"]
    mw = (eng >= 30.0).to(torch.float32)
    records = [
        check_scatter(dev, gen, [(x[g["dst_src"]] * g["dst_w"],
                                  g["dst_dst"], n)],
                      unordered=(x[g["src"]] * g["weights"], g["indices"], n)),
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
    check_analyze("hashtag_pulse", fn, inputs, fn_cpu, inputs_cpu,
                  EXPECTED_LAUNCHES)
    return records


def drive(fn, inputs, expected, run=None):
    """One run of ``run`` (default ``fn``; ``fn.analyze`` for the traced
    run) with every launch count set to 0 just before it and read just
    after (they must equal ``expected``), then the median wall time of
    RUNS more.  Returns ``(counts, run_ms)``."""
    run = fn if run is None else run
    kernels.reset_launches()
    out = run({}, inputs)
    torch.cuda.synchronize()
    counted = kernels.launches()
    check(counted == expected,
          f"kernel launches of one run {counted} != {expected}")
    check(bool(out.isfinite().all()), "plan output is not finite")
    walls = []
    for _ in range(RUNS):
        kernels.reset_launches()
        t0 = time.perf_counter()
        run({}, inputs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        check(kernels.launches() == expected, "launches changed")
    return counted, statistics.median(walls) * 1e3


# -- observability: the ledger, EXPLAIN ANALYZE, observe -------------------


def timed_inputs(build):
    """``build()`` (a path's ``inputs_for``) with the default ledger reset
    just before it: ``(inputs, seconds, allocator rise in bytes)``."""
    reset_default_ledger()
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    inputs = build()
    torch.cuda.synchronize()
    return (inputs, time.perf_counter() - t0,
            torch.cuda.memory_allocated() - m0)


def payload_tensors(value) -> tuple:
    """``(tensors, host ints)`` of a store payload: a relation's columns,
    valid, count and overflow; a dict payload's tensor and int values."""
    if isinstance(value, BoundedRel):
        return (list(value.cols.values())
                + [value.valid, value.count, value.overflow]), []
    return ([v for v in value.values() if isinstance(v, torch.Tensor)],
            [v for v in value.values() if isinstance(v, int)])


def check_ledger(path, stores, inputs, rise):
    """[ledger]: each store's ledger entry holds its payload's tensor
    bytes plus 4 bytes a host int (the reference's count of a host leaf),
    each kind's total is the sum of its stores', and the allocator's rise
    over the inputs' build covers those bytes: every tensor is one block
    rounded up to ALLOC_BLOCK bytes, and one over 1 MiB may get a cached
    block up to ALLOC_SLACK larger (the allocator does not split off a
    rest of 1 MiB or less)."""
    led = default_ledger()
    kinds, blocks, slack = Counter(), 0, 0
    for name, store in stores.items():
        kind = STORE_KINDS[name]
        tensors, ints = payload_tensors(inputs[name])
        nbytes = sum(t.nbytes for t in tensors) + 4 * len(ints)
        entry = led.get((kind, f"{id(store):#x}"))
        check(entry is not None and entry.nbytes == nbytes,
              f"{path} {name}: ledger {entry and entry.nbytes} != payload "
              f"{nbytes} bytes")
        kinds[kind] += nbytes
        blocks += sum(-(-t.nbytes // ALLOC_BLOCK) * ALLOC_BLOCK
                      for t in tensors)
        slack += ALLOC_SLACK * sum(t.nbytes > (1 << 20) for t in tensors)
        phase("ledger", path=path, store=name, kind=kind,
              version=entry.version, actual_bytes=entry.nbytes,
              predicted_bytes=entry.predicted, ratio=entry.ratio)
    for kind, nbytes in kinds.items():
        check(led.bytes_for_kind(kind) == nbytes,
              f"{path}: ledger {kind} bytes {led.bytes_for_kind(kind)} != "
              f"{nbytes}")
    q = inputs["q"]
    blocks += -(-q.nbytes // ALLOC_BLOCK) * ALLOC_BLOCK
    total = sum(kinds.values())
    check(blocks <= rise <= blocks + slack,
          f"{path}: allocator rise {rise} outside [{blocks}, "
          f"{blocks + slack}] (ledger {total} + query {q.nbytes})")
    phase("ledger", path=path, ledger_bytes=total, query_bytes=q.nbytes,
          allocator_rise=rise, blocks_512=blocks,
          rise_minus_ledger=rise - total, rise_minus_blocks=rise - blocks,
          by_kind=json.dumps(dict(kinds)))


def host_syncs(call) -> list:
    """The synchronizing CUDA calls ``call()`` makes, as
    ``torch.cuda.set_sync_debug_mode("warn")`` flags them: one
    ``dir/file:line`` (the Python line that made the call) each."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return ["/".join(Path(w.filename).parts[-2:]) + f":{w.lineno}"
            for w in caught if "synchroniz" in str(w.message)]


def node_synced_ms(fn, inputs) -> dict:
    """Each concrete node's host time when the plan runs one node at a
    time through ``run_plan_subset`` with a ``torch.cuda.synchronize()``
    before and after it: dispatch and device work together (median of
    NODE_REPS)."""
    ctx = ExecContext(root={}, scope={}, device=fn.device)
    nodes = list(fn.concrete.topo())
    times = {n.id: [] for n in nodes}
    for _ in range(NODE_REPS):
        env = dict(inputs)
        for n in nodes:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            env = run_plan_subset(fn.concrete, ctx, env, [n.id])
            torch.cuda.synchronize()
            times[n.id].append((time.perf_counter() - t0) * 1e3)
    return {k: statistics.median(v) for k, v in times.items()}


def check_analyze(path, fn, inputs, fn_cpu, inputs_cpu, expected):
    """[analyze] and [analyze-op]: EXPLAIN ANALYZE of ``fn`` on the card
    through ``drive`` (its kernel launches those of ``__call__``), its
    outputs bitwise ``__call__``'s, each op span's count / overflow /
    capacity and the count sink equal to the CPU port's traced run of
    the same plan, its Chrome export valid, one device->host copy a run;
    the host syncs of each kind of run under the sync debug mode; the
    untraced and traced wall times as interleaved medians of PAIRS pairs
    (the overhead is reported, not gated); then one line per concrete node:
    the cost model's prediction, the span's dispatch ms (median over the
    pairs) and the node's synced ms (:func:`node_synced_ms`)."""
    counted, _ = drive(fn, inputs, expected, run=fn.analyze)
    out_call = fn({}, inputs)
    before = tracing.transfers
    out_traced = fn.analyze({}, inputs)
    check(tracing.transfers - before == 1,
          f"{path}: analyze made {tracing.transfers - before} device->host "
          f"copies, not 1")
    check(torch.equal(out_call, out_traced),
          f"{path}: analyze's output differs from __call__'s")
    trace = fn.last_run_trace
    fn_cpu.analyze({}, inputs_cpu)
    cpu = fn_cpu.last_run_trace
    check([s.name for s in trace.spans] == [s.name for s in cpu.spans],
          f"{path}: span names differ from the CPU port's")
    observed = 0
    for card, host in zip(trace.op_spans(), cpu.op_spans()):
        for key in ("count", "overflow", "capacity"):
            check(card.attrs.get(key) == host.attrs.get(key),
                  f"{path} {card.name}: {key} {card.attrs.get(key)} != CPU "
                  f"{host.attrs.get(key)}")
        observed += "count" in card.attrs
    check(trace.counts == cpu.counts,
          f"{path}: count sink {trace.counts} != CPU {cpu.counts}")
    with tempfile.TemporaryDirectory() as tmp:
        trace.to_chrome(Path(tmp) / "trace.json")
        doc = json.loads((Path(tmp) / "trace.json").read_text())
    errs = tracing.validate_chrome_trace(doc)
    check(not errs, f"{path}: chrome trace invalid: {errs[:3]}")
    syncs_call = host_syncs(lambda: fn({}, inputs))
    syncs_traced = host_syncs(lambda: fn.analyze({}, inputs))
    # what the debug mode flags at all: a device sync, a 4-byte copy
    flags_sync = len(host_syncs(torch.cuda.synchronize))
    flags_copy = len(host_syncs(
        lambda: torch.zeros(1, device=fn.device).cpu()))
    plain, traced, dispatch_ms = [], [], {}
    for _ in range(PAIRS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn({}, inputs)
        torch.cuda.synchronize()
        plain.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        fn.analyze({}, inputs)
        traced.append((time.perf_counter() - t0) * 1e3)
        for sp in fn.last_run_trace.spans:
            dispatch_ms.setdefault(sp.name, []).append(sp.dur_ms)
    run_ms, traced_ms = statistics.median(plain), statistics.median(traced)
    phase("analyze", path=path, launches=json.dumps(
              {k: v for k, v in counted.items() if v}),
          launches_equal_call=True, outputs_bitwise_call=True,
          counts_equal_cpu=True, spans=len(trace.spans),
          op_spans=len(trace.op_spans()), spans_with_count=observed,
          sink_sites=len(trace.counts), chrome_events=len(doc["traceEvents"]),
          chrome_valid=True, transfers_per_run=1,
          host_syncs_call=json.dumps(syncs_call),
          host_syncs_analyze=json.dumps(syncs_traced),
          debug_flags_synchronize=flags_sync, debug_flags_copy=flags_copy,
          run_ms=run_ms, traced_ms=traced_ms,
          overhead=traced_ms / run_ms - 1.0, bar=0.05, pairs=PAIRS,
          sync_ms=statistics.median(dispatch_ms["device_sync"]),
          run_span_ms=statistics.median(dispatch_ms["run"]))
    synced = node_synced_ms(fn, inputs)
    for sp in trace.op_spans():
        disp = statistics.median(dispatch_ms[sp.name])
        phase("analyze-op", path=path, node=sp.name,
              impl=sp.attrs["impl"],
              predicted_ms=sp.attrs.get("predicted_s", float("nan")) * 1e3,
              dispatch_ms=disp, synced_ms=synced[sp.name],
              dispatch_share=disp / synced[sp.name])
    phase("analyze-op", path=path, nodes=len(synced),
          dispatch_sum_ms=sum(statistics.median(dispatch_ms[sp.name])
                              for sp in trace.op_spans()),
          synced_sum_ms=sum(synced.values()))


def check_observe(analysis, syscat, fn, inputs, fn_cpu, inputs_cpu, hits):
    """[observe]: ``observe`` on the card and on the CPU port give equal
    feedback (counts are exact), re-planning with it gives one plan id on
    both, and the re-planned run's top-64 equals ``hits`` (the first
    run's)."""
    fb_card, fb_cpu = SelectivityFeedback(), SelectivityFeedback()
    before = tracing.transfers
    out = fn.observe({}, inputs, fb_card)
    check(tracing.transfers - before == 1, "observe: not one copy a run")
    check(torch.equal(out, fn({}, inputs)), "observe's output differs")
    fn_cpu.observe({}, inputs_cpu, fb_cpu)
    check(len(fb_card) > 0 and fb_card.fingerprint() == fb_cpu.fingerprint(),
          "observe: feedback on the card differs from the CPU's")
    again = repro_torch.compile(analysis, syscat, device="cuda",
                                feedback=fb_card)
    again_cpu = repro_torch.compile(analysis, syscat, device="cpu",
                                    feedback=fb_cpu)
    check(again.plan_id == again_cpu.plan_id,
          "observe: re-planned ids differ between card and CPU")
    hits_re, score = hits_and_score(again, run_env(again, inputs))
    check(torch.equal(hits_re.cols["doc"], hits.cols["doc"]),
          "observe: the re-planned top-64 differs from the first run's")
    check(bool(score.isfinite().all()), "observe: re-planned output")
    phase("observe", path="tri_selective", sites=len(fb_card),
          fingerprint=fb_card.fingerprint()[:12], fingerprint_equal_cpu=True,
          replanned_id=again.plan_id[:12], first_id=fn.plan_id[:12],
          replanned_id_equal_cpu=True,
          replanned_impls=json.dumps(dict(Counter(again.chosen_impls()))),
          top64_equal_first_run=True)


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
    inputs, t_h2d, rise = timed_inputs(
        lambda: windowed_ranking.inputs_for(*stores, query, dev))
    phase("data", path="tri_selective", tweets=table.rows,
          hashtags=graph.n_nodes, edges=graph.n_edges, docs=corpus.n_docs,
          postings=corpus.n_postings, window=SELECTIVITY,
          build_s=round(t_build, 3), h2d_s=round(t_h2d, 3))
    check_ledger("tri_selective", {"tweets": table, "g": graph,
                                   "cx": corpus}, inputs, rise)

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
    check_analyze("tri_selective", plans["default"], inputs, fn_cpu,
                  inputs_cpu, WINDOW_PLANS["default"][2])
    check_observe(analysis, syscat, plans["default"], inputs, fn_cpu,
                  inputs_cpu, hits_a)
    return [rec for _plan, rec in records]


# -- phases 10a-10h: the influencer rollup ---------------------------------


def influence_rollups(fn, env) -> list:
    """The three per-hashtag rollups (seed counts, text relevance,
    influence: the col_tensor nodes, in plan order) of one run."""
    return [env[n.id] for n in fn.concrete.topo()
            if n.impl == "col_tensor_rel"]


def influence_outputs(fn, env) -> dict:
    """What the check phase compares of one run: the plan output, the
    three rollups, the top-64 doc ids and the viral tweets (the fused
    filter chain's relation, the join's probe side)."""
    hits, out = hits_and_score(fn, env)
    return {"out": out, "rollups": influence_rollups(fn, env),
            "hits": hits.cols["doc"],
            "viral": node_out(fn, env, "rel_fused_col")}


def same_join(got, want) -> bool:
    """Two ``hash_join_nonunique`` results equal in every slot (placeholders
    included), count and overflow."""
    return all(torch.equal(g.cpu(), w.cpu()) for g, w in zip(got, want))


def join_edges(dev, viral, infl) -> list:
    """``hash_join_nonunique``'s cases on the card: ``(case, lkeys, lmask,
    rkeys, rmask, capacity)``.  The build rows of the last case repeat 64
    keys 50 times each, half of them invalid (~2.2M matches, no
    overflow)."""
    rng = np.random.RandomState(SEED)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    same = t(np.full(5000, 7, np.int32))
    ones = t(np.ones(5000, bool))
    e_k, e_m = t(np.zeros(0, np.int32)), t(np.zeros(0, bool))
    rk = np.repeat(np.arange(64, dtype=np.int32), 50)
    return [
        ("the path's join at capacity 2^20 (overflow)", viral.cols["user"],
         viral.valid, infl.cols["user"], infl.valid, JOIN_EDGE_CAP),
        ("5,000 x 5,000 equal keys (25M matches), capacity 1,000", same,
         ones, same, ones, 1000),
        ("empty probe side", e_k, e_m, infl.cols["user"], infl.valid, 4096),
        ("empty build side", viral.cols["user"], viral.valid, e_k, e_m,
         4096),
        ("invalid build rows among equal keys",
         t(rng.randint(-1, 66, 100_000).astype(np.int32)),
         t(rng.rand(100_000) < 0.9), t(rk[rng.permutation(rk.size)]),
         t(rng.rand(rk.size) < 0.5), 1 << 22),
    ]


def check_join_edges(dev, viral, infl):
    """hash_join_nonunique on the card at each of :func:`join_edges`,
    equal in every slot to the same join on the CPU."""
    for case, lk, lm, rk, rm, cap in join_edges(dev, viral, infl):
        got = hash_join_nonunique(lk, lm, rk, rm, cap)
        want = hash_join_nonunique(lk.cpu(), lm.cpu(), rk.cpu(), rm.cpu(),
                                   cap)
        check(same_join(got, want), f"join-edge {case}: card != CPU")
        count, overflow = int(got[3]), bool(got[4])
        if "overflow" in case or "25M" in case:
            check(overflow and count == cap, f"join-edge {case}: count "
                                             f"{count}, overflow {overflow}")
        if "empty" in case:
            check(count == 0 and not overflow, f"join-edge {case}: {count}")
        if "invalid" in case:
            v = got[2]
            check(bool(rm[got[1][v].long()].all()), "an invalid build row "
                                                     "matched")
        phase("join-edge", case=json.dumps(case), L=int(lk.shape[0]),
              R=int(rk.shape[0]), cap=cap, count=count, overflow=overflow,
              equal_cpu=True)


def triangle_oracle(src, dst, n) -> int:
    """Σ(A ∘ A²) of the 0/1 adjacency with an edge at every ``(src, dst)``,
    in int64 on the host, by edge-list intersection: each 2-path ``i -> k
    -> j`` whose ``(i, j)`` is an edge counts once."""
    keys = np.unique(np.asarray(src, np.int64) * n + np.asarray(dst))
    i, k = np.divmod(keys, n)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(i, minlength=n))])
    reps = np.diff(indptr)[k]                  # the 2-paths through (i, k)
    first = indptr[k] - (np.cumsum(reps) - reps)
    j = k[np.repeat(first, reps) + np.arange(int(reps.sum()))]
    paths = np.repeat(i, reps) * n + j
    pos = np.clip(np.searchsorted(keys, paths), 0, keys.size - 1)
    return int((keys[pos] == paths).sum())


def check_append(dev, syscat, analysis, stores, arrays, query, inputs):
    """Phase 10f: appends 1 % more tweets and documents (from seed 1) on
    the host, re-plans (a plan-cache miss with a new plan id, then a hit),
    and holds the appended stores' run on the card bitwise against the
    same analysis over stores built fresh from the concatenated arrays."""
    table, graph, corpus, infl = stores
    size = INFLUENCE
    rng = np.random.RandomState(APPEND["seed"])
    new_cols = tri_influence.tweet_columns(rng, APPEND["tweets"],
                                           size["hashtags"])
    new_cols["doc"] = np.arange(table.rows, table.rows + APPEND["tweets"],
                                dtype=np.int32)
    terms, lengths = tri_influence.corpus_terms(rng, APPEND["docs"],
                                                size["vocab"],
                                                size["terms_hi"])
    cache = PlanCache()
    fn0 = repro_torch.compile(analysis, syscat, device="cuda", cache=cache)
    repro_torch.compile(analysis, syscat, device="cuda", cache=cache)
    check(cache.hits == 1, f"recompiling missed the plan cache: {cache.hits}")
    versions = (table.version, corpus.version)
    t0 = time.perf_counter()
    table.append(new_cols)
    corpus.append(np.split(terms, np.cumsum(lengths)[:-1]))
    append_s = time.perf_counter() - t0
    check((table.version, corpus.version) == (versions[0] + 1,
                                              versions[1] + 1),
          "append did not bump the stores' versions")
    fn1 = repro_torch.compile(analysis, syscat, device="cuda", cache=cache)
    check(fn1.plan_id != fn0.plan_id and cache.hits == 1,
          "the appended stores reused the stale plan")
    fn1b = repro_torch.compile(analysis, syscat, device="cuda", cache=cache)
    check(fn1b.plan_id == fn1.plan_id and cache.hits == 2,
          "recompiling after the append missed the plan cache")
    caps = [a["capacity"] for n in fn1.concrete.topo()
            if n.impl == "rel_fused_agg_pallas"
            for op, a, _s, _t in n.attrs["chain"] if op == "bounded_join"]
    check(caps == [size["tweets"]], f"join capacity attrs {caps}")
    fresh_table = ColumnStore({k: np.concatenate([v, new_cols[k]])
                               for k, v in arrays["tweets"].items()})
    fresh_corpus = TextStore.from_flat(
        np.concatenate([arrays["terms"], terms]),
        np.concatenate([arrays["lengths"], lengths]), size["vocab"])
    for name in ("doc_ids", "term_ids", "tf", "doc_len", "idf"):
        check(np.array_equal(getattr(corpus, name),
                             getattr(fresh_corpus, name)),
              f"appended corpus {name} differs from a fresh index")
    fresh = tri_influence.influence_rollup(
        fresh_table, graph, fresh_corpus, infl, iters=size["iters"],
        capacity=size["tweets"])
    fn_fresh = repro_torch.compile(fresh, syscat, device="cuda", cache=False)
    check(fn_fresh.chosen_impls() == fn1.chosen_impls(),
          "the fresh stores' plan differs from the appended stores'")
    t0 = time.perf_counter()
    appended = {**inputs, "tweets": table.payload(dev),
                "cx": corpus.payload(dev)}
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - t0
    rebuilt = {**inputs, "tweets": fresh_table.payload(dev),
               "cx": fresh_corpus.payload(dev)}
    got = influence_outputs(fn1, run_env(fn1, appended))
    want = influence_outputs(fn_fresh, run_env(fn_fresh, rebuilt))
    for k in ("out", "hits"):
        check(torch.equal(got[k], want[k]), f"append: {k} differs bitwise "
                                            f"from the fresh stores'")
    for a, b in zip(got["rollups"], want["rollups"]):
        check(torch.equal(a, b), "append: a rollup differs bitwise")
    check(bool(got["out"].isfinite().all()), "append: output not finite")
    phase("append", tweets=table.rows, docs=corpus.n_docs,
          postings=corpus.n_postings, versions=json.dumps(
              [table.version, corpus.version]),
          plan_id=fn1.plan_id[:12], stale_plan_id=fn0.plan_id[:12],
          cache_hits=cache.hits, join_capacity=caps[0],
          append_s=round(append_s, 3), h2d_s=round(h2d_s, 3),
          bitwise_fresh=True)


def check_tricount(dev, syscat):
    """Phase 10g: ``graph_tricount`` planned (``graph_tricount_csr``) and
    run on the card over a symmetric random graph, exactly equal to the
    host's integer count divided by 6 in float32; its time."""
    n = TRICOUNT["nodes"]
    rng = np.random.RandomState(SEED)
    pairs = rng.randint(0, n, (2, n * TRICOUNT["pairs_per_node"]))
    graph = GraphStore.from_edges(pairs[0], pairs[1], n, symmetric=True)
    with Analysis("tricount", standard_catalog()) as a:
        a.store(a.op("graph_tricount", a.bind("g", graph)))
    fn = repro_torch.compile(a, syscat, device="cuda")
    check("graph_tricount_csr" in fn.chosen_impls(),
          f"tricount impls {fn.chosen_impls()}")
    g = graph.payload(dev)
    torch.cuda.reset_peak_memory_stats()
    got = fn({}, {"g": g})
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    s = triangle_oracle(graph.src, graph.indices, n)
    oracle_s = time.perf_counter() - t0
    want = float(np.float32(s) / np.float32(6.0))
    check(float(got) == want, f"triangle count {float(got)} != {want}")
    ms = cuda_ms(lambda: fn({}, {"g": g}), reps=5, warmup=1)
    # 2 n^3 for A @ A, n^2 for the product and the sum: float32 math
    bound_ms, bound_by = bound(4 * (2 * graph.n_edges + n + 1) + 4,
                               2 * n ** 3 + 2 * n ** 2, FP32_FLOPS)
    phase("tricount", nodes=n, edges=graph.n_edges, sum_a_a2=s,
          triangles=float(got), exact=True, ms=ms, bound_ms=bound_ms,
          bound_by=bound_by, peak_mem_gb=round(peak, 3),
          oracle_s=round(oracle_s, 3))


KEEP = (lambda v: float(v.max()) > 1.5)             # noqa: E731
FOLD = (lambda acc, v: acc * 0.5 + v)               # noqa: E731


def check_collections(dev, syscat):
    """Phase 10h: an ADIL program that maps a one-op subplan (relu² by
    ``ffn_act``) over a ListT of float32 vectors, filters them by their
    max and folds the kept ones, on the card and on the CPU: bitwise equal
    (every step is one correctly rounded elementwise operation)."""
    size, length = COLLECTION["vectors"], COLLECTION["length"]
    vec = TensorT((length,), "float32", ("vocab",))
    with Analysis("collections", standard_catalog()) as a:
        xs = a.input("xs", ListT(vec, size))
        body = Plan("body")
        body.add_input("x", vec)
        body.set_outputs(body.add("ffn_act", ["x"], {"act": "relu2"}))
        a.store(a.reduce(a.filter(a.map(xs, body), KEEP), FOLD))
    fn = repro_torch.compile(a, syscat, device="cuda")
    fn_cpu = repro_torch.compile(a, syscat, device="cpu")
    check(fn.chosen_impls() == ["map", "filter", "reduce", "store"],
          f"collection impls {fn.chosen_impls()}")
    rng = np.random.RandomState(SEED)
    vals = [(rng.randn(length) * s).astype(np.float32)
            for s in np.linspace(0.1, 1.0, size)]
    card = [torch.from_numpy(v).to(dev) for v in vals]
    got = fn({}, {"xs": card})
    want = fn_cpu({}, {"xs": [torch.from_numpy(v) for v in vals]})
    check(torch.equal(got.cpu(), want), "collections: card != CPU")
    kept = sum(KEEP(np.square(np.maximum(v, 0))) for v in vals)
    check(0 < kept < size, f"the filter kept {kept} of {size}")
    ms = cuda_ms(lambda: fn({}, {"xs": card}), reps=5, warmup=1)
    phase("collections", vectors=size, length=length, kept=int(kept),
          bitwise_cpu=True, ms=ms)


def influence_path(args, dev, syscat) -> list:
    """Phases 10a-10h: ``tri_influence``.  Returns its kernels' records."""
    size = {k: v for k, v in INFLUENCE.items() if k != "cut"}
    # 10a. data (set-up)
    t0 = time.perf_counter()
    rng = np.random.RandomState(SEED)
    arrays = tri_influence.influence_arrays(rng, **size)
    stores = tri_influence.stores_from_arrays(arrays, **size)
    table, graph, corpus, infl = stores
    analysis = tri_influence.influence_rollup(*stores, iters=size["iters"])
    query = corpus.query_vector(rng.randint(0, size["vocab"], 6))
    t_build = time.perf_counter() - t0
    inputs, t_h2d, rise = timed_inputs(
        lambda: tri_influence.inputs_for(*stores, query, dev))
    phase("data", path="tri_influence", tweets=table.rows,
          influencers=infl.rows, hashtags=graph.n_nodes,
          edges=graph.n_edges, docs=corpus.n_docs,
          postings=corpus.n_postings, join_capacity=size["tweets"],
          cut=json.dumps(INFLUENCE["cut"]), build_s=round(t_build, 3),
          h2d_s=round(t_h2d, 3))
    check_ledger("tri_influence", {"tweets": table, "g": graph,
                                   "cx": corpus, "infl": infl}, inputs, rise)

    # 10b. the main path through the entry points
    fn = repro_torch.compile(analysis, syscat, device="cuda")
    impls = Counter(fn.chosen_impls())
    check(impls == INFLUENCE_IMPLS, f"chosen impls {dict(impls)} != "
                                    f"{dict(INFLUENCE_IMPLS)}")
    chains = [[op for op, *_ in n.attrs["chain"]] for n in fn.concrete.topo()
              if n.impl == "rel_fused_agg_pallas"]
    check(["bounded_join", "rel_group_agg"] in chains,
          f"the bounded join is not fused into a group-by: {chains}")
    torch.cuda.reset_peak_memory_stats()
    counted, run_ms = drive(fn, inputs, INFLUENCE_LAUNCHES)
    phase("main", path="tri_influence", plan_id=fn.plan_id[:12],
          impls=json.dumps(dict(impls)), chains=json.dumps(chains),
          launches=json.dumps({k: v for k, v in counted.items() if v}),
          run_ms=run_ms, runs=RUNS, setup_s=round(t_build + t_h2d, 3),
          peak_mem_gb=round(torch.cuda.max_memory_allocated() / 1e9, 3))
    if args.profile:
        profile_run(fn, inputs, "tri_influence")

    # 10c. against the port's plain path on the CPU, and run to run
    a = influence_outputs(fn, run_env(fn, inputs))
    b = influence_outputs(fn, run_env(fn, inputs))
    check(torch.equal(a["out"], b["out"]) and torch.equal(a["hits"],
                                                          b["hits"])
          and all(torch.equal(x, y) for x, y in zip(a["rollups"],
                                                   b["rollups"])),
          "two card runs differ bitwise")
    cap = size["tweets"]
    join_a = hash_join_nonunique(a["viral"].cols["user"], a["viral"].valid,
                                 inputs["infl"].cols["user"],
                                 inputs["infl"].valid, cap)
    join_ms = cuda_ms(lambda: hash_join_nonunique(
        a["viral"].cols["user"], a["viral"].valid,
        inputs["infl"].cols["user"], inputs["infl"].valid, cap), reps=5)
    fn_cpu = repro_torch.compile(analysis, syscat, device="cpu")
    check(fn_cpu.plan_id == fn.plan_id, "CPU plan differs from the card's")
    inputs_cpu = tri_influence.inputs_for(*stores, query, "cpu")
    t0 = time.perf_counter()
    c = influence_outputs(fn_cpu, run_env(fn_cpu, inputs_cpu))
    t_cpu = time.perf_counter() - t0
    join_c = hash_join_nonunique(c["viral"].cols["user"], c["viral"].valid,
                                 inputs_cpu["infl"].cols["user"],
                                 inputs_cpu["infl"].valid, cap)
    check(torch.equal(a["hits"].cpu(), c["hits"]),
          "top-64 ids differ from the CPU plain path")
    for x, y in zip(a["rollups"], c["rollups"]):
        torch.testing.assert_close(x.cpu(), y, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(a["out"].cpu(), c["out"], rtol=RTOL,
                               atol=ATOL)
    check(same_join(join_a, join_c),
          "the join (lidx, ridx, valid, count, overflow) differs from the "
          "CPU's")
    check(not bool(join_a[4]), "the path's join overflowed")
    phase("check", path="tri_influence", top64_equal_cpu=True,
          rollups_allclose_cpu=True, join_every_slot_equal_cpu=True,
          bitwise_rerun=True, viral=int(a["viral"].count),
          join_count=int(join_a[3]), join_overflow=bool(join_a[4]),
          join_ms=join_ms,
          out_max_abs_err_cpu=float((a["out"].cpu() - c["out"]).abs().max()),
          cpu_plain_s=round(t_cpu, 3))
    check_analyze("tri_influence", fn, inputs, fn_cpu, inputs_cpu,
                  INFLUENCE_LAUNCHES)
    viral = a["viral"]
    del a, b, c, join_a, join_c, inputs_cpu

    # 10d. kernels on the very arguments one run gives them
    calls = {"scatter_add": [], "masked_segment_agg": []}
    with recording(graph_store, "scatter_add", calls["scatter_add"]), \
            recording(runtime, "masked_segment_agg",
                      calls["masked_segment_agg"]):
        run_env(fn, inputs)
    torch.cuda.synchronize()
    check(len(calls["scatter_add"]) == INFLUENCE_LAUNCHES["scatter_add"]
          and len(calls["masked_segment_agg"])
          == INFLUENCE_LAUNCHES["masked_segment_agg"],
          f"kernel calls of one run: "
          f"{ {k: len(v) for k, v in calls.items()} }")
    # the join-fed group-by first (the call timed): R = capacity, the
    # join's matches a valid prefix
    seg = sorted(calls["masked_segment_agg"],
                 key=lambda call: -int((call[2] != 0).sum()))
    check(int(seg[0][1].shape[0]) == cap, "no group-by at R = capacity")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    records = [check_segment_agg(dev, gen, seg, edges=False),
               check_scatter(dev, gen, calls["scatter_add"], edges=False)]
    del calls, seg
    for rec in records:
        rec["launches"] = counted[rec["name"]]
        rec["path"] = "tri_influence"

    # 10e-10h
    check_join_edges(dev, viral, inputs["infl"])
    del viral
    check_append(dev, syscat, analysis, stores, arrays, query, inputs)
    del inputs
    free_memory()
    check_tricount(dev, syscat)
    free_memory()
    check_collections(dev, syscat)
    return records


# -- phase 12: flash attention against its plain version -------------------


def flash_inputs(gen, dev, b, sq, skv, h, kvh, d, dtype):
    """q, k, v as the planned prefill hands them to the kernel: q and k
    fresh tensors (the RoPE outputs), v a strided view into the fused qkv
    projection's output."""
    q = torch.randn(b, sq, h, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, skv, kvh, d, generator=gen, device=dev).to(dtype)
    qkv = torch.randn(b, skv, (h + 2 * kvh) * d, generator=gen,
                      device=dev).to(dtype)
    v = qkv[..., (h + kvh) * d:].reshape(b, skv, kvh, d)
    return q, k, v


def served_inputs(gen, dev, lens, s, h, kvh, d, theta):
    """q, k, v of one batched prefill as the runtime builds its token
    batch: row i holds a prompt of ``lens[i]`` tokens (0 for a pad row),
    and every later position token 0, whose v is one vector and whose q
    and k are one vector each rotated by RoPE to its position."""
    b = len(lens)
    q, k, v = flash_inputs(gen, dev, b, s, s, h, kvh, d, torch.bfloat16)
    pos = torch.arange(s, device=dev)
    pq, pk, pv = (torch.randn(1, 1, n, d, generator=gen, device=dev)
                  .to(torch.bfloat16) for n in (h, kvh, kvh))
    pq = rope(pq.expand(1, s, h, d), pos, theta=theta)[0]
    pk = rope(pk.expand(1, s, kvh, d), pos, theta=theta)[0]
    for i, n in enumerate(lens):
        q[i, n:], k[i, n:], v[i, n:] = pq[n:], pk[n:], pv[0]
    return q, k, v


def attention_pairs(sq, skv, causal, window) -> int:
    """The (query, key) pairs one head's attention must compute: each
    row's valid keys, all kv_len keys for a row with none (their mean)."""
    per_row = attention_mask(sq, skv, causal=causal, window=window).sum(1)
    return int(torch.where(per_row > 0, per_row,
                           torch.full_like(per_row, skv)).sum())


def flash_compare(q, k, v, *, causal=True, window=0, hmajor=False):
    """The kernel against its plain version on the same inputs, within
    the dtype's tolerance; returns the max abs error."""
    if hmajor:
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        got = flash_attention_hmajor(qh, kh, vh, causal=causal,
                                     window=window).transpose(1, 2)
    else:
        got = flash_attention(q, k, v, causal=causal, window=window)
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    tol = FLASH_TOL[q.dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    check(got.dtype == q.dtype and got.shape == q.shape,
          "flash_attention: wrong output dtype or shape")
    return float((got.float() - want.float()).abs().max())


# (name, b, sq, skv, h, kv heads, d, dtype, causal, window, hmajor)
FLASH_EDGES = (
    ("float32", 1, 256, 256, 16, 8, 128, torch.float32, True, 0, False),
    ("non-causal", 2, 200, 200, 16, 8, 128, torch.bfloat16, False, 0, False),
    ("window 16", 1, 300, 300, 16, 8, 128, torch.bfloat16, True, 16, False),
    ("ragged 100", 1, 100, 100, 16, 8, 128, torch.bfloat16, True, 0, False),
    ("ragged 1000", 1, 1000, 1000, 16, 8, 128, torch.bfloat16, True, 0,
     False),
    ("q_len 1", 4, 1, 777, 16, 8, 128, torch.bfloat16, True, 0, False),
    ("q_len < kv_len", 2, 100, 1000, 16, 8, 128, torch.bfloat16, True, 0,
     False),
    ("MQA", 1, 512, 512, 16, 1, 128, torch.bfloat16, True, 0, False),
    ("fully-masked rows", 1, 70, 50, 16, 8, 128, torch.float32, True, 0,
     False),
    ("smoke width", 2, 48, 48, 4, 2, 16, torch.float32, True, 0, False),
    ("head_dim 64 window", 1, 130, 130, 8, 2, 64, torch.float32, True, 16,
     False),
    ("non-causal window", 1, 90, 90, 4, 4, 32, torch.float32, False, 8,
     False),
    ("heads-major entry", 2, 300, 300, 16, 8, 128, torch.bfloat16, True, 0,
     True),
    # the head dims the tensor-core kernel pads: 160 -> 192, 256, 72 -> 128
    # (a depth that is no multiple of 16), 112 -> 128 with GQA 6
    ("head_dim 160", 1, 300, 300, 8, 2, 160, torch.bfloat16, True, 0, False),
    ("head_dim 160 float32", 1, 300, 300, 8, 2, 160, torch.float32, True, 0,
     False),
    ("head_dim 256", 1, 300, 300, 8, 2, 256, torch.bfloat16, True, 0, False),
    ("head_dim 256 float32 window", 1, 300, 300, 8, 2, 256, torch.float32,
     True, 40, False),
    ("head_dim 72", 1, 300, 300, 4, 2, 72, torch.bfloat16, True, 0, False),
    ("head_dim 112 GQA 6", 1, 300, 300, 12, 2, 112, torch.bfloat16, True, 0,
     False),
)
# stablelm-12b's prefill at width 4 and bucket 2048 (32 / 8 heads of 160):
# timed beside SDPA, not served here
STABLELM_FLASH = (4, 2048, 32, 8, 160)


def check_flash(dev, gen, cfg, batched_width) -> dict:
    """flash_attention at the serving prefill's shapes (timed) and at the
    edge cases; returns its JSON record (the served width at bucket
    2048)."""
    h, kvh, d = cfg.heads, cfg.kv_heads, cfg.resolved_head_dim
    err = 0.0
    for name, b, sq, skv, hh, kk, dd, dt, causal, window, hm in FLASH_EDGES:
        q, k, v = flash_inputs(gen, dev, b, sq, skv, hh, kk, dd, dt)
        e = flash_compare(q, k, v, causal=causal, window=window, hmajor=hm)
        if name == "fully-masked rows":
            # rows 0..19 see no key: the mean of v over the 50 keys
            mean_v = v.float().mean(1).repeat_interleave(hh // kk, dim=1)
            got = flash_attention(q, k, v, causal=True)
            torch.testing.assert_close(got[:, :20].float(),
                                       mean_v[:, None].expand(-1, 20, -1, -1),
                                       atol=FLASH_TOL[dt], rtol=FLASH_TOL[dt])
        err = max(err, e)
        phase("serve-kernel", case=json.dumps(name), b=b, q_len=sq,
              kv_len=skv, heads=hh, kv_heads=kk, head_dim=dd,
              dtype=str(dt).split(".")[1], causal=causal, window=window,
              max_abs_err=e)
    # each bucket of the trace at the served width (two prompts of the
    # bucket's length, two pad rows) and at batch 1, the warmup's shape
    lens_of = {}
    for r in serve_trace(cfg, SERVE["prompt_lens"], SERVE["requests"], 1):
        lens_of.setdefault(bucket_len(r.prompt_len, hi=SERVE["max_seq"]),
                           []).append(r.prompt_len)
    record = None
    for s, lens in sorted(lens_of.items()):
        served = (lens + [0] * batched_width)[:batched_width]
        for b, rows in ((batched_width, served), (1, [s])):
            q, k, v = served_inputs(gen, dev, rows, s, h, kvh, d,
                                    cfg.rope_theta)
            e = flash_compare(q, k, v)
            err = max(err, e)
            ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True))
            plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v,
                                                             causal=True))
            qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
            lib_ms = cuda_ms(lambda: torch.nn.functional
                             .scaled_dot_product_attention(
                                 qh, kh, vh, is_causal=True, enable_gqa=True))
            nbytes = 2 * (2 * b * s * h * d + 2 * b * s * kvh * d)
            nops = 4 * b * h * d * attention_pairs(s, s, True, 0)
            bound_ms, bound_by = bound(nbytes, nops, BF16_FLOPS)
            phase("serve-kernel", name="flash_attention",
                  shape="served" if b == batched_width else "warmup", b=b,
                  seq=s, prompt_lens=json.dumps(rows), heads=h,
                  kv_heads=kvh, head_dim=d, dtype="bfloat16", causal=True,
                  max_abs_err=e, ms=ms, plain_ms=plain_ms,
                  library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
                  share_of_bound=bound_ms / ms, tflops=nops / ms / 1e9)
            if (b, s) == (batched_width, max(lens_of)):
                record = {"name": "flash_attention", "route": "cuda",
                          "source": "src/repro_torch/kernels/csrc/"
                                    "flash_attention.cu",
                          "replaces": "src/repro/kernels/flash_attention/"
                                      "ops.py:110",
                          "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by,
                          "library_ms": lib_ms}
            del q, k, v, qh, kh, vh
    b, s, h, kvh, d = STABLELM_FLASH
    q, k, v = flash_inputs(gen, dev, b, s, s, h, kvh, d, torch.bfloat16)
    e = flash_compare(q, k, v)
    err = max(err, e)
    ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True))
    plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, causal=True))
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True, enable_gqa=True))
    nbytes = 2 * (2 * b * s * h * d + 2 * b * s * kvh * d)
    nops = 4 * b * h * d * attention_pairs(s, s, True, 0)
    bound_ms, bound_by = bound(nbytes, nops, BF16_FLOPS)
    phase("serve-kernel", name="flash_attention", shape="stablelm-12b", b=b,
          seq=s, heads=h, kv_heads=kvh, head_dim=d, dtype="bfloat16",
          causal=True, max_abs_err=e, ms=ms, plain_ms=plain_ms,
          library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
          share_of_bound=bound_ms / ms, tflops=nops / ms / 1e9)
    del q, k, v, qh, kh, vh
    record["max_abs_err"] = err
    return record


# -- phases 11-14: qwen3-0.6b served ---------------------------------------


def serve_trace(cfg, prompt_lens, n, gen) -> list:
    """n requests cycling over ``prompt_lens``, token ids from SEED."""
    rng = np.random.RandomState(SEED)
    return [ServeRequest(i, tuple(rng.randint(
        0, cfg.vocab, prompt_lens[i % len(prompt_lens)]).tolist()), gen)
        for i in range(n)]


def bucket_impls(fwd) -> tuple:
    """(outer impls, scan subplan impls) of a planned prefill."""
    outer = Counter(fwd.chosen_impls())
    inner = Counter(m.impl for n in fwd.concrete.topo()
                    if n.subplan is not None for m in n.subplan.topo())
    return outer, inner


def timed(fn, acc, key):
    """``fn`` wrapped to add its host seconds to ``acc[key]``."""
    def wrapper(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            acc[key] += time.perf_counter() - t0
    return wrapper


def serve_runtime(model, params, syscat, dev, *, max_batch, max_seq,
                  prefill_batch=4):
    return AsyncServingRuntime(
        model, params, engines=("xla", "pallas"), max_batch=max_batch,
        max_seq=max_seq, page_size=SERVE["page_size"],
        plan_cache=PlanCache(), syscat=syscat, prefill_batch=prefill_batch,
        device=dev)


def serve_path(args, dev, syscat) -> list:
    """Phases 11-14: qwen3-0.6b served.  Returns the flash record."""
    # 11. data: the model at full width from a seeded generator on the card
    cfg = get_config(SERVE["arch"])
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    n_params = sum(int(t.numel()) for _k, t in _leaves(params))
    phase("data", path="qwen3_serve", arch=cfg.name, layers=cfg.n_layers,
          d_model=cfg.d_model, heads=cfg.heads, kv_heads=cfg.kv_heads,
          head_dim=cfg.resolved_head_dim, vocab=cfg.vocab, dtype=cfg.dtype,
          param_dtype=cfg.param_dtype, params=n_params,
          init_s=round(time.perf_counter() - t0, 3))

    # 12. the kernel at the path's shapes and at edge cases
    gen = torch.Generator(device=dev).manual_seed(SEED)
    record = check_flash(dev, gen, cfg, SERVE["max_batch"])
    torch.cuda.empty_cache()

    # 13. the runtime through its entry points
    reqs = serve_trace(cfg, SERVE["prompt_lens"], SERVE["requests"],
                       SERVE["gen"])
    rt = serve_runtime(model, params, syscat, dev,
                       max_batch=SERVE["max_batch"],
                       max_seq=SERVE["max_seq"])
    t0 = time.perf_counter()
    rt.warmup([r.prompt_len for r in reqs])
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    for bucket, fwd in sorted(rt._prefill_fns.items()):
        outer, inner = bucket_impls(fwd)
        check(inner["attn_flash_pallas"] == 1 and "sdpa_xla" not in inner,
              f"bucket {bucket}: attention impls {dict(inner)}")
        phase("serve", bucket=bucket, plan_id=fwd.plan_id[:12],
              impls=json.dumps(dict(outer)), layer_impls=json.dumps(
                  dict(inner)))
    s0 = rt.pc.stats()
    fwd0 = rt.registry.count("lm.prefill_forwards", 0)
    secs = {"prefill": 0.0, "decode": 0.0}
    rt._try_join = timed(rt._try_join, secs, "prefill")
    rt._decode_tick = timed(rt._decode_tick, secs, "decode")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = rt.serve(reqs, timeout_s=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counted = kernels.launches()
    forwards = rt.registry.count("lm.prefill_forwards", 0) - fwd0
    s1 = rt.pc.stats()
    check([r.status for r in res] == ["ok"] * len(reqs),
          f"serve statuses {[r.status for r in res]}")
    check(all(len(r.tokens) == SERVE["gen"] for r in res),
          "a request generated the wrong number of tokens")
    hits, misses = s1["hits"] - s0["hits"], s1["misses"] - s0["misses"]
    tokens = sum(len(r.tokens) for r in res)
    occ = rt.pool.occupancy()
    fill = rt.registry.summary("lm.pool_fill")
    phase("serve", requests=len(reqs), ok=len(res), wall_s=round(wall, 4),
          warmup_s=round(warmup_s, 3), prefill_forwards=forwards,
          launches=json.dumps({k: v for k, v in counted.items() if v}),
          tokens=tokens, total_tok_s=tokens / wall,
          decode_tok_s=sum(len(r.tokens) - 1 for r in res) / secs["decode"],
          prefill_s=round(secs["prefill"], 4),
          decode_s=round(secs["decode"], 4), ticks=rt.metrics.ticks,
          ttft_ms=json.dumps([round(r.metrics.ttft_s * 1e3, 2)
                              for r in res]),
          plan_ms=json.dumps([round(r.metrics.plan_ms, 2) for r in res]),
          prefill_ms=json.dumps([round(r.metrics.prefill_ms, 2)
                                 for r in res]),
          tpot_ms=json.dumps([round(r.metrics.tpot_s * 1e3, 3)
                              for r in res]),
          plan_hits_after_warmup=hits, plan_misses_after_warmup=misses,
          pool_fill_max=fill.max, pool_after=json.dumps(occ),
          peak_mem_gb=round(torch.cuda.max_memory_allocated() / 1e9, 3))
    record["launches"] = counted["flash_attention"]
    record["path"] = "qwen3_serve"
    check_serve_ledger(rt)
    if args.profile:
        # the same runtime serves the trace again (its requests are reset)
        profile_call(lambda: rt.serve(reqs, timeout_s=600), "qwen3_serve")

    # 14. checks
    check(counted == launch_counts(flash_attention=cfg.n_layers * forwards),
          f"launches {counted} != {cfg.n_layers} x {forwards} forwards")
    check(misses == 0 and hits >= len(reqs),
          f"plan cache after warmup: {hits} hits, {misses} misses")
    check(occ["slots_used"] == 0 and occ["pages_used"] == 0,
          f"pool not drained: {occ}")
    del rt, res
    torch.cuda.empty_cache()
    graph_ms = check_decode_graph(model, params, dev, SERVE["max_batch"])
    model32 = build_model(cfg.replace(dtype="float32"))
    rt32 = serve_runtime(model32, params, syscat, dev,
                         max_batch=SERVE["max_batch"],
                         max_seq=SERVE["max_seq"])
    rt32.warmup([r.prompt_len for r in reqs])
    t0 = time.perf_counter()
    res32 = rt32.serve(reqs, timeout_s=600)
    rt_s = time.perf_counter() - t0
    del rt32
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    seq = serve_sequential(model32, params, reqs, max_seq=SERVE["max_seq"],
                           engines=("xla", "pallas"), syscat=syscat,
                           plan_cache=PlanCache(), device=dev)
    seq_s = time.perf_counter() - t0
    check([r.status for r in res32] == ["ok"] * len(reqs),
          "float32 serve failed")
    differ = [r.rid for r, q in zip(res32, seq) if r.tokens != q.tokens]
    check(not differ, f"float32 runtime and serve_sequential differ on "
                      f"requests {differ}")
    torch.cuda.empty_cache()
    cpu = cpu_subtrace(cfg, model32, params, syscat, dev,
                       serve_trace(cfg, SUBTRACE["prompt_lens"], 2,
                                   SUBTRACE["gen"]), SUBTRACE["max_seq"])
    phase("check", path="qwen3_serve",
          launches_equal_layers_x_forwards=True,
          decode_graph_bitwise_eager=True, **graph_ms,
          plan_hit_rate_after_warmup=hits / (hits + misses),
          f32_runtime_equal_sequential=True, f32_runtime_s=round(rt_s, 3),
          f32_sequential_s=round(seq_s, 3), **cpu)
    return [record]


def check_serve_ledger(rt):
    """[ledger] of a served trace: the runtime's telemetry snapshot; the
    KV pool's ledger entry holds the bytes of the pool's tensors, and no
    entry outlives its anchor (``leaks()`` empty)."""
    snap = rt.telemetry_snapshot()
    entry = rt.ledger.get(("kv_pool", f"{id(rt.pool):#x}"))
    pool = sum(t.nbytes for gc in rt.pool.cache.values()
               for t in gc.values())
    check(entry is not None and entry.nbytes == pool,
          f"kv_pool ledger bytes {entry and entry.nbytes} != pool {pool}")
    leaks = rt.ledger.leaks()
    check(not leaks, f"ledger leaks {[(r, e.owner) for r, e in leaks]}")
    kept = [("plan_jit", f.plan_id) for f in rt._prefill_fns.values()]
    check(all(rt.ledger.get(k) is not None for k in kept),
          "a kept prefill plan is not in the ledger")
    phase("ledger", path="qwen3_serve", kv_pool_bytes=entry.nbytes,
          pool_tensor_bytes=pool, leaks=0, plan_jit=len(kept),
          recorder_events=len(rt.recorder), trips=len(rt.recorder.trips),
          snapshot=json.dumps(snap, default=str))


def check_decode_graph(model, params, dev, batch) -> dict:
    """The runtime's CUDA-graph decode step against the eager step on
    equal random caches, slots at different positions: logits and caches
    bitwise equal.  Returns the two steps' CUDA-event medians."""
    params = model.inference_params(params)
    cache = init_cache(model, batch, 512, device=dev)
    graph = DecodeGraph(model, params, cache, batch)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for _key, leaf in _leaves(cache):
        leaf.copy_(torch.randn(leaf.shape, generator=gen, device=dev))
    twin = {g: {k: v.clone() for k, v in gc.items()}
            for g, gc in cache.items()}
    tok = torch.randint(0, model.cfg.vocab, (batch, 1), generator=gen,
                        device=dev)
    idx = torch.arange(batch, device=dev) * 100 + 7
    got = graph(tok, idx).clone()
    want, _ = decode_step_batched(model, params, twin, tok, idx)
    check(torch.equal(got, want), "DecodeGraph logits differ from the "
                                  "eager step's")
    check(all(torch.equal(cache[g][k], twin[g][k])
              for g in cache for k in cache[g]),
          "DecodeGraph cache writes differ from the eager step's")
    return {"decode_graph_ms": cuda_ms(lambda: graph(tok, idx), reps=5),
            "decode_eager_ms": cuda_ms(lambda: decode_step_batched(
                model, params, twin, tok, idx), reps=5)}


def params_to(tree, device):
    """The same nested dict of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def cpu_subtrace(cfg, model32, params, syscat, dev, reqs, max_seq) -> dict:
    """Float32 requests on the card and through the port's plain path on
    the CPU: first-token logits allclose; token streams equal up to the
    first step whose top-2 logit margin (on the CPU) is within LOGIT_TOL."""
    runs = {}
    t0 = time.perf_counter()
    for where, p in (("card", params), ("cpu", params_to(params, "cpu"))):
        rt = serve_runtime(model32, p, syscat, dev if where == "card"
                           else "cpu", max_batch=2, max_seq=max_seq,
                           prefill_batch=1)
        rt.warmup([r.prompt_len for r in reqs])
        res = rt.serve(reqs, timeout_s=900)
        check([r.status for r in res] == ["ok"] * len(reqs),
              f"{where} sub-trace statuses {[r.status for r in res]}")
        runs[where] = (rt, res)
    cpu_s = time.perf_counter() - t0

    def last_logits(where, toks):
        rt, _ = runs[where]
        bucket = rt.bucket_of(len(toks))
        fwd, _ = rt._plan_prefill(bucket)
        padded = torch.zeros((1, bucket), dtype=torch.long, device=rt.device)
        padded[0, :len(toks)] = torch.tensor(toks)
        out = fwd(rt.params, {"tokens": padded})
        logits = out[0] if isinstance(out, tuple) else out   # prefill_kv
        return logits[0, len(toks) - 1, :cfg.vocab].float().cpu()

    err, diverged, margins = 0.0, [], []
    for i, req in enumerate(reqs):
        a = last_logits("card", req.prompt)
        c = last_logits("cpu", req.prompt)
        torch.testing.assert_close(a, c, atol=LOGIT_TOL, rtol=LOGIT_TOL)
        err = max(err, float((a - c).abs().max()))
        top = torch.topk(c, 2).values
        margins.append(float(top[0] - top[1]))
        ta, tc = runs["card"][1][i].tokens, runs["cpu"][1][i].tokens
        t = next((j for j, (x, y) in enumerate(zip(ta, tc)) if x != y), None)
        if t is not None:
            top = torch.topk(last_logits("cpu", req.prompt + tuple(tc[:t])),
                             2).values
            check(float(top[0] - top[1]) <= LOGIT_TOL,
                  f"request {i}: card and CPU tokens differ at step {t} "
                  f"where the top-2 margin is {float(top[0] - top[1])}")
            diverged.append((i, t))
    return {"cpu_first_logits_max_abs_err": err,
            "cpu_first_top2_margins": json.dumps(margins),
            "cpu_tokens_equal": not diverged,
            "cpu_diverged_at_near_tie": json.dumps(diverged),
            "cpu_subtrace_s": round(cpu_s, 3)}

# -- phases 15-22: the recurrent families served ---------------------------


@contextlib.contextmanager
def recording_shapes(module, name, calls, arg=0):
    """Keep in ``calls`` the arguments of the first call of ``module.name``
    (a kernel wrapper or layer, under the name its caller uses) at each new
    shape of its argument ``arg``: one planned prefill's arguments per
    bucket, without holding every layer's."""
    wrapped = getattr(module, name)

    def record(*args, **kwargs):
        key = tuple(args[arg].shape)
        if key not in calls:
            calls[key] = (args, kwargs)
        return wrapped(*args, **kwargs)

    setattr(module, name, record)
    try:
        yield
    finally:
        setattr(module, name, wrapped)


def stored_bytes(t) -> int:
    """The bytes a tensor's storage holds for its view: dimensions of
    stride 0 (a broadcast) count once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        n *= size if stride else 1
    return n * t.element_size()


def wkv6_inputs(gen, dev, b, t, h, d, dtype, decay=None):
    """r, k, v (unit normal), w in (0.4, 0.99), the constant ``decay`` or,
    for "mixed", exp(-exp(z)) with z ~ N(0, 1.5) per element (channels
    below 1e-3 beside channels near 1 in one head), u: the kernel's
    arguments as ``rwkv_time_mix`` shapes them."""
    r, k, v = (torch.randn(b, t, h, d, generator=gen, device=dev).to(dtype)
               for _ in range(3))
    if decay is None:
        w = torch.rand(b, t, h, d, generator=gen, device=dev) * 0.59 + 0.4
    elif decay == "mixed":
        w = torch.exp(-torch.exp(1.5 * torch.randn(
            b, t, h, d, generator=gen, device=dev)))
    else:
        w = torch.full((b, t, h, d), decay, device=dev)
    u = torch.randn(h, d, generator=gen, device=dev)
    return (r, k, v, w.to(dtype), u), {}


def ssd_inputs(gen, dev, b, t, h, p, n, dtype, decay=None, shared=True):
    """x, a in (0.5, 0.99), the constant ``decay`` or, for "mixed",
    exp(-exp(z)) with z ~ N(0, 1.5) per head plus N(0, 0.5) per step (some
    heads' decays near 0, others' near 1), and b, c as the mamba block
    passes them (one (B, T, N) matrix expanded over heads, stride 0) or
    materialized per head."""
    x = torch.randn(b, t, h, p, generator=gen, device=dev).to(dtype)
    if decay is None:
        a = torch.rand(b, t, h, generator=gen, device=dev) * 0.49 + 0.5
    elif decay == "mixed":
        a = torch.exp(-torch.exp(
            1.5 * torch.randn(1, 1, h, generator=gen, device=dev)
            + 0.5 * torch.randn(b, t, h, generator=gen, device=dev)))
    else:
        a = torch.full((b, t, h), decay, device=dev)
    hh = 1 if shared else h
    bb, cc = (torch.randn(b, t, hh, n, generator=gen, device=dev).to(dtype)
              .expand(b, t, h, n) for _ in range(2))
    return (x, a.to(dtype), bb, cc), {}


# (name, b, t, dtype, decay, ssd's b/c shared over heads); the bfloat16
# kernels work in chunks of CHUNK steps, wkv6's in sub-chunks of SUB_CHUNK
CHUNK, SUB_CHUNK = 64, 16
RECURRENT_EDGES = (
    ("T = 1", 1, 1, torch.bfloat16, None, True),
    ("T = 300, float32", 1, 300, torch.float32, None, True),
    ("B = 2, T = 300", 2, 300, torch.bfloat16, None, True),
    ("decay 1.0", 1, 300, torch.float32, 1.0, True),
    ("decay near 0", 1, 300, torch.float32, 1e-6, True),
    ("B = 2, T = 77 (ssd: b, c per head)", 2, 77, torch.float32, None,
     False),
    ("decay 1.0, bfloat16", 1, 300, torch.bfloat16, 1.0, True),
    ("decay near 0, bfloat16", 1, 300, torch.bfloat16, 1e-6, True),
    ("B = 2, T = 77, bfloat16 (ssd: b, c per head)", 2, 77, torch.bfloat16,
     None, False),
    ("mixed decays", 1, 300, torch.bfloat16, "mixed", True),
    ("mixed decays, float32", 1, 300, torch.float32, "mixed", True),
    *((f"T = {name} = {t}{tag}", 1, t, dt, None, True)
      for name, t in (("L - 1", CHUNK - 1), ("L + 1", CHUNK + 1),
                      ("2 L_sub + 1", 2 * SUB_CHUNK + 1))
      for dt, tag in ((torch.bfloat16, ""), (torch.float32, ", float32"))),
)


# the same inputs as views whose rows start 2 bytes past a 16-byte
# boundary: the kernels' element-load path in place of cp.async
UNALIGNED_EDGE = ("unaligned views, bfloat16", 1, 100, torch.bfloat16, None,
                  True)


def unaligned(t):
    """``t``'s values as a view one element into a wider buffer (a head
    dimension of stride 0 kept so); 3-d and smaller tensors as they are."""
    if t.dim() < 4:
        return t
    src = t[:, :, :1] if t.stride(2) == 0 else t
    buf = torch.zeros(*src.shape[:-1], src.shape[-1] + 1, dtype=src.dtype,
                      device=src.device)
    buf[..., 1:] = src
    return buf[..., 1:].expand(t.shape)


def recurrence_compare(spec, args, kwargs):
    """The kernel against its plain version on the same arguments, within
    the dtype's tolerance; returns the max abs error."""
    got = spec["kernel"](*args, **kwargs)
    want = spec["plain"](*args, **kwargs)[0]
    tol = RECURRENT_TOL[args[0].dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    check(got.dtype == args[0].dtype and got.shape == args[0].shape,
          f"{spec['name']}: wrong output dtype or shape")
    return float((got.float() - want.float()).abs().max())


def recurrence_work(spec, args) -> dict:
    """What the recurrence needs on these arguments: ``bytes``, each
    input's stored bytes once and the output once; ``products`` and
    ``other``, the operations of the chunked form the bfloat16 kernels
    compute (chunks of CHUNK steps, the last one partial; per chunk of l
    steps and head), its matrix products and the rest:

      ssd:  G = C Bᵀ, l (l + 1) N (causal; once per batch where b and c
            are shared over heads), M X, l (l + 1) P, C H_in and the state
            update, 2 l N P each; other: the decays of M, l (l + 1), the
            scalings of Y and X, 2 l P, H's decay, N P;
      wkv6: A's pairs in different sub-chunks, 2 D each, A V over the
            l (l + 1) / 2 pairs s <= t, 2 D each, q S_in and the state
            update, 2 l D² each; other: the pairs inside a sub-chunk, 3 D
            each (a power of two, a product, a sum), the operands' decays
            and the cumsum, 8 l D, S's decay, D²;

    and ``sequential``, the sequential form's operations: 5 D² + 3 D
    (wkv6: r·S, the state update and the bonus scalar Σ r u k) or 5 N P
    (ssd: the state update and c·H) a step and head."""
    out = args[0]
    nbytes = sum(stored_bytes(t) for t in args) + stored_bytes(out)
    b, t, h, d = out.shape
    lens = [min(CHUNK, t - t0) for t0 in range(0, t, CHUNK)]
    if spec["name"] == "wkv6":
        def inside(n):        # pairs s <= t inside one chunk's sub-chunks
            subs = [min(SUB_CHUNK, n - s0) for s0 in range(0, n, SUB_CHUNK)]
            return sum(m * (m + 1) // 2 for m in subs)
        products = sum(2 * d * (n * (n + 1) // 2 - inside(n))
                       + 2 * d * n * (n + 1) // 2 + 4 * n * d * d
                       for n in lens) * b * h
        other = sum(3 * d * inside(n) + 8 * n * d + d * d
                    for n in lens) * b * h
        return {"bytes": nbytes, "products": products, "other": other,
                "sequential": (5 * d * d + 3 * d) * b * t * h}
    n_st = args[2].shape[-1]
    g_copies = b if args[2].stride(2) == 0 and args[3].stride(2) == 0 \
        else b * h
    products = (sum(n * (n + 1) for n in lens) * n_st * g_copies
                + sum(n * (n + 1) * d + 4 * n * n_st * d
                      for n in lens) * b * h)
    other = sum(n * (n + 1) + 2 * n * d + n_st * d for n in lens) * b * h
    return {"bytes": nbytes, "products": products, "other": other,
            "sequential": 5 * n_st * d * b * t * h}


def recurrence_bound(work, dtype) -> tuple:
    """The least time the card could take (ms) and what bounds it: bytes
    at 3.35 TB/s against the chunked form's products at the tensor-core
    rate of the type the kernel feeds them (bfloat16: 989 TFLOP/s) plus
    its other operations at the float32 rate.  The float32 kernel computes
    the sequential form: its operations at the float32 rate."""
    t_bytes = work["bytes"] / HBM_BYTES_PER_S
    if dtype == torch.bfloat16:
        t_ops = work["products"] / BF16_FLOPS + work["other"] / FP32_FLOPS
    else:
        t_ops = work["sequential"] / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_recurrence(dev, gen, cfg, spec, calls) -> dict:
    """The recurrence kernel on the arguments one planned prefill gave it
    at each bucket (timed) and at the edge cases; returns its JSON record
    (the largest bucket)."""
    err = 0.0
    if spec["name"] == "wkv6":
        h, d = cfg.heads, cfg.resolved_head_dim
        make = lambda b, t, dt, dc, sh: wkv6_inputs(  # noqa: E731
            gen, dev, b, t, h, d, dt, dc)
    else:
        h = cfg.expand * cfg.d_model // cfg.mamba_head_dim
        make = lambda b, t, dt, dc, sh: ssd_inputs(  # noqa: E731
            gen, dev, b, t, h, cfg.mamba_head_dim, cfg.ssm_state, dt, dc,
            sh)
    for name, b, t, dt, decay, shared in (*RECURRENT_EDGES, UNALIGNED_EDGE):
        args, kwargs = make(b, t, dt, decay, shared)
        if name == UNALIGNED_EDGE[0]:
            args = tuple(unaligned(a) for a in args)
            check(all(a.storage_offset() % 8 for a in args if a.dim() == 4),
                  "unaligned edge case: a view starts aligned")
        e = recurrence_compare(spec, args, kwargs)
        err = max(err, e)
        phase(f"{spec['path']}-kernel", case=json.dumps(name), b=b, t=t,
              dtype=str(dt).split(".")[1], max_abs_err=e)
    record = None
    for shape, (args, kwargs) in sorted(calls.items(),
                                        key=lambda kv: kv[0][1]):
        e = recurrence_compare(spec, args, kwargs)
        err = max(err, e)
        ms = cuda_ms(lambda: spec["kernel"](*args, **kwargs))
        dev_ms, via = device_ms(lambda: spec["kernel"](*args, **kwargs))
        plain_ms = cuda_ms(lambda: spec["plain"](*args, **kwargs), reps=3,
                           warmup=1)
        work = recurrence_work(spec, args)
        bound_ms, bound_by = recurrence_bound(work, args[0].dtype)
        seq_bound_ms, seq_by = bound(work["bytes"], work["sequential"],
                                     FP32_FLOPS)
        phase(f"{spec['path']}-kernel", name=spec["name"], shape="served",
              args=json.dumps([list(a.shape) for a in args]),
              strides=json.dumps([list(a.stride()) for a in args]),
              dtype=str(args[0].dtype).split(".")[1], max_abs_err=e, ms=ms,
              device_ms=dev_ms, device_ms_via=via, plain_ms=plain_ms,
              library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
              share_of_bound=bound_ms / dev_ms, seq_bound_ms=seq_bound_ms,
              seq_bound_by=seq_by, mb=work["bytes"] / 1e6,
              product_gflop=work["products"] / 1e9,
              other_gflop=work["other"] / 1e9,
              seq_gflop=work["sequential"] / 1e9)
        record = {"name": spec["name"], "route": "cuda",
                  "source": spec["source"], "replaces": spec["replaces"],
                  "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                  "bound_ms": bound_ms, "bound_by": bound_by,
                  "library_ms": None}
    check(record is not None, f"{spec['name']}: no call was recorded")
    record["max_abs_err"] = err
    return record


def check_flash_calls(calls, path) -> dict:
    """flash_attention on the arguments a served model's planned prefill
    gave it at each bucket (timed, beside scaled_dot_product_attention);
    returns its JSON record (the largest bucket)."""
    err, record = 0.0, None
    for _shape, (args, kwargs) in sorted(calls.items(),
                                         key=lambda kv: kv[0][1]):
        q, k, v = args
        causal, window = kwargs.get("causal", True), kwargs.get("window", 0)
        e = flash_compare(q, k, v, causal=causal, window=window)
        err = max(err, e)
        b, s, h, d = q.shape
        kvh = k.shape[2]
        ms = cuda_ms(lambda: flash_attention(q, k, v, causal=causal,
                                             window=window))
        plain_ms = cuda_ms(lambda: flash_attention_plain(
            q, k, v, causal=causal, window=window))
        qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
        lib_ms = cuda_ms(lambda: torch.nn.functional
                         .scaled_dot_product_attention(
                             qh, kh, vh, is_causal=causal, enable_gqa=True))
        nbytes = q.element_size() * (2 * b * s * h * d + 2 * b * s * kvh * d)
        nops = 4 * b * h * d * attention_pairs(s, s, causal, window)
        bound_ms, bound_by = bound(nbytes, nops, BF16_FLOPS)
        phase(f"{path}-kernel", name="flash_attention", b=b, seq=s,
              heads=h, kv_heads=kvh, head_dim=d,
              dtype=str(q.dtype).split(".")[1], max_abs_err=e, ms=ms,
              plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
              bound_by=bound_by, share_of_bound=bound_ms / ms)
        record = {"name": "flash_attention", "route": "cuda",
                  "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                  "replaces": "src/repro/kernels/flash_attention/ops.py:110",
                  "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                  "bound_by": bound_by, "library_ms": lib_ms}
    check(record is not None, f"{path}: no flash_attention call recorded")
    record["max_abs_err"] = err
    return record


def prefill_engines_agree(model32, params, syscat, dev, spec) -> float:
    """The float32 planned prefill at bucket 512 with the kernel (engines
    xla + pallas) against the chunked plain engine (xla) on the card:
    last-position logits within LOGIT_TOL.  Returns the max abs error."""
    bucket = RSUB["engine_bucket"]
    toks = torch.randint(0, model32.cfg.vocab, (1, bucket), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(
                             SEED))
    params = model32.inference_params(params)
    last = {}
    for engines in (("xla", "pallas"), ("xla",)):
        fwd = plan_and_compile(
            model32.build_plan(1, bucket, mode="prefill"), CATALOG, syscat,
            engines=engines, cache=False, device=dev)
        inner = bucket_impls(fwd)[1]
        want = spec["impl"] if "pallas" in engines else spec["xla"]
        check(inner[want] > 0, f"bucket {bucket} {engines}: impls "
                               f"{dict(inner)}")
        last[engines] = fwd(params, {"tokens": toks})[0, -1].float()
    a, b = last[("xla", "pallas")], last[("xla",)]
    torch.testing.assert_close(a, b, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    return float((a - b).abs().max())


def recurrent_path(args, dev, syscat, arch) -> list:
    """One recurrent family served (rwkv6-3b: phases 15-18; zamba2-7b:
    19-22).  Returns its kernels' records."""
    spec = RECURRENT[arch]
    path = spec["path"]
    t_path = time.perf_counter()
    # data: the model at full width from a seeded generator on the card
    cfg = get_config(arch)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    leaves = [t for _k, t in _leaves(params)]
    phase("data", path=path, arch=cfg.name, family=cfg.family,
          layers=cfg.n_layers, d_model=cfg.d_model, dtype=cfg.dtype,
          param_dtype=cfg.param_dtype,
          params=sum(int(t.numel()) for t in leaves),
          param_gb=round(sum(stored_bytes(t) for t in leaves) / 1e9, 3),
          seconds=round(time.perf_counter() - t0, 3))

    # serve: the runtime through its entry points, each kernel's
    # arguments recorded at every bucket
    t0 = time.perf_counter()
    reqs = serve_trace(cfg, RSERVE["prompt_lens"], RSERVE["requests"],
                       RSERVE["gen"])
    rt = serve_runtime(model, params, syscat, dev,
                       max_batch=RSERVE["max_batch"],
                       max_seq=RSERVE["max_seq"])
    check(not rt.kv_mode, f"{arch}: the runtime is not in replay mode")
    rt.warmup([r.prompt_len for r in reqs])
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    flash_buckets = set()
    for bucket, fwd in sorted(rt._prefill_fns.items()):
        outer, inner = bucket_impls(fwd)
        check(inner[spec["impl"]] > 0 and spec["xla"] not in inner,
              f"bucket {bucket}: recurrence impls {dict(inner)}")
        if inner["attn_flash_pallas"]:
            flash_buckets.add(bucket)
        phase("serve", path=path, bucket=bucket, plan_id=fwd.plan_id[:12],
              impls=json.dumps(dict(outer)),
              layer_impls=json.dumps(dict(inner)))
    s0 = rt.pc.stats()
    fwd0 = rt.registry.count("lm.prefill_forwards", 0)
    secs = {"prefill": 0.0, "decode": 0.0}
    rt._try_join = timed(rt._try_join, secs, "prefill")
    rt._decode_tick = timed(rt._decode_tick, secs, "decode")
    calls, flash_calls = {}, {}
    torch.cuda.reset_peak_memory_stats()
    with recording_shapes(spec["module"], spec["entry"], calls), \
            recording_shapes(attention_layer, "flash_attention", flash_calls):
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = rt.serve(reqs, timeout_s=900)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counted = kernels.launches()
    forwards = rt.registry.count("lm.prefill_forwards", 0) - fwd0
    s1 = rt.pc.stats()
    hits, misses = s1["hits"] - s0["hits"], s1["misses"] - s0["misses"]
    check([r.status for r in res] == ["ok"] * len(reqs),
          f"{arch} serve statuses {[r.status for r in res]}")
    check(all(len(r.tokens) == RSERVE["gen"] for r in res),
          f"{arch}: a request generated the wrong number of tokens")
    tokens = sum(len(r.tokens) for r in res)
    occ = rt.pool.occupancy()
    ms_of = lambda key: json.dumps([  # noqa: E731
        round(getattr(r.metrics, key), 2) for r in res])
    phase("serve", path=path, requests=len(reqs), wall_s=round(wall, 4),
          warmup_s=round(warmup_s, 3), prefill_forwards=forwards,
          replay_steps=rt.registry.count("lm.replay_steps", 0),
          launches=json.dumps({k: v for k, v in counted.items() if v}),
          tokens=tokens, total_tok_s=tokens / wall,
          decode_tok_s=sum(len(r.tokens) - 1 for r in res) / secs["decode"],
          join_s=round(secs["prefill"], 4), decode_s=round(secs["decode"], 4),
          ticks=rt.metrics.ticks,
          ttft_ms=json.dumps([round(r.metrics.ttft_s * 1e3, 2)
                              for r in res]),
          plan_ms=ms_of("plan_ms"), prefill_ms=ms_of("prefill_ms"),
          replay_ms=ms_of("replay_ms"), adopt_ms=ms_of("adopt_ms"),
          tpot_ms=json.dumps([round(r.metrics.tpot_s * 1e3, 3)
                              for r in res]),
          plan_hits_after_warmup=hits, plan_misses_after_warmup=misses,
          pool_after=json.dumps(occ),
          peak_mem_gb=round(torch.cuda.max_memory_allocated() / 1e9, 3),
          seconds=round(time.perf_counter() - t_path, 1))
    # one batch-1 forward per request: the kernel runs in every layer of
    # it, flash in every shared attention block where the bucket's plan
    # picked it
    shared = cfg.n_layers // cfg.shared_attn_period \
        if cfg.family == "hybrid" else 0
    flash_forwards = sum(rt.bucket_of(r.prompt_len) in flash_buckets
                         for r in reqs)
    expected = launch_counts(**{spec["name"]: cfg.n_layers * forwards,
                                "flash_attention": shared * flash_forwards})
    check(forwards == len(reqs), f"{forwards} prefill forwards for "
                                 f"{len(reqs)} requests")
    check(counted == expected, f"{arch} launches {counted} != {expected}")
    check(misses == 0 and hits >= len(reqs),
          f"plan cache after warmup: {hits} hits, {misses} misses")
    check(occ["slots_used"] == 0 and occ["pages_used"] == 0,
          f"pool not drained: {occ}")
    if args.profile:
        # one request (prompt 100) on the same runtime: the full trace's
        # ~3,600 replayed steps of thousands of kernels each would swamp
        # the profiler
        one = serve_trace(cfg, RSERVE["prompt_lens"][:1], 1, RSERVE["gen"])
        profile_call(lambda: rt.serve(one, timeout_s=900), path)
    del rt, res
    torch.cuda.empty_cache()

    # kernel: against its plain version on the recorded arguments and at
    # edge cases
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    records = [check_recurrence(dev, gen, cfg, spec, calls)]
    if flash_calls:
        records.append(check_flash_calls(flash_calls, path))
    for rec in records:
        rec["launches"] = counted[rec["name"]]
        rec["path"] = path
    del calls, flash_calls
    torch.cuda.empty_cache()
    phase(f"{path}-kernel", seconds=round(time.perf_counter() - t0, 1))

    # check: float32 runtime against serve_sequential; the kernel's
    # prefill against the chunked engine's; rwkv6-3b on the CPU
    t0 = time.perf_counter()
    model32 = build_model(cfg.replace(dtype="float32"))
    sub = serve_trace(cfg, RSUB["prompt_lens"], len(RSUB["prompt_lens"]),
                      RSUB["gen"])
    rt32 = serve_runtime(model32, params, syscat, dev,
                         max_batch=RSERVE["max_batch"],
                         max_seq=RSERVE["max_seq"])
    rt32.warmup([r.prompt_len for r in sub])
    res32 = rt32.serve(sub, timeout_s=900)
    del rt32
    torch.cuda.empty_cache()
    seq = serve_sequential(model32, params, sub, max_seq=RSERVE["max_seq"],
                           engines=("xla", "pallas"), syscat=syscat,
                           plan_cache=PlanCache(), device=dev)
    check([r.status for r in res32] == ["ok"] * len(sub),
          f"{arch} float32 serve failed")
    differ = [r.rid for r, q in zip(res32, seq) if r.tokens != q.tokens]
    check(not differ, f"{arch} float32 runtime and serve_sequential differ "
                      f"on requests {differ}")
    f32_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    engine_err = prefill_engines_agree(model32, params, syscat, dev, spec)
    cpu = {}
    if spec["cpu_check"]:
        cpu = cpu_subtrace(cfg, model32, params, syscat, dev,
                           serve_trace(cfg, RCPU["prompt_lens"], 1,
                                       RCPU["gen"]), RCPU["max_seq"])
    phase("check", path=path, launches_equal_layers_x_forwards=True,
          flash_forwards=flash_forwards,
          plan_hit_rate_after_warmup=hits / (hits + misses),
          f32_runtime_equal_sequential=True, f32_s=round(f32_s, 3),
          prefill_kernel_vs_chunked_max_abs_err=engine_err, **cpu,
          seconds=round(time.perf_counter() - t0, 1))
    del params, leaves, model, model32
    torch.cuda.empty_cache()
    return records


# -- phases 23-26: dbrx-132b served ---------------------------------------


def gmm_inputs(gen, dev, e, c, d, f, dtype):
    """x (E, C, D) and w (E, D, F), unit normal, in ``dtype``."""
    return (torch.randn(e, c, d, generator=gen, device=dev).to(dtype),
            torch.randn(e, d, f, generator=gen, device=dev).to(dtype))


def gmm_edge_cases(gen, dev):
    """(name, x, w): float32, ragged C / D / F (no multiple of the bfloat16
    kernel's 128 / 64 / 256 tiles), E = 1, C = 1, all-zero capacity rows,
    a weight view at an offset in a stacked tree (at 8 elements, read in
    place; at 4, 8 bytes off the TMA alignment, copied first) and a
    non-contiguous x (copied first in bfloat16)."""
    cases = [("float32 4 x 20 x 12 x 28",
              *gmm_inputs(gen, dev, 4, 20, 12, 28, torch.float32)),
             ("bfloat16 4 x 20 x 12 x 28",
              *gmm_inputs(gen, dev, 4, 20, 12, 28, torch.bfloat16)),
             ("E = 1, 33 x 40 x 17",
              *gmm_inputs(gen, dev, 1, 33, 40, 17, torch.bfloat16)),
             ("float32 16 x 300 x 6144 x 200",
              *gmm_inputs(gen, dev, 16, 300, 6144, 200, torch.float32)),
             ("bfloat16 16 x 300 x 1000 x 600",
              *gmm_inputs(gen, dev, 16, 300, 1000, 600, torch.bfloat16)),
             ("C = 1, 3 x 1 x 256 x 520",
              *gmm_inputs(gen, dev, 3, 1, 256, 520, torch.bfloat16))]
    stacked = torch.randn(2, 4, 264, 400, generator=gen,
                          device=dev).to(torch.bfloat16)
    x = torch.randn(4, 130, 264, generator=gen, device=dev).to(
        torch.bfloat16)
    cases.append(("bfloat16 w view at 4 (copied)", x,
                  stacked[1, :, :, 4:388]))
    x, w = gmm_inputs(gen, dev, 16, 256, 512, 384, torch.bfloat16)
    x[:, 100:] = 0.0
    cases.append(("all-zero capacity rows", x, w))
    for dt in (torch.float32, torch.bfloat16):
        stacked = torch.randn(2, 4, 256, 400, generator=gen,
                              device=dev).to(dt)
        w = stacked[1, :, :, 8:392]                  # a view at an offset
        x = torch.randn(4, 256, 300, generator=gen, device=dev).to(dt)
        x = x.transpose(1, 2)[:, :250]               # (4, 250, 256) strided
        cases.append((f"{str(dt).split('.')[1]} strided x, w view", x, w))
    return cases


def gmm_compare(x, w):
    """The kernel against its plain version on the same inputs, within the
    dtype's tolerance, one expert at a time (float32 copies of a whole
    served output would take 2.8 GB each); returns the max abs error."""
    got = gmm(x, w)
    want = gmm_reference(x, w)
    check(got.dtype == x.dtype
          and got.shape == (x.shape[0], x.shape[1], w.shape[2]),
          "gmm: wrong output dtype or shape")
    tol, err = GMM_TOL[x.dtype], 0.0
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        torch.testing.assert_close(a, b, atol=tol, rtol=tol)
        err = max(err, float((a - b).abs().max()))
    return err


def slow_ms(fn) -> float:
    """CUDA-event median of ``fn``: REPS launches, or 5 where one launch
    takes over 50 ms."""
    first = cuda_ms(fn, reps=1, warmup=1)
    return cuda_ms(fn, reps=5 if first > 50 else REPS, warmup=0)


def check_gmm(dev, gen, calls) -> dict:
    """gmm on the arguments each planned prefill gave it, in both shapes
    (``wi`` / ``wg`` and ``wo``; timed beside the plain version and
    ``torch.bmm``), and at the edge cases; returns its JSON record (``wi``
    at the largest bucket)."""
    err = 0.0
    for name, x, w in gmm_edge_cases(gen, dev):
        e = gmm_compare(x, w)
        err = max(err, e)
        phase("dbrx_serve-kernel", case=json.dumps(name),
              x=json.dumps(list(x.shape)), w=json.dumps(list(w.shape)),
              dtype=str(x.dtype).split(".")[1], max_abs_err=e)
    record = None
    for shape, (args, _kw) in sorted(calls.items(),
                                     key=lambda kv: (kv[0][1], kv[0][2])):
        x, w = args
        e = gmm_compare(x, w)
        err = max(err, e)
        ms = slow_ms(lambda: gmm(x, w))
        plain_ms = slow_ms(lambda: gmm_reference(x, w))
        lib_ms = slow_ms(lambda: torch.bmm(x, w))
        ne, c, d = x.shape
        f = w.shape[2]
        nbytes = x.element_size() * (ne * c * d + ne * d * f + ne * c * f)
        nops = 2 * ne * c * d * f
        rate = BF16_FLOPS if x.dtype == torch.bfloat16 else FP32_FLOPS
        bound_ms, bound_by = bound(nbytes, nops, rate)
        phase("dbrx_serve-kernel", name="gmm", shape="served",
              x=json.dumps(list(x.shape)), w=json.dumps(list(w.shape)),
              w_strides=json.dumps(list(w.stride())),
              dtype=str(x.dtype).split(".")[1], max_abs_err=e, ms=ms,
              plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
              bound_by=bound_by, share_of_bound=bound_ms / ms,
              tflops=nops / ms / 1e9, gb=nbytes / 1e9)
        if d < f:                                  # wi / wg
            record = {"name": "gmm", "route": "cuda",
                      "source": "src/repro_torch/kernels/csrc/moe_gmm.cu",
                      "replaces": "src/repro/kernels/moe_gmm/moe_gmm.py:49",
                      "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "library_ms": lib_ms}
        del x, w, args
        torch.cuda.empty_cache()
    check(record is not None, "dbrx_serve: no gmm call recorded")
    record["max_abs_err"] = err
    return record


@contextlib.contextmanager
def prefill_drops(rt, drops):
    """Append to ``drops`` one entry per planned prefill: its bucket,
    width and host time, and the assignments its MoE layers dropped
    (``~keep``) of prompt tokens and of every token (pad rows and pad
    tails included).  The ``keep`` masks are summed once the run is
    over."""
    slots, prefill, keeps = moe_layer.capacity_slots, rt._prefill, []

    def record(flat_i, experts, cap):
        keep, dest = slots(flat_i, experts, cap)
        keeps.append(keep)
        return keep, dest

    def run(fwd, toks, ns):
        keeps.clear()
        t0 = time.perf_counter()
        out = prefill(fwd, toks, ns)        # ends in a copy to the host
        drops.append((toks.shape, ns.copy(), list(keeps),
                      (time.perf_counter() - t0) * 1e3))
        return out

    moe_layer.capacity_slots, rt._prefill = record, run
    try:
        yield
    finally:
        moe_layer.capacity_slots = slots
        del rt._prefill
        for i, (shape, ns, ks, ms) in enumerate(drops):
            real = (torch.arange(shape[1])[None, :]
                    < torch.from_numpy(ns)[:, None]).to(ks[0].device)
            per = [(~k.reshape(shape[0], shape[1], -1)) for k in ks]
            drops[i] = {"bucket": shape[1], "width": shape[0],
                        "prefill_ms": round(ms, 2),
                        "prompt_drops": sum(int((d & real[..., None]).sum())
                                            for d in per),
                        "all_drops": sum(int(d.sum()) for d in per)}


def first_logits_agree(model32, params, syscat, dev, req) -> float:
    """The last prompt position's logits of the float32 planned
    ``prefill_kv`` forward (the runtime's first token) and ``prefill``
    forward (``serve_sequential``'s) on one request, within LOGIT_TOL;
    returns the max abs error."""
    bucket = bucket_len(req.prompt_len, hi=DBRX["max_seq"])
    toks = torch.zeros((1, bucket), dtype=torch.long, device=dev)
    toks[0, :req.prompt_len] = torch.tensor(req.prompt)
    last = []
    for mode in ("prefill_kv", "prefill"):
        fwd = plan_and_compile(model32.build_plan(1, bucket, mode=mode),
                               CATALOG, syscat, engines=("xla", "pallas"),
                               cache=False, device=dev)
        out = fwd(params, {"tokens": toks})
        logits = out[0] if isinstance(out, tuple) else out
        last.append(logits[0, req.prompt_len - 1].float())
        del out, logits
    torch.testing.assert_close(last[0], last[1], atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    return float((last[0] - last[1]).abs().max())


def moe_impls_agree(calls) -> dict:
    """``moe_gmm`` (the kernel) against ``moe_dense`` at capacity factor
    2.0 on layer 0's float32 MoE input at the sub-trace's bucket 512: the
    same dispatch, so ``keep`` and ``dest`` equal and the outputs within
    the float32 tolerance (the kernel's FMA sums against cuBLAS's)."""
    (args, kw), = [v for k, v in calls.items() if k[1] == DSUB["moe_bucket"]]
    p, x = args
    slots = {}
    for fn in (moe_layer.moe_gmm, moe_layer.moe_dense):
        got = []
        with recording(moe_layer, "capacity_slots", got):
            y = fn(p, x, **kw)
        slots[fn.__name__] = (moe_layer.capacity_slots(*got[0]), y)
    (kg, dg), yg = slots["moe_gmm"]
    (kd, dd), yd = slots["moe_dense"]
    check(torch.equal(kg, kd) and torch.equal(dg, dd),
          "moe_gmm and moe_dense dispatch differently")
    tol = GMM_TOL[torch.float32]
    torch.testing.assert_close(yg, yd, atol=tol, rtol=tol)
    return {"moe_gmm_vs_dense_max_abs_err": float((yg - yd).abs().max()),
            "moe_gmm_vs_dense_drops": int((~kg).sum())}


def dbrx_path(args, dev, syscat) -> list:
    """Phases 23-26: dbrx-132b served at full width, 2 of its 40 layers.
    Returns its kernels' records."""
    path = "dbrx_serve"
    t_path = time.perf_counter()
    # 23. data: the model at full width from a seeded generator on the card
    cfg = get_config(DBRX["arch"]).replace(n_layers=DBRX["n_layers"])
    model = build_model(cfg)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = model.init_params(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = [t for _k, t in _leaves(params)]
    n_params = sum(int(t.numel()) for t in leaves)
    phase("data", path=path, arch=cfg.name, family=cfg.family,
          layers=cfg.n_layers, cut=json.dumps(DBRX["cut"]),
          d_model=cfg.d_model, heads=cfg.heads, kv_heads=cfg.kv_heads,
          head_dim=cfg.resolved_head_dim, experts=cfg.experts,
          top_k=cfg.top_k, d_ff=cfg.d_ff, vocab=cfg.vocab, dtype=cfg.dtype,
          param_dtype=cfg.param_dtype, params=n_params,
          config_param_count=cfg.param_count(),   # without the norm scales
          param_gb=round(sum(stored_bytes(t) for t in leaves) / 1e9, 3),
          seconds=round(init_s, 3),
          init_peak_gb=round(torch.cuda.max_memory_allocated() / 1e9, 3))
    del leaves

    # 24. serve: the runtime through its entry points, the kernels'
    # arguments and each prefill's drops recorded
    t0 = time.perf_counter()
    reqs = serve_trace(cfg, DBRX["prompt_lens"], DBRX["requests"],
                       DBRX["gen"])
    rt = serve_runtime(model, params, syscat, dev,
                       max_batch=DBRX["max_batch"], max_seq=DBRX["max_seq"])
    check(rt.kv_mode, "dbrx: the runtime is not in prefill_kv mode")
    phase("data", path=path, after="inference_params",
          mem_gb=round(torch.cuda.memory_allocated() / 1e9, 3),
          peak_gb=round(torch.cuda.max_memory_allocated() / 1e9, 3))
    rt.warmup([r.prompt_len for r in reqs])
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    for bucket, fwd in sorted(rt._prefill_fns.items()):
        outer, inner = bucket_impls(fwd)
        check(inner["moe_gmm_pallas"] == 1
              and inner["attn_flash_pallas"] == 1
              and not {"moe_dropping", "moe_dense_onehot", "sdpa_xla"}
              & set(inner), f"bucket {bucket}: impls {dict(inner)}")
        phase("serve", path=path, bucket=bucket, plan_id=fwd.plan_id[:12],
              impls=json.dumps(dict(outer)),
              layer_impls=json.dumps(dict(inner)))
    s0 = rt.pc.stats()
    fwd0 = rt.registry.count("lm.prefill_forwards", 0)
    secs = {"prefill": 0.0, "decode": 0.0}
    rt._try_join = timed(rt._try_join, secs, "prefill")
    rt._decode_tick = timed(rt._decode_tick, secs, "decode")
    calls, flash_calls, drops = {}, {}, []
    torch.cuda.reset_peak_memory_stats()
    with recording_shapes(moe_layer, "grouped_matmul", calls), \
            recording_shapes(attention_layer, "flash_attention",
                             flash_calls), prefill_drops(rt, drops):
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = rt.serve(reqs, timeout_s=900)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counted = kernels.launches()
    forwards = rt.registry.count("lm.prefill_forwards", 0) - fwd0
    s1 = rt.pc.stats()
    hits, misses = s1["hits"] - s0["hits"], s1["misses"] - s0["misses"]
    check([r.status for r in res] == ["ok"] * len(reqs),
          f"dbrx serve statuses {[r.status for r in res]}")
    check(all(len(r.tokens) == DBRX["gen"] for r in res),
          "dbrx: a request generated the wrong number of tokens")
    tokens = sum(len(r.tokens) for r in res)
    occ = rt.pool.occupancy()
    phase("serve", path=path, requests=len(reqs), wall_s=round(wall, 4),
          warmup_s=round(warmup_s, 3), prefill_forwards=forwards,
          launches=json.dumps({k: v for k, v in counted.items() if v}),
          tokens=tokens, total_tok_s=tokens / wall,
          decode_tok_s=sum(len(r.tokens) - 1 for r in res) / secs["decode"],
          prefill_s=round(secs["prefill"], 4),
          decode_s=round(secs["decode"], 4), ticks=rt.metrics.ticks,
          ttft_ms=json.dumps([round(r.metrics.ttft_s * 1e3, 2)
                              for r in res]),
          prefill_ms=json.dumps([round(r.metrics.prefill_ms, 2)
                                 for r in res]),
          tpot_ms=json.dumps([round(r.metrics.tpot_s * 1e3, 3)
                              for r in res]),
          plan_hits_after_warmup=hits, plan_misses_after_warmup=misses,
          pool_after=json.dumps(occ),
          peak_mem_gb=round(torch.cuda.max_memory_allocated() / 1e9, 3),
          seconds=round(time.perf_counter() - t_path, 1))
    phase("serve", path=path, prefills=json.dumps(drops))
    # each prefill forward: 3 gmm launches in each MoE layer, one flash in
    # each layer
    moe_layers = cfg.n_layers // cfg.moe_every
    expected = launch_counts(gmm=3 * moe_layers * forwards,
                             flash_attention=cfg.n_layers * forwards)
    check(counted == expected, f"dbrx launches {counted} != {expected}")
    check(misses == 0 and hits >= len(reqs),
          f"plan cache after warmup: {hits} hits, {misses} misses")
    check(occ["slots_used"] == 0 and occ["pages_used"] == 0,
          f"pool not drained: {occ}")
    if args.profile:
        # the same runtime serves the trace again (its requests are reset)
        profile_call(lambda: rt.serve(reqs, timeout_s=900), path)
    del rt, res
    free_memory()

    # 25. kernel: against its plain version on the recorded arguments and
    # at edge cases; flash on dbrx's (GQA 6, head_dim 128)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    records = [check_gmm(dev, gen, calls)]
    del calls
    torch.cuda.empty_cache()
    records.append(check_flash_calls(flash_calls, path))
    for rec in records:
        rec["launches"] = counted[rec["name"]]
        rec["path"] = path
    del flash_calls
    torch.cuda.empty_cache()
    phase(f"{path}-kernel", seconds=round(time.perf_counter() - t0, 1))

    # 26. check: a float32 sub-trace through the runtime against
    # serve_sequential where its prefills dropped no prompt token;
    # moe_gmm against moe_dense on layer 0's recorded input
    t0 = time.perf_counter()
    model32 = build_model(cfg.replace(dtype="float32"))
    sub = serve_trace(cfg, DSUB["prompt_lens"], len(DSUB["prompt_lens"]),
                      DSUB["gen"])
    rt32 = serve_runtime(model32, params, syscat, dev,
                         max_batch=DBRX["max_batch"],
                         max_seq=DBRX["max_seq"])
    rt32.warmup([r.prompt_len for r in sub])
    moe_calls, sub_drops = {}, []
    with recording_shapes(moe_layer, "moe_gmm", moe_calls, arg=1), \
            prefill_drops(rt32, sub_drops):
        res32 = rt32.serve(sub, timeout_s=900)
    del rt32
    free_memory()
    seq = serve_sequential(model32, params, sub, max_seq=DBRX["max_seq"],
                           engines=("xla", "pallas"), syscat=syscat,
                           plan_cache=PlanCache(), device=dev)
    check([r.status for r in res32] == ["ok"] * len(sub),
          "dbrx float32 serve failed")
    check(len(sub_drops) == len(sub), f"{len(sub_drops)} prefills for "
                                      f"{len(sub)} requests")
    # each request prefills alone, in its own bucket
    compared = {}
    for req, r, q in zip(sub, res32, seq):
        (d,) = [d for d in sub_drops if d["bucket"] == r.metrics.bucket]
        if d["prompt_drops"] == 0:
            check(r.tokens == q.tokens, f"request {r.rid}: float32 runtime "
                  f"and serve_sequential differ with no prompt drops")
            compared[r.rid] = "tokens"
        else:
            err = first_logits_agree(model32, params, syscat, dev, req)
            check(r.tokens[0] == q.tokens[0], f"request {r.rid}: first "
                  f"tokens differ")
            compared[r.rid] = f"first-token logits ({err})"
    f32_s = time.perf_counter() - t0
    agree = moe_impls_agree(moe_calls)
    del moe_calls
    torch.cuda.empty_cache()
    graph_ms = check_decode_graph(model, params, dev, DBRX["max_batch"])
    torch.cuda.empty_cache()
    phase("check", path=path, launches_equal_layers_x_forwards=True,
          decode_graph_bitwise_eager=True, **graph_ms,
          plan_hit_rate_after_warmup=hits / (hits + misses),
          f32_sub_drops=json.dumps(sub_drops),
          f32_runtime_vs_sequential=json.dumps(compared),
          f32_s=round(f32_s, 3), **agree,
          cpu_check="left out: 31 GB of float32 parameters on the host",
          seconds=round(time.perf_counter() - t0, 1))
    del params, model, model32
    torch.cuda.empty_cache()
    return records


# -- phases 28-32: many analysts at once and the resilience layer ---------


def node_launches(fn, inputs) -> dict:
    """Each concrete node's kernel launches in one run of ``fn`` (the plan
    run one node at a time through ``run_plan_subset``)."""
    ctx = ExecContext(root={}, scope={}, device=fn.device)
    env, out = dict(inputs), {}
    for n in fn.concrete.topo():
        kernels.reset_launches()
        env = run_plan_subset(fn.concrete, ctx, env, [n.id])
        out[n.id] = Counter(kernels.launches())
    torch.cuda.synchronize()
    return out


@contextlib.contextmanager
def residuals(log):
    """Append ``(plan, node ids)`` of every residual the subplan cache's CSE
    pass runs (``mqo.run_plan_subset``) to ``log``."""
    wrapped = mqo.run_plan_subset

    def record(pplan, ctx, values, node_ids):
        log.append((pplan, list(node_ids)))
        return wrapped(pplan, ctx, values, node_ids)

    mqo.run_plan_subset = record
    try:
        yield
    finally:
        mqo.run_plan_subset = wrapped


def mq_runtime(model, params, syscat, dev, **kw):
    """The analytical queries' runtime: the benchmark's (2 decode slots,
    max_seq 32) over qwen3 SMOKE, whose language-model half stays idle."""
    return AsyncServingRuntime(model, params, max_batch=2, max_seq=32,
                               syscat=syscat, device=dev, **kw)


def check_batched_agg(dev, calls) -> dict:
    """The group-by's batching rule on the card: the 8 light queries'
    ``masked_segment_agg`` arguments (recorded in their isolated runs)
    stacked and run under ``torch.func.vmap`` — one launch a row — against
    a loop of unbatched kernel calls and against the plain version."""
    n_groups = calls[0][3]
    v, k, w = (torch.stack([c[i] for c in calls]) for i in range(3))
    kernels.reset_launches()
    s, c = torch.func.vmap(
        lambda a, b, m: masked_segment_agg(a, b, m, n_groups))(v, k, w)
    torch.cuda.synchronize()
    launched = kernels.launches()["masked_segment_agg"]
    check(launched == len(calls),
          f"batched masked_segment_agg: {launched} launches for "
          f"{len(calls)} rows")
    bitwise, err = True, 0.0
    for i, (a, b, m, g) in enumerate(calls):
        ls, lc = masked_segment_agg(a, b, m, g)
        ps, pc = masked_segment_agg_plain(a, b, m, g)
        torch.testing.assert_close(s[i], ps, rtol=RTOL, atol=ATOL)
        check(torch.equal(c[i], pc) and torch.equal(c[i], lc),
              "batched masked_segment_agg: counts differ")
        bitwise &= bool(torch.equal(s[i], ls))
        err = max(err, float((s[i] - ps).abs().max()))
    return {"rows": len(calls), "R": int(v.shape[1]), "G": n_groups,
            "launches": launched, "bitwise_loop": bitwise,
            "max_abs_err_plain": err}


def multi_query_path(args, dev, syscat) -> list:
    """Phases 28-32: the multi-query workload and the resilience layer.
    Returns its kernels' records."""
    # 28. data: hashtag_pulse's stores, the 11 query vectors of the
    # benchmark's 16 clients
    t0 = time.perf_counter()
    rng = np.random.RandomState(SEED)
    table, graph, corpus = build_social_data(rng, **FULL)
    qs_np = mq.query_vectors(rng, corpus, 11)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    stores = inputs_for(table, graph, corpus, qs_np[0], dev)
    qs = [torch.from_numpy(q).to(dev) for q in qs_np]
    torch.cuda.synchronize()
    heavy_in = {k: stores[k] for k in ("tweets", "g", "cx")}
    light_in = {k: stores[k] for k in ("tweets", "cx")}
    phase("data", path="multi_query", tweets=table.rows,
          hashtags=graph.n_nodes, edges=graph.n_edges, docs=corpus.n_docs,
          postings=corpus.n_postings, queries=len(qs),
          build_s=round(t_build, 3),
          h2d_s=round(time.perf_counter() - t0, 3))

    # 29. [mq]: 16 clients through serve_analyses
    ah = mq.heavy_analysis(table, graph, corpus, iters=MQ["iters"])
    al = mq.light_analysis(table, corpus, graph.n_nodes)
    fh = repro_torch.compile(ah, syscat, device=dev)
    fl = repro_torch.compile(al, syscat, device=dev)
    impls_h, impls_l = Counter(fh.chosen_impls()), Counter(fl.chosen_impls())
    check(impls_h == EXPECTED_IMPLS, f"heavy impls {dict(impls_h)}")
    check(impls_l == MQ_LIGHT_IMPLS, f"light impls {dict(impls_l)}")
    wl = mq.workload((ah, fh), (al, fl), heavy_in, light_in, qs)
    per_node = {fh.plan_id: node_launches(fh, wl[0][1]),
                fl.plan_id: node_launches(fl, wl[8][1])}
    plan_launches = {pid: sum(nodes.values(), Counter())
                     for pid, nodes in per_node.items()}
    # isolated references: each query alone through __call__ (also warms
    # the unbatched path), its launches those of its plan; the kernels'
    # arguments of one heavy and the 8 light runs recorded
    sc_calls, agg_heavy, agg_light, refs = [], [], [], []
    for i, (fn, inp, _bp, _sv) in enumerate(wl):
        sc, agg = ((sc_calls, agg_heavy) if i == 0
                   else ([], agg_light) if fn is fl else ([], []))
        kernels.reset_launches()
        with recording(graph_store, "scatter_add", sc), \
                recording(runtime, "masked_segment_agg", agg):
            refs.append(fn({}, inp))
        torch.cuda.synchronize()
        got = Counter(kernels.launches())
        check(+got == +plan_launches[fn.plan_id],
              f"query {i}: launches {dict(+got)} != its plan's "
              f"{dict(+plan_launches[fn.plan_id])}")
    model = build_model(get_smoke_config(SERVE["arch"]).replace(
        dtype="float32"))
    params = model.init_params(torch.Generator(device=dev).manual_seed(SEED))
    # the sequential baseline: run_analysis one query at a time, no
    # subplan cache
    rt_seq = mq_runtime(model, params, syscat, dev)
    check(rt_seq.subplans is None, "baseline runtime holds a subplan cache")
    seq, each = [], []
    t0 = time.perf_counter()
    for fn, inp, _, _ in wl:
        t1 = time.perf_counter()
        seq.append(rt_seq.run_analysis(fn, {}, inp))
        each.append((time.perf_counter() - t1) * 1e3)
    t_seq = time.perf_counter() - t0
    check(all(torch.equal(a, b) for a, b in zip(seq, refs)),
          "sequential run_analysis differs from __call__")

    def requests():
        return [AnalysisRequest(rid=i, planned=fn, inputs=inp, params={},
                                tenant=f"client{i % 4}", batch_param=bp,
                                store_versions=sv)
                for i, (fn, inp, bp, sv) in enumerate(wl)]

    # the budget: a warm-up pass (the batched path's first run) through a
    # cache with room for everything gives the cached intermediates' bytes
    probe = mq_runtime(model, params, syscat, dev,
                       subplan_budget=MQ["probe_budget"])
    probe.serve_analyses(requests(), timeout_s=600)
    cached = probe.subplans.stats()
    budget = MQ["budget_factor"] * cached["bytes"]
    budget = -(-budget // (1 << 20)) << 20
    del probe
    led = MemoryLedger()
    rt = mq_runtime(model, params, syscat, dev, ledger=led,
                    plan_cache=PlanCache(ledger=led), subplan_budget=budget)
    reqs, ran = requests(), []
    copies = mqo.host_copies
    kernels.reset_launches()
    t0 = time.perf_counter()
    with residuals(ran):
        res = rt.serve_analyses(reqs, timeout_s=600)
    torch.cuda.synchronize()
    t_conc = time.perf_counter() - t0
    counted = kernels.launches()
    copies = mqo.host_copies - copies
    s = rt.metrics.analytics_summary()
    sub = rt.subplans.stats()
    check([r.status for r in res] == ["ok"] * len(res),
          f"statuses {[(r.status, r.error) for r in res]}")
    got = {k: s[k] for k in mq.SMOKE_COUNTERS}
    check(got == mq.SMOKE_COUNTERS,
          f"counters {got} != the reference's {mq.SMOKE_COUNTERS}")
    check(all(r.batched for r in res[8:]) and not any(r.batched
                                                      for r in res[:8]),
          "light queries not batched")
    fallbacks = [e for e in rt.recorder.events() if e.kind == "batch_fallback"]
    check(not fallbacks, f"batch_fallback events {fallbacks}")
    for i, (r, want) in enumerate(zip(res[:8], refs[:8])):
        check(torch.equal(r.value, want),
              f"query {i} (deduped={r.deduped}, shared_hits="
              f"{r.shared_hits}) differs from its isolated run")
    batched_err, batched_bitwise = 0.0, True
    for r, want in zip(res[8:], refs[8:]):
        torch.testing.assert_close(r.value, want, rtol=RTOL, atol=ATOL)
        batched_bitwise &= bool(torch.equal(r.value, want))
        batched_err = max(batched_err, float((r.value - want).abs().max()))
    # launches: each residual's nodes, plus one light plan per batched row
    expected = Counter()
    for pplan, nids in ran:
        pid = fh.plan_id if pplan is fh.concrete else fl.plan_id
        for nid in nids:
            expected += per_node[pid][nid]
    for _ in res[8:]:
        expected += plan_launches[fl.plan_id]
    check(+Counter(counted) == +expected,
          f"launches {dict(+Counter(counted))} != the executed nodes' "
          f"{dict(+expected)}")
    check(copies == len(reqs),
          f"content_key made {copies} host copies for {len(reqs)} queries")
    check(sub["bytes"] <= budget and sub["oversize_skips"] == 0
          and sub["evictions"] == 0, f"subplan cache {sub}")
    check(led.snapshot()["by_kind"].get("subplan", 0) == sub["bytes"],
          "ledger subplan bytes differ from the cache's")
    rt.subplans.clear()
    check(led.snapshot()["by_kind"].get("subplan", 0) == 0
          and not led.leaks(), "subplan bytes or leaks after clear()")
    batched = check_batched_agg(dev, agg_light)
    phase("mq", clients=len(reqs), tenants=4, heavy_plan=fh.plan_id[:12],
          light_plan=fl.plan_id[:12], iters=MQ["iters"],
          heavy_ms=statistics.median(each[:8]),
          light_ms=statistics.median(each[8:]),
          sequential_s=round(t_seq, 4), multi_query_s=round(t_conc, 4),
          sequential_over_multi=t_seq / t_conc,
          **{k: s[k] for k in ("deduped", "batched", "shared_hits")},
          counters_equal_reference=True, batch_fallbacks=0,
          deduped_and_cached_bitwise=True,
          batched_bitwise_isolated=batched_bitwise,
          batched_max_abs_err=batched_err, residual_runs=len(ran),
          launches=json.dumps(dict(+Counter(counted))),
          launches_equal_plan=True, host_copies=copies,
          cached_entries=cached["entries"], cached_bytes=cached["bytes"],
          budget_bytes=budget, subplan_bytes=sub["bytes"],
          subplan_hits=sub["hits"], leaks_after_clear=0,
          mean_ttfr_ms=s["mean_ttfr_ms"], p95_ttfr_ms=s["p95_ttfr_ms"])
    phase("mq-batched", **batched)
    if args.profile:
        profile_call(lambda: mq_runtime(
            model, params, syscat, dev, subplan_budget=budget
        ).serve_analyses(requests(), timeout_s=600), "multi_query")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    records = [check_scatter(dev, gen, sc_calls, edges=False),
               check_segment_agg(dev, gen, agg_heavy + agg_light,
                                 edges=False)]
    for rec in records:
        rec["launches"] = counted[rec["name"]]
        rec["path"] = "multi_query"
    del rt, rt_seq, res, seq, refs, sc_calls, agg_heavy, agg_light

    # 30. [resilience]: hashtag_pulse's plan under a ResilientExecutor
    check_resilience(dev, syscat, table, graph, corpus,
                     {**heavy_in, "q": qs[0]})

    # 31. [degrade]: the heavy query at ladder level 2
    check_degrade(dev, syscat, table, graph, corpus, fh, model, params,
                  {**heavy_in, "q": qs[0]})
    del stores, heavy_in, light_in, qs, wl, model, params
    free_memory()

    # 32. [serve-faults]: qwen3-0.6b's served trace under the chaos spec
    check_serve_faults(dev, syscat)
    return records


def check_resilience(dev, syscat, table, graph, corpus, inputs):
    """[resilience]: an injected persistent fault at the group-by kernel
    opens the breaker and re-plans without the kernels; a rate-only
    injector retries the same plan to the fault-free result; a KernelError
    fails fast with the breaker closed, and any other real error at the
    kernel is retried on the same plan with the breaker closed."""
    pulse = parse_adil(adil_script(table, graph, corpus), standard_catalog())
    base = repro_torch.compile(pulse, syscat, device=dev)
    kernels.reset_launches()
    want = base({}, inputs)
    torch.cuda.synchronize()
    check(kernels.launches() == EXPECTED_LAUNCHES, "base plan launches")

    def rex(**kw):
        return ResilientExecutor(
            pulse.catalog, syscat, engines=store_engines(pallas=True),
            sleep=lambda s: None,
            plan_kwargs={"store_versions": pulse.store_versions(),
                         "device": dev}, **kw)

    # 1. a persistently broken kernel site opens the breaker
    rec = FlightRecorder()
    r1 = rex(policy=RetryPolicy(max_attempts=3, base_backoff_s=0.0,
                                jitter=0.0),
             breaker=CircuitBreaker(threshold=1), recorder=rec,
             faults=FaultInjector(seed=0,
                                  always_fail=("rel_fused_agg_pallas",)))
    out, fn = r1.run(pulse.plan, {}, inputs)
    base_id = r1.attempts_log[0][2]
    check(base_id == base.plan_id, "executor's base plan is not compile's")
    check(fn.plan_id != base_id, "breaker re-plan kept the plan id")
    check(not [i for i in fn.chosen_impls() if i.endswith("_pallas")],
          f"degraded plan keeps kernels {fn.chosen_impls()}")
    check(r1.breaker.blocklist(base_id) == ("pallas",), "breaker not open")
    check(any(r == "breaker_open" for r, _ in rec.trips), "no breaker_open")
    kernels.reset_launches()
    again = fn({}, inputs)
    torch.cuda.synchronize()
    check(not any(kernels.launches().values()),
          f"degraded plan launched {kernels.launches()}")
    err = float((out - want).abs().max())
    torch.testing.assert_close(out, want, rtol=RTOL, atol=ATOL)
    # 2. rate-only faults: retries of the same plan, run after run
    faults = FaultInjector.from_spec(CHAOS)
    r2 = rex(policy=RetryPolicy(max_attempts=8, base_backoff_s=0.0),
             breaker=CircuitBreaker(threshold=1 << 20), faults=faults)
    for _ in range(RESILIENCE_RUNS):
        out2, fn2 = r2.run(pulse.plan, {}, inputs)
        check(fn2.plan_id == base_id, "rate-only retry re-planned")
        check(torch.equal(out2, want),
              "retried result differs from the fault-free run's")
    fails = sum(1 for a in r2.attempts_log if a[0] == "fail")
    # 3. a kernel error fails fast: one attempt, the breaker closed
    rec3 = FlightRecorder()
    r3 = rex(policy=RetryPolicy(max_attempts=5, base_backoff_s=0.0),
             breaker=CircuitBreaker(threshold=1), recorder=rec3)
    wrapped = runtime.masked_segment_agg

    def broken(*a, **k):
        raise build.KernelError("masked_segment_agg: injected launch error")

    runtime.masked_segment_agg = broken
    try:
        r3.run(pulse.plan, {}, inputs)
    except ExecError as exc:
        fast = (not exc.retryable and isinstance(exc.cause, build.KernelError)
                and len(r3.attempts_log) == 1 and not r3.breaker.events
                and not any(r == "breaker_open" for r, _ in rec3.trips))
    else:
        fast = False
    finally:
        runtime.masked_segment_agg = wrapped
    check(fast, f"KernelError did not fail fast: {r3.attempts_log}")
    # 4. any other real error at the kernel (not injected) is retried on
    # the same plan and never opens the breaker
    rec4 = FlightRecorder()
    r4 = rex(policy=RetryPolicy(max_attempts=3, base_backoff_s=0.0),
             breaker=CircuitBreaker(threshold=1), recorder=rec4,
             faults=FaultInjector(seed=0, rate=0.0))

    def failing(*a, **k):
        raise RuntimeError("masked_segment_agg: a real, not injected, error")

    runtime.masked_segment_agg = failing
    try:
        r4.run(pulse.plan, {}, inputs)
    except ExecError as exc:
        kept = (exc.retryable and len(r4.attempts_log) == 3
                and {a[2] for a in r4.attempts_log} == {base_id}
                and not r4.breaker.events
                and not any(r == "breaker_open" for r, _ in rec4.trips))
    else:
        kept = False
    finally:
        runtime.masked_segment_agg = wrapped
    check(kept, f"a real kernel-site error re-planned: {r4.attempts_log}")
    phase("resilience", plan=base_id[:12], degraded_plan=fn.plan_id[:12],
          degraded_impls=json.dumps(dict(Counter(fn.chosen_impls()))),
          degraded_launches=0, base_launches=json.dumps(
              {k: v for k, v in EXPECTED_LAUNCHES.items() if v}),
          degraded_max_abs_err=err,
          degraded_bitwise=bool(torch.equal(again, want)),
          breaker_open_trips=sum(r == "breaker_open" for r, _ in rec.trips),
          chaos=json.dumps(CHAOS), chaos_runs=RESILIENCE_RUNS,
          chaos_faults=faults.n_errors(), chaos_failed_attempts=fails,
          chaos_bitwise=True, kernel_error_attempts=len(r3.attempts_log),
          kernel_error_breaker_closed=True,
          real_error_attempts=len(r4.attempts_log),
          real_error_plans=len({a[2] for a in r4.attempts_log}),
          real_error_breaker_closed=True)


def check_degrade(dev, syscat, table, graph, corpus, fh, model, params,
                  inputs):
    """[degrade]: run_analysis(heavy, degrade=2) clamps k to 8 and iters to
    3; the degraded plan picks the impls of a direct compile of the clamped
    program and gives its outputs bitwise; scatter_add launches fall with
    iters."""
    pol = DegradePolicy(mq.CAT)
    rt = mq_runtime(model, params, syscat, dev, degrade=pol)
    pol.registry, pol.recorder = rt.registry, rt.recorder
    kernels.reset_launches()
    rt.run_analysis(fh, {}, inputs, degrade=False)
    full = kernels.launches()
    kernels.reset_launches()
    out = rt.run_analysis(fh, {}, inputs, degrade=DEGRADE_LEVEL)
    deg = kernels.launches()
    # warm wall times of each (median of RUNS, each ending in a sync)
    walls = {}
    for key, lvl in (("full_ms", False), ("degraded_ms", DEGRADE_LEVEL)):
        ts = []
        for _ in range(RUNS):
            t0 = time.perf_counter()
            rt.run_analysis(fh, {}, inputs, degrade=lvl)
            ts.append((time.perf_counter() - t0) * 1e3)
        walls[key] = statistics.median(ts)
    event = pol.events[-1]
    clamps = {(c["attr"], c["from"], c["to"]) for c in event["clamps"]}
    check(clamps == {("k", 64, 8), ("iters", MQ["iters"], 3)},
          f"clamps {clamps}")
    direct = repro_torch.compile(mq.heavy_analysis(
        table, graph, corpus, iters=3, k=8), syscat, device=dev)
    deg_fn = pol.replan(fh, DEGRADE_LEVEL, cache=rt.pc)
    check(deg_fn.plan_id == event["degraded_plan_id"] != fh.plan_id,
          "degraded plan id")
    check(Counter(deg_fn.chosen_impls()) == Counter(direct.chosen_impls()),
          "degraded impls differ from the clamped program's")
    check(torch.equal(out, direct({}, inputs)),
          "degraded output differs from the clamped program's")
    check(full["scatter_add"] == 2 + MQ["iters"] and deg["scatter_add"] == 5,
          f"scatter_add launches {full['scatter_add']} -> "
          f"{deg['scatter_add']}")
    phase("degrade", level=DEGRADE_LEVEL, plan=fh.plan_id[:12],
          degraded_plan=deg_fn.plan_id[:12],
          direct_compile_plan=direct.plan_id[:12],
          clamps=json.dumps(sorted(clamps)), impls_equal_direct=True,
          output_bitwise_direct=True,
          scatter_add_launches=f"{full['scatter_add']}->{deg['scatter_add']}",
          **walls)


def check_serve_faults(dev, syscat):
    """[serve-faults]: qwen3-0.6b's served trace under the chaos spec, twice
    (one schedule), against a fault-free run at prefill_batch 1; then a
    deadline at submit and one at a token boundary."""
    cfg = get_config(SERVE["arch"])
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(SEED))
    reqs = serve_trace(cfg, SERVE["prompt_lens"], SERVE["requests"],
                       SERVE["gen"])
    lens = [r.prompt_len for r in reqs]

    def runtime_(**kw):
        led = MemoryLedger()
        return AsyncServingRuntime(
            model, params, engines=("xla", "pallas"),
            max_batch=SERVE["max_batch"], max_seq=SERVE["max_seq"],
            page_size=SERVE["page_size"], plan_cache=PlanCache(ledger=led),
            ledger=led, syscat=syscat, device=dev, **kw)

    clean_rt = runtime_(prefill_batch=1)
    clean_rt.warmup(lens)
    clean = clean_rt.serve(reqs, timeout_s=600)
    check([r.status for r in clean] == ["ok"] * len(reqs),
          "fault-free serve failed")
    schedules, walls, statuses, touched = [], [], [], set()
    for _ in range(2):
        faults = FaultInjector.from_spec(CHAOS)
        rt = runtime_(faults=faults)
        check(rt.prefill_batch == 1, "faults did not force prefill_batch 1")
        rt.warmup(lens)
        fwd0 = rt.registry.count("lm.prefill_forwards", 0)
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = rt.serve(reqs, timeout_s=600)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        forwards = rt.registry.count("lm.prefill_forwards", 0) - fwd0
        check(kernels.launches() == launch_counts(
            flash_attention=cfg.n_layers * forwards), "flash launches")
        for r, c in zip(res, clean):
            check(r.status in ("ok", "truncated", "error",
                               "deadline_exceeded", "timeout", "rejected"),
                  f"request {r.rid}: status {r.status}")
            check(r.status == "ok" and r.tokens == c.tokens
                  or r.status != "ok" and r.error is not None,
                  f"request {r.rid} ({r.status}) differs from the "
                  f"fault-free run")
        occ = rt.pool.occupancy()
        check(occ["slots_used"] == 0 and occ["pages_used"] == 0
              and not rt.ledger.leaks(), f"pool or ledger after chaos {occ}")
        schedules.append(faults.schedule())
        statuses.append([r.status for r in res])
        touched |= {s[1][1] for s in faults.schedule() if s[1][0] == "prefill"}
    check(schedules[0] == schedules[1] and statuses[0] == statuses[1],
          "two runs under one seed gave two schedules")
    # deadlines: one expired at submit, one at a token boundary
    late = ServeRequest("late", reqs[0].prompt, 4, deadline_s=0.0)
    r_late = clean_rt.serve([late], timeout_s=600)[0]
    check(r_late.status == "deadline_exceeded"
          and r_late.error["phase"] == "submit", f"late: {r_late.status}")
    # the token-boundary cut, through serve(): a budget of request 0's
    # prefill plus 2.5 of the fault-free run's shortest decode steps, on a
    # fresh runtime (it has observed no latency, so the door does not shed
    # the request as unmeetable)
    step_s = min(r.metrics.tpot_s for r in clean)
    budget_s = clean[0].metrics.prefill_ms / 1e3 + 2.5 * step_s
    cut_rt = runtime_(prefill_batch=1)
    cut_rt.warmup([reqs[0].prompt_len])
    cut = ServeRequest("cut", reqs[0].prompt, SERVE["gen"],
                       deadline_s=budget_s)
    r_cut = cut_rt.serve([cut], timeout_s=600)[0]
    partial = r_cut.tokens
    occ = cut_rt.pool.occupancy()
    check(r_cut.status == "deadline_exceeded"
          and r_cut.error["phase"] == "decode"
          and 1 <= len(partial) < SERVE["gen"]
          and partial == clean[0].tokens[:len(partial)]
          and occ["slots_used"] == 0 and occ["pages_used"] == 0
          and not cut_rt.ledger.leaks(),
          f"token-boundary cut: {r_cut} budget {budget_s} s")
    kinds = Counter(k for k, _s, _o in schedules[0])
    phase("serve-faults", arch=cfg.name, requests=len(reqs),
          chaos=json.dumps(CHAOS), injected=json.dumps(dict(kinds)),
          statuses=json.dumps(dict(Counter(statuses[0]))),
          touched=json.dumps(sorted(touched)), same_schedule_twice=True,
          ok_equal_fault_free=True, pool_empty=True, leaks=0,
          walls_s=json.dumps([round(w, 4) for w in walls]),
          deadline_submit=r_late.status, deadline_cut_budget_s=budget_s,
          deadline_cut_step_s=step_s, deadline_cut_tokens=len(partial),
          deadline_cut_phase=r_cut.error["phase"],
          deadline_cut_equal_fault_free=True)
    del clean_rt, rt, cut_rt


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one run of each path (torch.profiler)")
    ap.add_argument("--paths", default=None,
                    help="comma-separated paths to run (default: every "
                         "path), e.g. tri_influence")
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
    sass = sass_counts(sorted({op for ops in SASS_REQUIRED.values()
                               for op in ops} | set(SASS_COUNTED)))
    phase("build", sass=json.dumps(sass))
    for lib, ops in SASS_REQUIRED.items():
        for op in ops:
            check(sass[lib][op] > 0,
                  f"{lib}: no {op} instruction in its SASS")
    for lib in SASS_REQUIRED:
        spills = [ln.strip() for ln in built["logs"][lib].splitlines()
                  if "spill" in ln and not ln.strip().startswith(
                      "0 bytes stack frame, 0 bytes spill stores, "
                      "0 bytes spill loads")]
        check(not spills, f"{lib}: ptxas reports spills {spills}")

    syscat = SystemCatalog(hardware=hardware_for_device(name))
    records = []
    paths = [("hashtag_pulse", pulse_path),
             ("tri_selective_0.01", window_path),
             ("tri_influence", influence_path), ("qwen3_serve", serve_path)]
    paths += [(spec["path"], lambda a, d, s, arch=arch: recurrent_path(
        a, d, s, arch)) for arch, spec in RECURRENT.items()]
    paths.append(("dbrx_serve", dbrx_path))
    paths.append(("multi_query", multi_query_path))
    if args.paths:
        wanted = args.paths.split(",")
        unknown = set(wanted) - {p for p, _ in paths}
        check(not unknown, f"unknown paths {sorted(unknown)}")
        paths = [(p, run) for p, run in paths if p in wanted]
    for path, run in paths:
        t0 = time.perf_counter()
        records += run(args, dev, syscat)
        free_memory()
        phase("time", path=path, seconds=round(time.perf_counter() - t0, 1))

    # 33. results
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "path")
    # device_ms / library_device_ms: the tri-store kernels' and the
    # recurrences' times without host dispatch, null where not measured
    extra = ("device_ms", "library_device_ms")
    print(json.dumps({"kernels": [{**{k: r[k] for k in keys},
                                   **{k: r.get(k) for k in extra}}
                                  for r in records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
