"""Async serving runtime: continuous batching over the plan cache.

The port of the language-model part of the reference's
``serving/runtime.py``.  One :class:`AsyncServingRuntime` owns

  * a **bucketed planned prefill** per power-of-two prompt bucket, fetched
    through the content-hashed plan cache (warm buckets never re-plan);
  * a fixed-width **batched decode step** (``decode_step_batched`` at
    ``max_batch``) whose slots requests join and leave at token boundaries;
  * a :class:`~repro_torch.serving.kv_pool.PagedKVPool` seeded **directly
    from the planned prefill's per-layer K/V outputs** (``mode=
    "prefill_kv"``) — no decode replay of the prompt — where the whole
    decode state is attention K/V (``kv_mode``);
  * the **replay fallback** for the recurrent families (rwkv, hybrid),
    whose rwkv / mamba state no planned forward exposes: a planned
    ``mode="prefill"`` forward gives the first token, then the prompt is
    replayed through a batch-1 decode step over one reused batch-1 cache
    (zeroed in place per request) and that cache is written into the
    request's slot (``PagedKVPool.adopt``);
  * an asyncio event loop that interleaves admission, planned prefill of
    incoming requests and decode of in-flight ones at token boundaries.

A model whose forward takes ``frontend_embeds`` (the vlm and encdec
families) is refused when the runtime (or ``serve_sequential``) is built
(:func:`check_servable`): a request carries tokens only.  The reference
builds such a runtime and fails at its first prefill with ``KeyError:
'frontend_embeds'``.

In ``kv_mode``, same-bucket waiting requests prefill together: the
bucket's batch-1 plan runs on a ``(w, bucket)`` token batch (every impl is
batch-polymorphic), which is what the reference's ``vmap`` of the planned
forward computes.
The runtime holds the parameters with their projection matrices cast to
the activation dtype once (``LM.inference_params``), where the reference
casts them per call: the same numbers.

The engines default to ``("xla", "pallas")``: the planner's kernel slot,
which puts the flash-attention, WKV6 and SSD kernels in the prefills it
prices cheaper (the reference defaults to ``("xla",)``).  The runtime runs
on the card unless ``device="cpu"`` is passed, and raises without one.  No
``try`` wraps a prefill or a decode tick: a kernel or launch error surfaces
to the caller.

Resource accounting and incident capture are the reference's: a
:class:`~repro_torch.core.ledger.MemoryLedger` (the plan cache's, by
default the process-wide one) holds the KV pool's one allocation and ties
each bucket's kept prefill plan to its plan-cache entry, so a plan the
runtime still holds after the cache evicted it shows in ``leaks()``; a
:class:`~repro_torch.core.ledger.FlightRecorder` keeps telemetry snapshots
(every ``snapshot_every`` ticks) and trips a dump on an admission
rejection (``admission_reject``), a loop timeout (``serve_timeout``), a
missed deadline (``deadline_miss``), a failed prefill or decode
(``prefill_error``, ``decode_error``) and an analytical executor error
(``executor_error``).

Fault tolerance is the reference's: a request may carry ``deadline_s``
(queued requests drop, active ones leave at a token boundary and return
their pages); an optional :class:`~repro_torch.core.faults.FaultInjector`
fires at the admission, prefill and decode seams — a failed prefill is
re-enqueued up to ``prefill_retries`` times, a faulted decode tick is
retried whole (the check comes before the CUDA-graph replay and before any
write to the pool or to a position), up to ``decode_fault_cap``
consecutive faults — and injection forces ``prefill_batch`` to 1, as in
the reference.  A kernel error (``KernelError``, a sticky CUDA error) is
never absorbed: the prefill's pages are returned and the error raised.

Analytical (tri-store) queries share the runtime: :meth:`run_analysis`
runs one planned function (traced with ``analyze=True``, through the
cross-query subplan cache of ``core/mqo.py`` when the runtime holds one,
degraded by a :class:`~repro_torch.serving.degrade.DegradePolicy` under
overload); :meth:`serve_analyses` admits many per tenant (weighted round
robin), single-flights exact twins, runs queries equal up to their
``batch_param`` input as ONE planned forward under ``torch.func.vmap``,
and sends the rest through the subplan cache.
"""
from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from ..core import tracing
from ..core.executor import default_syscat, plan_and_compile, resolve_device
from ..core.faults import FaultInjectedError
from ..core.ir import SystemCatalog
from ..core.ledger import FlightRecorder, MemoryLedger, default_ledger
from ..core.mqo import SubplanCache, mqo_run, subdag_keys
from ..core.plan_cache import (PlanCache, default_plan_cache,
                               load_plan_cache, save_plan_cache)
from ..core.resilience import classify, is_kernel_error
from ..models.decode import (DecodeGraph, decode_step_batched,
                             init_cache)
from ..models.lm import CATALOG, LM
from .admission import AdmissionController, bucket_len
from .kv_pool import PagedKVPool
from .metrics import MetricsRegistry, RequestMetrics, ServingMetrics
from .scheduler import ContinuousBatchScheduler, TenantScheduler


@dataclass(frozen=True)
class ServeRequest:
    rid: object
    prompt: tuple                    # token ids
    gen: int
    arrival: float = 0.0             # seconds after run() start
    deadline_s: Optional[float] = None   # budget from arrival; None = none

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)


@dataclass
class ServeResult:
    rid: object
    tokens: list = field(default_factory=list)
    # ok | rejected | truncated | deadline_exceeded | error | timeout
    status: str = "ok"
    metrics: Optional[RequestMetrics] = None
    error: Optional[dict] = None     # structured failure detail (non-ok)

    @property
    def ok(self) -> bool:
        return self.status in ("ok", "truncated")


@dataclass
class AnalysisRequest:
    """One analytical query submitted to the multi-query admission loop.

    ``batch_param`` names an input whose value may differ across otherwise
    identical queries (a PageRank seed set, a top-k query vector): requests
    sharing a plan fingerprint modulo that slot are coalesced per admission
    tick into one vmapped planned forward.  ``store_versions`` are the
    (name, version) pairs of the bound stores — they key the sub-DAG cache
    entries so appends provably invalidate."""

    rid: object
    planned: object                  # PlannedFunction
    inputs: dict
    params: object = None
    tenant: object = "default"
    batch_param: Optional[str] = None
    store_versions: tuple = ()
    tied_to: object = None           # ledger owner of the producing store
    aux: Optional[dict] = None


@dataclass
class AnalysisResult:
    rid: object
    value: object = None
    status: str = "ok"               # ok | error
    error: Optional[dict] = None
    shared_hits: int = 0             # cached sub-DAGs reused by this query
    executed: int = 0                # residual nodes actually run
    deduped: bool = False            # rode an identical in-flight query
    batched: bool = False            # ran inside a vmapped batch
    ttfr_ms: float = 0.0             # submit -> first result

    @property
    def ok(self) -> bool:
        return self.status == "ok"


def _first_tokens(logits, ns, vocab: int):
    """Greedy token at each row's last prompt position ``ns - 1``."""
    rows = torch.arange(logits.shape[0], device=logits.device)
    return torch.argmax(logits[rows, ns - 1, :vocab], dim=-1)


def check_servable(model: LM) -> None:
    """Raise ``ValueError`` for a model whose planned forward needs a
    ``frontend_embeds`` input, which no request supplies."""
    cfg = model.cfg
    if cfg.frontend != "none":
        raise ValueError(
            f"{cfg.name} (family={cfg.family}, frontend={cfg.frontend}): "
            f"its forward needs a 'frontend_embeds' input that a serve "
            f"request does not carry; run the planned forward with "
            f"frontend_embeds (repro_torch.data.synth_batch) and the "
            f"decode step (models.decode) instead")


class AsyncServingRuntime:
    def __init__(self, model: LM, params, *, max_batch: int = 4,
                 max_seq: int = 128, page_size: int = 16,
                 page_budget: int | None = None,
                 bucket_lo: int = 8, engines=("xla", "pallas"),
                 syscat: Optional[SystemCatalog] = None,
                 plan_cache: Optional[PlanCache] = None,
                 plan_cache_dir: Optional[str] = None,
                 admission: Optional[AdmissionController] = None,
                 registry: Optional[MetricsRegistry] = None,
                 ledger: Optional[MemoryLedger] = None,
                 recorder: Optional[FlightRecorder] = None,
                 snapshot_every: int = 64,
                 faults=None,
                 degrade=None,
                 prefill_retries: int = 2,
                 decode_fault_cap: int = 8,
                 subplan_cache: Optional[SubplanCache] = None,
                 subplan_budget: Optional[int] = None,
                 tenant_weights: Optional[dict] = None,
                 analysis_tick: int = 16,
                 prefill_batch: int = 4, device=None):
        check_servable(model)
        self.device = resolve_device(device)
        self.model = model
        self.cfg = model.cfg
        self.params = model.inference_params(params)
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.bucket_lo = bucket_lo
        self.engines = tuple(engines)
        self.syscat = syscat or default_syscat(self.device)
        self.pc = plan_cache if plan_cache is not None else \
            default_plan_cache()
        self.plan_cache_dir = plan_cache_dir
        if plan_cache_dir:
            load_plan_cache(plan_cache_dir, self.pc)   # warm start
        self.kv_mode = model.supports_prefill_kv()
        self.registry = registry if registry is not None else \
            MetricsRegistry()
        # resource accounting + incident capture: the ledger tracks every
        # resident tensor tree (KV pool, plan-cache entries, store
        # payloads); the flight recorder keeps a bounded ring of telemetry
        # snapshots, dumped on rejection / timeout
        self.ledger = ledger if ledger is not None else \
            getattr(self.pc, "ledger", None) or default_ledger()
        self.recorder = recorder if recorder is not None else FlightRecorder()
        self.snapshot_every = max(int(snapshot_every), 1)
        self.pool = PagedKVPool(model, max_batch, max_seq,
                                page_size=page_size, page_budget=page_budget,
                                registry=self.registry, ledger=self.ledger,
                                device=self.device)
        self.scheduler = ContinuousBatchScheduler(max_batch)
        self.admission = admission or AdmissionController()
        self.metrics = ServingMetrics(registry=self.registry)
        self._prefill_fns: dict = {}     # bucket -> PlannedFunction
        # on the card the decode step is a CUDA graph over the pool, built
        # here, before any slot is seeded (building writes position 0)
        self._decode = (DecodeGraph(model, self.params, self.pool.cache,
                                    max_batch)
                        if self.device.type == "cuda" else None)
        # replay mode: one batch-1 cache every request's prompt replays
        # into (zeroed first), and its step, built on first use (warmup)
        self._cache1 = None if self.kv_mode else init_cache(
            model, 1, max_seq, device=self.device)
        self._replay = None
        self._results: dict = {}
        self._t0 = time.perf_counter()
        # fault tolerance: an optional FaultInjector exercises the
        # admission/prefill/decode seams; prefill faults retry by
        # re-enqueueing (bounded), decode-tick faults retry the whole tick
        # (state is untouched — the fault fires before the decode step
        # writes anything); a DegradePolicy (serving.degrade) cheapens
        # analytical plans under overload
        self.faults = faults
        self.degrade = degrade
        self.prefill_retries = int(prefill_retries)
        self.decode_fault_cap = int(decode_fault_cap)
        self._prefill_attempts: dict = {}   # rid -> failed attempts
        self._tick_no = 0
        self._decode_faults = 0             # consecutive faulted ticks
        # multi-query analytics: a byte-budgeted cache of materialized
        # sub-DAG intermediates (cross-query CSE), a weighted round-robin
        # tenant scheduler feeding the admission loop, and single-flight
        # futures so concurrent identical sub-DAGs compute once
        if subplan_cache is not None:
            self.subplans: Optional[SubplanCache] = subplan_cache
        elif subplan_budget is not None:
            self.subplans = SubplanCache(
                subplan_budget, ledger=self.ledger, recorder=self.recorder,
                registry=self.registry)
        else:
            self.subplans = None
        self.analysis_sched = TenantScheduler(tenant_weights)
        self.analysis_tick = max(int(analysis_tick), 1)
        self._analysis_inflight: dict = {}  # root key -> asyncio.Future
        # id(request) -> (results dict, t0) of the run_analyses call that
        # owns it: concurrent calls share one tenant scheduler, so a tick
        # may drain another call's request — settlement routes through the
        # owning call's sink, never the draining call's
        self._analysis_sinks: dict = {}
        # up to ``prefill_batch`` same-bucket waiting requests prefill as
        # ONE planned forward over a (w, bucket) token batch (1 disables);
        # deterministic fault replay needs per-request prefill sites, so
        # injection forces the sequential path
        self.prefill_batch = 1 if faults is not None \
            else max(int(prefill_batch), 1)

    # -- planning ----------------------------------------------------------
    def _now(self) -> float:
        return time.perf_counter() - self._t0

    def bucket_of(self, prompt_len: int) -> int:
        return bucket_len(prompt_len, lo=self.bucket_lo, hi=self.max_seq)

    def is_warm(self, bucket: int) -> bool:
        return bucket in self._prefill_fns

    def _plan_prefill(self, bucket: int):
        """Fetch (or plan, on a cold bucket) the bucket's prefill forward
        through the plan cache: ``prefill_kv`` in kv_mode, else
        ``prefill`` (logits only).  Returns (planned fn, plan ms)."""
        t0 = time.perf_counter()
        hits0 = self.pc.hits
        mode = "prefill_kv" if self.kv_mode else "prefill"
        plan = self.model.build_plan(1, bucket, mode=mode)
        fwd = plan_and_compile(plan, CATALOG, self.syscat,
                               engines=self.engines, cache=self.pc,
                               device=self.device)
        self.metrics.observe_plan(hit=self.pc.hits > hits0)
        kept = self._prefill_fns.get(bucket)
        if kept is None or kept.plan_id != fwd.plan_id:
            # tie the kept plan's lifetime to its plan-cache entry: once
            # the cache evicts the entry while the runtime still holds the
            # plan, this registration shows up in ledger.leaks()
            self.ledger.register(
                ("plan_jit", fwd.plan_id), nbytes=0, kind="plan_jit",
                tied_to=("plan_cache", fwd.plan_id))
        self._prefill_fns[bucket] = fwd
        return fwd, (time.perf_counter() - t0) * 1e3

    def _prefill(self, fwd, toks: np.ndarray, ns: np.ndarray):
        """One planned forward over the (w, bucket) token batch: returns
        (plan outputs, first tokens (w,) on the host).  Counted as one
        ``lm.prefill_forwards``."""
        outs = fwd(self.params, {"tokens": torch.from_numpy(toks).to(
            self.device)})
        logits = outs[0] if isinstance(outs, tuple) else outs
        firsts = _first_tokens(logits, torch.from_numpy(ns).to(
            self.device).long(), self.cfg.vocab)
        self.registry.count("lm.prefill_forwards")
        return outs, firsts.cpu().numpy()

    def warmup(self, prompt_lens: Sequence[int]) -> None:
        """Plan every bucket the trace will touch and run its prefill once
        (batch 1 and, in kv_mode with batched prefill, the bucket's one
        batched width), the batched decode step and, in replay mode, the
        batch-1 replay step, so serving-time work is plan-cache hits and
        execution."""
        for n in sorted({self.bucket_of(n) for n in prompt_lens}):
            fwd, _ = self._plan_prefill(n)
            if not self.kv_mode:
                self._prefill(fwd, np.zeros((1, n), np.int32),
                              np.full((1,), n, np.int32))
                continue
            widths = [1]
            if self.prefill_batch > 1:
                widths.append(min(self.prefill_batch, self.max_batch))
            for w in widths:
                outs, _ = self._prefill(fwd, np.zeros((w, n), np.int32),
                                        np.full((w,), n, np.int32))
                # writes zero-token K/V into a scratch slot; harmless — any
                # join overwrites it
                if self.pool.alloc("__warmup__", 1) is not None:
                    self.pool.seed("__warmup__",
                                   _row(outs[1:], 0), n)
                    self.pool.free("__warmup__")
        # position 0 of every slot gets token 0's K/V (and every recurrent
        # state a step); any join overwrites the slot
        self._decode_step(np.zeros((self.max_batch, 1), np.int64),
                          np.zeros((self.max_batch,), np.int64))
        if not self.kv_mode:
            # the replay step too (on the card: its CUDA graph is built);
            # every request zeroes the replay cache before its replay
            zero = torch.zeros((1,), dtype=torch.long, device=self.device)
            self._replay_step(zero[:, None], zero)

    def _replay_step(self, tokens, indices):
        """The batch-1 decode step over the replay cache: the CUDA graph on
        the card (built at the first call), the eager step on the CPU."""
        if self.device.type != "cuda":
            return decode_step_batched(self.model, self.params, self._cache1,
                                       tokens, indices)[0]
        if self._replay is None:
            self._replay = DecodeGraph(self.model, self.params, self._cache1,
                                       1)
        return self._replay(tokens, indices)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _decode_step(self, toks: np.ndarray, idxs: np.ndarray):
        """The batched decode step over the pool: the CUDA graph on the
        card, the eager step on the CPU.  Returns the logits."""
        toks = torch.from_numpy(toks).to(self.device)
        idxs = torch.from_numpy(idxs).to(self.device)
        if self._decode is not None:
            return self._decode(toks, idxs)
        return decode_step_batched(self.model, self.params, self.pool.cache,
                                   toks, idxs)[0]

    # -- telemetry ----------------------------------------------------------
    def telemetry_snapshot(self) -> dict:
        """One continuous-telemetry record: ledger totals, KV occupancy +
        fragmentation, per-bucket queue depth, plan-cache hit/byte ratios,
        decode-batch occupancy.  Published as registry gauges and recorded
        in the flight recorder ring."""
        pc_stats = self.pc.stats()
        snap = {
            "ledger": self.ledger.snapshot(),
            "kv": {**self.pool.occupancy(), **self.pool.fragmentation()},
            "queues": {b: len(q) for b, q in self.scheduler.queues.items()
                       if q},
            "queue_depth": self.scheduler.queue_depth(),
            "active_slots": self.scheduler.n_active(),
            "plan_cache": pc_stats,
            "ticks": self.metrics.ticks,
        }
        self.ledger.publish(self.registry)
        g = self.registry.gauge
        g("plan_cache.hit_rate").set(pc_stats["hit_rate"])
        g("plan_cache.bytes").set(pc_stats["bytes"])
        g("serving.queue_depth").set(snap["queue_depth"])
        g("serving.active_slots").set(snap["active_slots"])
        return snap

    def _maybe_snapshot(self, force: bool = False) -> None:
        if force or self.metrics.ticks % self.snapshot_every == 0:
            self.recorder.record("telemetry", self.telemetry_snapshot())

    # -- admission ----------------------------------------------------------
    def _reject(self, req: ServeRequest, reason: str) -> None:
        self.metrics.rejected += 1
        self._results[req.rid] = ServeResult(
            req.rid, [], "rejected", None,
            error={"reason": reason, "rid": str(req.rid)})
        self.recorder.trip("admission_reject", {
            "rid": str(req.rid), "reason": reason,
            "prompt_len": req.prompt_len, "gen": req.gen,
            "queue_depth": self.scheduler.queue_depth(),
            "active": self.scheduler.n_active()})

    def _deadline_at(self, req: ServeRequest) -> float:
        """Absolute (run-clock) expiry; +inf when no deadline is set."""
        if req.deadline_s is None:
            return float("inf")
        return req.arrival + req.deadline_s

    def _estimate_completion_s(self, req: ServeRequest) -> Optional[float]:
        """Observed-latency completion estimate for deadline admission:
        queue wait + TTFT + gen * TPOT from the lm.* summaries.  None until
        enough traffic has been observed to estimate at all."""
        s = self.metrics
        if s._ttft.count < 1 or (req.gen > 1 and s._tpot.count < 1):
            return None
        return (s._queue_wait.mean + s._ttft.mean
                + max(req.gen - 1, 0) * s._tpot.mean)

    def submit(self, req: ServeRequest) -> None:
        if self.faults is not None:
            # admission stall: the front door pauses (queue growth +
            # deadline pressure); stall sites never raise
            self.faults.check(("admission", str(req.rid)))
        if req.prompt_len < 1 or req.gen < 1:
            self._reject(req, "empty prompt or zero gen")
            return
        if req.prompt_len + req.gen > self.max_seq:
            self._reject(req, "exceeds max_seq")
            return
        try:
            bucket = self.bucket_of(req.prompt_len)
        except ValueError:
            self._reject(req, "unbucketable")
            return
        if req.deadline_s is not None:
            now = self._now()
            if now >= self._deadline_at(req):
                self._resolve_deadline(req, phase="submit")
                return
            est = self._estimate_completion_s(req)
            if est is not None and now + est > self._deadline_at(req):
                # cannot finish in time at observed latencies: shedding at
                # the door beats burning KV pages on a doomed request
                self._reject(req, "deadline_unmeetable")
                return
        action = self.admission.decide(
            warm=self.is_warm(bucket),
            queue_depth=self.scheduler.queue_depth(),
            active=self.scheduler.n_active(), max_batch=self.max_batch)
        if action == "reject":
            self._reject(req, "queue full")
            return
        # "admit" and "queue" both enqueue; a cold bucket's head is only
        # *planned* once the decode batch drains (scheduler-side gate)
        self.scheduler.enqueue(req, bucket, self._now())

    # -- deadlines -----------------------------------------------------------
    def _resolve_deadline(self, req: ServeRequest, *, phase: str,
                          tokens: Sequence[int] = (), rm=None) -> None:
        """Resolve a request whose deadline expired: structured error,
        partial tokens preserved, one deadline_miss trip per request."""
        self.metrics.registry.count("serving.deadline_miss")
        self._results[req.rid] = ServeResult(
            req.rid, list(tokens), "deadline_exceeded", rm,
            error={"reason": "deadline_exceeded", "rid": str(req.rid),
                   "phase": phase, "deadline_s": req.deadline_s,
                   "tokens_done": len(tokens)})
        self.recorder.trip("deadline_miss", {
            "rid": str(req.rid), "phase": phase,
            "deadline_s": req.deadline_s, "now": self._now(),
            "tokens_done": len(tokens)})

    def _expire_deadlines(self) -> None:
        """Deadline sweep, run once per loop iteration: queued requests are
        dropped in place; active ones leave at this token boundary, their
        KV pages going straight back to the pool (ledger-verified — the
        pool's one allocation never leaks per-request state)."""
        now = self._now()
        for w in self.scheduler.waiting():
            if now >= self._deadline_at(w.request):
                self.scheduler.remove(w)
                self._resolve_deadline(w.request, phase="queued")
        for st in list(self.scheduler.active()):
            if now >= self._deadline_at(st.request):
                self.scheduler.leave(st.slot)
                self.pool.free(st.request.rid)
                st.rm.finished_at = now
                self._resolve_deadline(st.request, phase="decode",
                                       tokens=st.out, rm=st.rm)

    # -- prefill + join ------------------------------------------------------
    def _join(self, req: ServeRequest, bucket: int, enqueued_at: float,
              kv_groups, first: int, plan_ms: float,
              prefill_ms: float) -> None:
        """Seed the request's slot (from its prefill K/V in kv_mode, by
        replaying its prompt otherwise) and join the decode batch with its
        first token."""
        rm = RequestMetrics(req.rid, bucket=bucket,
                            prompt_len=req.prompt_len, gen=req.gen,
                            submitted_at=enqueued_at)
        rm.plan_ms, rm.prefill_ms = plan_ms, prefill_ms
        # reserve prompt + the first decode write (position prompt_len is
        # written by the first tick, before extend() is consulted)
        self.pool.alloc(req.rid, req.prompt_len + 1)
        if self.kv_mode:
            self.pool.seed(req.rid, kv_groups, req.prompt_len)
        else:
            self._replay_and_adopt(req, rm)
        now = self._now()
        rm.joined_at = rm.first_token_at = now
        st = self.scheduler.join(req, pos=req.prompt_len, tok=first,
                                 first_out=first, now=now)
        st.rm = rm
        self.metrics.joins += 1
        if st.done:                          # gen == 1: prefill was enough
            self._finish(st, "ok")

    def _replay_and_adopt(self, req: ServeRequest, rm) -> None:
        """The replay fallback: zero the batch-1 cache in place, replay the
        prompt through the batch-1 decode step, write the cache into the
        request's slot.  ``rm.replay_ms`` / ``rm.adopt_ms``: host clock
        around each, ending in a device sync."""
        t0 = time.perf_counter()
        for leaf in (x for gc in self._cache1.values() for x in gc.values()):
            leaf.zero_()
        toks = torch.tensor(req.prompt, dtype=torch.long,
                            device=self.device)[None, :]
        pos = torch.zeros((1,), dtype=torch.long, device=self.device)
        for t in range(req.prompt_len):
            self._replay_step(toks[:, t:t + 1], pos.fill_(t))
        self.registry.count("lm.replay_steps", req.prompt_len)
        self._sync()
        t1 = time.perf_counter()
        self.pool.adopt(req.rid, self._cache1)
        self._sync()
        rm.replay_ms = (t1 - t0) * 1e3
        rm.adopt_ms = (time.perf_counter() - t1) * 1e3

    def _prefill_and_join(self, req: ServeRequest, bucket: int,
                          enqueued_at: float) -> None:
        if self.faults is not None:
            # before any allocation: a prefill fault leaves nothing behind
            self.faults.check(("prefill", str(req.rid), bucket))
        fwd, plan_ms = self._plan_prefill(bucket)
        t0 = time.perf_counter()
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :req.prompt_len] = req.prompt
        outs, firsts = self._prefill(fwd, toks,
                                     np.array([req.prompt_len], np.int32))
        self._join(req, bucket, enqueued_at,
                   outs[1:] if self.kv_mode else None, int(firsts[0]),
                   plan_ms, (time.perf_counter() - t0) * 1e3)

    def _pop_prefill_batch(self, w) -> list:
        """Starting from the chosen head ``w``, pop up to ``prefill_batch``
        same-bucket waiting requests that the decode batch and KV pool can
        conservatively absorb together.  Returns [(req, enqueued_at), ...]."""
        batch = [(self.scheduler.pop(w), w.enqueued_at)]
        if not self.kv_mode or self.prefill_batch <= 1:
            return batch
        q = self.scheduler.queues.get(w.bucket)
        pending_pages = self.pool.pages_for(batch[0][0].prompt_len + 1)
        while (q and len(batch) < self.prefill_batch
               and self.scheduler.n_active() + len(batch)
               < self.scheduler.max_batch
               and len(self.pool._free_slots) > len(batch)):
            nxt = q[0]
            need = self.pool.pages_for(nxt.request.prompt_len + 1)
            if self.pool.pages_in_use + pending_pages + need > \
                    self.pool.page_budget:
                break
            batch.append((self.scheduler.pop(nxt), nxt.enqueued_at))
            pending_pages += need
        return batch

    def _try_join(self) -> bool:
        """Fill free decode slots from the wait queues: FIFO within bucket,
        longest-waiting-first across buckets; cold buckets only when the
        batch has drained enough to afford planning.  Same-bucket waiting
        requests prefill as ONE planned forward."""
        joined = False
        while self.scheduler.free_slot() is not None:
            warm = {b for b in self.scheduler.queues if self.is_warm(b)}
            w = self.scheduler.peek_next(warm_buckets=warm)
            if w is None and self.admission.can_plan_cold(
                    active=self.scheduler.n_active(),
                    max_batch=self.max_batch):
                w = self.scheduler.peek_next()
            if w is None:
                break
            if not self.pool.can_admit(w.request.prompt_len + 1):
                break                        # memory pressure: keep queueing
            bucket = w.bucket
            batch = self._pop_prefill_batch(w)
            if len(batch) == 1:
                req, enq = batch[0]
                try:
                    self._prefill_and_join(req, bucket, enq)
                except Exception as exc:
                    self._prefill_failure(req, bucket, enq, exc)
            else:
                self._prefill_and_join_many(batch, bucket)
            joined = True
        return joined

    def _prefill_and_join_many(self, batch: list, bucket: int) -> None:
        """Prefill a same-bucket group as one planned forward over a
        (width, bucket) token batch and join each member."""
        # one plan fetch per member: each keeps its own plan-cache hit and
        # plan_ms accounting (warm fetches are cache lookups)
        plan_mss = []
        for _ in batch:
            fwd, plan_ms = self._plan_prefill(bucket)
            plan_mss.append(plan_ms)
        # pad to the bucket's one warmed width: a short batch wastes a few
        # pad rows but keeps one batched shape per bucket
        width = max(min(self.prefill_batch, self.max_batch), len(batch))
        toks = np.zeros((width, bucket), np.int32)
        ns = np.ones((width,), np.int32)
        for i, (req, _) in enumerate(batch):
            toks[i, :req.prompt_len] = req.prompt
            ns[i] = req.prompt_len
        t0 = time.perf_counter()
        outs, firsts = self._prefill(fwd, toks, ns)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        self.registry.count("lm.batched_prefills", len(batch))
        self.registry.summary("lm.prefill_batch").observe(len(batch))
        for i, (req, enq) in enumerate(batch):
            self._join(req, bucket, enq, _row(outs[1:], i), int(firsts[i]),
                       plan_mss[i], prefill_ms / len(batch))

    def _prefill_failure(self, req: ServeRequest, bucket: int,
                         enqueued_at: float, exc: Exception) -> None:
        """A prefill attempt died (injected or real).  Clean up any pages
        the attempt claimed, then either re-enqueue (bounded retries,
        retryable errors only) or resolve with a structured error.  A
        kernel error is raised after the clean-up: no retry mends it."""
        if self.pool.holds(req.rid):
            self.pool.free(req.rid)
        if is_kernel_error(exc):
            raise exc
        err = classify(exc, plan_id=f"prefill_bucket_{bucket}")
        attempts = self._prefill_attempts.get(req.rid, 0) + 1
        self._prefill_attempts[req.rid] = attempts
        self.metrics.registry.count("serving.prefill_faults")
        self.recorder.record("prefill_fault", {
            "rid": str(req.rid), "bucket": bucket, "attempt": attempts,
            "error": err.to_dict()})
        if err.retryable and attempts <= self.prefill_retries:
            # back of its bucket queue: the retry is a fresh occurrence of
            # the fault site, so rate-injected faults clear on replay
            self.scheduler.enqueue(req, bucket, enqueued_at)
            return
        self._prefill_attempts.pop(req.rid, None)
        self._results[req.rid] = ServeResult(
            req.rid, [], "error", None,
            error={"reason": "prefill_failed", "rid": str(req.rid),
                   "attempts": attempts, **err.to_dict()})
        self.recorder.trip("prefill_error", {
            "rid": str(req.rid), "bucket": bucket, "attempts": attempts,
            "error": err.to_dict()})

    # -- decode -------------------------------------------------------------
    def _finish(self, st, status: str, error: Optional[dict] = None) -> None:
        self.scheduler.leave(st.slot)
        self.pool.free(st.request.rid)
        self._prefill_attempts.pop(st.request.rid, None)
        st.rm.finished_at = self._now()
        self.metrics.finish(st.rm)
        self._results[st.request.rid] = ServeResult(
            st.request.rid, list(st.out), status, st.rm, error=error)

    def _decode_tick(self) -> bool:
        """One continuous-batching step: every active slot decodes one token
        at its own position; finished requests leave at this boundary."""
        active = self.scheduler.active()
        self.metrics.observe_tick(self.scheduler.queue_depth(),
                                  self.pool.occupancy()["fill"])
        self._maybe_snapshot()
        if not active:
            return False
        self._tick_no += 1
        if self.faults is not None:
            # the fault fires BEFORE the decode step (the CUDA-graph replay
            # on the card), so a faulted tick leaves the pool cache and
            # every slot position untouched — the retry is simply the next
            # loop iteration re-running the identical tick
            try:
                self.faults.check(("decode", self._tick_no))
            except FaultInjectedError as exc:
                self._decode_faults += 1
                self.metrics.registry.count("serving.decode_faults")
                self.recorder.record("decode_fault", {
                    "tick": self._tick_no, "consecutive": self._decode_faults,
                    "error": repr(exc)})
                if self._decode_faults > self.decode_fault_cap:
                    # persistently broken decode: fail the active batch
                    # with structured errors instead of spinning forever
                    detail = {"reason": "decode_failed",
                              "consecutive_faults": self._decode_faults,
                              "error": repr(exc)}
                    self.recorder.trip("decode_error", detail)
                    for st in list(self.scheduler.active()):
                        self._finish(st, "error",
                                     error={**detail,
                                            "rid": str(st.request.rid)})
                    self._decode_faults = 0
                return True
        self._decode_faults = 0
        toks = np.zeros((self.max_batch, 1), np.int64)
        idxs = np.zeros((self.max_batch,), np.int64)
        for st in active:
            toks[st.slot, 0] = st.tok
            idxs[st.slot] = st.pos
        logits = self._decode_step(toks, idxs)
        nxt = torch.argmax(logits[:, 0, :self.cfg.vocab], dim=-1).cpu()
        for st in active:
            st.tok = int(nxt[st.slot])
            st.pos += 1
            st.out.append(st.tok)
            if st.done:
                self._finish(st, "ok")
            elif not self.pool.extend(st.request.rid, st.pos + 1):
                self._finish(st, "truncated")   # page budget exhausted
        return True

    # -- event loop ----------------------------------------------------------
    async def _submit_all(self, pending) -> None:
        for r in pending:
            delay = r.arrival - self._now()
            if delay > 0:
                await asyncio.sleep(delay)
            self.submit(r)

    def _fail_outstanding(self, requests, timeout_s: float) -> None:
        """Loop timeout: resolve every request that has no result yet with
        a structured timeout error and return its resources.  One
        serve_timeout trip captures the stuck state."""
        self.recorder.trip("serve_timeout", {
            "timeout_s": timeout_s, "done": len(self._results),
            "expected": len(requests),
            "queue_depth": self.scheduler.queue_depth(),
            "active": self.scheduler.n_active(),
            "telemetry": self.telemetry_snapshot()})
        for st in list(self.scheduler.active()):
            self._finish(st, "timeout",
                         error={"reason": "timeout", "phase": "decode",
                                "rid": str(st.request.rid),
                                "timeout_s": timeout_s,
                                "tokens_done": len(st.out)})
        for w in list(self.scheduler.waiting()):
            self.scheduler.remove(w)
        for r in requests:
            if r.rid not in self._results:
                self._results[r.rid] = ServeResult(
                    r.rid, [], "timeout", None,
                    error={"reason": "timeout", "phase": "queued",
                           "rid": str(r.rid), "timeout_s": timeout_s})

    async def run(self, requests: Sequence[ServeRequest],
                  timeout_s: float = 300.0) -> list:
        """Serve a trace of requests; returns ServeResults in input order.
        A loop timeout resolves the outstanding requests (freeing their KV
        slots) instead of raising out of the loop.  The loop ends when
        every request of this call is resolved, so one runtime serves any
        number of traces in turn; a request id that an earlier call
        resolved is reset (its old result dropped, the request served
        anew), and an id given twice in one call raises ``ValueError``
        (the reference counts results instead, so its second call returns
        early)."""
        rids = [r.rid for r in requests]
        if len(set(rids)) != len(rids):
            raise ValueError("run: a request id appears twice in one call")
        for rid in rids:
            self._results.pop(rid, None)
            self._prefill_attempts.pop(rid, None)
        self._t0 = time.perf_counter()
        pending = sorted(requests, key=lambda r: r.arrival)
        submitter = asyncio.ensure_future(self._submit_all(pending))
        try:
            while any(rid not in self._results for rid in rids):
                if self._now() > timeout_s:
                    self._fail_outstanding(requests, timeout_s)
                    break
                self._expire_deadlines()
                progressed = self._try_join()
                progressed = self._decode_tick() or progressed
                # yield so arrivals interleave with serving; back off when
                # idle (waiting on future arrivals)
                await asyncio.sleep(0 if progressed else 0.0005)
        finally:
            submitter.cancel()
        if self.plan_cache_dir:
            save_plan_cache(self.pc, self.plan_cache_dir)
        return [self._results[r.rid] for r in requests]

    def serve(self, requests: Sequence[ServeRequest],
              timeout_s: float = 300.0) -> list:
        """Synchronous wrapper around :meth:`run`.  Refuses to nest inside
        a running event loop."""
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            return asyncio.run(self.run(requests, timeout_s=timeout_s))
        raise RuntimeError(
            "serve() was called from a running event loop; call "
            "`await runtime.run(requests, timeout_s=...)` instead")

    # -- analytical requests --------------------------------------------------
    def _trip_context(self) -> dict:
        """Incident context for executor_error trips: memory + occupancy
        state at failure time, not just the exception repr."""
        return {"ledger": self.ledger.snapshot(),
                "metrics": self.registry.report()}

    # -- multi-query analytics ------------------------------------------------
    def _analysis_exec(self, req: AnalysisRequest, keys=None):
        """One analytical query through the cross-query CSE path (subplan
        cache attached) or plain execution; returns (value, frontier
        info)."""
        if self.subplans is not None:
            out, info = mqo_run(req.planned, req.params, req.inputs,
                                cache=self.subplans,
                                versions=req.store_versions,
                                aux=req.aux, keys=keys, tied_to=req.tied_to)
        else:
            out = req.planned(req.params, req.inputs, aux=req.aux)
            info = {"shared_hits": 0,
                    "executed": len(req.planned.concrete.nodes)}
        self._sync()
        return out, info

    @staticmethod
    def _leaf_sig(value) -> tuple:
        """Shape/dtype signature of a value's leaves — batchable queries
        must agree on it so stacking is well-formed."""
        return tuple((str(getattr(x, "dtype", type(x).__name__)),
                      tuple(getattr(x, "shape", ())))
                     for x in tracing.tree_leaves(value))

    def _batch_group_key(self, req: AnalysisRequest, keys: dict) -> tuple:
        """Queries coalesce into one vmapped forward iff they share a plan,
        the same declared ``batch_param`` slot, the same *objects* for
        every other input, and the same batch-leaf shape/dtype.  Object
        identity is conservative (equal-but-distinct tensors miss the
        batch) but sound, and it is how multi-query workloads actually
        share bound payloads; the ids stay valid because the requests hold
        their inputs alive through the tick."""
        bp = req.batch_param
        fixed = tuple(sorted(
            (n, id(v)) for n, v in req.inputs.items() if n != bp))
        return (getattr(req.planned, "plan_id", id(req.planned)), bp,
                fixed, self._leaf_sig(req.inputs[bp]),
                "noparams" if not req.params else id(req.params))

    def _run_batched_group(self, leaders: list):
        """Execute same-shape queries as ONE planned forward under
        ``torch.func.vmap`` over their stacked ``batch_param`` values;
        returns per-query values.  Every op runs batched and eagerly, the
        same dispatch path the unbatched queries take; a kernel wrapper
        reached with a batched tensor goes through its batching rule."""
        bp = leaders[0].batch_param
        planned = leaders[0].planned
        fixed = {n: v for n, v in leaders[0].inputs.items() if n != bp}
        stacked = torch.stack([torch.as_tensor(r.inputs[bp])
                               for r in leaders])
        params = leaders[0].params
        aux = leaders[0].aux

        def one(pv):
            return planned(params, {**fixed, bp: pv}, aux=aux)

        outs = torch.func.vmap(one)(stacked)
        self._sync()
        vals = [tuple(o[i] for o in outs) if isinstance(outs, tuple)
                else outs[i] for i in range(len(leaders))]
        self.registry.count("analytics.batched", len(leaders))
        return vals

    def _root_key(self, req: AnalysisRequest, keys: dict) -> tuple:
        """The whole-query identity: plan id + the runtime keys of its
        outputs — two queries with equal root keys compute the same
        values, whatever their programs looked like."""
        return (getattr(req.planned, "plan_id", id(req.planned)),
                tuple(keys.get(o, o) for o in req.planned.concrete.outputs))

    def _settle_analysis(self, req: AnalysisRequest, res: AnalysisResult,
                         results: dict, t0: float) -> None:
        # route to the owning run_analyses call's results dict (a tick may
        # have drained a concurrent call's request); fall back to the
        # draining call's dict for requests with no registered owner
        sink, st0 = self._analysis_sinks.get(id(req), (results, t0))
        res.ttfr_ms = (time.perf_counter() - st0) * 1e3
        self.registry.summary("analytics.ttfr_ms").observe(res.ttfr_ms)
        self.registry.count("analytics.requests")
        sink[req.rid] = res

    async def _admit_analysis_tick(self, tick: list, results: dict,
                                   t0: float) -> None:
        """One admission tick: key every drained query, dedupe exact twins
        (intra-tick groups + cross-task in-flight futures), coalesce
        same-shape queries into vmapped batches, run the rest through the
        CSE path, and resolve every request with a result."""
        loop = asyncio.get_running_loop()
        groups: dict = {}        # root key -> [(req, keys), ...]
        waiters: list = []       # (req, future of an in-flight twin)
        for req in tick:
            keys = subdag_keys(req.planned, req.inputs,
                               versions=req.store_versions,
                               params=req.params)
            root = self._root_key(req, keys)
            fut = self._analysis_inflight.get(root)
            if fut is not None and root not in groups:
                waiters.append((req, fut))
                continue
            groups.setdefault(root, []).append((req, keys))
        # same-shape batching among group leaders (>=2 make a batch)
        singles, shaped = [], {}
        for root, members in groups.items():
            leader = members[0][0]
            if leader.batch_param is not None \
                    and leader.batch_param in leader.inputs:
                gk = self._batch_group_key(leader, members[0][1])
                shaped.setdefault(gk, []).append((root, members))
            else:
                singles.append((root, members))
        vbatches = []
        for g in shaped.values():
            if len(g) >= 2:
                vbatches.append(g)
            else:
                singles.extend(g)
        futs = {}
        for root, _ in singles:
            futs[root] = self._analysis_inflight[root] = loop.create_future()
        for g in vbatches:
            for root, _ in g:
                futs[root] = self._analysis_inflight[root] = \
                    loop.create_future()

        def settle(req, res):
            self._settle_analysis(req, res, results, t0)

        def resolve(root, members, payload, *, batched=False):
            status, val, info, err = payload
            fut = futs[root]
            if not fut.done():
                fut.set_result(payload)
            self._analysis_inflight.pop(root, None)
            for j, (req, _) in enumerate(members):
                if j > 0:
                    self.registry.count("analytics.deduped")
                res = AnalysisResult(
                    req.rid, val, status, err,
                    shared_hits=info.get("shared_hits", 0),
                    executed=info.get("executed", 0),
                    deduped=j > 0, batched=batched)
                settle(req, res)

        try:
            await self._run_analysis_tick(vbatches, singles, waiters,
                                          resolve, settle)
        except BaseException as exc:
            self._fail_analysis_tick(tick, futs, results, exc)
            raise

    async def _run_analysis_tick(self, vbatches, singles, waiters,
                                 resolve, settle) -> None:
        """Run one tick's vmapped batches, then its singles through the
        CSE path, then settle its twins of other ticks' in-flight
        queries."""
        for g in vbatches:
            leaders = [members[0][0] for _, members in g]
            try:
                vals = self._run_batched_group(leaders)
                for (root, members), val in zip(g, vals):
                    resolve(root, members,
                            ("ok", val, {"executed": 1}, None), batched=True)
            except Exception as exc:
                if is_kernel_error(exc):
                    raise
                # vmap refused the plan (data-dependent shapes, a host
                # read): run each leader through the CSE path instead
                self.recorder.record("batch_fallback", {
                    "n": len(g), "error": repr(exc)})
                singles.extend(g)
        for root, members in singles:
            leader, lkeys = members[0]
            try:
                val, info = self._analysis_exec(leader, keys=lkeys)
                resolve(root, members, ("ok", val, info, None))
            except Exception as exc:
                err = {"reason": "analysis_failed",
                       "plan_id": getattr(leader.planned, "plan_id", ""),
                       "error": repr(exc)}
                self.recorder.trip("executor_error",
                                   {**err, **self._trip_context()})
                if is_kernel_error(exc):
                    raise
                resolve(root, members, ("error", None, {}, err))
            await asyncio.sleep(0)   # let twins land on the future map
        for req, fut in waiters:
            status, val, info, err = await fut
            self.registry.count("analytics.deduped")
            res = AnalysisResult(req.rid, val, status, err,
                                 shared_hits=info.get("shared_hits", 0),
                                 deduped=True)
            settle(req, res)

    def _fail_analysis_tick(self, tick: list, futs: dict, results: dict,
                            exc: BaseException) -> None:
        """A tick left on an exception (a kernel error, a cancelled task):
        fail each of its in-flight futures, so that a concurrent task
        awaiting one raises too instead of hanging, and drop them from the
        in-flight map, so that a later twin computes anew.  A drained
        request that another ``run_analyses`` call owns gets the exception
        as its result, which that call raises."""
        for root, fut in futs.items():
            if not fut.done():
                if isinstance(exc, Exception):
                    fut.set_exception(exc)
                    fut.exception()      # retrieved: its awaiters re-raise
                else:
                    fut.cancel()
            if self._analysis_inflight.get(root) is fut:
                del self._analysis_inflight[root]
        for req in tick:
            sink = self._analysis_sinks.get(id(req))
            if sink is not None and sink[0] is not results \
                    and req.rid not in sink[0]:
                sink[0][req.rid] = exc

    async def run_analyses(self, requests: Sequence[AnalysisRequest],
                           timeout_s: float = 300.0) -> list:
        """Serve a set of analytical queries through the multi-query
        admission path: per-tenant weighted round-robin drains up to
        ``analysis_tick`` queries per tick; each tick dedupes exact twins
        (single-flight — the first computes, the rest await its future),
        coalesces same-shape queries into one vmapped forward, and runs
        the remainder through the subplan-cache CSE pass.  Returns
        AnalysisResults in input order; every query resolves (errors are
        structured, a loop timeout resolves stragglers)."""
        t0 = time.perf_counter()
        results: dict = {}
        mine = {id(r) for r in requests}
        for r in requests:
            self._analysis_sinks[id(r)] = (results, t0)
            self.analysis_sched.enqueue(r, r.tenant)
        try:
            # completion is scoped to THIS call's requests: a tick may
            # settle a concurrent call's drained query into that call's
            # sink (or pick up extras), so len(results) alone can't gate
            while any(r.rid not in results for r in requests):
                if time.perf_counter() - t0 > timeout_s:
                    # pull this call's undrained stragglers out of the
                    # shared tenant queues so a later call can't adopt
                    # them, then resolve them with structured timeouts
                    self.analysis_sched.purge(lambda item: id(item) in mine)
                    for r in requests:
                        if r.rid not in results:
                            self._settle_analysis(r, AnalysisResult(
                                r.rid, None, "error",
                                {"reason": "timeout",
                                 "timeout_s": timeout_s}),
                                results, t0)
                    break
                tick = self.analysis_sched.drain(self.analysis_tick)
                if not tick:
                    await asyncio.sleep(0.0005)
                    continue
                await self._admit_analysis_tick(tick, results, t0)
                await asyncio.sleep(0)
            for r in requests:
                # a concurrent call's tick failed on this call's query
                if isinstance(results[r.rid], BaseException):
                    raise results[r.rid]
        finally:
            for r in requests:
                self._analysis_sinks.pop(id(r), None)
            # on a raise, leave no query of this call in the shared queues
            self.analysis_sched.purge(lambda item: id(item) in mine)
        self._maybe_snapshot(force=True)
        return [results[r.rid] for r in requests]

    def serve_analyses(self, requests: Sequence[AnalysisRequest],
                       timeout_s: float = 300.0) -> list:
        """Synchronous wrapper around :meth:`run_analyses` (same nesting
        rule as :meth:`serve`)."""
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            return asyncio.run(self.run_analyses(requests,
                                                 timeout_s=timeout_s))
        raise RuntimeError(
            "serve_analyses() was called from a running event loop; call "
            "`await runtime.run_analyses(...)` instead")

    def run_analysis(self, planned, params, inputs: dict, *,
                     analyze: bool = False, aux: Optional[dict] = None,
                     deadline_s: Optional[float] = None,
                     degrade=None, store_versions: tuple = (),
                     tied_to=None):
        """Execute an analytical (tri-store) :class:`PlannedFunction`
        through the runtime's shared metrics registry, so LM and
        analytical traffic report into one place: wall time (ending in a
        device sync) lands in the ``analytics.run_ms`` summary,
        request/trace counts in ``analytics.*`` counters.  With
        ``analyze=True`` the run goes through ``PlannedFunction.analyze``
        (EXPLAIN ANALYZE tracing) and the trace's wall/sync split is
        recorded too.  Either path feeds the flight recorder: traced runs
        land their RunTrace summary in the ring (and trip a dump on
        BoundedRel overflow, inside ``analyze``); an executor exception
        trips an ``executor_error`` dump carrying the current ledger
        snapshot + metrics report.

        ``degrade``: with a :class:`~repro_torch.serving.degrade.
        DegradePolicy` attached to the runtime, a standing query is
        transparently switched to its cheaper variant under overload —
        pass an int to force a ladder level, ``False`` to opt this call
        out.  ``deadline_s`` bounds the run's wall time *post hoc*: a miss
        lands an ``analytics.deadline_miss`` count and a recorder event
        (an analytical plan has no token boundary to cancel at, so the
        deadline informs shedding, not abortion)."""
        if degrade is not False and self.degrade is not None:
            lvl = degrade if isinstance(degrade, int) \
                and not isinstance(degrade, bool) else \
                self.degrade.level(
                    queue_depth=self.scheduler.queue_depth(),
                    max_batch=self.max_batch,
                    kv_fill=self.pool.occupancy()["fill"])
            if lvl > 0:
                planned = self.degrade.replan(planned, lvl, cache=self.pc)
        if self.faults is not None and planned.faults is None:
            planned.faults = self.faults
        t0 = time.perf_counter()
        try:
            if analyze:
                outs = planned.analyze(params, inputs, aux=aux,
                                       recorder=self.recorder,
                                       trip_context=self._trip_context)
                tr = planned.last_run_trace
                self.registry.summary("analytics.trace_wall_ms").observe(
                    tr.wall_ms)
                self.registry.summary("analytics.sync_ms").observe(
                    tr.sync_ms)
                self.registry.count("analytics.traced")
            elif self.subplans is not None and planned.faults is None:
                # cross-query CSE: reuse cached sub-DAG intermediates and
                # execute only the residual suffix (bitwise-identical — the
                # reused values are an identical computation's tensors)
                outs, _info = mqo_run(planned, params, inputs,
                                      cache=self.subplans,
                                      versions=store_versions, aux=aux,
                                      tied_to=tied_to)
                self._sync()
            else:
                outs = planned(params, inputs, aux=aux)
                self._sync()
        except Exception as exc:
            # analyze() already tripped for its own failures (with the same
            # trip context); only the untraced path needs capture here
            if not analyze:
                self.recorder.trip("executor_error", {
                    "plan_id": getattr(planned, "plan_id", ""),
                    "error": repr(exc), **self._trip_context()})
            raise
        elapsed_s = time.perf_counter() - t0
        if deadline_s is not None and elapsed_s > deadline_s:
            self.registry.count("analytics.deadline_miss")
            self.recorder.record("deadline_miss", {
                "plan_id": planned.plan_id, "kind": "analysis",
                "deadline_s": deadline_s, "elapsed_s": elapsed_s})
        self.registry.summary("analytics.run_ms").observe(elapsed_s * 1e3)
        self.registry.count("analytics.requests")
        self._maybe_snapshot(force=True)
        return outs


def _row(kv_groups, i: int):
    """Row ``i`` of a prefill's K/V outputs, as a batch-1 plan output:
    every (layers, w, bucket, KV, D) leaf sliced to (layers, 1, ...)."""
    return tuple(tuple((k[:, i:i + 1], v[:, i:i + 1]) for k, v in kv_g)
                 for kv_g in kv_groups)


def serve_sequential(model: LM, params, requests: Sequence[ServeRequest], *,
                     max_seq: int = 128, bucket_lo: int = 8,
                     engines=("xla", "pallas"), syscat=None,
                     plan_cache=None, device=None) -> list:
    """The sequential seed path, as a baseline: one request at a time —
    planned (bucketed, cached) prefill for the prompt logits, prompt replay
    through the cached decode path to build the KV cache, then
    token-by-token decode at batch 1.  One batch-1 cache serves every
    request in turn (zeroed for each, as a fresh one); on the card its
    decode step is a CUDA graph, as the runtime's."""
    check_servable(model)
    dev = resolve_device(device)
    syscat = syscat or default_syscat(dev)
    pc = plan_cache if plan_cache is not None else default_plan_cache()
    cfg = model.cfg
    params = model.inference_params(params)
    cache = init_cache(model, 1, max_seq, device=dev)
    if dev.type == "cuda":
        step = DecodeGraph(model, params, cache, 1)
    else:
        def step(tokens, indices):
            return decode_step_batched(model, params, cache, tokens,
                                       indices)[0]
    results = []
    for req in requests:
        bucket = bucket_len(req.prompt_len, lo=bucket_lo, hi=max_seq)
        plan = model.build_plan(1, bucket, mode="prefill")
        fwd = plan_and_compile(plan, CATALOG, syscat, engines=engines,
                               cache=pc, device=dev)
        padded = torch.zeros((1, bucket), dtype=torch.long, device=dev)
        padded[0, :req.prompt_len] = torch.tensor(req.prompt)
        logits = fwd(params, {"tokens": padded})
        tok = int(_first_tokens(logits, torch.tensor(
            [req.prompt_len], device=dev), cfg.vocab)[0])
        for leaf in (x for gc in cache.values() for x in gc.values()):
            leaf.zero_()
        pos = torch.zeros((1,), dtype=torch.long, device=dev)
        for t in range(req.prompt_len):
            step(padded[:, t:t + 1], pos.fill_(t))
        out = [tok]
        for t in range(req.prompt_len, req.prompt_len + req.gen - 1):
            lg = step(torch.tensor([[tok]], dtype=torch.long, device=dev),
                      pos.fill_(t))
            tok = int(torch.argmax(lg[0, 0, :cfg.vocab]))
            out.append(tok)
        results.append(ServeResult(req.rid, out, "ok", None))
    return results
