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
rejection (``admission_reject``) and on a loop timeout
(``serve_timeout``).

Not ported yet (ROADMAP §1): fault injection and retries, deadlines,
degraded-mode replanning, the sub-plan cache and the analytical requests;
their constructor arguments are absent.
"""
from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.executor import default_syscat, plan_and_compile, resolve_device
from ..core.ir import SystemCatalog
from ..core.ledger import FlightRecorder, MemoryLedger, default_ledger
from ..core.plan_cache import (PlanCache, default_plan_cache,
                               load_plan_cache, save_plan_cache)
from ..models.decode import (DecodeGraph, decode_step_batched,
                             init_cache)
from ..models.lm import CATALOG, LM
from .admission import AdmissionController, bucket_len
from .kv_pool import PagedKVPool
from .metrics import MetricsRegistry, RequestMetrics, ServingMetrics
from .scheduler import ContinuousBatchScheduler


@dataclass(frozen=True)
class ServeRequest:
    rid: object
    prompt: tuple                    # token ids
    gen: int
    arrival: float = 0.0             # seconds after run() start

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)


@dataclass
class ServeResult:
    rid: object
    tokens: list = field(default_factory=list)
    status: str = "ok"               # ok | rejected | truncated | timeout
    metrics: Optional[RequestMetrics] = None
    error: Optional[dict] = None     # structured failure detail (non-ok)

    @property
    def ok(self) -> bool:
        return self.status in ("ok", "truncated")


def _first_tokens(logits, ns, vocab: int):
    """Greedy token at each row's last prompt position ``ns - 1``."""
    rows = torch.arange(logits.shape[0], device=logits.device)
    return torch.argmax(logits[rows, ns - 1, :vocab], dim=-1)


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
                 prefill_batch: int = 4, device=None):
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
        # up to ``prefill_batch`` same-bucket waiting requests prefill as
        # ONE planned forward over a (w, bucket) token batch (1 disables)
        self.prefill_batch = max(int(prefill_batch), 1)

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

    def submit(self, req: ServeRequest) -> None:
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
                self._prefill_and_join(req, bucket, enq)
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

    # -- decode -------------------------------------------------------------
    def _finish(self, st, status: str, error: Optional[dict] = None) -> None:
        self.scheduler.leave(st.slot)
        self.pool.free(st.request.rid)
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
        self._t0 = time.perf_counter()
        pending = sorted(requests, key=lambda r: r.arrival)
        submitter = asyncio.ensure_future(self._submit_all(pending))
        try:
            while any(rid not in self._results for rid in rids):
                if self._now() > timeout_s:
                    self._fail_outstanding(requests, timeout_s)
                    break
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
