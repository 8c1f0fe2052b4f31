"""Resilient execution: error taxonomy, retries, breakers, degraded replans.

Tracing, the ledger and the flight recorder are the *observe* half of
production readiness; this module is the *survive* half, in the spirit of
BigDAWG's degraded cross-island execution and Polystore++'s
accelerator-fallback argument: when a Pallas kernel, a sharded collective,
or a compacted store op fails at runtime, the right response is usually not
"replay the same broken plan" but "re-plan without the broken capability".

The pieces:

  * :class:`ExecError` — the taxonomy.  Every executor failure is wrapped
    with its site (node id / op / impl / engine) and classified
    retryable-vs-fatal (:func:`classify`).  Injected faults and transient
    infra errors are retryable; shape/type/missing-impl bugs are fatal —
    retrying those burns the deadline for nothing.
  * :class:`RetryPolicy` — deadline-aware bounded retries with exponential
    backoff and *deterministic* jitter (hash of (seed, attempt), so two
    runs of the same schedule back off identically).
  * :class:`CircuitBreaker` — per-(plan_id, fallback-class) failure
    counters.  Tripping open feeds a **candidate blocklist** that
    :func:`degrade_options` folds into the planning options — and because
    ``engines`` and ``rewrite_pipeline`` are part of
    ``PlanOptions.cache_key()`` (plus an explicit ``extra_key``), the
    re-plan has a *provably different plan id*:

        pallas broken    -> drop the "pallas" engine (XLA impls win)
        sharded broken   -> drop "shard_stores"       (dense-global stores)
        compacted broken -> drop "choose_compaction"  (UNCOMPACTED pipeline)

  * :class:`ResilientExecutor` — the loop tying them together:
    plan (under the current blocklist) -> run -> on failure classify,
    record, maybe trip the breaker, back off, re-plan, retry — all within
    the deadline, with every event landed in the FlightRecorder ring.

The port's copy of the reference package's ``core/resilience.py``,
verbatim apart from import paths and one rule of its own, the kernel-error
rule.  Only an injected fault maps to a fallback class, so only an
injected fault opens a breaker and re-plans without a capability: a real
failure (a ``RuntimeError`` from a wrapper, an ``OSError``, an
out-of-memory error) is retried on the same plan, if it is retryable, and
never runs plain in the kernels' place.  And a
:class:`~repro_torch.kernels.build.KernelError` (``nvcc`` missing, a build
that failed, a library that does not load, a launch the card refused) and
a ``torch.AcceleratorError`` (a sticky CUDA error: nothing later in the
process can run on the card) are fatal: one attempt.  The reference calls
any ``RuntimeError`` retryable and maps any ``*_pallas`` impl's failure to
the ``"pallas"`` class, so a kernel that does not build would re-plan
without the kernels, quietly.  Injected faults keep the reference's
behaviour: at a ``_pallas`` site the breaker opens, the ``pallas`` engine
is dropped and the plan re-planned under a new plan id.
``ResilientExecutor`` plans through ``plan_and_compile``, so it runs on
the card unless ``plan_kwargs`` holds ``device="cpu"``.
"""
from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from ..kernels.build import KernelError
from .faults import FaultInjectedError

# fallback classes — the units the breaker opens over (coarse on purpose:
# one broken Pallas kernel poisons trust in the whole engine for this plan)
FALLBACK_CLASSES = ("pallas", "sharded", "compacted")


class ExecError(RuntimeError):
    """An executor failure with its site attached.

    ``node_id`` / ``op`` / ``impl`` / ``engine`` locate the failure in the
    physical plan; ``retryable`` drives the retry loop; ``plan_id`` ties
    the failure to the plan fingerprint the breaker keys on."""

    def __init__(self, message: str, *, node_id: str = "", op: str = "",
                 impl: str = "", engine: str = "", plan_id: str = "",
                 retryable: bool = True,
                 cause: Optional[BaseException] = None):
        super().__init__(message)
        self.node_id = node_id
        self.op = op
        self.impl = impl
        self.engine = engine
        self.plan_id = plan_id
        self.retryable = retryable
        self.cause = cause

    def to_dict(self) -> dict:
        return {"error": str(self), "node_id": self.node_id, "op": self.op,
                "impl": self.impl, "engine": self.engine,
                "plan_id": self.plan_id, "retryable": self.retryable,
                "cause": repr(self.cause) if self.cause else None}


# a kernel that cannot build or launch, and a sticky CUDA error: no retry
# and no re-plan mends them in this process (the port's kernel-error rule)
_KERNEL_TYPES = (KernelError,) + ((torch.AcceleratorError,)
                                  if hasattr(torch, "AcceleratorError")
                                  else ())

# exception types that indicate a *plan or program bug* — retrying the same
# (or any) plan cannot fix them, so the loop fails fast
_FATAL_TYPES = (TypeError, ValueError, KeyError, IndexError,
                AttributeError, NotImplementedError, AssertionError
                ) + _KERNEL_TYPES


def is_kernel_error(exc: BaseException) -> bool:
    """True for a kernel that cannot build or launch, or a sticky CUDA
    error, raised or wrapped as an ExecError's cause: the errors the
    port's kernel-error rule never retries and never absorbs."""
    if isinstance(exc, ExecError):
        exc = exc.cause
    return isinstance(exc, _KERNEL_TYPES)


def classify(exc: BaseException, *, node=None, plan_id: str = "",
             engine: str = "") -> ExecError:
    """Wrap any raised exception into the :class:`ExecError` taxonomy.

    Injected faults model transient infra failures -> retryable.  Python
    bug types (shape/type/lookup errors) -> fatal.  Everything else
    (RuntimeError from a backend, XLA internal errors) is treated as
    retryable: the cost of one wasted retry is far below the cost of
    failing a request on a transient."""
    if isinstance(exc, ExecError):
        return exc
    kw = {"plan_id": plan_id, "engine": engine, "cause": exc}
    if node is not None:
        kw.update(node_id=str(getattr(node, "id", "")),
                  op=str(getattr(node, "op", "")),
                  impl=str(getattr(node, "impl", "")))
    if isinstance(exc, FaultInjectedError):
        return ExecError(f"injected fault: {exc}", retryable=True, **kw)
    if isinstance(exc, _FATAL_TYPES):
        return ExecError(f"fatal {type(exc).__name__}: {exc}",
                         retryable=False, **kw)
    return ExecError(f"{type(exc).__name__}: {exc}", retryable=True, **kw)


def fallback_class(err: ExecError) -> Optional[str]:
    """Map a failure site to the capability the breaker should distrust.

    Pallas-engine impls -> "pallas"; collective/xfer impls (the sharded
    execution seams) -> "sharded"; compaction impls -> "compacted".  None
    means no structural fallback exists (plain retry is all we have).
    Only an injected fault has a class (the port's kernel-error rule): a
    real failure keeps the breaker closed, so no run re-plans without the
    kernels on its own."""
    if not isinstance(err.cause, FaultInjectedError):
        return None
    if err.engine == "pallas" or err.impl.endswith("_pallas"):
        return "pallas"
    if err.impl.startswith("xfer_") or "all_to_all" in err.impl \
            or "collective" in err.impl:
        return "sharded"
    if err.impl.startswith("compact") or "compact" in err.op:
        return "compacted"
    # fault sites carry the impl in the site tuple even when the node
    # attribution is missing (e.g. runtime-seam injections)
    flat = "/".join(map(str, err.cause.site))
    if "pallas" in flat:
        return "pallas"
    if "xfer" in flat or "shard" in flat:
        return "sharded"
    if "compact" in flat:
        return "compacted"
    return None


# --------------------------------------------------------------------------
# retry policy
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded, deadline-aware retries with deterministic jitter.

    ``backoff_s(attempt)`` is a pure function of (seed, attempt) — two runs
    of the same failure schedule sleep identically, keeping chaos runs
    reproducible end-to-end."""

    max_attempts: int = 3
    base_backoff_s: float = 0.01
    max_backoff_s: float = 1.0
    jitter: float = 0.25             # +/- fraction of the backoff
    seed: int = 0

    def backoff_s(self, attempt: int) -> float:
        base = min(self.base_backoff_s * (2 ** max(attempt - 1, 0)),
                   self.max_backoff_s)
        if self.jitter <= 0.0:
            return base
        h = hashlib.sha256(
            repr((self.seed, attempt)).encode()).digest()
        u = int.from_bytes(h[:8], "big") / float(1 << 64)   # [0, 1)
        return base * (1.0 + self.jitter * (2.0 * u - 1.0))

    def should_retry(self, err: ExecError, attempt: int, *,
                     elapsed_s: float = 0.0,
                     deadline_s: Optional[float] = None) -> bool:
        """One decision point: attempts left, error retryable, and the next
        backoff still fits inside the deadline."""
        if not err.retryable:
            return False
        if attempt >= self.max_attempts:
            return False
        if deadline_s is not None and \
                elapsed_s + self.backoff_s(attempt) >= deadline_s:
            return False
        return True


# --------------------------------------------------------------------------
# circuit breaker -> candidate blocklist
# --------------------------------------------------------------------------


@dataclass
class CircuitBreaker:
    """Per-(plan_id, fallback-class) failure counter with an open state
    that feeds the planner's candidate blocklist.

    ``threshold`` consecutive failures of one class open the circuit for
    ``cooldown_s``; while open, :meth:`blocklist` reports the class and the
    re-plan drops the matching capability.  A success on the fallback plan
    does *not* close the circuit early — the broken capability stays
    avoided until the cooldown expires (half-open), at which point one
    probe is allowed through."""

    threshold: int = 1
    cooldown_s: float = 60.0
    clock: Callable[[], float] = time.monotonic
    _fail: dict = field(default_factory=dict)    # (plan_id, cls) -> count
    _open_at: dict = field(default_factory=dict)  # (plan_id, cls) -> t_open
    events: list = field(default_factory=list)

    def record_failure(self, plan_id: str, err: ExecError) -> Optional[str]:
        """Count a failure; returns the fallback class if the circuit
        (newly or already) holds open for it, else None."""
        cls = fallback_class(err)
        if cls is None:
            return None
        key = (plan_id, cls)
        self._fail[key] = self._fail.get(key, 0) + 1
        if self._fail[key] >= self.threshold and key not in self._open_at:
            self._open_at[key] = self.clock()
            self.events.append(("open", plan_id, cls))
        return cls if key in self._open_at else None

    def record_success(self, plan_id: str) -> None:
        """A clean run on this plan closes any *expired* circuits (the
        half-open probe succeeded) and clears failure counters."""
        now = self.clock()
        for key in [k for k in self._open_at if k[0] == plan_id]:
            if now - self._open_at[key] >= self.cooldown_s:
                del self._open_at[key]
                self._fail.pop(key, None)
                self.events.append(("close", key[0], key[1]))
        for key in [k for k in self._fail if k[0] == plan_id
                    and k not in self._open_at]:
            self._fail.pop(key, None)

    def is_open(self, plan_id: str, cls: str) -> bool:
        key = (plan_id, cls)
        t = self._open_at.get(key)
        if t is None:
            return False
        if self.clock() - t >= self.cooldown_s:
            return False                 # half-open: allow a probe
        return True

    def blocklist(self, plan_id: str) -> tuple:
        """The fallback classes currently open for this plan, sorted —
        the tuple folded into the re-plan's ``extra_key`` (and realized
        structurally by :func:`degrade_options`)."""
        return tuple(sorted(
            cls for (pid, cls) in self._open_at
            if pid == plan_id and self.is_open(pid, cls)))

    def fingerprint(self, plan_id: str) -> tuple:
        """Plan-identity material: ``("blocklist", *classes)``.  Folding
        this into ``extra_key`` makes a breaker-open re-plan a provable
        cache miss even if the structural degrade were a no-op."""
        return ("blocklist",) + self.blocklist(plan_id)


def degrade_options(engines: tuple, rewrite_pipeline: tuple,
                    blocklist: tuple) -> tuple:
    """Realize a blocklist structurally: returns degraded
    ``(engines, rewrite_pipeline)``.

        "pallas"    -> remove the pallas engine (XLA candidates win)
        "sharded"   -> drop the shard_stores pass (dense-global stores,
                       replicated execution — no collectives to fail)
        "compacted" -> drop choose_compaction (UNCOMPACTED behaviour)

    Both tuples are part of ``PlanOptions.cache_key()``, so any non-empty
    applicable blocklist changes the plan id."""
    engines = tuple(engines)
    pipeline = tuple(rewrite_pipeline)
    if "pallas" in blocklist:
        engines = tuple(e for e in engines if e != "pallas")
    if "sharded" in blocklist:
        pipeline = tuple(p for p in pipeline if p != "shard_stores")
    if "compacted" in blocklist:
        pipeline = tuple(p for p in pipeline if p != "choose_compaction")
    return engines, pipeline


# --------------------------------------------------------------------------
# the resilient execution loop
# --------------------------------------------------------------------------


@dataclass
class ResilientExecutor:
    """plan -> run -> classify -> (breaker, backoff) -> re-plan -> retry.

    Wraps the staged plan pipeline with the full survival loop.  Give it
    the *planning inputs* (logical plan, catalogs, baseline engines /
    rewrite pipeline) rather than a compiled function: a breaker trip must
    be able to re-enter the planner with degraded options.

    ``recorder`` (FlightRecorder) receives every retry, breaker trip, and
    final failure; ``faults`` (FaultInjector) threads into the ExecContext
    of every attempt."""

    catalog: Any
    syscat: Any
    policy: RetryPolicy = RetryPolicy()
    breaker: CircuitBreaker = field(default_factory=CircuitBreaker)
    recorder: Optional[Any] = None
    faults: Optional[Any] = None
    clock: Callable[[], float] = time.monotonic
    sleep: Callable[[float], None] = time.sleep
    # plan-time knobs forwarded to plan_and_compile
    engines: tuple = ("xla",)
    rewrite_pipeline: Optional[tuple] = None
    plan_kwargs: dict = field(default_factory=dict)
    attempts_log: list = field(default_factory=list)

    def compile(self, logical, *, blocklist: tuple = ()):
        """Plan under the current blocklist.  The blocklist degrades the
        options structurally *and* is folded into extra_key, so the plan id
        provably differs from the undegraded plan's."""
        from .executor import plan_and_compile
        from .rewrite import DEFAULT_PIPELINE
        engines, pipeline = degrade_options(
            self.engines, self.rewrite_pipeline or DEFAULT_PIPELINE,
            blocklist)
        kw = dict(self.plan_kwargs)
        if blocklist:
            prior = tuple(kw.pop("store_versions", ()) or ())
            kw["store_versions"] = prior + (("blocklist",) + blocklist,)
        fn = plan_and_compile(logical, self.catalog, self.syscat,
                              engines=engines, rewrite_pipeline=pipeline,
                              **kw)
        if self.faults is not None:
            fn.faults = self.faults
        return fn

    def run(self, logical, params, inputs: dict, *,
            aux: Optional[dict] = None,
            deadline_s: Optional[float] = None):
        """Execute with retries + degraded replanning.  Returns
        ``(outputs, planned_fn)`` — callers can inspect ``planned_fn.plan_id``
        to see whether a fallback plan served the request.  Raises the last
        :class:`ExecError` when retries are exhausted or the error is
        fatal."""
        t0 = self.clock()
        attempt = 0
        base_fn = self.compile(logical)
        base_plan_id = base_fn.plan_id
        fn = base_fn
        last_blocklist: tuple = self.breaker.blocklist(base_plan_id)
        if last_blocklist:
            fn = self.compile(logical, blocklist=last_blocklist)
        while True:
            attempt += 1
            try:
                out = fn(params, inputs, aux)
                self.breaker.record_success(base_plan_id)
                self.attempts_log.append(
                    ("ok", attempt, fn.plan_id, last_blocklist))
                return out, fn
            except Exception as exc:
                err = classify(exc, plan_id=fn.plan_id)
                elapsed = self.clock() - t0
                self.attempts_log.append(
                    ("fail", attempt, fn.plan_id, err.to_dict()))
                opened = self.breaker.record_failure(base_plan_id, err)
                if self.recorder is not None:
                    self.recorder.record("exec_retry", {
                        "attempt": attempt, "plan_id": fn.plan_id,
                        "error": err.to_dict(), "elapsed_s": elapsed})
                    if opened:
                        self.recorder.trip("breaker_open", {
                            "plan_id": base_plan_id, "class": opened,
                            "error": err.to_dict()})
                if not self.policy.should_retry(
                        err, attempt, elapsed_s=elapsed,
                        deadline_s=deadline_s):
                    if self.recorder is not None:
                        reason = ("deadline_exceeded"
                                  if err.retryable else "fatal_error")
                        self.recorder.trip("retries_exhausted", {
                            "plan_id": fn.plan_id, "attempts": attempt,
                            "reason": reason, "error": err.to_dict()})
                    raise err from exc
                self.sleep(self.policy.backoff_s(attempt))
                blocklist = self.breaker.blocklist(base_plan_id)
                if blocklist != last_blocklist:
                    fn = self.compile(logical, blocklist=blocklist)
                    last_blocklist = blocklist


__all__ = ["ExecError", "classify", "fallback_class", "RetryPolicy",
           "CircuitBreaker", "degrade_options", "ResilientExecutor",
           "FALLBACK_CLASSES", "is_kernel_error"]
