"""Deterministic fault injection: the chaos half of the resilience layer.

The port's copy of the reference package's ``core/faults.py``, verbatim:
the fire decision is the same sha256, so equal seeds and sites give the
reference's schedule.

A production tri-store survives failed collectives, broken kernels, and
latency spikes only if those failures can be *rehearsed*.  This module is
the rehearsal harness: a :class:`FaultInjector` threaded through
:class:`~repro_torch.core.executor.ExecContext` (``faults=None`` keeps the
executor on its untouched fast path, the same zero-cost pattern as
``tracer=None``) and through the serving runtime's admission/prefill/decode
seams.

Determinism is the design center.  Every potential fault site is a tuple
key — ``("node", node_id, impl)``, ``("xfer", node_id, kind)``,
``("prefill", rid, bucket)``, ``("decode", tick)`` — and the fire decision
is a pure hash of ``(seed, site, occurrence)``: the *n*-th execution of a
site either always faults or never faults for a given seed.  Two runs of
the same workload under the same seed therefore produce the **same failure
schedule** (asserted by ``tests/test_torch_resilience.py``, against the
reference's schedule too), which is what makes "non-faulted requests are
bitwise-identical to a fault-free run" a testable property rather than a
hope.

Fault kinds:

  * **error** — raise :class:`FaultInjectedError` at the site (executor
    node failures, xfer/collective failures, prefill/decode failures);
  * **latency** — a deterministic ``sleep(latency_s)`` spike at the site;
  * **stall** — an admission-side sleep (the serving front door pauses,
    exercising queue growth and deadline expiry under backpressure).

``always_fail`` substrings mark sites as *persistently* broken (every
occurrence faults) — the knob that forces the circuit breaker open and
proves the re-plan-onto-fallback path; ``max_faults`` bounds the total
number of injected errors so chaos runs terminate.
"""
from __future__ import annotations

import hashlib
import time
from typing import Optional, Sequence


class FaultInjectedError(RuntimeError):
    """An injected failure.  Carries its site so the resilience layer can
    attribute it (node id / impl / engine) and the tests can assert the
    schedule.  Injected faults are *retryable by definition* — they model
    transient infrastructure failures, not plan bugs."""

    def __init__(self, site: tuple, occurrence: int, kind: str = "error"):
        self.site = tuple(site)
        self.occurrence = int(occurrence)
        self.kind = kind
        super().__init__(
            f"injected {kind} fault at {self.site} "
            f"(occurrence {self.occurrence})")


def _site_hash(seed: int, site: tuple, occurrence: int) -> float:
    """Pure uniform-in-[0,1) decision value for one (site, occurrence)."""
    key = repr((int(seed), tuple(map(str, site)), int(occurrence)))
    h = hashlib.sha256(key.encode()).digest()
    return int.from_bytes(h[:8], "big") / float(1 << 64)


class FaultInjector:
    """Seed + site-keyed deterministic fault source.

    ``rate`` is the per-occurrence error probability (hashed, not sampled:
    the schedule is a pure function of the seed); ``latency_rate`` /
    ``latency_s`` control deterministic latency spikes; ``stall_s`` is the
    admission-stall duration (categories listed in ``stall_categories``
    sleep instead of raising).  ``categories`` restricts error injection to
    the named site categories (first tuple element); ``always_fail``
    substrings mark persistently broken sites.
    """

    def __init__(self, seed: int = 0, rate: float = 0.0, *,
                 categories: Optional[Sequence[str]] = None,
                 always_fail: Sequence[str] = (),
                 max_faults: Optional[int] = None,
                 latency_rate: float = 0.0, latency_s: float = 0.0,
                 stall_s: float = 0.0,
                 stall_categories: Sequence[str] = ("admission",),
                 sleep=time.sleep):
        if not 0.0 <= float(rate) <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {rate}")
        self.seed = int(seed)
        self.rate = float(rate)
        self.categories = (None if categories is None
                           else frozenset(categories))
        self.always_fail = tuple(str(s) for s in always_fail)
        self.max_faults = max_faults if max_faults is None else int(max_faults)
        self.latency_rate = float(latency_rate)
        self.latency_s = float(latency_s)
        self.stall_s = float(stall_s)
        self.stall_categories = frozenset(stall_categories)
        self._sleep = sleep
        self._occurrence: dict = {}      # site -> times seen
        self.injected: list = []         # [(kind, site, occurrence), ...]
        self.checked = 0

    # -- schedule ----------------------------------------------------------
    def _always(self, site: tuple) -> bool:
        if not self.always_fail:
            return False
        flat = "/".join(map(str, site))
        return any(s in flat for s in self.always_fail)

    def would_fail(self, site: tuple, occurrence: int) -> bool:
        """The pure decision: does occurrence *n* of ``site`` fault?  No
        state is consumed — the schedule is inspectable ahead of time."""
        site = tuple(site)
        if self._always(site):
            return True
        if self.rate <= 0.0:
            return False
        if self.categories is not None and site[0] not in self.categories:
            return False
        return _site_hash(self.seed, site, occurrence) < self.rate

    # -- runtime hooks -----------------------------------------------------
    def check(self, site: tuple) -> None:
        """The executor/runtime hook: count this occurrence of ``site`` and
        raise / spike / pass according to the deterministic schedule."""
        site = tuple(site)
        self.checked += 1
        occ = self._occurrence.get(site, 0)
        self._occurrence[site] = occ + 1
        if site[0] in self.stall_categories:
            if self.stall_s > 0.0:
                self.injected.append(("stall", site, occ))
                self._sleep(self.stall_s)
            return
        if (self.latency_rate > 0.0 and self.latency_s > 0.0
                and _site_hash(self.seed + 0x5eed, site, occ)
                < self.latency_rate):
            self.injected.append(("latency", site, occ))
            self._sleep(self.latency_s)
        budget_left = (self.max_faults is None
                       or self.n_errors() < self.max_faults)
        if budget_left and self.would_fail(site, occ):
            self.injected.append(("error", site, occ))
            raise FaultInjectedError(site, occ)

    def n_errors(self) -> int:
        return sum(1 for k, _s, _o in self.injected if k == "error")

    def schedule(self) -> list:
        """The injected-fault log as plain tuples (determinism assert)."""
        return [(k, tuple(map(str, s)), o) for k, s, o in self.injected]

    def reset(self) -> None:
        """Clear occurrence counters + log: re-running the same workload
        replays the identical schedule."""
        self._occurrence.clear()
        self.injected.clear()
        self.checked = 0

    def __repr__(self):
        return (f"FaultInjector(seed={self.seed}, rate={self.rate}, "
                f"injected={len(self.injected)})")

    # -- CLI spec ----------------------------------------------------------
    @classmethod
    def from_spec(cls, spec: str) -> "FaultInjector":
        """Parse a pinned chaos schedule spec: ``"seed=0,rate=0.05"`` with
        optional ``latency_rate= latency_s= stall_s= max_faults=
        always_fail=sub1+sub2``.  The CI ``chaos-smoke`` job pins exactly
        this string so the schedule is reproducible across runs."""
        kw: dict = {}
        for part in str(spec).split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"bad fault spec element {part!r} "
                                 f"(want key=value)")
            k, v = part.split("=", 1)
            k = k.strip()
            if k in ("seed", "max_faults"):
                kw[k] = int(v)
            elif k in ("rate", "latency_rate", "latency_s", "stall_s"):
                kw[k] = float(v)
            elif k == "always_fail":
                kw[k] = tuple(v.split("+"))
            elif k == "categories":
                kw[k] = tuple(v.split("+"))
            else:
                raise ValueError(f"unknown fault spec key {k!r}")
        seed = kw.pop("seed", 0)
        rate = kw.pop("rate", 0.0)
        return cls(seed, rate, **kw)


__all__ = ["FaultInjector", "FaultInjectedError"]
