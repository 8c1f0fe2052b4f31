"""Content-addressed LRU cache of staged physical plans.

BigDAWG and Polystore++ both observe that staged plans with *stable
identities* are the prerequisite for plan reuse across repeated traffic.
Here the identity is ``ir.plan_id`` — a content hash over plan structure,
catalog signatures, syscat fingerprint, and planning options — and the
cached value is the full :class:`~repro_torch.core.pipeline.StagedPhysicalPlan`
(optimized logical plan, candidate plan, concrete plan, choices, buffering
decision and the per-pass trace).

A cache hit skips the entire pass pipeline: repeated/bucketed workloads
(serving buckets, re-built train steps, dry-run sweeps) rebind the cached
staged plan to their runtime context (mesh / sharding rules / interpret
mode) instead of replanning from scratch.  Staged plans are treated as
immutable once cached; the executor never mutates them at call time.
"""
from __future__ import annotations

import os
import pickle
import tempfile
import threading
from collections import OrderedDict
from typing import Any, Optional

from .tracing import tree_leaves

# per-node bookkeeping overhead (dataclass + dict slots, interned strings)
# and the fallback for opaque entries staged_bytes cannot walk
_NODE_BYTES = 256
_FALLBACK_BYTES = 1024


def staged_bytes(staged) -> int:
    """Estimated resident bytes of a cached staged plan: per-node overhead
    plus the nbytes of any array constants folded into node attrs (the part
    that actually scales — a plan embedding a broadcast build side can dwarf
    a hundred constant-free plans).  An explicit ``nbytes`` attribute wins;
    anything unwalkable falls back to a flat constant so byte accounting
    degrades to count accounting, never raises."""
    nb = getattr(staged, "nbytes", None)
    if isinstance(nb, (int, float)) and nb >= 0:
        return int(nb)
    try:
        total = 0
        for node in staged.concrete.topo():
            total += _NODE_BYTES
            for leaf in tree_leaves(dict(node.attrs)):
                n = getattr(leaf, "nbytes", None)   # numpy and torch alike
                if n is not None:
                    total += int(n)
        return max(total, _NODE_BYTES)
    except Exception:
        return _FALLBACK_BYTES


class PlanCache:
    """LRU map: plan_id -> StagedPhysicalPlan, with hit/miss accounting.

    Eviction is **calibration-aware**: each entry remembers the cost-model
    fit fingerprint it was planned under (``insert(..., fingerprint=)``),
    and ``note_fingerprint`` records the fingerprint of the current cost
    model.  An entry is **stale** when its fingerprint differs from the
    current one *and* it has not been touched since the current fingerprint
    took effect — i.e. it was planned under a superseded fit and nobody is
    using it.  Stale entries are evicted first (LRU among themselves); with
    none, eviction is plain LRU.  The not-touched-since condition keeps a
    *concurrently active* second cost model's hot entries protected: being
    looked up under the new calibration re-proves an entry live, so two
    callers sharing one cache cannot thrash each other's working sets.

    Alongside the entry-count bound, an optional ``byte_budget`` bounds the
    *bytes* the cached staged plans hold (estimated per entry at insert,
    registered in the MemoryLedger under ``("plan_cache", plan_id)``).
    Byte-budget eviction is stale-first, then **largest-first** — entry
    count is a poor proxy for memory when staged plans embed folded
    constants of very different sizes, so the budget sheds the biggest
    non-stale entry rather than the coldest.
    """

    def __init__(self, maxsize: int = 128,
                 byte_budget: Optional[int] = None, ledger=None):
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        if byte_budget is not None and byte_budget < 1:
            raise ValueError(f"byte_budget must be >= 1, got {byte_budget}")
        self.maxsize = maxsize
        self.byte_budget = byte_budget
        self._ledger = ledger                # None -> default_ledger(), lazy
        # one reentrant lock covers every counter and map mutation: the
        # serving loop's admission path and benchmark scripts look plans up
        # from multiple tasks/threads, and the bare ``self.hits += 1``
        # read-modify-writes (plus the OrderedDict reorders) raced —
        # stats() could report hits + misses != lookups.  Reentrant because
        # insert() -> note_fingerprint() nests.
        self._lock = threading.RLock()
        self._entries: "OrderedDict[str, Any]" = OrderedDict()
        self._fps: dict = {}                 # plan_id -> fit fingerprint
        self._seen_epoch: dict = {}          # plan_id -> epoch of last touch
        self._sizes: dict = {}               # plan_id -> estimated bytes
        self._epoch = 0                      # bumps when the fit changes
        self.current_fingerprint: Optional[str] = None
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.stale_evictions = 0
        self.byte_evictions = 0
        self.bytes_in_cache = 0

    @property
    def ledger(self):
        if self._ledger is None:
            from .ledger import default_ledger
            self._ledger = default_ledger()
        return self._ledger

    def note_fingerprint(self, fingerprint: str) -> None:
        """Record the fingerprint of the cost model in current use (called
        by ``compile_staged`` on every cached planning request, so pure-hit
        workloads still see calibration refreshes).

        The uncalibrated ``"analytic"`` fallback never *displaces* a fitted
        fingerprint: many call sites pass no cost model at all, and letting
        each of their compiles flip currency back and forth would churn the
        staleness epoch on every interleaving.  Calibration only moves
        forward."""
        with self._lock:
            if fingerprint == "analytic" and \
                    self.current_fingerprint is not None:
                return
            if fingerprint != self.current_fingerprint:
                self._epoch += 1
            self.current_fingerprint = fingerprint

    def lookup(self, plan_id: str):
        """Return the cached staged plan (refreshing recency) or None."""
        with self._lock:
            entry = self._entries.get(plan_id)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(plan_id)
            self._seen_epoch[plan_id] = self._epoch
            self.hits += 1
            return entry

    def insert(self, plan_id: str, staged, fingerprint: Optional[str] = None
               ) -> None:
        # size estimation walks the staged plan — keep it outside the lock
        nb = staged_bytes(staged)
        with self._lock:
            if plan_id in self._entries:
                self.bytes_in_cache -= self._sizes.get(plan_id, 0)
            self._entries[plan_id] = staged
            self._sizes[plan_id] = nb
            self.bytes_in_cache += nb
            self.ledger.register(("plan_cache", plan_id), nbytes=nb,
                                 kind="plan_cache")
            if fingerprint is not None:
                self._fps[plan_id] = fingerprint
                self.note_fingerprint(fingerprint)
            self._seen_epoch[plan_id] = self._epoch
            self._entries.move_to_end(plan_id)
            while len(self._entries) > self.maxsize:
                self._evict_one()
            # byte budget on top of the count bound: stale entries go first
            # (LRU among themselves), then the *largest* live entry — the
            # goal is bytes back per eviction, not recency.  The newest
            # entry is never evicted on its own insert (len > 1), even when
            # it alone exceeds the budget: callers still get their plan
            # cached until something else arrives.
            if self.byte_budget is not None:
                while (self.bytes_in_cache > self.byte_budget
                       and len(self._entries) > 1):
                    self._evict_one_bytes(keep=plan_id)

    def _evict_one_bytes(self, keep: Optional[str] = None) -> None:
        victim = None
        if self.current_fingerprint is not None:
            victim = next((p for p in self._entries
                           if p != keep and self._is_stale(p)), None)
        if victim is not None:
            self.stale_evictions += 1
        else:
            victim = max((p for p in self._entries if p != keep),
                         key=lambda p: self._sizes.get(p, 0))
        self._drop(victim)
        self.evictions += 1
        self.byte_evictions += 1

    def _drop(self, plan_id: str) -> None:
        del self._entries[plan_id]
        self._fps.pop(plan_id, None)
        self._seen_epoch.pop(plan_id, None)
        self.bytes_in_cache -= self._sizes.pop(plan_id, 0)
        self.ledger.release(("plan_cache", plan_id))

    def _is_stale(self, plan_id: str) -> bool:
        fp = self._fps.get(plan_id)
        return (fp is not None and fp != self.current_fingerprint
                and self._seen_epoch.get(plan_id, -1) < self._epoch)

    def _evict_one(self) -> None:
        victim = None
        if self.current_fingerprint is not None:
            victim = next((p for p in self._entries if self._is_stale(p)),
                          None)
        if victim is None:
            victim = next(iter(self._entries))
        else:
            self.stale_evictions += 1
        self._drop(victim)
        self.evictions += 1

    def clear(self) -> None:
        with self._lock:
            for plan_id in self._entries:
                self.ledger.release(("plan_cache", plan_id))
            self._entries.clear()
            self._fps.clear()
            self._seen_epoch.clear()
            self._sizes.clear()
            self.bytes_in_cache = 0
            self._epoch = 0
            self.current_fingerprint = None
            self.hits = self.misses = self.evictions = 0
            self.stale_evictions = 0
            self.byte_evictions = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, plan_id: str) -> bool:
        with self._lock:
            return plan_id in self._entries

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "size": len(self._entries),
                "maxsize": self.maxsize,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "stale_evictions": self.stale_evictions,
                "byte_evictions": self.byte_evictions,
                "bytes": self.bytes_in_cache,
                "byte_budget": self.byte_budget,
                "hit_rate": (self.hits / total) if total else 0.0,
            }

    def __repr__(self):
        s = self.stats()
        return (f"PlanCache(size={s['size']}/{s['maxsize']} "
                f"hits={s['hits']} misses={s['misses']} "
                f"hit_rate={s['hit_rate']:.2f})")


# --------------------------------------------------------------------------
# disk persistence: plan_id-keyed warm start
# --------------------------------------------------------------------------
#
# Staged plans are content-addressed, so persisting them is safe by
# construction: the file name *is* the plan_id, and a restart that computes
# the same id gets the same plan (a syscat / catalog / options change
# computes a different id and simply misses).  Used by the serving runtime
# and launch/train for warm-started planning across process restarts.

_SUFFIX = ".staged.pkl"


def save_plan_cache(cache: PlanCache, dir_path: str) -> int:
    """Write every cached staged plan to ``dir_path/<plan_id>.staged.pkl``
    (atomic per entry; already-persisted ids are skipped).  Returns the
    number of newly written entries."""
    os.makedirs(dir_path, exist_ok=True)
    written = 0
    with cache._lock:                      # snapshot: writes happen unlocked
        entries = list(cache._entries.items())
    for plan_id, staged in entries:
        path = os.path.join(dir_path, plan_id + _SUFFIX)
        if os.path.exists(path):
            continue
        fd, tmp = tempfile.mkstemp(dir=dir_path, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as fh:
                # fingerprint rides along so calibration-aware eviction
                # classifies warm-started entries too
                pickle.dump({"staged": staged,
                             "fingerprint": cache._fps.get(plan_id)}, fh)
            os.replace(tmp, path)
            written += 1
        except Exception:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
    return written


def load_plan_cache(dir_path: str, cache: Optional[PlanCache] = None,
                    ) -> PlanCache:
    """Warm-start a PlanCache from a persisted directory.  Entries load in
    mtime order (oldest first) so LRU recency mirrors write order; corrupt
    or unreadable files are skipped — a warm start can only help, never
    fail the caller.  Loading counts neither hits nor misses."""
    cache = cache if cache is not None else PlanCache()
    if not os.path.isdir(dir_path):
        return cache
    entries = [e for e in os.scandir(dir_path) if e.name.endswith(_SUFFIX)]
    entries.sort(key=lambda e: e.stat().st_mtime)
    for e in entries:
        plan_id = e.name[:-len(_SUFFIX)]
        if plan_id in cache:
            continue
        try:
            with open(e.path, "rb") as fh:
                obj = pickle.load(fh)
        except Exception:
            continue
        if isinstance(obj, dict) and "staged" in obj:
            cache.insert(plan_id, obj["staged"])
            if obj.get("fingerprint") is not None:
                # classify the entry for stale-first eviction, but loading
                # old plans must not make their fit the *current* one
                cache._fps[plan_id] = obj["fingerprint"]
        else:                      # pre-fingerprint format: bare staged plan
            cache.insert(plan_id, obj)
    return cache


# process-wide default, shared by every entry point (adil.Analysis.compile,
# launch/train, launch/serve, launch/dryrun, benchmarks)
_DEFAULT = PlanCache()


def default_plan_cache() -> PlanCache:
    return _DEFAULT


def clear_default_plan_cache() -> None:
    _DEFAULT.clear()
