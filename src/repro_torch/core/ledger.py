"""Resource ledger + flight recorder: the always-on accounting layer.

The port's counterpart of the reference package's ``core/ledger.py``.
EXPLAIN ANALYZE (``core/tracing.py``) observes a *single run*; nothing so
far tracked what the system holds **resident across runs** — store payload
buffers, BoundedRel capacity headroom, KV-pool pages, plan-cache entry
constants, shard shuffle scratch.  BigDAWG's monitoring framework records
execution history precisely to drive cross-engine decisions, and
Polystore++ argues accelerator-aware polystores need resource-level
visibility; this module is that layer:

  * :class:`MemoryLedger` — registers every live device pytree under an
    owner key with byte gauges, high-water marks, and
    **predicted-vs-actual** deltas against the cost model's
    capacity-derived sizes (``cost_model.predicted_resident_bytes``).
    Leak detection flags entries still registered after the store version
    they snapshot is superseded, or after the plan-cache entry they are
    tied to is evicted.
  * :class:`FlightRecorder` — a bounded ring of the last N events
    (``RunTrace`` summaries, metric snapshots) that dumps to JSONL when
    tripped: on BoundedRel overflow, admission rejection, or executor
    error.  The black box you read *after* the incident.

Registration is host-side bookkeeping only — a ``tree_bytes`` walk over
already-built tensors, no device sync, no extra allocations — so it rides
along on store ``payload()`` / pool construction / plan-cache insert
unconditionally (the telemetry-off executor fast path is untouched).

One deliberate difference: the port's graph and text payloads carry more
than the reference's (the graph's dst-ordered edge copy, the corpus's
``doc_ptr`` and ``max_doc_postings``).  Each store passes the bytes of
those keys to :func:`register_store_payload` as ``extra``, which adds
them to the cost model's prediction, so ``actual - predicted`` is the
reference's for every store.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Optional

from .tracing import tree_bytes


def _owner_key(owner) -> tuple:
    if isinstance(owner, tuple):
        return owner
    return (str(owner),)


@dataclass
class LedgerEntry:
    """One registered live pytree (or byte-sized resource)."""

    owner: tuple
    kind: str
    nbytes: int
    predicted: Optional[int] = None
    version: Optional[int] = None
    tied_to: Optional[tuple] = None   # owner whose lifetime bounds this one
    seq: int = 0

    @property
    def ratio(self) -> Optional[float]:
        """actual / predicted bytes (None without a prediction)."""
        if not self.predicted:
            return None
        return self.nbytes / self.predicted

    def as_dict(self) -> dict:
        return {"owner": list(map(str, self.owner)), "kind": self.kind,
                "nbytes": self.nbytes, "predicted": self.predicted,
                "version": self.version,
                "tied_to": (list(map(str, self.tied_to))
                            if self.tied_to else None)}


class MemoryLedger:
    """Byte accounting for every live device pytree, keyed by owner.

    ``register`` under an owner key **replaces** any previous entry for the
    same owner (the normal append/replace flow releases the superseded
    bytes); a consumer that *pins* a snapshot registers under its own owner
    with ``tied_to=`` the producing owner and ``version=`` the version it
    captured — :meth:`leaks` then flags it once the producer moves on
    (superseded version) or disappears (released / evicted).
    """

    def __init__(self):
        self._entries: "dict[tuple, LedgerEntry]" = {}
        self._kind_bytes: dict = {}
        self._kind_peak: dict = {}
        self._total = 0
        self.peak_bytes = 0
        self.transient_bytes = 0          # lifetime scratch total
        self.transient_peak = 0           # max single transient grant
        self._seq = 0
        self._lock = threading.Lock()

    # -- registration ------------------------------------------------------
    def register(self, owner, value=None, *, nbytes: Optional[int] = None,
                 predicted: Optional[int] = None,
                 version: Optional[int] = None, kind: Optional[str] = None,
                 tied_to=None) -> LedgerEntry:
        """Register (or replace) the live bytes held under ``owner``.

        ``nbytes`` defaults to
        :func:`~repro_torch.core.tracing.tree_bytes` over ``value``;
        ``predicted`` is the cost model's capacity-derived expectation;
        ``version`` the producing store's monotonic version; ``tied_to``
        another owner whose lifetime bounds this entry.
        """
        key = _owner_key(owner)
        nb = int(tree_bytes(value) if nbytes is None else nbytes)
        k = kind if kind is not None else str(key[0])
        tied = _owner_key(tied_to) if tied_to is not None else None
        with self._lock:
            old = self._entries.get(key)
            if old is not None:
                self._total -= old.nbytes
                self._kind_bytes[old.kind] = \
                    self._kind_bytes.get(old.kind, 0) - old.nbytes
            self._seq += 1
            e = LedgerEntry(key, k, nb, predicted, version, tied, self._seq)
            self._entries[key] = e
            self._total += nb
            self._kind_bytes[k] = self._kind_bytes.get(k, 0) + nb
            self.peak_bytes = max(self.peak_bytes, self._total)
            self._kind_peak[k] = max(self._kind_peak.get(k, 0),
                                     self._kind_bytes[k])
        return e

    def release(self, owner) -> int:
        """Drop the entry under ``owner``; returns the bytes released."""
        key = _owner_key(owner)
        with self._lock:
            e = self._entries.pop(key, None)
            if e is None:
                return 0
            self._total -= e.nbytes
            self._kind_bytes[e.kind] = \
                self._kind_bytes.get(e.kind, 0) - e.nbytes
            return e.nbytes

    def release_kind(self, kind: str) -> int:
        """Drop every entry of one owner kind; returns the bytes released.
        The subplan cache drains through this on clear(): its entries are
        keyed by content hash, so enumerating the owners from outside the
        ledger would duplicate its bookkeeping."""
        with self._lock:
            keys = [k for k, e in self._entries.items() if e.kind == kind]
        freed = 0
        for k in keys:
            freed += self.release(k)
        return freed

    def note_transient(self, owner, nbytes: int, kind: str = "transient"
                       ) -> None:
        """Account scratch that lives only inside one executed program
        (shuffle buckets staged through an all-to-all): it contributes to
        the high-water mark — resident bytes plus scratch is the true
        peak — without needing a paired release."""
        nb = int(nbytes)
        with self._lock:
            self.transient_bytes += nb
            self.transient_peak = max(self.transient_peak, nb)
            self.peak_bytes = max(self.peak_bytes, self._total + nb)
            self._kind_peak[kind] = max(self._kind_peak.get(kind, 0), nb)

    # -- gauges ------------------------------------------------------------
    def total_bytes(self) -> int:
        return self._total

    def bytes_for_kind(self, kind: str) -> int:
        return self._kind_bytes.get(kind, 0)

    def entries(self, kind: Optional[str] = None) -> list:
        with self._lock:
            es = list(self._entries.values())
        if kind is not None:
            es = [e for e in es if e.kind == kind]
        return es

    def get(self, owner) -> Optional[LedgerEntry]:
        return self._entries.get(_owner_key(owner))

    # -- leak detection ----------------------------------------------------
    def leaks(self) -> list:
        """Entries whose lifetime anchor has moved on: ``tied_to`` owner
        released/evicted (``"evicted"``), or still present at a *different*
        version than the one this entry snapshot captured
        (``"superseded"``).  Returns ``[(reason, entry), ...]``."""
        out = []
        with self._lock:
            for e in self._entries.values():
                if e.tied_to is None:
                    continue
                anchor = self._entries.get(e.tied_to)
                if anchor is None:
                    out.append(("evicted", e))
                elif (e.version is not None and anchor.version is not None
                      and e.version != anchor.version):
                    out.append(("superseded", e))
        return out

    def predicted_vs_actual(self) -> list:
        """Per-entry ``(entry, predicted, actual, ratio)`` for every entry
        carrying a prediction — the 2x-agreement check the tri-store
        benchmark enforces."""
        return [(e, e.predicted, e.nbytes, e.ratio)
                for e in self.entries() if e.predicted]

    # -- reporting ---------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            by_kind = dict(sorted(self._kind_bytes.items()))
            n = len(self._entries)
            total, peak = self._total, self.peak_bytes
        return {"total_bytes": total, "peak_bytes": peak,
                "transient_bytes": self.transient_bytes,
                "by_kind": by_kind, "entries": n,
                "leaks": len(self.leaks())}

    def publish(self, registry, prefix: str = "ledger") -> None:
        """Set byte gauges in a (duck-typed) MetricsRegistry."""
        registry.gauge(f"{prefix}.total_bytes").set(self._total)
        registry.gauge(f"{prefix}.peak_bytes").set(self.peak_bytes)
        for kind, nb in self._kind_bytes.items():
            registry.gauge(f"{prefix}.{kind}_bytes").set(nb)

    def report(self) -> str:
        snap = self.snapshot()
        lines = [f"[ledger] {snap['entries']} entries, "
                 f"{snap['total_bytes'] / 1e6:.2f} MB resident "
                 f"(peak {snap['peak_bytes'] / 1e6:.2f} MB, "
                 f"transient {snap['transient_bytes'] / 1e6:.2f} MB)"]
        for kind, nb in snap["by_kind"].items():
            lines.append(f"[ledger]   {kind}: {nb / 1e6:.2f} MB "
                         f"(peak {self._kind_peak.get(kind, 0) / 1e6:.2f} MB)")
        for e, pred, act, ratio in self.predicted_vs_actual():
            lines.append(f"[ledger]   {'/'.join(map(str, e.owner))}: "
                         f"predicted {pred / 1e6:.2f} MB, actual "
                         f"{act / 1e6:.2f} MB ({ratio:.2f}x)")
        for reason, e in self.leaks():
            lines.append(f"[ledger]   LEAK ({reason}): "
                         f"{'/'.join(map(str, e.owner))} holds "
                         f"{e.nbytes / 1e6:.2f} MB")
        return "\n".join(lines)

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()
            self._kind_bytes.clear()
            self._kind_peak.clear()
            self._total = 0
            self.peak_bytes = 0
            self.transient_bytes = 0
            self.transient_peak = 0


# --------------------------------------------------------------------------
# flight recorder: the bounded black box
# --------------------------------------------------------------------------


@dataclass
class FlightEvent:
    seq: int
    kind: str
    ts: float
    payload: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {"record": "event", "seq": self.seq, "kind": self.kind,
                "ts": self.ts, "payload": self.payload}


class FlightRecorder:
    """Bounded ring of the last ``capacity`` telemetry events.

    ``record`` is O(1) and never grows past the ring bound (older events
    drop, counted in ``dropped``).  ``trip(reason)`` dumps the ring as
    JSON-lines — to ``dump_dir/flight_NNN_<reason>.jsonl`` when a dump
    directory is configured, otherwise returned in-memory — and is wired
    to the three incident triggers: BoundedRel overflow
    (``PlannedFunction.analyze``), admission rejection and executor error
    (``AsyncServingRuntime``).
    """

    def __init__(self, capacity: int = 64, dump_dir: Optional[str] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.dump_dir = dump_dir
        self._ring: deque = deque(maxlen=self.capacity)
        self._seq = 0
        self.dropped = 0
        self.trips: list = []            # (reason, path-or-None)
        self._lock = threading.Lock()

    def record(self, kind: str, payload: Optional[dict] = None
               ) -> FlightEvent:
        with self._lock:
            self._seq += 1
            if len(self._ring) == self.capacity:
                self.dropped += 1
            ev = FlightEvent(self._seq, kind, time.time(), payload or {})
            self._ring.append(ev)
        return ev

    def record_trace(self, trace) -> FlightEvent:
        """Compact RunTrace summary (the full trace stays with the plan)."""
        return self.record("run_trace", {
            "plan_id": getattr(trace, "plan_id", ""),
            "wall_ms": getattr(trace, "wall_ms", 0.0),
            "sync_ms": getattr(trace, "sync_ms", 0.0),
            "spans": len(getattr(trace, "spans", ())),
            "counts": [[list(map(str, site)), c, cap]
                       for site, c, cap in getattr(trace, "counts", ())],
            "collective_totals": trace.collective_totals()
            if hasattr(trace, "collective_totals") else {},
        })

    def events(self) -> list:
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        return len(self._ring)

    def trip(self, reason: str, detail: Optional[dict] = None):
        """Dump the ring.  Returns the JSONL path (with ``dump_dir``) or
        the record list; either way the trip itself lands in the ring so a
        later dump shows the earlier incidents."""
        with self._lock:
            events = list(self._ring)
            n_trip = len(self.trips)
            seq, dropped = self._seq, self.dropped
        records = [{"record": "flight_dump", "reason": reason,
                    "detail": detail or {}, "ts": time.time(),
                    "events": len(events), "total_recorded": seq,
                    "dropped": dropped}]
        records.extend(ev.as_dict() for ev in events)
        path = None
        if self.dump_dir:
            os.makedirs(self.dump_dir, exist_ok=True)
            path = os.path.join(self.dump_dir,
                                f"flight_{n_trip:03d}_{reason}.jsonl")
            with open(path, "w") as fh:
                for rec in records:
                    fh.write(json.dumps(rec, default=str) + "\n")
        with self._lock:
            self.trips.append((reason, path))
        self.record("trip", {"reason": reason, "detail": detail or {},
                             "dump": path})
        return path if path is not None else records


# --------------------------------------------------------------------------
# process-wide default (store payload() / plan-cache registration target)
# --------------------------------------------------------------------------

_DEFAULT: Optional[MemoryLedger] = None


def default_ledger() -> MemoryLedger:
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = MemoryLedger()
    return _DEFAULT


def reset_default_ledger() -> None:
    default_ledger().reset()


def register_store_payload(store, payload, kind: str, extra: int = 0):
    """Register a store's freshly built device payload in the default
    ledger: actual bytes from the payload, predicted bytes from the cost
    model's capacity-derived sizing plus ``extra``, the bytes of the keys
    the store's payload holds beyond the reference's (which
    ``predicted_resident_bytes`` does not price), version from the store's
    monotonic counter.  Re-registration (append -> new payload) replaces
    the previous entry, releasing its bytes; consumers holding the *old*
    payload pin their own tied entries if they want leak tracking."""
    from .cost_model import predicted_resident_bytes
    try:
        predicted = predicted_resident_bytes(store.type)
        if predicted is not None:
            predicted += int(extra)
    except Exception:
        predicted = None
    default_ledger().register(
        (kind, f"{id(store):#x}"), payload, predicted=predicted,
        version=getattr(store, "version", 0), kind=kind)
    return payload


__all__ = ["MemoryLedger", "LedgerEntry", "FlightRecorder", "FlightEvent",
           "default_ledger", "reset_default_ledger",
           "register_store_payload"]
