"""Runtime tracing + metrics: the EXPLAIN ANALYZE substrate of the port.

The counterpart of the reference package's ``core/tracing.py``: the
planner's cost model predicts, and this module supplies the runtime half
of the loop that checks the prediction.

  * :class:`Tracer` — a low-overhead, thread-safe, nestable span recorder.
    Off by default (``ExecContext.tracer is None`` keeps the executor on
    its untouched fast path); when installed, the executor opens one
    :class:`Span` per physical op and store impls annotate the innermost
    open span with their dist strategy and collective-byte attribution.
  * **deferred device values** — per-op observations that live on the
    device (BoundedRel counts, overflow flags) are *deferred*, not
    fetched: the tracer collects the tensors and :meth:`Tracer.resolve`
    moves them all to the host in **one** copy at the end of the run.
    Tracing and ``PlannedFunction.observe`` share this single transfer
    point (:func:`resolve_counts`, both through :func:`_to_host`) — no
    per-op host read, one device sync per run.
  * :class:`RunTrace` — one executed run: spans, resolved count-sink
    observations, per-op ``(impl, features, observed_s)`` calibration
    samples (the dataset ``core.feedback.fit_weights`` refits the cost
    model from), and exporters — structured JSON-lines
    (:meth:`RunTrace.to_jsonl`) and Chrome-trace / Perfetto-loadable JSON
    (:meth:`RunTrace.to_chrome`).

Span wall times are *dispatch* times: CUDA launches are asynchronous, so
an op's span closes when its kernels are queued, and the single
``device_sync`` span at the end of an analyzed run
(``torch.cuda.synchronize``) absorbs whatever work was still in flight.
On the CPU every op runs to its end inside its span and the sync span is
empty.
"""
from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

# device-to-host copies made by :func:`_to_host` since import: one per
# resolved run (read by the tests and the chip smoke)
transfers = 0


# --------------------------------------------------------------------------
# spans
# --------------------------------------------------------------------------


@dataclass
class Span:
    """One timed region: a physical op, a pass, or a whole run."""

    name: str
    cat: str = "op"
    t0: float = 0.0                # perf_counter seconds (tracer-relative)
    dur: float = 0.0               # seconds
    tid: int = 0
    span_id: int = 0
    parent_id: Optional[int] = None
    attrs: dict = field(default_factory=dict)

    @property
    def dur_ms(self) -> float:
        return self.dur * 1e3

    def as_dict(self) -> dict:
        return {"name": self.name, "cat": self.cat, "t0_s": self.t0,
                "dur_ms": self.dur_ms, "tid": self.tid,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "attrs": dict(self.attrs)}


class Tracer:
    """Thread-safe nestable span recorder.

    Each thread keeps its own open-span stack (nesting is per-thread);
    completed spans land in one shared list under a lock.  Tracing is off
    where no tracer is installed (``ExecContext.tracer is None``).
    """

    def __init__(self):
        self.spans: list = []
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._next_id = 0
        self._epoch = time.perf_counter()
        # deferred device-side observations: (span, key, value) — resolved
        # in ONE copy by resolve()
        self._deferred: list = []

    # -- span lifecycle ----------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    @contextmanager
    def span(self, name: str, cat: str = "op", **attrs):
        stack = self._stack()
        with self._lock:
            sid = self._next_id
            self._next_id += 1
        sp = Span(name, cat, time.perf_counter() - self._epoch, 0.0,
                  threading.get_ident(), sid,
                  stack[-1].span_id if stack else None, attrs)
        stack.append(sp)
        try:
            yield sp
        finally:
            sp.dur = (time.perf_counter() - self._epoch) - sp.t0
            stack.pop()
            with self._lock:
                self.spans.append(sp)

    def annotate(self, **attrs) -> None:
        """Attach attrs to the innermost open span of the calling thread
        (store impls report dist strategy / collective bytes this way
        without knowing which physical node wraps them)."""
        stack = self._stack()
        if stack:
            stack[-1].attrs.update(attrs)

    def defer(self, key: str, value) -> None:
        """Record a device-side observation against the innermost open
        span; fetched by :meth:`resolve` in one transfer at end of run."""
        stack = self._stack()
        if stack:
            with self._lock:
                self._deferred.append((stack[-1], key, value))

    def resolve(self, sink=None) -> list:
        """The single device->host transfer point: move every deferred
        observation — and, when given, the run's ``count_sink`` entries —
        to the host in **one** copy, fold the deferred values into their
        spans' attrs, and return the resolved sink (same shape as
        :func:`resolve_counts`)."""
        with self._lock:
            pending, self._deferred = self._deferred, []
        sink = sink or []
        if not pending and not sink:
            return []
        flat = [v for _, _, v in pending]
        for _site, c, cap in sink:
            flat += [c, cap]
        vals = _to_host(flat)
        for (sp, key, _), v in zip(pending, vals):
            sp.attrs[key] = v
        rest = vals[len(pending):]
        return [(site, float(rest[2 * i]), int(rest[2 * i + 1]))
                for i, (site, _c, _cp) in enumerate(sink)]

    # -- views -------------------------------------------------------------
    def by_name(self) -> dict:
        out: dict = {}
        for sp in self.spans:
            out.setdefault(sp.name, []).append(sp)
        return out


def _to_host(values) -> list:
    """Every tensor of ``values`` to the host in **one** copy, each value
    back as the kind the reference's ``_scalarize`` gives it: a 0-d bool
    tensor as ``bool``, an integer one as ``int``, a floating one as
    ``float``, a larger tensor as a numpy array of its dtype.  Other values
    pass through.  The tensors (on the plan's one device) are cast to
    float64, which holds every bool, int32 and float32 value exactly — one
    cast per dtype — and concatenated."""
    global transfers
    out = list(values)
    groups: dict = {}
    for i, v in enumerate(out):
        if isinstance(v, torch.Tensor):
            groups.setdefault(v.dtype, []).append(i)
    if not groups:
        return out
    flat = torch.cat([torch.cat([out[i].reshape(-1) for i in idx])
                      .to(torch.float64) for idx in groups.values()])
    host = flat.cpu().numpy()
    transfers += 1
    at = 0
    for idx in groups.values():
        for i in idx:
            n = out[i].numel()
            out[i] = _scalarize(host[at:at + n], out[i])
            at += n
    return out


def _scalarize(vals: np.ndarray, t: torch.Tensor):
    if t.dim() == 0:
        if t.dtype == torch.bool:
            return bool(vals[0])
        if not (t.dtype.is_floating_point or t.dtype.is_complex):
            return int(vals[0])
        return float(vals[0])
    dt = np.dtype(str(t.dtype).replace("torch.", ""))
    return vals.astype(dt).reshape(tuple(t.shape))


# --------------------------------------------------------------------------
# the shared transfer point for count-sink observations
# --------------------------------------------------------------------------


def resolve_counts(sink) -> list:
    """Resolve accumulated ``count_sink`` entries ``(site, count, capacity)``
    in **one** device->host copy — the single per-run transfer shared by
    ``PlannedFunction.observe`` and EXPLAIN ANALYZE.  Counts accumulate on
    the device during the run; nothing synchronizes until this call.  An
    entry's count or capacity may be a 0-d tensor or a Python scalar."""
    if not sink:
        return []
    flat = []
    for _site, c, cap in sink:
        flat += [c, cap]
    vals = _to_host(flat)
    return [(site, float(vals[2 * i]), int(vals[2 * i + 1]))
            for i, (site, _c, _cap) in enumerate(sink)]


# --------------------------------------------------------------------------
# wire-byte attribution for the mesh-kinded transfers
# --------------------------------------------------------------------------


def xfer_wire_bytes(kind: str, payload_bytes: float, n: int) -> float:
    """Per-shard wire bytes a transfer of ``kind`` actually moves for a
    ``payload_bytes``-sized value on an ``n``-wide data axis — the runtime
    counterpart of the cost model's xfer pricing."""
    n = max(1, int(n))
    if kind == "replicate":            # all-gather: receive the (n-1)/n rest
        return payload_bytes * (n - 1) / n
    if kind == "repartition":          # all-to-all: keep 1/n of the 1/n slice
        return payload_bytes * (n - 1) / (n * n)
    if kind == "spill":                # host round trip: down and back up
        return 2.0 * payload_bytes
    return 0.0                         # pin / local: device-resident


def tree_leaves(value):
    """The leaves of a plan value, as the reference's pytree flattening
    sees them: tensors, dict payloads, lists / tuples, and a BoundedRel's
    ``cols``, ``valid``, ``count`` and ``overflow`` (``None`` is no
    leaf)."""
    if value is None:
        return
    if isinstance(value, dict):
        for v in value.values():
            yield from tree_leaves(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from tree_leaves(v)
    elif hasattr(value, "cols") and hasattr(value, "valid"):
        # duck-typed BoundedRel (no core -> stores import)
        yield from tree_leaves(value.cols)
        yield value.valid
        # the count is lazy: an uncomputed one is a 0-d int32 (4 bytes),
        # counted without launching its reduction
        count = getattr(value, "_count", None)
        yield count if count is not None else _LAZY_COUNT
        yield value.overflow
    else:
        yield value


class _LazyCount:
    nbytes = 4


_LAZY_COUNT = _LazyCount()


def tree_bytes(value) -> int:
    """Static payload size of a plan value: the bytes of every tensor leaf,
    and ``size * itemsize`` (4 bytes for a host int) for any other leaf,
    as the reference counts them."""
    total = 0
    for leaf in tree_leaves(value):
        nb = getattr(leaf, "nbytes", None)
        if nb is None:
            sz = getattr(leaf, "size", 1)
            sz = sz if isinstance(sz, int) else 1
            it = getattr(getattr(leaf, "dtype", None), "itemsize", 4)
            nb = sz * it
        total += int(nb)
    return total


# --------------------------------------------------------------------------
# one executed run
# --------------------------------------------------------------------------


@dataclass
class RunTrace:
    """Everything one analyzed execution observed, merge-ready for
    ``StagedPhysicalPlan.explain(analyze=...)``."""

    spans: list = field(default_factory=list)
    wall_ms: float = 0.0             # whole run, device-synced once
    sync_ms: float = 0.0             # the single end-of-run device sync
    counts: list = field(default_factory=list)   # resolved sink entries
    samples: list = field(default_factory=list)  # (impl, features, obs_s)
    plan_id: str = ""

    # -- views -------------------------------------------------------------
    def span_for(self, node_id: str) -> Optional[Span]:
        for sp in self.spans:
            if sp.name == node_id:
                return sp
        return None

    def op_spans(self) -> list:
        return [sp for sp in self.spans if sp.cat not in ("run", "sync")]

    def collective_totals(self) -> dict:
        """Per-shard collective traffic, aggregated by transfer kind plus
        the store kernels' own collective annotations."""
        out: dict = {}
        for sp in self.spans:
            kind = sp.attrs.get("xfer_kind")
            if kind is not None:
                row = out.setdefault(kind, {"bytes": 0.0, "ops": 0})
                row["bytes"] += float(sp.attrs.get("wire_bytes", 0.0))
                row["ops"] += 1
            cb = sp.attrs.get("coll_bytes")
            if cb is not None:
                coll = sp.attrs.get("coll", "collective")
                row = out.setdefault(coll, {"bytes": 0.0, "ops": 0})
                row["bytes"] += float(cb)
                row["ops"] += 1
        return out

    # -- exporters ---------------------------------------------------------
    def to_jsonl(self, path) -> None:
        """Structured JSON-lines trace log: one header line, then one line
        per span in completion order."""
        own = isinstance(path, (str, os.PathLike))
        fh = open(path, "w") if own else path
        try:
            fh.write(json.dumps({
                "record": "run", "plan_id": self.plan_id,
                "wall_ms": self.wall_ms, "sync_ms": self.sync_ms,
                "spans": len(self.spans),
                "collective_totals": self.collective_totals()}) + "\n")
            for sp in self.spans:
                fh.write(json.dumps({"record": "span", **sp.as_dict()},
                                    default=str) + "\n")
            for site, count, cap in self.counts:
                fh.write(json.dumps({
                    "record": "count", "site": list(map(str, site)),
                    "count": count, "capacity": cap}) + "\n")
        finally:
            if own:
                fh.close()

    def chrome_events(self) -> list:
        """Chrome trace-event list (Perfetto/chrome://tracing loadable):
        ``ph="X"`` complete events in microseconds, plus process/thread
        metadata events, plus ``ph="C"`` **counter-track** events for the
        resolved cardinality observations — every span whose deferred
        count/overflow resolved, and every count-sink site, gets a counter
        sample at the span's (or run's) end so the BoundedRel counts are
        visible in the timeline, not only in the report."""
        pid = os.getpid()
        tids = {}
        events = [{"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
                   "args": {"name": f"repro plan {self.plan_id[:12]}"}}]
        for sp in self.spans:
            tid = tids.setdefault(sp.tid, len(tids))
            events.append({
                "ph": "X", "pid": pid, "tid": tid,
                "name": sp.name, "cat": sp.cat,
                "ts": sp.t0 * 1e6, "dur": sp.dur * 1e6,
                "args": {k: _jsonable(v) for k, v in sp.attrs.items()},
            })
            if "count" in sp.attrs:
                args = {"count": float(sp.attrs["count"])}
                if "overflow" in sp.attrs:
                    args["overflow"] = float(sp.attrs["overflow"] or 0.0)
                events.append({
                    "ph": "C", "pid": pid, "tid": tid,
                    "name": f"count:{sp.name}",
                    "ts": (sp.t0 + sp.dur) * 1e6, "args": args,
                })
        run_end = max((sp.t0 + sp.dur for sp in self.spans), default=0.0)
        for site, count, cap in self.counts:
            events.append({
                "ph": "C", "pid": pid, "tid": 0,
                "name": "count:" + "/".join(map(str, site)),
                "ts": run_end * 1e6,
                "args": {"count": float(count), "capacity": float(cap)},
            })
        for raw, tid in tids.items():
            events.append({"ph": "M", "pid": pid, "tid": tid,
                           "name": "thread_name",
                           "args": {"name": f"thread-{raw}"}})
        return events

    def to_chrome(self, path) -> None:
        doc = {"traceEvents": self.chrome_events(),
               "displayTimeUnit": "ms",
               "otherData": {"plan_id": self.plan_id,
                             "wall_ms": self.wall_ms}}
        own = isinstance(path, (str, os.PathLike))
        fh = open(path, "w") if own else path
        try:
            json.dump(doc, fh)
        finally:
            if own:
                fh.close()


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


def validate_chrome_trace(doc: dict) -> list:
    """Schema check for an exported Chrome trace: returns a list of
    violations, empty when the document is loadable."""
    errs = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["missing traceEvents"]
    evs = doc["traceEvents"]
    if not isinstance(evs, list) or not evs:
        return ["traceEvents empty or not a list"]
    for i, ev in enumerate(evs):
        for k in ("ph", "pid", "tid", "name"):
            if k not in ev:
                errs.append(f"event {i}: missing {k!r}")
        ph = ev.get("ph")
        if ph not in ("X", "M", "B", "E", "i", "C"):
            errs.append(f"event {i}: unknown ph {ph!r}")
        if ph == "X":
            for k in ("ts", "dur"):
                if not isinstance(ev.get(k), (int, float)):
                    errs.append(f"event {i}: non-numeric {k!r}")
        if ph == "C":
            if not isinstance(ev.get("ts"), (int, float)):
                errs.append(f"event {i}: non-numeric 'ts'")
            args = ev.get("args")
            if not isinstance(args, dict) or not args or \
                    any(not isinstance(v, (int, float))
                        for v in args.values()):
                errs.append(f"event {i}: counter args must be a non-empty "
                            f"dict of numeric series")
    return errs
