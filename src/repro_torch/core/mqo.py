"""Multi-query optimization: cross-query subplan dedup over content hashes.

Concurrent analytical queries on a shared tri-store overlap heavily — the
same scans, the same filtered relations, the same PageRank over the same
graph snapshot — yet each ``run_analysis`` call so far executed its plan
alone.  This module is the sharing layer:

  * **Runtime sub-DAG keys** — :func:`ir.subdag_fingerprints` over the
    staged plan's concrete physical plan, with every reachable plan input
    bound to a runtime identity (:func:`input_keys_for`: bound-store
    *versions*, small-argument content hashes) and the staged plan's
    ``mqo_salt`` (cost-model + feedback fingerprints) folded in.  Two
    queries' nodes get the same key iff the value computed under them is
    identical — across textually different programs, across processes.
  * :class:`SubplanCache` — key -> materialized intermediate (BoundedRel /
    graph / score pytrees), LRU with **byte-budget** eviction, every entry
    registered in the :class:`~repro_torch.core.ledger.MemoryLedger` under
    owner kind ``"subplan"`` and tied to the producing store's ledger entry
    + version, so an append makes lingering reuse visible as a ledger leak
    (and :meth:`SubplanCache.note_store` evicts it eagerly).  An eviction
    rate above threshold inside the telemetry window trips the flight
    recorder (``subplan_thrash``) with the recent MQO frontier decisions
    in the dump.
  * :func:`mqo_run` — the CSE execution pass: split the concrete plan at
    the cache-hit **frontier**, execute only the residual suffix
    (:func:`~repro_torch.core.executor.run_plan_subset`), insert the fresh
    intermediates back.  Reused values are the exact arrays an identical
    computation produced, so results are bitwise-identical to an isolated
    run by construction.

Single-flighting of *concurrent* identical sub-DAGs lives in the serving
runtime's admission loop (``AsyncServingRuntime.run_analyses``): queries
admitted in one tick are grouped by root key before execution, and an
in-flight future map covers queries arriving while a twin still runs.

The port's copy of the reference package's ``core/mqo.py``.  One part is
its own: :func:`content_key` hashes a tensor leaf by its numpy dtype name,
its shape and its bytes on the host, so a key equals the reference's for
the same numpy input (a bfloat16 leaf hashes its bits under the name
``bfloat16``, which is what ml_dtypes gives the reference).  Only leaves
within ``_MAX_HASH_BYTES`` are copied to the host; each copy of a card
tensor is one host sync, counted in ``host_copies``.  Store payloads are
keyed by their version (``ver:``) and never hashed.
"""
from __future__ import annotations

import hashlib
import itertools
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch

from .executor import run_plan_subset
from .ir import subdag_fingerprints
from .tracing import tree_bytes

# content-hash cap: arguments above this (store payloads, big frontiers)
# get a unique key instead — hashing megabytes per admission would cost
# more than the sharing wins
_MAX_HASH_BYTES = 1 << 22

_uniq = itertools.count()

# card -> host copies content_key has made (one host sync each)
host_copies = 0

# impls whose output is an alias of an input or a constant — caching them
# would double-count bytes in the ledger without saving any work
_SKIP_CACHE_IMPLS = frozenset({
    "identity", "store", "const", "virtual",
    "xfer_pin", "xfer_local", "xfer_repartition",
})


def content_key(value, *, max_bytes: int = _MAX_HASH_BYTES) -> Optional[str]:
    """sha256 over a small argument pytree's leaf bytes (dtype + shape +
    data, dict keys sorted); None when the pytree is too large to hash or
    contains unhashable leaves.  Every leaf is framed with a type tag and
    a terminator, and containers emit open/close markers, so adjacent
    values can never run together: ``[1, 2]`` != ``[12]``, ``{}`` !=
    ``[]``, ``[1.5, 2]`` != ``[1.52]``."""
    h = hashlib.sha256()
    total = 0

    def walk(v):
        nonlocal total
        if isinstance(v, dict):
            h.update(b"{")
            for k in sorted(v):
                h.update(b"k:" + repr(k).encode() + b"=")
                if not walk(v[k]):
                    return False
            h.update(b"}")
            return True
        if isinstance(v, (list, tuple)):
            h.update(b"[" if isinstance(v, list) else b"(")
            for x in v:
                if not walk(x):
                    return False
            h.update(b"]" if isinstance(v, list) else b")")
            return True
        if hasattr(v, "shape") and hasattr(v, "dtype"):
            if isinstance(v, torch.Tensor):
                total += v.numel() * v.element_size()
                if total > max_bytes:
                    return False
                leaf = _host_leaf(v)
                if leaf is None:
                    return False
                dtype, shape, data = leaf
            else:
                a = np.asarray(v)
                total += a.nbytes
                if total > max_bytes:
                    return False
                dtype, shape, data = str(a.dtype), a.shape, a.tobytes()
            # dtype + shape frame the raw bytes: their length is fixed
            # given the header, so no delimiter can be forged by data
            h.update(b"a:" + dtype.encode()
                     + b":" + repr(shape).encode() + b":")
            h.update(data)
            h.update(b";")
            return True
        if isinstance(v, (int, float, bool, str, bytes, type(None))):
            h.update(type(v).__name__.encode()
                     + b":" + repr(v).encode() + b";")
            return True
        return False

    if not walk(value):
        return None
    return "sha:" + h.hexdigest()


def _host_leaf(t: torch.Tensor):
    """``(numpy dtype name, shape, bytes)`` of a tensor leaf, copied to the
    host; None for a dtype numpy cannot name (it is then unhashable).
    bfloat16 carries its bits under the name ``bfloat16``."""
    global host_copies
    t = t.detach()
    if t.device.type != "cpu":
        host_copies += 1
        t = t.cpu()
    shape = tuple(int(d) for d in t.shape)
    if t.dtype == torch.bfloat16:
        return "bfloat16", shape, t.contiguous().view(torch.int16).numpy(
        ).tobytes()
    try:
        a = t.numpy()
    except TypeError:
        return None
    return str(a.dtype), shape, a.tobytes()


def input_keys_for(inputs: Mapping[str, Any],
                   versions: Any = ()) -> dict:
    """Runtime identity per plan input, the ``leaf_keys`` of a sub-DAG key.

    ``versions``: the bound stores' ``(name, version)`` vector (what
    ``adil.Analysis.store_versions`` returns) or an equivalent mapping.
    A versioned input's key is its version — O(1), and an append provably
    changes it.  Unversioned inputs are content-hashed when small; inputs
    too large to hash get a **unique** key, so they can never produce a
    false cache hit (only missed sharing)."""
    vmap = dict(versions)
    keys = {}
    for name, v in inputs.items():
        if name in vmap:
            keys[name] = f"ver:{name}:{int(vmap[name])}"
            continue
        ck = content_key(v)
        keys[name] = ck if ck is not None else \
            f"uniq:{name}:{next(_uniq)}"
    return keys


def params_key(params) -> str:
    """Runtime identity of a query's parameter pytree.  Physical ops read
    params through ``ctx.params_for`` (pp-attr bindings), so two queries
    with equal plans and inputs but different params compute different
    values — the params identity must reach every sub-DAG key.  Empty
    params (the analytical common case) map to a constant so param-free
    queries share freely; non-empty params are content-hashed when small,
    and params too large to hash get a **unique** key — no sharing, but
    never a false hit."""
    if not params:
        return "noparams"
    ck = content_key(params)
    return ck if ck is not None else f"uniq:params:{next(_uniq)}"


class SubplanCache:
    """Content-keyed LRU of materialized sub-DAG intermediates.

    Values are whatever the physical op produced — BoundedRel pytrees,
    CSR frontier vectors, score arrays — held device-resident so a hit
    replaces the entire sub-DAG's execution with a dict lookup.  Bytes are
    bounded by ``byte_budget`` with LRU eviction; each entry registers in
    the ledger under ``("subplan", key)``, tied to the producing store's
    ledger entry at the version it was materialized from.

    Thrash detection: insertions and evictions land in a sliding window;
    when the eviction fraction over a full window reaches
    ``thrash_rate``, the flight recorder trips a ``subplan_thrash`` dump
    carrying the cache stats and the recent MQO frontier decisions —
    the working set no longer fits and queries are evicting each other's
    intermediates instead of sharing them.
    """

    def __init__(self, byte_budget: int = 64 << 20, *,
                 max_entries: int = 512, ledger=None, recorder=None,
                 registry=None, thrash_window: int = 32,
                 thrash_rate: float = 0.5):
        if byte_budget < 1:
            raise ValueError(f"byte_budget must be >= 1, got {byte_budget}")
        self.byte_budget = int(byte_budget)
        self.max_entries = int(max_entries)
        self._ledger = ledger
        self.recorder = recorder
        self.registry = registry
        self._lock = threading.RLock()
        self._entries: OrderedDict = OrderedDict()   # key -> value
        self._sizes: dict = {}                       # key -> bytes
        self._stores: dict = {}    # key -> ((store name, version), ...)
        self.bytes_in_cache = 0
        self.hits = 0
        self.misses = 0
        self.insertions = 0
        self.evictions = 0
        self.version_evictions = 0
        self.oversize_skips = 0
        self.thrash_window = int(thrash_window)
        self.thrash_rate = float(thrash_rate)
        self._events: deque = deque(maxlen=self.thrash_window)  # 1 = evict
        self.thrash_trips = 0
        self.frontier_log: deque = deque(maxlen=32)

    @property
    def ledger(self):
        if self._ledger is None:
            from .ledger import default_ledger
            self._ledger = default_ledger()
        return self._ledger

    # -- lookup / insert ----------------------------------------------------
    def lookup(self, key: str):
        """The cached intermediate under ``key`` (refreshing recency) or
        None.  Returns the value itself — entries are treated as immutable
        by every consumer, exactly like plan-cache entries."""
        with self._lock:
            if key not in self._entries:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            if self.registry is not None:
                self.registry.count("analytics.shared_hits")
            return self._entries[key]

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._entries

    def insert(self, key: str, value, *, stores: Sequence[tuple] = (),
               tied_to=None) -> bool:
        """Insert a materialized intermediate.  ``stores``: the
        ``(name, version)`` pairs of the bound stores this value was
        computed from (recorded for :meth:`note_store` invalidation);
        ``tied_to``: the producing store's ledger owner, giving the entry
        a lifetime anchor — once the store re-registers at a new version,
        a lingering entry shows up in ``ledger.leaks()`` as superseded.
        Returns False when the value alone exceeds the byte budget (not
        cached, counted in ``oversize_skips``)."""
        nb = int(tree_bytes(value))
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                return True
            if nb > self.byte_budget:
                self.oversize_skips += 1
                return False
            while (self.bytes_in_cache + nb > self.byte_budget
                   or len(self._entries) >= self.max_entries):
                self._evict_lru()
            self._entries[key] = value
            self._sizes[key] = nb
            self._stores[key] = tuple(stores)
            self.bytes_in_cache += nb
            ver = None
            if stores:
                ver = int(stores[0][1])
            self.ledger.register(("subplan", key), nbytes=nb,
                                 kind="subplan", version=ver,
                                 tied_to=tied_to)
            self.insertions += 1
            self._events.append(0)
            self._publish()
        return True

    def _evict_lru(self) -> None:
        key, _ = self._entries.popitem(last=False)
        self.bytes_in_cache -= self._sizes.pop(key, 0)
        self._stores.pop(key, None)
        self.ledger.release(("subplan", key))
        self.evictions += 1
        self._events.append(1)
        self._maybe_trip()

    def note_store(self, name: str, version: int) -> int:
        """A bound store moved to ``version``: evict every entry
        materialized from an older version of it.  Runtime keys fold the
        version in, so stale entries could never be *hit* again — this
        reclaims their bytes eagerly instead of waiting for LRU pressure
        (and clears the would-be ledger leak).  Returns evictions."""
        dropped = 0
        with self._lock:
            victims = [k for k, sv in self._stores.items()
                       if any(n == name and int(v) != int(version)
                              for n, v in sv)]
            for k in victims:
                del self._entries[k]
                self.bytes_in_cache -= self._sizes.pop(k, 0)
                self._stores.pop(k, None)
                self.ledger.release(("subplan", k))
                self.version_evictions += 1
                dropped += 1
            if dropped:
                self._publish()
        return dropped

    def note_versions(self, versions: Any) -> int:
        """Vector form of :meth:`note_store` (``(name, version)`` pairs)."""
        return sum(self.note_store(n, v) for n, v in dict(versions).items())

    # -- thrash detection ---------------------------------------------------
    def note_frontier(self, decision: dict) -> None:
        """Record one MQO frontier split (plan id, hit/executed node
        counts) — the context a thrash dump needs to show *which* queries
        were fighting over the budget."""
        self.frontier_log.append(dict(decision, ts=time.time()))

    def _maybe_trip(self) -> None:
        if self.recorder is None or len(self._events) < self.thrash_window:
            return
        rate = sum(self._events) / len(self._events)
        if rate < self.thrash_rate:
            return
        self.thrash_trips += 1
        self._events.clear()           # one trip per full thrashing window
        self.recorder.trip("subplan_thrash", {
            "eviction_rate": rate, "window": self.thrash_window,
            "stats": self.stats(),
            "frontiers": list(self.frontier_log)})

    # -- bookkeeping ---------------------------------------------------------
    def _publish(self) -> None:
        if self.registry is not None:
            self.registry.gauge("subplan.bytes").set(self.bytes_in_cache)
            self.registry.gauge("subplan.entries").set(len(self._entries))

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def clear(self) -> None:
        with self._lock:
            self.ledger.release_kind("subplan")
            self._entries.clear()
            self._sizes.clear()
            self._stores.clear()
            self.bytes_in_cache = 0
            self._events.clear()
            self._publish()

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "entries": len(self._entries),
                "bytes": self.bytes_in_cache,
                "byte_budget": self.byte_budget,
                "hits": self.hits,
                "misses": self.misses,
                "insertions": self.insertions,
                "evictions": self.evictions,
                "version_evictions": self.version_evictions,
                "oversize_skips": self.oversize_skips,
                "thrash_trips": self.thrash_trips,
                "hit_rate": (self.hits / total) if total else 0.0,
            }

    def __repr__(self):
        s = self.stats()
        return (f"SubplanCache(entries={s['entries']} "
                f"bytes={s['bytes']}/{s['byte_budget']} "
                f"hits={s['hits']} misses={s['misses']})")


# --------------------------------------------------------------------------
# the CSE pass: frontier split + residual execution
# --------------------------------------------------------------------------


def subdag_keys(planned, inputs: Mapping[str, Any], *,
                versions: Any = (), params: Any = None,
                input_keys: Optional[Mapping[str, str]] = None) -> dict:
    """Runtime sub-DAG keys for one query: every concrete-plan node's
    content hash with this call's input identities, params identity
    (:func:`params_key` — ops read params through pp-attr bindings, so
    params are as much an input as ``inputs``), and the staged plan's
    salt folded in.  ``planned`` is a PlannedFunction (or anything with
    ``concrete`` + optionally ``staged``)."""
    keys = dict(input_keys) if input_keys is not None else \
        input_keys_for(inputs, versions)
    staged = getattr(planned, "staged", None)
    salt = getattr(staged, "mqo_salt", "") if staged is not None else ""
    salt = f"{salt}|{params_key(params)}"
    return subdag_fingerprints(planned.concrete, leaf_keys=keys, salt=salt)


def split_at_frontier(pplan, keys: Mapping[str, str],
                      cache: SubplanCache) -> tuple:
    """Walk the concrete plan backward from its outputs, stopping at
    cache-hit nodes.  Returns ``(hits, residual)``: node id -> cached
    value for the frontier, and the (topo-ordered) residual node ids that
    still need executing.  A fully cached plan returns an empty
    residual.  The walk uses an explicit stack (like ``run_plan``/``topo``)
    so plan depth never hits Python's recursion limit."""
    hits: dict = {}
    residual: list = []
    seen: set = set()
    stack = list(pplan.outputs)
    while stack:
        ref = stack.pop()
        if ref in seen or ref not in pplan.nodes:
            continue                    # plan input, or already resolved
        seen.add(ref)
        key = keys.get(ref)
        val = cache.lookup(key) if key is not None else None
        if val is not None:
            hits[ref] = val
            continue
        residual.append(ref)
        stack.extend(pplan.nodes[ref].inputs)
    order = {n.id: i for i, n in enumerate(pplan.topo())}
    residual.sort(key=order.__getitem__)
    return hits, residual


def mqo_run(planned, params, inputs: Mapping[str, Any], *,
            cache: SubplanCache, versions: Any = (),
            input_keys: Optional[Mapping[str, str]] = None,
            aux: Optional[dict] = None, keys: Optional[dict] = None,
            tied_to=None):
    """Execute a planned analytical function through the subplan cache.

    Equivalent to ``planned(params, inputs)`` — bitwise so, since reused
    intermediates are the arrays an identical sub-DAG produced — but only
    the residual suffix past the cache-hit frontier actually runs.  Fresh
    non-trivial intermediates are inserted for the next query, recorded
    against ``versions`` (the bound stores' ``(name, version)`` vector)
    and ledger-tied to ``tied_to`` (the producing store's ledger owner,
    when the caller holds it).  Returns ``(outputs, info)`` where ``info``
    carries the frontier decision (``shared_hits`` / ``executed`` /
    ``total``)."""
    pplan = planned.concrete
    if keys is None:
        keys = subdag_keys(planned, inputs, versions=versions,
                           params=params, input_keys=input_keys)
    hits, residual = split_at_frontier(pplan, keys, cache)
    ctx = planned._context(params, inputs, aux)
    env = dict(inputs)
    env.update(hits)
    env = run_plan_subset(pplan, ctx, env, residual)
    vers = tuple(dict(versions).items())
    for nid in residual:
        n = pplan.nodes[nid]
        if n.impl in _SKIP_CACHE_IMPLS or n.virtual:
            continue
        key = keys.get(nid)
        if key is not None:
            cache.insert(key, env[nid], stores=vers, tied_to=tied_to)
    info = {"plan_id": getattr(planned, "plan_id", ""),
            "shared_hits": len(hits), "executed": len(residual),
            "total": len(pplan.nodes)}
    cache.note_frontier(info)
    outs = tuple(env[o] for o in pplan.outputs)
    return (outs if len(outs) > 1 else outs[0]), info


__all__ = ["SubplanCache", "content_key", "input_keys_for", "params_key",
           "subdag_keys", "split_at_frontier", "mqo_run"]
