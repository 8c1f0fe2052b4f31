"""Continuous batching scheduler.

The decode batch has a fixed capacity (``max_batch`` slots — the jitted
batched decode step compiles once at that width).  Requests join a free slot
at a token boundary after their planned prefill, decode one token per
scheduler tick at their own sequence position, and leave at the boundary
where their generation completes — no batch-wide barrier, no reallocation.

Queueing policy: FIFO within a bucket, **longest-waiting-first across
buckets** — the head chosen for the next free slot is the earliest-enqueued
head among all bucket queues (ties broken by bucket for determinism).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class SlotState:
    """One in-flight request occupying a decode-batch slot."""

    request: object                  # ServeRequest
    slot: int
    pos: int                         # next cache position to write
    tok: int                         # token to feed at ``pos``
    out: list = field(default_factory=list)   # generated token ids
    joined_at: float = 0.0
    rm: object = None                # RequestMetrics, attached by the runtime

    @property
    def done(self) -> bool:
        return len(self.out) >= self.request.gen


@dataclass
class _Waiting:
    request: object
    bucket: int
    enqueued_at: float
    seq: int                         # arrival tiebreaker


class TenantScheduler:
    """Per-tenant weighted round-robin over analytical query queues.

    Smooth WRR (the nginx variant): each pick adds every backlogged
    tenant's weight to its credit, the tenant with the highest credit
    wins and pays the total weight back.  Over any window the picks a
    tenant receives are proportional to its weight, and a tenant with an
    empty queue accrues nothing — no starvation, no bursts after idle.
    """

    def __init__(self, weights: Optional[dict] = None,
                 default_weight: int = 1):
        self.weights = dict(weights or {})
        self.default_weight = max(int(default_weight), 1)
        self.queues: dict = {}       # tenant -> deque of items
        self._credit: dict = {}      # tenant -> smooth-WRR credit
        self.picks: dict = {}        # tenant -> granted picks (fairness view)

    def weight_of(self, tenant) -> int:
        return max(int(self.weights.get(tenant, self.default_weight)), 1)

    def enqueue(self, item, tenant="default") -> None:
        self.queues.setdefault(tenant, deque()).append(item)

    def depth(self) -> int:
        return sum(len(q) for q in self.queues.values())

    def pop_next(self):
        """The next item under smooth WRR, or None when all queues are
        empty."""
        backlogged = [t for t, q in self.queues.items() if q]
        if not backlogged:
            return None
        total = 0
        for t in backlogged:
            w = self.weight_of(t)
            self._credit[t] = self._credit.get(t, 0) + w
            total += w
        best = max(backlogged, key=lambda t: (self._credit[t], str(t)))
        self._credit[best] -= total
        self.picks[best] = self.picks.get(best, 0) + 1
        return self.queues[best].popleft()

    def purge(self, pred) -> list:
        """Remove (and return) every queued item matching ``pred``.  A
        timed-out ``run_analyses`` call purges its own stragglers so a
        later call draining the shared queues can never adopt them."""
        removed = []
        for t, q in self.queues.items():
            keep = deque()
            for item in q:
                (removed if pred(item) else keep).append(item)
            self.queues[t] = keep
        return removed

    def drain(self, k: Optional[int] = None) -> list:
        """Up to ``k`` items (all backlogged items when None) in WRR
        order — one admission tick's worth of queries."""
        out = []
        while k is None or len(out) < k:
            item = self.pop_next()
            if item is None:
                break
            out.append(item)
        return out


class ContinuousBatchScheduler:
    def __init__(self, max_batch: int):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.max_batch = max_batch
        self.slots: list = [None] * max_batch
        self.queues: dict = {}       # bucket -> deque[_Waiting]
        self._seq = 0

    # -- waiting side ------------------------------------------------------
    def enqueue(self, request, bucket: int, now: float) -> None:
        self.queues.setdefault(bucket, deque()).append(
            _Waiting(request, bucket, now, self._seq))
        self._seq += 1

    def queue_depth(self) -> int:
        return sum(len(q) for q in self.queues.values())

    def peek_next(self, *, warm_buckets=None) -> Optional[_Waiting]:
        """The longest-waiting head across bucket FIFOs.  With
        ``warm_buckets`` given, only heads whose bucket is warm qualify
        (cold heads wait for a planning window)."""
        best = None
        for bucket, q in self.queues.items():
            if not q:
                continue
            if warm_buckets is not None and bucket not in warm_buckets:
                continue
            head = q[0]
            if best is None or (head.enqueued_at, head.seq) < \
                    (best.enqueued_at, best.seq):
                best = head
        return best

    def pop(self, waiting: _Waiting):
        q = self.queues[waiting.bucket]
        assert q[0] is waiting, "pop must take the queue head"
        return q.popleft().request

    def remove(self, waiting: _Waiting) -> None:
        """Drop a waiting entry from anywhere in its bucket queue (deadline
        expiry and timeout resolution cancel mid-queue, not just heads)."""
        self.queues[waiting.bucket].remove(waiting)

    def waiting(self) -> list:
        """Every queued entry across buckets (deadline sweep order-free)."""
        return [w for q in self.queues.values() for w in q]

    # -- batch side --------------------------------------------------------
    def free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def join(self, request, *, pos: int, tok: int, first_out: int,
             now: float) -> SlotState:
        slot = self.free_slot()
        if slot is None:
            raise RuntimeError("no free decode slot")
        st = SlotState(request, slot, pos, tok, [first_out], now)
        self.slots[slot] = st
        return st

    def leave(self, slot: int) -> SlotState:
        st = self.slots[slot]
        if st is None:
            raise RuntimeError(f"slot {slot} already free")
        self.slots[slot] = None
        return st

    def active(self) -> list:
        return [s for s in self.slots if s is not None]

    def n_active(self) -> int:
        return sum(1 for s in self.slots if s is not None)
