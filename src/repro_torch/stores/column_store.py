"""Columnar relational store: struct-of-tensors tables.

The port's counterpart of the reference package's ``stores/column_store.py``.
A table value at run time is a :class:`~repro_torch.stores.bounded.BoundedRel`
— one ``(capacity,)`` tensor per column plus a ``valid`` vector and a row
``count`` on the device — so every relational function below is
static-shaped and reads nothing back to the host.

Functions:

  * :func:`filter_mask` — predicate over one column;
  * :func:`hash_join`   — equi-join probe against a *unique-key* build side
    (stable sort + binary search);
  * :func:`hash_join_nonunique` — equi-join against a **non-unique** build
    side: every key match claims a slot of a capacity-bounded,
    validity-prefixed result (overflow flagged, never silent);
  * :func:`group_agg`   — segment-reduce per group id (sum / count / mean /
    max), mask-weighted.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..core.executor import resolve_device
from ..core.ir import TableT, ValidationError
from ..core.ledger import register_store_payload
from ..kernels.graph_kernels import scatter_add_plain
from .bounded import BoundedRel

_CMP = {
    "eq": lambda a, b: a == b,
    "ne": lambda a, b: a != b,
    "lt": lambda a, b: a < b,
    "le": lambda a, b: a <= b,
    "gt": lambda a, b: a > b,
    "ge": lambda a, b: a >= b,
}


class ColumnStore:
    """Host-side container for one table: named columns of equal length.

    Columns are canonicalized to 32-bit on ingest, as in the reference
    (device tables are 32-bit; integer columns whose values would wrap are
    refused rather than corrupted).  ``capacity`` (>= the ingested row
    count) preallocates headroom for :meth:`append`: the pad rows are
    ``valid=False``, and appends within capacity keep the table's shape.
    Every append bumps the monotonic ``version``, which the planner folds
    into the plan-cache key, so plans priced against the old rows are not
    reused.

    ``shards > 1`` declares the table row-partitioned over the mesh's
    ``data`` axis: the capacity rounds up to a shard multiple (the pad
    rows are ``valid=False``) and the type says ``partitioning="row"``.
    """

    def __init__(self, columns: Dict[str, np.ndarray],
                 capacity: Optional[int] = None, shards: int = 1):
        if not columns:
            raise ValidationError("ColumnStore needs >= 1 column")
        lens = {k: len(v) for k, v in columns.items()}
        if len(set(lens.values())) != 1:
            raise ValidationError(f"ragged columns: {lens}")
        self._cols = {k: self._canon_col(k, np.asarray(v))
                      for k, v in columns.items()}
        self.rows = next(iter(lens.values()))
        self.capacity = self.rows if capacity is None else int(capacity)
        if self.capacity < self.rows:
            raise ValidationError(
                f"capacity {self.capacity} < ingested rows {self.rows}")
        self.shards = int(shards)
        if self.shards < 1:
            raise ValidationError(f"shards {self.shards} < 1")
        self.capacity += (-self.capacity) % self.shards
        self.version = 0

    def with_shards(self, shards: int) -> "ColumnStore":
        """This table re-declared as row-partitioned over ``shards`` mesh
        slices (shares the ingested column data)."""
        out = ColumnStore(self._cols, capacity=self.capacity, shards=shards)
        out.rows = self.rows
        out.version = self.version
        return out

    @staticmethod
    def _canon_col(name: str, col: np.ndarray) -> np.ndarray:
        if col.dtype in (np.int64, np.uint64, np.uint32):
            info = np.iinfo(np.int32)
            if col.size and (col.min() < info.min or col.max() > info.max):
                raise ValidationError(
                    f"column {name!r}: int values exceed int32 range; "
                    f"re-key before ingest (device tables are 32-bit)")
            return col.astype(np.int32)
        if col.dtype == np.float64:
            return col.astype(np.float32)
        return col

    @property
    def type(self) -> TableT:
        # expected_count only when headroom exists, as in the reference
        exp = None if self.rows == self.capacity else self.rows
        return TableT(tuple((k, str(v.dtype)) for k, v in self._cols.items()),
                      self.capacity, exp, "row" if self.shards > 1 else None)

    def payload(self, device="cuda") -> BoundedRel:
        """The table on ``device`` (the card unless the caller asks for the
        CPU), registered in the default memory ledger."""
        dev = resolve_device(device)
        pad = self.capacity - self.rows
        cols = {k: torch.from_numpy(np.pad(v, (0, pad)) if pad else v
                                    ).to(dev)
                for k, v in self._cols.items()}
        valid = torch.arange(self.capacity, dtype=torch.int32,
                             device=dev) < self.rows
        rel = BoundedRel(cols, valid,
                         torch.tensor(self.rows, dtype=torch.int32,
                                      device=dev))
        return register_store_payload(self, rel, "column_store")

    def column(self, name: str) -> np.ndarray:
        return self._cols[name][:self.rows]

    def append(self, columns: Dict[str, np.ndarray]) -> "ColumnStore":
        """Append rows (same schema) on the host; the next ``payload()``
        carries them to the device.  Appends beyond ``capacity`` grow it to
        the new row count (a shape, and so a plan-type, change); either way
        ``version`` bumps."""
        if set(columns) != set(self._cols):
            raise ValidationError(
                f"append schema mismatch: {sorted(columns)} vs "
                f"{sorted(self._cols)}")
        lens = {k: len(v) for k, v in columns.items()}
        if len(set(lens.values())) != 1:
            raise ValidationError(f"ragged append: {lens}")
        new = {k: self._canon_col(k, np.asarray(v))
               for k, v in columns.items()}
        for k, v in new.items():
            if v.dtype != self._cols[k].dtype:
                raise ValidationError(
                    f"append column {k!r}: dtype {v.dtype} != "
                    f"{self._cols[k].dtype}")
        for k, v in new.items():
            self._cols[k] = np.concatenate([self._cols[k], v])
        self.rows += next(iter(lens.values()))
        self.capacity = max(self.capacity, self.rows)
        self.capacity += (-self.capacity) % self.shards
        self.version += 1
        return self


# --------------------------------------------------------------------------
# relational functions (pure functions over column tensors)
# --------------------------------------------------------------------------


def filter_mask(col: torch.Tensor, cmp: str, value) -> torch.Tensor:
    if cmp not in _CMP:
        raise ValidationError(f"filter: unknown cmp {cmp!r}")
    return _CMP[cmp](col, value)


def hash_join(lkeys: torch.Tensor, rkeys: torch.Tensor):
    """Equi-join probe: for every left key, the index of the matching right
    row and a match flag.  The build side must have unique keys.

    Returns ``(idx, matched)`` with ``idx.shape == lkeys.shape``; ``idx``
    is int32, like the reference's.
    """
    if rkeys.shape[0] == 0:   # empty build side: every probe row unmatched
        return (torch.zeros(lkeys.shape, dtype=torch.int32,
                            device=lkeys.device),
                torch.zeros(lkeys.shape, dtype=torch.bool,
                            device=lkeys.device))
    order = torch.argsort(rkeys, stable=True)
    sorted_r = rkeys[order]
    pos = torch.searchsorted(sorted_r, lkeys.to(sorted_r.dtype))
    pos = torch.clamp(pos, 0, rkeys.shape[0] - 1)
    idx = order[pos].to(torch.int32)
    matched = sorted_r[pos] == lkeys
    return idx, matched


def hash_join_nonunique(lkeys, lmask, rkeys, rmask, capacity: int):
    """Equi-join with a **non-unique build side**, capacity-bounded.

    Every (valid probe row, valid build row) key match claims one output
    slot, ordered by probe row and, within one probe row, by the build
    side's stable sorted order.  Slots ``[0, count)`` hold matches, the
    rest are placeholders; when the true match total exceeds ``capacity``
    the excess is dropped and ``overflow`` is True.  Invalid build rows are
    skipped by a rank-select over the sorted validity prefix sum.

    The reference accumulates the per-probe ends in float32 and relies on
    every deciding value staying below 2^24; a parallel float scan on the
    card would round its prefixes past 2^24 differently and need not stay
    sorted.  Here the clamped counts (``min(cnt, capacity + 1)``) are
    summed in int64: exact, so the outputs equal the reference's bit for
    bit on every input its capacity guard admits, placeholders included.

    Returns ``(lidx, ridx, valid, count, overflow)``: the first three
    ``(capacity,)`` (int32, int32, bool), ``count`` a 0-d int32 and
    ``overflow`` a 0-d bool, all on the keys' device.
    """
    cap = int(capacity)
    if cap >= 1 << 23:
        raise ValidationError(
            f"bounded_join: capacity {cap} >= 2^23 (the slot-owner search "
            f"needs exact float32 prefix sums in the emitted region)")
    nl, nr = int(lkeys.shape[0]), int(rkeys.shape[0])
    dev = lkeys.device
    if nl == 0 or nr == 0:
        z = torch.zeros(cap, dtype=torch.int32, device=dev)
        return (z, z.clone(), torch.zeros(cap, dtype=torch.bool, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.bool, device=dev))
    order = torch.argsort(rkeys, stable=True)
    sk = rkeys[order]
    cum = torch.cumsum(rmask[order].to(torch.int64), 0, dtype=torch.int64)
    lk = lkeys.to(sk.dtype)
    lo = torch.searchsorted(sk, lk)                   # int64
    hi = torch.searchsorted(sk, lk, right=True)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    before = torch.where(lo > 0, cum[torch.clamp(lo - 1, min=0)], zero)
    upto = torch.where(hi > 0, cum[torch.clamp(hi - 1, min=0)], zero)
    # clamping at cap + 1 keeps every emitted slot's owner and the
    # overflow predicate (total > cap), as in the reference
    cnt = torch.clamp(torch.where(lmask, upto - before, zero), max=cap + 1)
    ends = torch.cumsum(cnt, 0, dtype=torch.int64)   # inclusive ends
    total = ends[-1]
    j = torch.arange(cap, dtype=torch.int64, device=dev)
    # owner probe row of slot j: the first row whose end exceeds j
    i = torch.clamp(torch.searchsorted(ends, j, right=True), 0, nl - 1)
    rank = j - (ends[i] - cnt[i])
    # the rank-th valid sorted build row at or after lo[i]: the first
    # sorted position whose inclusive valid count reaches before + rank + 1
    p = torch.searchsorted(cum, before[i] + rank + 1)
    rpos = order[torch.clamp(p, 0, nr - 1)]
    count = torch.clamp(total, max=cap).to(torch.int32)
    return (i.to(torch.int32), rpos.to(torch.int32), j < count, count,
            total > cap)


def group_agg(values: Optional[torch.Tensor], keys: torch.Tensor,
              num_groups: int, mask: torch.Tensor, fn: str):
    """Mask-weighted segment aggregate of ``values`` per group id; keys
    outside ``[0, num_groups)`` are dropped, as ``segment_sum`` drops them.

    ``fn="max"`` returns a ``(values, valid)`` pair: ``valid[g]`` is False
    for groups with no unmasked rows (whose value slot is filled with 0.0).
    The other aggregates return the value tensor alone.
    """
    w = mask.to(torch.float32)
    if fn == "count":
        return scatter_add_plain(w, keys, num_groups)
    v = values.to(torch.float32)
    if fn == "sum":
        return scatter_add_plain(v * w, keys, num_groups)
    if fn == "mean":
        s = scatter_add_plain(v * w, keys, num_groups)
        c = scatter_add_plain(w, keys, num_groups)
        return s / torch.clamp(c, min=1.0)
    if fn == "max":
        g = int(num_groups)
        ok = mask & (keys >= 0) & (keys < g)
        idx = torch.where(ok, keys, torch.full_like(keys, g)).long()
        m = torch.full((g + 1,), -torch.inf, dtype=torch.float32,
                       device=v.device)
        m = m.scatter_reduce(0, idx, torch.where(ok, v, -torch.inf),
                             reduce="amax")[:g]
        valid = torch.isfinite(m)
        return torch.where(valid, m, torch.zeros_like(m)), valid
    raise ValidationError(f"group_agg: unknown fn {fn!r}")
