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
  * :func:`group_agg`   — segment-reduce per group id (sum / count / mean /
    max), mask-weighted.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..core.executor import resolve_device
from ..core.ir import TableT, ValidationError
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
    count) preallocates headroom: the pad rows are ``valid=False``.
    """

    def __init__(self, columns: Dict[str, np.ndarray],
                 capacity: Optional[int] = None):
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
        self.version = 0

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
                      self.capacity, exp, None)

    def payload(self, device="cuda") -> BoundedRel:
        """The table on ``device`` (the card unless the caller asks for the
        CPU)."""
        dev = resolve_device(device)
        pad = self.capacity - self.rows
        cols = {k: torch.from_numpy(np.pad(v, (0, pad)) if pad else v
                                    ).to(dev)
                for k, v in self._cols.items()}
        valid = torch.arange(self.capacity, dtype=torch.int32,
                             device=dev) < self.rows
        return BoundedRel(cols, valid,
                          torch.tensor(self.rows, dtype=torch.int32,
                                       device=dev))

    def column(self, name: str) -> np.ndarray:
        return self._cols[name][:self.rows]


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
