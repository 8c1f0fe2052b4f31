"""BoundedRel: the capacity-bounded relation, the tri-store's one runtime
representation for every filtered / joined / top-k / grouped intermediate.

The port's counterpart of the reference package's ``stores/bounded.py``: a
**fixed-shape struct-of-tensors** (one ``(capacity,)`` tensor per column)
plus

  * ``valid``    — the per-row validity vector (the selection mask),
  * ``count``    — the number of valid rows, a 0-d int32 tensor kept on
    the relation's device (computed lazily from ``valid``),
  * ``overflow`` — a 0-d bool tensor: somewhere upstream, true results did
    not fit a declared capacity and rows were dropped.

It is a plain class (PyTorch needs no pytree registration) with the same
dict-like surface (``rel["col"]``, ``rel["_mask"]``).  Rows with
``valid == False`` carry placeholder values; every consumer weights by
``valid``.  Nothing here reads a device value back to the host.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

MASK = "_mask"


class BoundedRel:
    """Capacity-bounded relation: struct-of-tensors + valid + count."""

    __slots__ = ("cols", "valid", "_count", "overflow")

    def __init__(self, cols: Dict[str, torch.Tensor], valid: torch.Tensor,
                 count=None, overflow=None):
        self.cols = dict(cols)
        self.valid = valid
        self._count = count
        self.overflow = (torch.zeros((), dtype=torch.bool,
                                     device=valid.device)
                         if overflow is None else overflow)

    @property
    def count(self) -> torch.Tensor:
        if self._count is None:
            self._count = self.valid.sum(dtype=torch.int32)
        return self._count

    # -- dict-like surface (compat with the column-dict convention) --------
    def __getitem__(self, name: str):
        if name == MASK:
            return self.valid
        return self.cols[name]

    def __contains__(self, name: str) -> bool:
        return name == MASK or name in self.cols

    def __iter__(self):
        yield from self.cols
        yield MASK

    def keys(self):
        return tuple(self.cols) + (MASK,)

    def items(self):
        for k in self.cols:
            yield k, self.cols[k]
        yield MASK, self.valid

    # -- structure ---------------------------------------------------------
    @property
    def capacity(self) -> int:
        return int(self.valid.shape[0])

    @property
    def device(self) -> torch.device:
        return self.valid.device

    def col_names(self) -> tuple:
        return tuple(self.cols)

    def with_cols(self, cols: Dict[str, torch.Tensor]) -> "BoundedRel":
        """Same cardinality metadata over a different column set."""
        return BoundedRel(cols, self.valid, self._count, self.overflow)

    def narrowed(self, mask: torch.Tensor) -> "BoundedRel":
        """Conjoin a predicate mask: validity and count shrink, capacity
        and column storage do not (the masked-execution realization)."""
        return BoundedRel(self.cols, self.valid & mask, None, self.overflow)

    def __repr__(self):
        cols = ", ".join(self.cols)
        return (f"BoundedRel([{cols}]; capacity={self.capacity}, "
                f"device={self.device})")


def as_bounded(value) -> BoundedRel:
    """Coerce a runtime table value to BoundedRel.  Accepts a BoundedRel
    (returned as-is) or a column dict with an optional ``_mask`` key
    (wrapped; missing mask means fully valid)."""
    if isinstance(value, BoundedRel):
        return value
    cols = {k: v for k, v in value.items() if k != MASK}
    if MASK in value:
        valid = value[MASK]
    else:
        any_col = next(iter(cols.values()))
        valid = torch.ones(any_col.shape[:1], dtype=torch.bool,
                           device=any_col.device)
    return BoundedRel(cols, valid)


def compact_rel(rel: BoundedRel, capacity: Optional[int] = None
                ) -> BoundedRel:
    """Stable prefix compaction: the valid rows, in their original order,
    moved to the front of a (possibly smaller) capacity.

    Each valid row's slot is its exclusive valid-prefix sum; rows whose
    slot is at or past ``capacity`` go to a spill slot that is cut off, so
    no row count is read back to the host.  If more than ``capacity`` rows
    are valid the excess is dropped and ``overflow`` is raised; invalid
    output slots replicate row 0 with ``valid=False``, as in the reference.
    """
    cap = rel.capacity if capacity is None else int(capacity)
    cap = max(1, min(cap, rel.capacity))
    dev = rel.device
    pos = torch.cumsum(rel.valid.to(torch.int32), 0) - 1
    slot = torch.where(rel.valid & (pos < cap), pos,
                       torch.full_like(pos, cap)).long()
    idx = torch.zeros(cap + 1, dtype=torch.long, device=dev)
    idx.scatter_(0, slot, torch.arange(rel.capacity, device=dev))
    idx = idx[:cap]
    cols = {k: v[idx] for k, v in rel.cols.items()}
    count = torch.clamp(rel.count, max=cap).to(torch.int32)
    valid = torch.arange(cap, dtype=torch.int32, device=dev) < count
    overflow = rel.overflow | (rel.count > cap)
    return BoundedRel(cols, valid, count, overflow)
