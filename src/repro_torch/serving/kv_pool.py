"""Preallocated paged KV-cache pool with per-request page tables.

The port of the reference's ``serving/kv_pool.py``.  The pool allocates the
full decode cache **once** — batch axis = ``n_slots``, sequence axis =
``max_seq`` — and batch-membership changes are pure bookkeeping: a joining
request claims a free slot and its prefill K/V is written into that slot's
rows; a leaving request only returns its slot and pages.  Nothing is
reallocated.  Where the reference rebinds a donated, functionally updated
cache, the port writes the slot's rows **in place** (``seed``), and the
decode step writes each slot's new position in place too.

Sequence capacity is accounted in fixed-size **pages**: a request holds
``ceil(tokens / page_size)`` pages from a global budget, recorded in its
:class:`PageTable`, and acquires its next page lazily as decode crosses a
page boundary.  Pages are slot-local — physical page ``(slot, j)`` backs
logical page ``j`` — which keeps every per-request cache region contiguous
(attention needs no gather) while still giving the admission side a
token-granular occupancy signal: with ``page_budget`` below ``n_slots *
pages_per_slot`` the pool refuses joins on memory pressure even when slots
are free.  The recurrent families' slots hold their rwkv / mamba state
beside any K/V; ``adopt`` (the replay fallback) writes a whole batch-1
decode cache into a slot.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

from ..models.decode import attn_block_indices, init_cache


@dataclass
class PageTable:
    """Logical→physical page map for one request (pages are slot-local)."""

    request_id: object
    slot: int
    page_size: int
    pages: list = field(default_factory=list)   # [(slot, j), ...] in order

    @property
    def n_tokens_capacity(self) -> int:
        return len(self.pages) * self.page_size

    def covers(self, n_tokens: int) -> bool:
        return n_tokens <= self.n_tokens_capacity


class PagedKVPool:
    def __init__(self, model, n_slots: int, max_seq: int, *,
                 page_size: int = 16, page_budget: int | None = None,
                 registry=None, ledger=None, device=None):
        if n_slots < 1 or max_seq < 1 or page_size < 1:
            raise ValueError("n_slots, max_seq, page_size must be >= 1")
        self.model = model
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.page_size = page_size
        self.pages_per_slot = math.ceil(max_seq / page_size)
        total = n_slots * self.pages_per_slot
        self.page_budget = total if page_budget is None else \
            min(page_budget, total)
        # the one allocation: full-length caches (prefill_kv seeding and
        # per-slot decode positions need non-ring layouts)
        self.cache = init_cache(model, n_slots, max_seq, device=device)
        self._free_slots = list(range(n_slots))
        self._tables: dict = {}      # request_id -> PageTable
        self.pages_in_use = 0
        # occupancy/fragmentation gauges live in the shared registry; the
        # ledger records the one allocation — resident for the pool's
        # lifetime, so it never re-registers
        self.registry = registry
        if ledger is not None:
            ledger.register(("kv_pool", f"{id(self):#x}"), self.cache,
                            kind="kv_pool")
        self._update_gauges()

    # -- admission-facing capacity -----------------------------------------
    def pages_for(self, n_tokens: int) -> int:
        return max(1, math.ceil(n_tokens / self.page_size))

    def can_admit(self, n_tokens: int) -> bool:
        if n_tokens > self.max_seq:
            return False
        return bool(self._free_slots) and \
            self.pages_in_use + self.pages_for(n_tokens) <= self.page_budget

    # -- page-table lifecycle ----------------------------------------------
    def alloc(self, request_id, n_tokens: int) -> PageTable | None:
        """Claim a slot + the pages covering ``n_tokens`` (the prompt).
        Returns None when out of slots or pages (caller keeps queueing)."""
        if request_id in self._tables:
            raise ValueError(f"request {request_id!r} already in pool")
        if not self.can_admit(n_tokens):
            return None
        slot = self._free_slots.pop(0)
        n_pages = self.pages_for(n_tokens)
        pt = PageTable(request_id, slot, self.page_size,
                       [(slot, j) for j in range(n_pages)])
        self._tables[request_id] = pt
        self.pages_in_use += n_pages
        self._update_gauges()
        return pt

    def extend(self, request_id, n_tokens: int) -> bool:
        """Grow a request's page table to cover ``n_tokens`` (decode crossing
        a page boundary).  False when the budget or the slot is exhausted —
        the runtime must finish/evict the request."""
        pt = self._tables[request_id]
        if pt.covers(n_tokens):
            return True
        if n_tokens > self.max_seq:
            return False
        need = self.pages_for(n_tokens) - len(pt.pages)
        if self.pages_in_use + need > self.page_budget:
            return False
        start = len(pt.pages)
        pt.pages.extend((pt.slot, j) for j in range(start, start + need))
        self.pages_in_use += need
        self._update_gauges()
        return True

    def free(self, request_id) -> int:
        """Release a request's slot and pages; returns the freed slot."""
        pt = self._tables.pop(request_id)
        self.pages_in_use -= len(pt.pages)
        self._free_slots.append(pt.slot)
        self._free_slots.sort()
        if self.registry is not None:
            # final page count = the request's lifetime footprint
            self.registry.summary("kv.pages_per_request").observe(
                len(pt.pages))
        self._update_gauges()
        return pt.slot

    def table(self, request_id) -> PageTable:
        return self._tables[request_id]

    def holds(self, request_id) -> bool:
        """True while the request owns a slot + pages."""
        return request_id in self._tables

    # -- data path ----------------------------------------------------------
    @torch.inference_mode()
    def seed(self, request_id, kv_groups, prompt_len: int) -> int:
        """Write a batch-1 ``prefill_kv`` plan output into the request's
        slot, in place; returns the slot.  The full bucket (prompt + right
        padding) is written: padded positions are never read — decode
        overwrites position p before the valid mask reaches it.  O(bucket)
        data movement — the join cost."""
        pt = self._tables[request_id]
        for g, kv_g in zip(self.model.groups, kv_groups):
            gc = self.cache[g.name]
            for bi, (k, v) in zip(attn_block_indices(g), kv_g):
                if k.shape[2] > self.max_seq:
                    raise ValueError(
                        "KV pool needs full-length caches: bucket "
                        f"{k.shape[2]} > max_seq {self.max_seq}")
                for key, val in ((f"b{bi}_k", k), (f"b{bi}_v", v)):
                    leaf = gc[key]
                    leaf[:, pt.slot, :val.shape[2]] = val[:, 0].to(leaf.dtype)
        return pt.slot

    @torch.inference_mode()
    def adopt(self, request_id, cache1) -> int:
        """Write a batch-1 decode cache (the replay fallback's: the prompt
        replayed through the decode step) into the request's slot, in
        place: every leaf — K/V and recurrent state alike — so nothing of
        the slot's earlier occupant or of a warm-up step survives.  Returns
        the slot."""
        pt = self._tables[request_id]
        for g, gc in self.cache.items():
            src = cache1[g]
            if src.keys() != gc.keys():
                raise ValueError(f"adopt: cache group {g} has leaves "
                                 f"{sorted(src)}, the pool {sorted(gc)}")
            for key, leaf in gc.items():
                if src[key].shape[1] != 1 or \
                        src[key].shape[2:] != leaf.shape[2:]:
                    raise ValueError(
                        f"adopt: {g}/{key} is {tuple(src[key].shape)}, the "
                        f"pool's slot needs {(leaf.shape[0], 1)} + "
                        f"{tuple(leaf.shape[2:])}")
                leaf[:, pt.slot] = src[key][:, 0].to(leaf.dtype)
        return pt.slot

    def occupancy(self) -> dict:
        return {
            "slots_used": self.n_slots - len(self._free_slots),
            "n_slots": self.n_slots,
            "pages_used": self.pages_in_use,
            "page_budget": self.page_budget,
            "page_size": self.page_size,
            "fill": self.pages_in_use / max(self.page_budget, 1),
        }

    def fragmentation(self) -> dict:
        """Free-space shape, not just amount.  Pages are slot-local and
        each slot's used pages are a prefix, so the free space is one tail
        run per slot; ``max_contig_free_run`` — the longest such run,
        counting runs that span consecutive fully-free slots — is the
        largest single-request footprint that can still be admitted
        without eviction."""
        free_pages = self.page_budget - self.pages_in_use
        used_by_slot = {}
        for pt in self._tables.values():
            used_by_slot[pt.slot] = used_by_slot.get(pt.slot, 0) \
                + len(pt.pages)
        max_run = 0
        cur = 0
        for slot in range(self.n_slots):
            used = used_by_slot.get(slot, 0)
            if used:
                max_run = max(max_run, cur)
                cur = self.pages_per_slot - used
            else:
                cur += self.pages_per_slot
        max_run = max(max_run, cur)
        # the budget caps any admission below the geometric free run
        max_run = min(max_run, free_pages)
        return {"free_pages": free_pages,
                "free_slots": len(self._free_slots),
                "max_contig_free_run": max_run}

    def _update_gauges(self) -> None:
        if self.registry is None:
            return
        frag = self.fragmentation()
        self.registry.gauge("kv.free_pages").set(frag["free_pages"])
        self.registry.gauge("kv.free_slots").set(frag["free_slots"])
        self.registry.gauge("kv.max_contig_free_run").set(
            frag["max_contig_free_run"])
        self.registry.gauge("kv.fill").set(
            self.pages_in_use / max(self.page_budget, 1))


__all__ = ["PagedKVPool", "PageTable", "attn_block_indices"]
