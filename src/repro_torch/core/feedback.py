"""Observed-selectivity feedback: calibrate cardinality estimates from
executed plans.

The planner's selectivity story (pushdown) was purely *a priori*: an explicit
``selectivity=`` hint or a per-comparator heuristic.  A mis-hinted filter
therefore mis-prices every masked candidate downstream and the planner
cannot recover.  This module closes the loop:

  * the executor, when asked to **observe** a run
    (``PlannedFunction.observe``), records the actual ``count / capacity``
    of every ``rel_filter`` / ``sel_mask`` site — BoundedRel makes the
    observed count a first-class runtime value;
  * observations accumulate per **site key** — a content key derived from
    the op's attrs (column, comparator, value), so the same predicate is
    recognized across recompiles and rewrite-induced node renames;
  * on re-plan, the rewrite layer's ``estimate_selectivity`` blends the
    observed fraction over the hint/heuristic (observation-weighted), so a
    mis-hinted selectivity self-corrects;
  * the feedback state's ``fingerprint()`` is folded into the staged plan
    id, so a re-plan under new observations is a **plan-cache miss** —
    stale plans priced on stale estimates are never reused.

The feedback object is caller-owned (scope it per workload / per serving
bucket family); the active one is installed for the duration of a planning
run via :func:`activate_feedback` (a context variable, so threaded
planning stays correct).
"""
from __future__ import annotations

import contextlib
import contextvars
import hashlib
from typing import Optional

# weight of the observed fraction when blending over the a-priori estimate
FEEDBACK_BLEND = 0.8

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "selectivity_feedback", default=None)


def filter_site(attrs, cols=None, capacity=None) -> tuple:
    """Site key of one ``rel_filter`` instance: the predicate plus the
    input relation's column schema and capacity.  Schema + capacity
    disambiguate same-shaped predicates over *different* tables — without
    them, one table's observed fraction would leak into another's
    compaction decisions.  (Both survive compaction and rerouting
    consistently: the rewrite-time input type and the run-time relation
    agree on column set and capacity at every filter site.)  Distinct
    same-schema, same-capacity tables still alias; scope feedback objects
    per workload when that matters."""
    return ("rel_filter", tuple(cols) if cols else (),
            None if capacity is None else int(capacity),
            str(attrs.get("col")), str(attrs.get("cmp")),
            repr(attrs.get("value")))


def sel_mask_site(attrs) -> tuple:
    """Site key of one ``sel_mask`` export: column + entity domain."""
    return ("sel_mask", str(attrs.get("col")), int(attrs.get("size", 0)))


class SelectivityFeedback:
    """Per-site EMA of observed ``count / capacity`` fractions."""

    def __init__(self, ema: float = 0.5):
        self.ema = float(ema)
        self._obs: dict = {}          # site key -> (fraction, n_observations)
        self._overflowed: set = set()  # sites whose compaction dropped rows

    def record(self, site: tuple, count, capacity) -> float:
        """Fold one observation in; returns the site's updated fraction."""
        cap = max(1, int(capacity))
        frac = min(1.0, max(0.0, float(count) / cap))
        prev = self._obs.get(site)
        if prev is None:
            cur = frac
            n = 1
        else:
            cur = (1.0 - self.ema) * prev[0] + self.ema * frac
            n = prev[1] + 1
        self._obs[site] = (cur, n)
        return cur

    def lookup(self, site: tuple) -> Optional[float]:
        hit = self._obs.get(site)
        return None if hit is None else hit[0]

    def blend(self, site: tuple, estimate: float) -> float:
        """Observed-over-heuristic blend: the planner's working estimate."""
        obs = self.lookup(site)
        if obs is None:
            return estimate
        s = FEEDBACK_BLEND * obs + (1.0 - FEEDBACK_BLEND) * float(estimate)
        return float(min(1.0, max(0.0, s)))

    def note_overflow(self, site: tuple) -> None:
        """Record that a capacity bound sized from this site's estimate
        dropped rows at run time.  ``choose_compaction`` backs off from
        overflowed sites on re-plan (overflow-adaptive replanning's first
        half: stop compacting rather than stay silently lossy)."""
        self._overflowed.add(site)

    def is_overflowed(self, site: tuple) -> bool:
        return site in self._overflowed

    def __len__(self) -> int:
        return len(self._obs)

    def fingerprint(self) -> str:
        """Content hash of the observation state (part of the plan id, so
        new observations invalidate cached plans).  Fractions are rounded
        so float noise below planning significance does not thrash the
        cache."""
        if not self._obs and not self._overflowed:
            return "none"
        rows = tuple(sorted((repr(k), round(v[0], 4), v[1])
                            for k, v in self._obs.items()))
        ovf = tuple(sorted(repr(s) for s in self._overflowed))
        return hashlib.sha256(repr((rows, ovf)).encode()).hexdigest()

    def __repr__(self):
        return (f"SelectivityFeedback(sites={len(self._obs)}, "
                f"fp={self.fingerprint()[:8]})")


def fit_weights(traces, model=None, *, min_samples: int = 3):
    """Refit cost-model constants from accumulated EXPLAIN ANALYZE traces.

    ``traces``: an iterable of :class:`~repro_torch.core.tracing.RunTrace`
    objects (``PlannedFunction.analyze`` accumulates one per run), whose
    ``samples`` carry ``(impl, raw-feature dict, observed_seconds)`` rows —
    exactly the §6.2 calibration dataset.  Impls with fewer than
    ``min_samples`` observations are skipped (a one-point fit would just
    memorize dispatch noise).  Returns the (given or fresh)
    :class:`~repro_torch.core.cost_model.CostModel` with refit per-impl Eq.-2
    weights; its changed ``fingerprint()`` invalidates cached plans, so the
    next compile re-selects candidates under the calibrated model — the
    adaptive-execution roadmap item's refit half."""
    from .cost_model import CostModel
    by_impl: dict = {}
    for tr in traces:
        for impl, feats, sec in getattr(tr, "samples", ()) or ():
            by_impl.setdefault(impl, []).append((impl, feats, float(sec)))
    rows = [s for ss in by_impl.values() if len(ss) >= min_samples
            for s in ss]
    model = model if model is not None else CostModel()
    if rows:
        model.fit(rows)
    return model


def active_feedback() -> Optional[SelectivityFeedback]:
    """The feedback store installed for the current planning run."""
    return _ACTIVE.get()


@contextlib.contextmanager
def activate_feedback(feedback: Optional[SelectivityFeedback]):
    """Install ``feedback`` as the active store for the duration of a
    planning run (no-op for ``None``)."""
    token = _ACTIVE.set(feedback)
    try:
        yield feedback
    finally:
        _ACTIVE.reset(token)
