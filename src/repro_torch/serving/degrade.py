"""Graceful degradation: shed load by cheapening standing analytical plans.

Under overload the right tri-store behaviour is not "queue forever" or
"reject everything" but *degrade*: a standing analytical query (social-feed
ranking, trend detection) usually tolerates a cheaper answer — fewer top-k
results, fewer PageRank power iterations — far better than a missed
deadline.  BigDAWG calls this degraded cross-island execution; here it is a
**plan-level** ladder: the :class:`DegradePolicy` clamps the cost-carrying
attrs of the *logical* plan (``k`` on ``text_topk`` / ``masked_topk``,
``iters`` on ``graph_pagerank``) and recompiles through the staged
pipeline, so the degraded variant has a provably different ``plan_id``
(the clamped attrs are part of the plan's content hash) and is itself
plan-cache-warm on repeat — a standing query flips between its full and
degraded variants with zero replanning cost after the first switch.

Every degradation is observable: an ``analytics.degraded`` counter, a
per-level counter, and a flight-recorder event carrying the exact attr
clamps applied.

The port's copy of the reference package's ``serving/degrade.py``; the
degraded function is bound to the original's device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from ..core.executor import PlannedFunction
from ..core.ir import infer_types

# op -> attr the ladder clamps (missing attrs fall back to op defaults)
_CLAMP_ATTRS = {
    "text_topk": "k",
    "masked_topk": "k",
    "graph_pagerank": "iters",
}
_PAGERANK_DEFAULT_ITERS = 10


@dataclass
class DegradePolicy:
    """A two-rung degrade ladder over analytical plan attrs.

    ``ladder[level - 1]`` maps attr name -> cap for that level; level 0 is
    "no degradation".  :meth:`level` turns overload signals (queue depth,
    KV fill) into a rung; :meth:`replan` produces the degraded
    PlannedFunction."""

    catalog: Any                      # FunctionCatalog for re-inference
    ladder: tuple = (
        {"k": 32, "iters": 5},        # level 1: mild shedding
        {"k": 8, "iters": 3},         # level 2: survival mode
    )
    queue_hi: float = 1.0             # queue_depth / max_batch ratios
    queue_crit: float = 2.0
    fill_hi: float = 0.80             # KV pool fill fractions
    fill_crit: float = 0.95
    registry: Optional[Any] = None
    recorder: Optional[Any] = None
    events: list = field(default_factory=list)

    @property
    def max_level(self) -> int:
        return len(self.ladder)

    def level(self, *, queue_depth: int = 0, max_batch: int = 1,
              kv_fill: float = 0.0) -> int:
        """Overload signals -> ladder rung.  Queue depth is normalized by
        the decode batch width (a 4-wide runtime with 8 queued is twice
        oversubscribed); KV fill is the memory-pressure signal."""
        q = queue_depth / max(max_batch, 1)
        if q >= self.queue_crit or kv_fill >= self.fill_crit:
            return min(2, self.max_level)
        if q >= self.queue_hi or kv_fill >= self.fill_hi:
            return min(1, self.max_level)
        return 0

    # -- plan surgery ------------------------------------------------------
    def degrade_logical(self, plan, lvl: int):
        """Copy the logical plan with the level's caps applied; returns
        ``(plan2, changes)`` where changes lists every clamp as
        ``(node_id, attr, before, after)``.  Empty changes means the plan
        has nothing to cheapen at this level."""
        if lvl <= 0:
            return plan, []
        caps = self.ladder[min(lvl, self.max_level) - 1]
        plan2 = plan.copy()
        changes = []

        def visit(p):
            for n in p.topo():
                if n.subplan is not None:
                    visit(n.subplan)
                attr = _CLAMP_ATTRS.get(n.op)
                if attr is None or attr not in caps:
                    continue
                default = (_PAGERANK_DEFAULT_ITERS
                           if attr == "iters" else None)
                cur = n.attrs.get(attr, default)
                if cur is None:
                    continue
                cap = int(caps[attr])
                if int(cur) > cap:
                    n.attrs[attr] = cap
                    changes.append((n.id, attr, int(cur), cap))

        visit(plan2)
        if changes:
            # clamped k changes output capacities: re-infer the metadata
            # map so the planner prices the cheaper plan, not the old one
            infer_types(plan2, self.catalog)
        return plan2, changes

    def replan(self, planned: PlannedFunction, lvl: int, *,
               cache=None) -> PlannedFunction:
        """The degraded variant of a compiled analytical function.  Same
        runtime bindings (device / faults); different —
        and provably different — plan id whenever anything was clamped.
        Returns ``planned`` unchanged when the level clamps nothing."""
        from ..core.pipeline import compile_staged
        logical2, changes = self.degrade_logical(planned.logical, lvl)
        if not changes:
            return planned
        staged = compile_staged(
            logical2, self.catalog, planned.syscat,
            options=planned.staged.options if planned.staged else None,
            cache=cache, extra_key=(("degrade_level", int(lvl)),))
        fn = PlannedFunction.from_staged(staged, planned.syscat,
                                         device=planned.device)
        fn.faults = planned.faults
        self._observe(lvl, planned.plan_id, fn.plan_id, changes)
        return fn

    def _observe(self, lvl, plan_id, degraded_id, changes) -> None:
        event = {"level": int(lvl), "plan_id": plan_id,
                 "degraded_plan_id": degraded_id,
                 "clamps": [{"node": n, "attr": a, "from": b, "to": c}
                            for n, a, b, c in changes]}
        self.events.append(event)
        if self.registry is not None:
            self.registry.count("analytics.degraded")
            self.registry.count(f"analytics.degraded.level{int(lvl)}")
        if self.recorder is not None:
            self.recorder.record("degrade", event)


__all__ = ["DegradePolicy"]
