"""ADIL-style analysis front end (paper §2).

The paper's ADIL is a textual dataflow language; its Python analogue is
an API that gives the same *semantics* — assignment statements over typed
variables, strict compile-time validation, higher-order map/filter/reduce,
and `store` effects — as an embedded DSL whose product is a validated
logical :class:`~repro_torch.core.ir.Plan` ready for the AWESOME pipeline.

    with Analysis("NewsAnalysis", catalog) as a:
        toks = a.input("tokens", TensorT((4, 64), "int32", ("batch","seq")))
        h = a.op("embed", toks, vocab=512, embed=64, pp=("embed",))
        h = a.op("attention", h, heads=4, kv_heads=2, head_dim=16,
                 embed=64, pp=("attn",))
        a.store(h)
    fn = a.compile(syscat)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

from .executor import PlannedFunction, plan_and_compile
from .ir import (CorpusT, FunctionCatalog, GraphT, Plan, SystemCatalog,
                 TableT, Type, ValidationError, infer_types)


@dataclass(frozen=True)
class Var:
    """A typed ADIL variable (an SSA name into the plan)."""

    name: str
    analysis: "Analysis"

    @property
    def type(self) -> Type:
        return self.analysis.plan.types[self.name]

    def __repr__(self):
        t = self.analysis.plan.types.get(self.name)
        return f"Var({self.name}: {t!r})"


class Analysis:
    """One `create analysis ... as {{ ... }}` block."""

    def __init__(self, name: str, catalog: FunctionCatalog):
        self.plan = Plan(name)
        self.catalog = catalog
        self._stores: list = []
        self._bound: dict = {}   # input name -> bound Store object

    # -- statements ----------------------------------------------------------
    def input(self, name: str, typ: Type) -> Var:
        self.plan.add_input(name, typ)
        return Var(name, self)

    # -- native store declarations (the paper's table/graph/corpus types) ----
    def table(self, name: str, rows: int, cols) -> Var:
        """Declare a relational store input: ``cols`` is ``((name, dtype),
        ...)``.  At call time the caller binds ``ColumnStore.payload()``."""
        return self.input(name, TableT(tuple((str(c), str(d))
                                             for c, d in cols), int(rows)))

    def graph(self, name: str, nodes: int, edges: int,
              weighted: bool = False) -> Var:
        """Declare a CSR graph store input (``GraphStore.payload()``)."""
        return self.input(name, GraphT(int(nodes), int(edges),
                                       bool(weighted)))

    def corpus(self, name: str, docs: int, vocab: int, postings: int) -> Var:
        """Declare a text store input (``TextStore.payload()``)."""
        return self.input(name, CorpusT(int(docs), int(vocab),
                                        int(postings)))

    def bind(self, name: str, store) -> Var:
        """Declare a store input directly from a Store object (its ``type``
        carries the size metadata the planner prices movement with).  The
        store stays tracked: its monotonic ``version`` is folded into the
        plan-cache key at compile time, so appending to a bound store
        invalidates plans cached against its previous contents."""
        self._bound[name] = store
        return self.input(name, store.type)

    def store_versions(self) -> tuple:
        """The bound stores' ``(name, version)`` vector (stores without a
        version — e.g. static graph snapshots — count as version 0)."""
        return tuple(sorted((n, int(getattr(s, "version", 0)))
                            for n, s in self._bound.items()))

    def op(self, op_name: str, *inputs, subplan: Optional[Plan] = None,
           **attrs) -> Var:
        ids = [v.name if isinstance(v, Var) else v for v in inputs]
        nid = self.plan.add(op_name, ids, attrs, subplan)
        # validate eagerly — every assignment type-checks at once (§3)
        infer_types(self.plan, self.catalog)
        return Var(nid, self)

    def map(self, coll: Var, body_plan: Plan) -> Var:
        return self.op("map", coll, subplan=body_plan)

    def filter(self, coll: Var, predicate) -> Var:
        return self.op("filter", coll, predicate=predicate)

    def reduce(self, coll: Var, fn) -> Var:
        return self.op("reduce", coll, fn=fn)

    def store(self, var: Var, **attrs) -> Var:
        nid = self.plan.add("store", [var.name], attrs)
        infer_types(self.plan, self.catalog)
        self._stores.append(nid)
        return Var(nid, self)

    # -- context manager sugar -------------------------------------------------
    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        if et is None:
            if not self._stores:
                raise ValidationError(
                    f"analysis {self.plan.name!r} has no store statements")
            self.plan.set_outputs(*self._stores)
        return False

    # -- compilation through the AWESOME pipeline ------------------------------
    def compile(self, syscat: SystemCatalog, **kw) -> PlannedFunction:
        """Compile through the staged plan pipeline.  Planning is cached by
        content hash (see ``core/plan_cache.py``): recompiling an identical
        analysis against the same catalogs reuses the staged plan instead of
        replanning.  Pass ``cache=False`` to force a fresh run."""
        if not self.plan.outputs:
            self.plan.set_outputs(*self._stores)
        if self._bound:
            # re-snapshot bound store types: an append since bind() may have
            # changed row counts / expected counts, and replanning against
            # the stale snapshot would price (and size compactions) on
            # stale cardinalities — the very thing the version key exists
            # to invalidate
            stale = False
            for n, s in self._bound.items():
                if self.plan.inputs.get(n) != s.type:
                    self.plan.inputs[n] = s.type
                    self.plan.types[n] = s.type
                    stale = True
            if stale:
                self.plan._bump()
                infer_types(self.plan, self.catalog)
            kw.setdefault("store_versions", self.store_versions())
        return plan_and_compile(self.plan, self.catalog, syscat, **kw)

    def plan_id(self, syscat: SystemCatalog) -> str:
        """Content hash identifying this analysis against the catalogs (the
        structural part of the plan-cache key; planning options are appended
        by the pipeline — see ``pipeline.staged_plan_id``).  Side-effect
        free: outputs defaulting happens on a copy, so stores added after
        this call still reach ``compile``."""
        from .ir import plan_id as _plan_id
        plan = self.plan
        if not plan.outputs and self._stores:
            plan = plan.copy()
            plan.set_outputs(*self._stores)
        return _plan_id(plan, self.catalog, syscat)
