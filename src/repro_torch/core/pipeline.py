"""Staged plan pipeline: a pass manager over the AWESOME planning stages.

The paper's optimizer (§4–§6, Algorithm 1) is a *staged* pipeline: rewrite
the validated logical DAG, generate engine-specific physical candidates,
pick winners with the learned cost model, then apply data parallelism and
buffering.  This module makes each stage a registered, individually-timed
**pipeline pass** over a shared :class:`PipelineContext`, and makes the
product a :class:`StagedPhysicalPlan` with a stable content-hashed
``plan_id`` — the unit the plan cache stores and the executor binds to a
runtime context (mesh / sharding rules / interpret mode).

Default pass order (Algorithm 1):

    rewrite -> generate_candidates -> select_candidates ->
    materialize_choice -> add_data_parallelism -> plan_buffering

Passes are looked up by name in :data:`PASS_REGISTRY`, so a custom pipeline
can drop, reorder, or add passes (``PlanPipeline(passes=(...,))``), and the
accumulated :class:`PassRecord` trace renders as an EXPLAIN-style report
(per-pass wall time, node-count deltas, candidate choices).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

from .buffering import BufferingDecision, plan_buffering
from .cost_model import CostModel, select_candidates
from .engines import resolve_engines
from .ir import (FunctionCatalog, Plan, SystemCatalog, ValidationError,
                 count_nodes)
from .ir import plan_id as compute_plan_id
from .parallel import add_data_parallelism, partition_stats
from .physical import (DEFAULT_PATTERNS, PhysPlan, generate_candidates,
                       materialize_choice)
from .plan_cache import PlanCache, default_plan_cache
from .rewrite import DEFAULT_PIPELINE as DEFAULT_REWRITES
from .rewrite import rewrite_with_trace


# --------------------------------------------------------------------------
# planning options (the plan-identity-relevant knobs)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class PlanOptions:
    """Everything that changes *what plan comes out* for a given logical
    plan + catalogs.  Hashed into ``plan_id``; runtime-only bindings (mesh
    object, sharding rules, interpret mode) deliberately live outside.

    ``plan_threads`` parallelizes candidate generation per scan-group; it
    changes only planning wall time, never the chosen plan, so it is
    deliberately **excluded** from ``cache_key``."""

    engines: tuple = ("xla",)
    data_parallel: bool = True
    buffering: bool = False
    global_batch: int = 1
    rewrite_pipeline: tuple = DEFAULT_REWRITES
    plan_threads: int = 1

    def cache_key(self) -> tuple:
        return ("opts", tuple(self.engines), self.data_parallel,
                self.buffering, self.global_batch,
                tuple(self.rewrite_pipeline))


# --------------------------------------------------------------------------
# pass registry + shared context
# --------------------------------------------------------------------------


@dataclass
class PassRecord:
    """One EXPLAIN row: what a pass did and what it cost."""

    name: str
    wall_ms: float
    nodes_before: int
    nodes_after: int
    info: dict = field(default_factory=dict)


@dataclass
class PipelineContext:
    """State threaded through the passes; accumulates the EXPLAIN trace."""

    catalog: FunctionCatalog
    syscat: SystemCatalog
    options: PlanOptions
    logical: Plan
    cost_model: Optional[CostModel] = None
    patterns: tuple = DEFAULT_PATTERNS
    # produced by passes
    logical_opt: Optional[Plan] = None
    pplan: Optional[PhysPlan] = None
    choices: Optional[dict] = None
    report: Optional[list] = None
    concrete: Optional[PhysPlan] = None
    buffering: Optional[BufferingDecision] = None
    trace: list = field(default_factory=list)

    def artifact(self):
        """The most-evolved plan artifact so far (for node-count deltas)."""
        for p in (self.concrete, self.pplan, self.logical_opt, self.logical):
            if p is not None:
                return p
        return None


PASS_REGISTRY: dict = {}


def pipeline_pass(name: str):
    """Register a pass: ``fn(ctx) -> info dict`` under a stable name."""
    def deco(fn):
        PASS_REGISTRY[name] = fn
        return fn
    return deco


# --------------------------------------------------------------------------
# the six Algorithm-1 stages as passes
# --------------------------------------------------------------------------


@pipeline_pass("rewrite")
def _pass_rewrite(ctx: PipelineContext) -> dict:
    ctx.logical_opt, rules = rewrite_with_trace(
        ctx.logical, ctx.catalog, ctx.options.rewrite_pipeline,
        syscat=ctx.syscat)
    return {"rules": rules}


@pipeline_pass("generate_candidates")
def _pass_generate(ctx: PipelineContext) -> dict:
    from .engines import get_engine
    ctx.pplan = generate_candidates(ctx.logical_opt, ctx.patterns,
                                    engines=ctx.options.engines,
                                    threads=ctx.options.plan_threads)

    def stats(pp):
        nv, nc = len(pp.pm), sum(len(c) for c in pp.pm.values())
        for n in pp.topo():
            if n.subplan is not None:
                sv, sc = stats(n.subplan)
                nv, nc = nv + sv, nc + sc
        return nv, nc

    nv, nc = stats(ctx.pplan)
    return {"virtual_nodes": nv, "candidates": nc,
            "engines": list(ctx.options.engines),
            # per-engine availability gate (Engine.is_available), surfaced
            # in the EXPLAIN report so an operator can see *why* a
            # hardware-gated engine's candidates were not offered
            "engine_availability": {
                e: get_engine(e).available() for e in ctx.options.engines}}


@pipeline_pass("select_candidates")
def _pass_select(ctx: PipelineContext) -> dict:
    ctx.choices, ctx.report = select_candidates(
        ctx.pplan, ctx.syscat, ctx.cost_model, engines=ctx.options.engines)
    return {"choices": [(r["pattern"], r["chosen"]) for r in ctx.report]}


@pipeline_pass("materialize_choice")
def _pass_materialize(ctx: PipelineContext) -> dict:
    ctx.concrete = materialize_choice(ctx.pplan, ctx.choices)
    return {}


@pipeline_pass("add_data_parallelism")
def _pass_data_parallel(ctx: PipelineContext) -> dict:
    if not ctx.options.data_parallel:
        return {"skipped": True}
    ctx.concrete = add_data_parallelism(ctx.concrete)
    return partition_stats(ctx.concrete)


@pipeline_pass("plan_buffering")
def _pass_buffering(ctx: PipelineContext) -> dict:
    ctx.buffering = plan_buffering(ctx.concrete,
                                   enabled=ctx.options.buffering,
                                   global_batch=ctx.options.global_batch)
    return {"enabled": ctx.buffering.enabled,
            "microbatches": ctx.buffering.num_microbatches,
            "chains": len(ctx.buffering.chains)}


# --------------------------------------------------------------------------
# the product: a staged physical plan with a stable identity
# --------------------------------------------------------------------------


@dataclass
class StagedPhysicalPlan:
    """Everything the pass pipeline produced for one planning problem.

    Cache-friendly: no runtime bindings (mesh objects, sharding rules); the
    executor's PlannedFunction wraps one of these plus the runtime context.
    Treated as immutable once built.
    """

    plan_id: str
    logical: Plan                  # the optimized (rewritten) logical plan
    pplan: PhysPlan                # with virtual nodes (pre-choice)
    concrete: PhysPlan             # chosen + data-parallelized
    choices: dict
    report: list
    buffering: BufferingDecision
    trace: list
    options: PlanOptions
    # identity material for the cross-query subplan cache (core/mqo.py):
    # cost-model + feedback fingerprints, folded into every sub-DAG hash so
    # a re-calibrated plan's intermediates provably miss the cache.  Stamped
    # by ``compile_staged``; plans unpickled from an older on-disk cache may
    # lack the attribute — read it with ``getattr(staged, "mqo_salt", "")``.
    mqo_salt: str = ""

    def subdag_fingerprints(self, *, leaf_keys=None, salt=None) -> dict:
        """Per-node sub-DAG content hashes of the **concrete** physical
        plan (see :func:`repro_torch.core.ir.subdag_fingerprints`).  The
        structural variant (no ``leaf_keys``) is memoized — the plan is
        immutable once staged, so one walk serves every query admission."""
        from .ir import subdag_fingerprints as _sfp
        s = getattr(self, "mqo_salt", "") if salt is None else salt
        if leaf_keys is None:
            cached = self.__dict__.get("_subdag_fp_cache")
            if cached is not None and cached[0] == s:
                return cached[1]
            fps = _sfp(self.concrete, salt=s)
            self.__dict__["_subdag_fp_cache"] = (s, fps)
            return fps
        return _sfp(self.concrete, leaf_keys=leaf_keys, salt=s)

    def explain(self, analyze=None) -> str:
        """EXPLAIN-style report: per-pass wall time, node-count deltas, and
        the cost model's candidate choices.  With ``analyze`` (a
        :class:`~repro_torch.core.tracing.RunTrace` from
        ``PlannedFunction.analyze``), an **EXPLAIN ANALYZE** section merges
        the plan-time records with the runtime spans: one
        ``predicted~ / observed=`` row per executed physical node, plus
        observed counts and per-shard collective totals."""
        avail = next((r.info["engine_availability"] for r in self.trace
                      if "engine_availability" in r.info), None)
        eng = ",".join(
            self.options.engines if avail is None else
            (f"{e}[{'up' if avail.get(e, True) else 'DOWN'}]"
             for e in self.options.engines))
        lines = [f"StagedPhysicalPlan {self.plan_id[:12]} (engines={eng})"]
        lines.append(f"  {'pass':<22}{'ms':>9}  {'nodes':<12}info")
        for r in self.trace:
            delta = (f"{r.nodes_before}"
                     if r.nodes_before == r.nodes_after
                     else f"{r.nodes_before} -> {r.nodes_after}")
            info = {k: v for k, v in r.info.items()
                    if k not in ("rules", "engine_availability")}
            lines.append(f"  {r.name:<22}{r.wall_ms:>9.2f}  {delta:<12}"
                         f"{info if info else ''}")
            for rule in r.info.get("rules", ()):
                lines.append(
                    f"    . {rule['rule']:<18}{rule['wall_ms']:>7.2f}  "
                    f"{rule['nodes_before']} -> {rule['nodes_after']}")
                # per-rule detail (pushdown: which ops received masks and
                # the estimated selectivity; fusion: collapsed chains)
                for rewr in rule.get("info", {}).get("pushed", ()):
                    lines.append("        + " + " ".join(
                        f"{k}={v}" for k, v in rewr.items()))
                # bounded relations: where compaction was placed, and the
                # count-vs-capacity reasoning behind it
                for cp in rule.get("info", {}).get("compacted", ()):
                    lines.append(
                        f"        + compact below={cp['filter']} "
                        f"count~{cp['expected']} capacity={cp['capacity']} "
                        f"(rows={cp['rows']}, "
                        f"selectivity={cp['selectivity']})")
                for ch in rule.get("info", {}).get("fused_chains", ()):
                    lines.append(
                        f"        + fused {'->'.join(ch['ops'])} "
                        f"(head={ch['head']})")
                # sharded stores: xfer kinds with priced wire bytes, and
                # the ops the runtime executes shard-locally
                for xf in rule.get("info", {}).get("xfers", ()):
                    lines.append(
                        f"        + xfer {xf['id']} kind={xf['kind']} "
                        f"~{xf['est_bytes']}B")
                for dn in rule.get("info", {}).get("dist", ()):
                    extra = ("" if "build_expected" not in dn else
                             f" build~{dn['build_expected']}")
                    lines.append(
                        f"        + dist {dn['id']} [{dn['op']}] "
                        f"{dn['dist']}{extra}")
        for r in self.report:
            costs = {k: f"{v:.3e}" for k, v in r["costs"].items()}
            lines.append(f"  choice [{r['pattern']}] -> {r['chosen']} "
                         f"({r.get('engine', '?')}) costs={costs}")
        if analyze is not None:
            lines.extend(self._explain_analyze(analyze))
        return "\n".join(lines)

    def _explain_analyze(self, trace) -> list:
        """Render one executed run against this plan: the runtime half of
        the report.  Observed times are per-op *dispatch* ms (the run
        device-syncs once, in the trailing ``device_sync`` span)."""
        lines = [f"  EXPLAIN ANALYZE wall={trace.wall_ms:.2f} ms "
                 f"(sync {trace.sync_ms:.2f} ms, "
                 f"{len(trace.op_spans())} op spans, "
                 f"plan {trace.plan_id[:12]})"]
        for sp in trace.op_spans():
            a = sp.attrs
            pred = a.get("predicted_s")
            pred_s = f"{pred:.3e}s" if pred is not None else "n/a"
            row = (f"  analyze {sp.name:<18} [{a.get('impl', '?')}] "
                   f"predicted~{pred_s} observed={sp.dur_ms:.3f}ms")
            if "count" in a:
                row += f" count={a['count']:.0f}/{a.get('capacity', '?')}"
            if "overflow" in a:
                row += f" overflow={bool(a['overflow'])}"
            if "xfer_kind" in a:
                row += (f" kind={a['xfer_kind']} "
                        f"bytes={a.get('payload_bytes', 0)} "
                        f"wire~{a.get('wire_bytes', 0.0):.0f}B")
            if "dist" in a:
                row += f" dist={a['dist']}"
            if "coll_bytes" in a:
                row += (f" coll={a.get('coll', 'collective')}"
                        f"~{a['coll_bytes']:.0f}B")
            lines.append(row)
        totals = trace.collective_totals()
        if totals:
            lines.append("  collective totals (per shard):")
            for kind in sorted(totals):
                t = totals[kind]
                lines.append(f"    {kind}: {t['ops']} ops, "
                             f"{t['bytes']:.0f} B")
        for site, count, cap in trace.counts:
            lines.append(f"  observed {site}: count={count:.0f}/{cap}")
        return lines

    @property
    def total_ms(self) -> float:
        return sum(r.wall_ms for r in self.trace)


# --------------------------------------------------------------------------
# pass manager
# --------------------------------------------------------------------------


class PlanPipeline:
    """Runs registered passes in order over a PipelineContext."""

    DEFAULT_PASSES = ("rewrite", "generate_candidates", "select_candidates",
                      "materialize_choice", "add_data_parallelism",
                      "plan_buffering")

    def __init__(self, passes: Optional[Sequence[str]] = None):
        self.passes = tuple(passes if passes is not None
                            else self.DEFAULT_PASSES)
        for name in self.passes:
            if name not in PASS_REGISTRY:
                raise ValidationError(
                    f"unknown pipeline pass {name!r} "
                    f"(registered: {sorted(PASS_REGISTRY)})")

    def run(self, logical: Plan, catalog: FunctionCatalog,
            syscat: SystemCatalog, *, options: Optional[PlanOptions] = None,
            cost_model: Optional[CostModel] = None,
            patterns=DEFAULT_PATTERNS,
            plan_id: Optional[str] = None) -> StagedPhysicalPlan:
        opts = options or PlanOptions()
        pid = plan_id or staged_plan_id(logical, catalog, syscat, opts,
                                        cost_model, patterns, self.passes)
        ctx = PipelineContext(catalog, syscat, opts, logical,
                              cost_model=cost_model, patterns=patterns)
        for name in self.passes:
            fn = PASS_REGISTRY[name]
            before = count_nodes(ctx.artifact())
            t0 = time.perf_counter()
            info = fn(ctx) or {}
            wall_ms = (time.perf_counter() - t0) * 1e3
            ctx.trace.append(PassRecord(name, wall_ms, before,
                                        count_nodes(ctx.artifact()), info))
        if ctx.concrete is None or ctx.buffering is None:
            raise ValidationError(
                f"pipeline {self.passes} did not produce a concrete plan "
                f"(need materialize_choice and plan_buffering)")
        return StagedPhysicalPlan(pid, ctx.logical_opt, ctx.pplan,
                                  ctx.concrete, ctx.choices, ctx.report or [],
                                  ctx.buffering, ctx.trace, opts)


# --------------------------------------------------------------------------
# cached entry point
# --------------------------------------------------------------------------


_PATTERNS_FP: dict = {}    # id(patterns) -> (patterns ref, fingerprint)


def _patterns_fingerprint(patterns) -> str:
    """Content hash of a physical pattern set.  Memoized by object identity
    (pattern sets are module-level constants) so the cache-hit path does not
    re-canonicalize candidate tables on every compile."""
    import hashlib

    from .ir import _canon
    hit = _PATTERNS_FP.get(id(patterns))
    if hit is not None and hit[0] is patterns:
        return hit[1]
    pats = tuple(
        (p.name, p.seq,
         tuple((c.name, c.impls, c.requires_backend, _canon(c.when))
               for c in p.candidates))
        for p in patterns)
    fp = hashlib.sha256(repr(pats).encode()).hexdigest()
    _PATTERNS_FP[id(patterns)] = (patterns, fp)
    return fp


def staged_plan_id(logical: Plan, catalog: FunctionCatalog,
                   syscat: SystemCatalog, options: PlanOptions,
                   cost_model: Optional[CostModel] = None,
                   patterns=DEFAULT_PATTERNS,
                   passes: Optional[tuple] = None,
                   feedback=None, extra_key: tuple = ()) -> str:
    """The cache key: content hash over plan structure, catalog signature,
    syscat fingerprint, planning options, cost-model weights, the physical
    pattern set, the pass list, the observed-selectivity feedback state,
    and any caller-supplied ``extra_key`` (bound-store versions) —
    everything that changes what plan comes out.  Feedback and store
    versions make cached plans *statistics-aware*: new observations or
    appended store contents are a provable cache miss, never a stale hit."""
    cm = cost_model.fingerprint() if cost_model is not None else "analytic"
    fb = feedback.fingerprint() if feedback is not None else "none"
    extra = options.cache_key() + (
        "cm", cm, "patterns", _patterns_fingerprint(patterns),
        "passes", tuple(passes or PlanPipeline.DEFAULT_PASSES),
        "feedback", fb, "extra", tuple(extra_key))
    return compute_plan_id(logical, catalog, syscat, extra=extra)


def compile_staged(logical: Plan, catalog: FunctionCatalog,
                   syscat: SystemCatalog, *,
                   options: Optional[PlanOptions] = None,
                   cost_model: Optional[CostModel] = None,
                   patterns=DEFAULT_PATTERNS,
                   pipeline: Optional[PlanPipeline] = None,
                   cache=None, feedback=None,
                   extra_key: tuple = ()) -> StagedPhysicalPlan:
    """Plan (or fetch from the plan cache) the staged physical plan.

    ``cache``: a PlanCache, None for the process-wide default, or False to
    force a fresh (uncached, uninserted) planning run.

    ``feedback``: an optional ``SelectivityFeedback`` store.  Its state is
    both *consumed* (the rewrite layer blends observed fractions over
    hints/heuristics while it is active) and *identified* (its fingerprint
    is part of the plan id, so re-planning after new observations misses
    the cache instead of reusing a plan priced on stale estimates).

    ``extra_key``: extra identity material (bound-store versions).
    """
    from .feedback import activate_feedback
    opts = options or PlanOptions()
    pl = pipeline or PlanPipeline()
    pid = staged_plan_id(logical, catalog, syscat, opts, cost_model,
                         patterns, pl.passes, feedback, extra_key)
    # the cost-model fit fingerprint doubles as the cache's calibration
    # marker: entries planned under an older fit are preferred eviction
    # victims (see PlanCache)
    cm_fp = cost_model.fingerprint() if cost_model is not None else "analytic"
    pc = None
    if cache is not False:
        pc = cache if isinstance(cache, PlanCache) else default_plan_cache()
        pc.note_fingerprint(cm_fp)
        hit = pc.lookup(pid)
        if hit is not None:
            return hit
    with activate_feedback(feedback):
        staged = pl.run(
            logical, catalog, syscat, options=opts, cost_model=cost_model,
            patterns=patterns, plan_id=pid)
    # the subplan-cache salt: everything that can change a node's *output
    # semantics or validity* without changing its structural sub-DAG hash.
    # A refit cost model or new selectivity observations replan into a new
    # pid anyway, so identical-salt entries are internally consistent; the
    # salt makes the cross-query cache miss provable for intermediates
    # materialized under the superseded calibration.
    fb_fp = feedback.fingerprint() if feedback is not None else "none"
    staged.mqo_salt = repr(("cm", cm_fp, "feedback", fb_fp))
    if pc is not None:
        pc.insert(pid, staged, fingerprint=cm_fp)
    return staged
