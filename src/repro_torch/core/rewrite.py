"""Logical-plan rewriting (paper §4.2).

Three rule families, ported from the paper:

  1. **Function decomposition** (§4.2.1) — coarse analytical functions are
     decomposed into primitive operators (NER → CoreNLP annotator chain in the
     paper; here ``attention`` → q/k/v projections + sdpa + out-proj and
     ``mlp`` → up/gate/act/down), exposing a deeper level of optimization.
  2. **Redundancy elimination** (§4.2.2) — identical operators on identical
     inputs execute once (CSE).  The paper's motivating case — Preprocess and
     NER sharing a tokenize/ssplit/pos/lemma prefix — maps to shared
     projection/norm prefixes after decomposition.
  3. **Operator fusion** (§4.2.3) — chains of per-element operators fuse so
     that (a) intermediates are never materialized, and (b) *larger logical
     patterns* exist for the physical planner to match, which unlocks better
     fused physical candidates (the paper's Fig. 5/7 argument).  Here:
     q/k/v-projection fusion, GLU-FFN refusion, and scan(=Map)-fusion of
     consecutive ``scan_layers`` nodes.

All passes re-run :func:`infer_types` afterwards, so a rewritten plan is
always re-validated (the paper re-checks metadata after every rewrite).
"""
from __future__ import annotations

import contextvars
import math
from typing import Callable

from .ir import (CMP_SELECTIVITY as _CMP_SELECTIVITY, FunctionCatalog, Node,
                 Plan, ValidationError, count_nodes, infer_types)

# --------------------------------------------------------------------------
# 1. function decomposition
# --------------------------------------------------------------------------

# op -> expander(plan_like, node) -> (new chain of (op, attrs)) replacing node.
# Chains are linear: first element consumes node.inputs, last produces output.


def _carry(node: Node) -> dict:
    """Attrs every decomposed sub-op inherits (param path, sharing)."""
    out = {}
    for k in ("pp", "shared"):
        if k in node.attrs:
            out[k] = node.attrs[k]
    return out


def _decompose_attention(node: Node):
    a = node.attrs
    base = _carry(node)
    proj = {**base, **{k: a[k] for k in ("heads", "kv_heads", "head_dim")}}
    sdpa = dict(proj)
    for k in ("causal", "window", "qk_norm", "rope", "rope_theta", "sink",
              "emit_kv"):
        if k in a:
            sdpa[k] = a[k]
    return [
        ("q_proj", proj), ("k_proj", proj), ("v_proj", proj),
        ("pack_qkv", dict(base)),
        ("sdpa", sdpa),
        ("out_proj", {**base, "embed": a["embed"]}),
    ]


def _decompose_mlp(node: Node):
    a = node.attrs
    base = _carry(node)
    if a.get("gated", True):
        return [
            ("ffn_up", {**base, "ffn": a["ffn"]}),
            ("ffn_gate", {**base, "ffn": a["ffn"]}),
            ("ffn_glu", {**base, "act": a.get("act", "silu")}),
            ("ffn_down", {**base, "embed": a["embed"]}),
        ]
    return [
        ("ffn_up", {**base, "ffn": a["ffn"]}),
        ("ffn_act", {**base, "act": a.get("act", "gelu")}),
        ("ffn_down", {**base, "embed": a["embed"]}),
    ]


_DECOMPOSE: dict = {"attention": _decompose_attention, "mlp": _decompose_mlp}

# wiring templates: how the produced ops connect (index into produced list,
# -1 == the original node's input).  Linear chains need no template; these two
# have fan-in joins.
_WIRING = {
    "attention": {
        0: (-1,), 1: (-1,), 2: (-1,),        # q,k,v proj from the input
        3: (0, 1, 2),                          # pack_qkv(q, k, v)
        4: (3,),                               # sdpa
        5: (4,),                               # out_proj
    },
    # mlp is wired explicitly in ``decompose`` (gated vs ungated fan-in).
}


def decompose(plan: Plan, catalog: FunctionCatalog) -> Plan:
    """Apply function-decomposition rules (recursively into subplans)."""
    out = Plan(plan.name, {}, dict(plan.inputs), plan.outputs, {}, plan._ctr)
    remap: dict = {i: i for i in plan.inputs}

    for node in plan.topo():
        sub = node.subplan
        if sub is not None:
            sub = decompose(sub, catalog)
        if node.op not in _DECOMPOSE:
            nid = out.add(node.op, [remap[i] for i in node.inputs],
                          dict(node.attrs), sub, id=node.id)
            remap[node.id] = nid
            continue

        chain = _DECOMPOSE[node.op](node)
        src = remap[node.inputs[0]]
        produced = []
        if node.op == "attention":
            wiring = _WIRING["attention"]
            for idx, (op, attrs) in enumerate(chain):
                ins = [src if j == -1 else produced[j] for j in wiring[idx]]
                produced.append(out.add(op, ins, attrs))
        else:  # mlp: explicit wiring
            a = node.attrs
            up = out.add(chain[0][0], [src], chain[0][1])
            produced.append(up)
            if a.get("gated", True):
                gate = out.add("ffn_gate", [src], chain[1][1])
                glu = out.add("ffn_glu", [up, gate], chain[2][1])
                produced += [gate, glu]
                last_in = glu
                down_attrs = chain[3][1]
            else:
                act = out.add("ffn_act", [up], chain[1][1])
                produced.append(act)
                last_in = act
                down_attrs = chain[2][1]
            produced.append(out.add("ffn_down", [last_in], down_attrs))
        remap[node.id] = produced[-1]

    out.outputs = tuple(remap[o] for o in plan.outputs)
    return infer_types(out, catalog)


# --------------------------------------------------------------------------
# 2. redundancy elimination (CSE)
# --------------------------------------------------------------------------


def eliminate_redundancy(plan: Plan, catalog: FunctionCatalog) -> Plan:
    """§4.2.2: identical (op, inputs, attrs) nodes are merged, recursively."""
    out = Plan(plan.name, {}, dict(plan.inputs), plan.outputs, {}, plan._ctr)
    remap: dict = {i: i for i in plan.inputs}
    seen: dict = {}

    for node in plan.topo():
        sub = node.subplan
        if sub is not None:
            sub = eliminate_redundancy(sub, catalog)
        ins = tuple(remap[i] for i in node.inputs)
        key = (node.op, ins,
               tuple(sorted((k, _hashable(v)) for k, v in node.attrs.items())),
               sub.structure_key() if sub is not None else None)
        if key in seen and node.op != "store":  # stores are effects; keep them
            remap[node.id] = seen[key]
            continue
        nid = out.add(node.op, list(ins), dict(node.attrs), sub, id=node.id)
        seen[key] = nid
        remap[node.id] = nid

    out.outputs = tuple(remap[o] for o in plan.outputs)
    return infer_types(out, catalog)


def _hashable(v):
    if isinstance(v, dict):
        return tuple(sorted((k, _hashable(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_hashable(x) for x in v)
    if callable(v):
        return getattr(v, "__name__", repr(v))
    return v


# --------------------------------------------------------------------------
# 3. operator fusion
# --------------------------------------------------------------------------


def fuse_qkv(plan: Plan, catalog: FunctionCatalog) -> Plan:
    """Fuse sibling q/k/v projections on the same input into one ``qkv_proj``.

    This is the tensor analogue of the paper's NLP-annotator pipeline fusion:
    three per-token projections sharing one input become a single fused
    operator whose output tuple feeds sdpa, and the *fused* pattern
    (qkv_proj→sdpa→out_proj) is what the physical pattern set matches to
    flash-attention candidates (Fig. 7's "larger pattern ⇒ better plans").
    """
    out = Plan(plan.name, {}, dict(plan.inputs), plan.outputs, {}, plan._ctr)
    remap: dict = {i: i for i in plan.inputs}
    nodes = list(plan.topo())
    consumed: set = set()

    by_input: dict = {}
    for n in nodes:
        if n.op in ("q_proj", "k_proj", "v_proj"):
            by_input.setdefault((n.inputs[0], _attr_key(n.attrs)), {})[n.op] = n

    fused_for: dict = {}  # pack_qkv node id -> fused qkv node will replace it
    for (src, _), group in by_input.items():
        if set(group) == {"q_proj", "k_proj", "v_proj"}:
            cons = plan.consumers()
            packs = [c for c in cons[group["q_proj"].id]
                     if plan.nodes[c].op == "pack_qkv"]
            for p in packs:
                pn = plan.nodes[p]
                if (pn.inputs == (group["q_proj"].id, group["k_proj"].id,
                                  group["v_proj"].id)):
                    fused_for[p] = (src, dict(group["q_proj"].attrs))
                    consumed.update(g.id for g in group.values())

    for n in nodes:
        sub = n.subplan
        if sub is not None:
            sub = fuse_qkv(sub, catalog)
        if n.id in consumed:
            continue
        if n.id in fused_for:
            src, attrs = fused_for[n.id]
            nid = out.add("qkv_proj", [remap[src]], attrs, id=n.id + "_fused")
            remap[n.id] = nid
            continue
        nid = out.add(n.op, [remap[i] for i in n.inputs], dict(n.attrs), sub,
                      id=n.id)
        remap[n.id] = nid

    out.outputs = tuple(remap[o] for o in plan.outputs)
    return infer_types(out, catalog)


def fuse_scans(plan: Plan, catalog: FunctionCatalog) -> Plan:
    """Map-fusion (§4.2.3) for ``scan_layers``: consecutive scans with the same
    trip count fuse into one scan whose subplan is the concatenation.  The
    intermediate carry between the two scans is never materialized per-layer,
    and XLA sees one loop instead of two (smaller HLO, better overlap)."""
    out = Plan(plan.name, {}, dict(plan.inputs), plan.outputs, {}, plan._ctr)
    remap: dict = {i: i for i in plan.inputs}
    nodes = list(plan.topo())
    cons = plan.consumers()
    skip: set = set()

    i = 0
    by_id = {n.id: n for n in nodes}
    for n in nodes:
        if n.id in skip:
            continue
        sub = n.subplan
        if (n.op == "scan_layers" and len(cons[n.id]) == 1):
            nxt = by_id.get(cons[n.id][0])
            if (nxt is not None and nxt.op == "scan_layers"
                    and nxt.inputs == (n.id,)
                    and nxt.attrs.get("n_layers") == n.attrs.get("n_layers")
                    and n.attrs.get("param_group") == nxt.attrs.get("param_group")):
                merged = _concat_subplans(n.subplan, nxt.subplan)
                attrs = dict(n.attrs)
                attrs["fused_from"] = (n.id, nxt.id)
                nid = out.add("scan_layers", [remap[n.inputs[0]]], attrs,
                              merged, id=n.id + "+" + nxt.id)
                remap[n.id] = nid
                remap[nxt.id] = nid
                skip.add(nxt.id)
                continue
        if sub is not None:
            sub = fuse_scans(sub, catalog)
        nid = out.add(n.op, [remap[i2] for i2 in n.inputs], dict(n.attrs), sub,
                      id=n.id)
        remap[n.id] = nid

    out.outputs = tuple(remap[o] for o in plan.outputs)
    return infer_types(out, catalog)


def _concat_subplans(a: Plan, b: Plan) -> Plan:
    """Concatenate two single-input/single-output subplans: b(a(x))."""
    assert len(a.inputs) == 1 and len(b.inputs) == 1
    out = a.copy()
    out.name = f"{a.name}+{b.name}"
    (a_out,) = a.outputs
    (b_in,) = b.inputs
    remap = {b_in: a_out}
    for n in b.topo():
        nid = out.add(n.op, [remap.get(i, i) for i in n.inputs], dict(n.attrs),
                      n.subplan.copy() if n.subplan else None,
                      id="b_" + n.id)
        remap[n.id] = nid
    out.outputs = (remap[b.outputs[0]],)
    return out


def _attr_key(attrs):
    return tuple(sorted((k, _hashable(v)) for k, v in attrs.items()))


# --------------------------------------------------------------------------
# 4. cross-engine transfer placement (tri-store: AWESOME §2 / tech-report §4)
# --------------------------------------------------------------------------
#
# AWESOME's optimizer is aware that a workload straddles engines: data moving
# between the relational, graph, and text stores is an explicit, costed
# operation, and the in-memory optimization decides *where* intermediates
# materialize.  ``place_xfers`` makes every engine boundary an explicit
# ``xfer`` node; the physical pattern set then offers two candidates per
# xfer — ``xfer_pin`` (keep the value device-resident) and ``xfer_spill``
# (materialize through the host) — and the cost model picks per boundary.
# ``place_xfers_naive`` models the federated-baseline strawman instead:
# every store-engine operator's output is materialized through the host
# (spill-only xfer), the per-op materialization AWESOME's placement beats.


def _engine_of_type(t) -> str:
    from .ir import CorpusT, GraphT, TableT
    if isinstance(t, TableT):
        return "rel"
    if isinstance(t, GraphT):
        return "graph"
    if isinstance(t, CorpusT):
        return "text"
    return "xla"


def _engine_of(plan: Plan, nid: str, catalog: FunctionCatalog) -> str:
    """Engine a value lives on: plan inputs by their data-model type, xfer
    nodes by their destination, other ops by their catalog attribution."""
    if nid in plan.inputs:
        return _engine_of_type(plan.inputs[nid])
    node = plan.nodes[nid]
    if node.op == "xfer":
        return node.attrs.get("dst_engine", "xla")
    return catalog.get(node.op).engine


def _pure_xla(plan: Plan, catalog: FunctionCatalog) -> bool:
    """No store-typed inputs and no store-engine ops, recursively — the
    overwhelmingly common tensor-only case, where xfer placement is a
    guaranteed no-op."""
    if any(_engine_of_type(t) != "xla" for t in plan.inputs.values()):
        return False
    for n in plan.topo():
        if n.op != "xfer" and catalog.get(n.op).engine != "xla":
            return False
        if n.subplan is not None and not _pure_xla(n.subplan, catalog):
            return False
    return True


def place_xfers(plan: Plan, catalog: FunctionCatalog) -> Plan:
    """Insert an ``xfer`` node on every edge that crosses an engine boundary.

    One xfer is shared per (producer, destination-engine) pair, so a value
    consumed by several same-engine operators moves once.  Pure-tensor plans
    (every op on the ``xla`` engine) are returned unchanged — and without
    paying the plan copy, since this pass runs on every default compile.
    """
    if _pure_xla(plan, catalog):
        return plan
    infer_types(plan, catalog)
    out = Plan(plan.name, {}, dict(plan.inputs), plan.outputs, {}, plan._ctr)
    remap: dict = {i: i for i in plan.inputs}
    xfer_for: dict = {}   # (producer id in out, dst engine) -> xfer id

    def crossed(src_old: str, src_new: str, dst_engine: str) -> str:
        src_engine = _engine_of(plan, src_old, catalog)
        if src_engine == dst_engine:
            return src_new
        key = (src_new, dst_engine)
        if key not in xfer_for:
            xfer_for[key] = out.add(
                "xfer", [src_new],
                {"src_engine": src_engine, "dst_engine": dst_engine},
                id=f"xfer_{src_old}_{dst_engine}")
        return xfer_for[key]

    for node in plan.topo():
        sub = node.subplan
        if sub is not None:
            sub = place_xfers(sub, catalog)
        dst_engine = ("xla" if node.op == "xfer"
                      else catalog.get(node.op).engine)
        ins = []
        for i in node.inputs:
            src = remap[i]
            if node.op != "xfer":
                src = crossed(i, src, dst_engine)
            ins.append(src)
        nid = out.add(node.op, ins, dict(node.attrs), sub, id=node.id)
        remap[node.id] = nid

    out.outputs = tuple(remap[o] for o in plan.outputs)
    return infer_types(out, catalog)


def place_xfers_naive(plan: Plan, catalog: FunctionCatalog) -> Plan:
    """The per-op-materialization baseline: every store-engine operator's
    output round-trips through the host (a spill-only xfer), the way a
    naive federated system hands each engine result back to the mediator.
    Used by ``benchmarks/tri_store_eff.py`` as the strawman that planned
    placement must beat."""
    infer_types(plan, catalog)
    out = Plan(plan.name, {}, dict(plan.inputs), plan.outputs, {}, plan._ctr)
    remap: dict = {i: i for i in plan.inputs}

    for node in plan.topo():
        sub = node.subplan
        if sub is not None:
            sub = place_xfers_naive(sub, catalog)
        nid = out.add(node.op, [remap[i] for i in node.inputs],
                      dict(node.attrs), sub, id=node.id)
        remap[node.id] = nid
        engine = ("xla" if node.op == "xfer"
                  else catalog.get(node.op).engine)
        if engine != "xla":
            remap[node.id] = out.add(
                "xfer", [nid],
                {"src_engine": engine, "dst_engine": "xla",
                 "spill_only": True},
                id=f"spill_{node.id}")

    out.outputs = tuple(remap[o] for o in plan.outputs)
    return infer_types(out, catalog)


# --------------------------------------------------------------------------
# 5. cross-engine predicate pushdown (AWESOME tech report: pushdown + lazy
#    materialization across the tri-store)
# --------------------------------------------------------------------------
#
# Relational filters narrow a selection mask that, without this pass, only
# the relational engine sees: downstream engines score every document and
# touch every edge even when the seed relation kept 1% of its rows.
# ``push_predicates`` propagates that selection across engine boundaries:
#
#   * **filter-below-join** — a ``rel_filter`` over a ``rel_join`` whose
#     predicate column comes from the probe (left) side sinks below the
#     join, so the probe runs on the narrowed relation (mask conjunction
#     commutes, so this is exact);
#   * **mask-into-text** — the unpushed idiom ``masked_topk(text_scores(cx,
#     q), m)`` (score the whole corpus in the text engine, select+top-k
#     outside it) collapses into a 3-input ``text_topk(cx, q, m)``: the
#     mask crosses the xfer boundary *into* the text engine, where the
#     physical layer can offer masked/fused scoring candidates;
#   * **graph frontier masks** — ``graph_expand``/``graph_pagerank`` whose
#     frontier/personalization descends from a filtered relation are
#     annotated with the estimated frontier sparsity, unlocking the
#     block-skipping SpMV candidate.
#
# Every rewritten/annotated op carries a ``selectivity`` attr — the
# estimated selected fraction, the product of upstream filter
# selectivities (explicit ``selectivity=`` hints win over the per-cmp
# heuristics).  The cost model prices masked candidates with it, so
# pushdown is chosen only where it is expected to win (at selectivity 1.0
# the dense plan is kept).

def _filter_site_of(plan: Plan, node: Node) -> tuple:
    """The filter's feedback site key, built from its input relation's
    type (schema + capacity: the table-identity components the run-time
    recording side derives from the relation itself)."""
    from .feedback import filter_site
    t = plan.types.get(node.inputs[0]) if node.inputs else None
    cols = t.col_names() if hasattr(t, "col_names") else ()
    cap = getattr(t, "rows", None)
    return filter_site(node.attrs, cols, cap)


def _filter_selectivity(node: Node, site: tuple = None) -> float:
    """*Marginal* selected fraction of one rel_filter: observed feedback
    (blended over the a-priori estimate) wins, then the explicit
    ``selectivity=`` hint (the paper's metadata route), then a
    per-comparator heuristic.

    Observation-over-hint ordering is the point of the feedback loop: a
    mis-hinted filter self-corrects once a run has been observed."""
    from .feedback import active_feedback
    if "selectivity" in node.attrs:
        base = float(node.attrs["selectivity"])
    else:
        base = _CMP_SELECTIVITY.get(node.attrs.get("cmp"), 0.5)
    fb = active_feedback()
    if fb is not None and site is not None:
        return fb.blend(site, base)
    return base


def estimate_selectivity(plan: Plan, nid: str, catalog: FunctionCatalog,
                         _memo: dict | None = None) -> float:
    """Estimated selected fraction of the value produced at ``nid``.

    Filters multiply along the lineage; group-by and entity-mask exports
    rescale row selectivity onto the group/entity domain (an upper bound:
    ``min(1, s · rows / domain)``); joins only narrow, so they pass the
    probe side's estimate through.  Plan inputs are fully selected (1.0).
    """
    memo = _memo if _memo is not None else {}
    if nid in memo:
        return memo[nid]
    if nid in plan.inputs:
        return 1.0
    node = plan.nodes[nid]

    def up(i):
        return estimate_selectivity(plan, node.inputs[i], catalog, memo)

    if node.op == "rel_filter":
        s = up(0) * _filter_selectivity(node, _filter_site_of(plan, node))
    elif node.op in ("rel_scan", "col_tensor", "xfer"):
        s = up(0)
    elif node.op == "rel_join":
        s = up(0)
    elif node.op == "compact":
        # compaction re-bases the fraction onto the narrowed capacity: the
        # surviving rows now fill (up to) the whole smaller relation
        t_in = plan.types.get(node.inputs[0])
        rows = getattr(t_in, "rows", 1)
        cap = int(node.attrs.get("capacity", rows))
        s = min(1.0, up(0) * max(rows, 1) / max(cap, 1))
    elif node.op in ("rel_group_agg", "sel_mask"):
        t = plan.types.get(node.inputs[0])
        rows = getattr(t, "rows", 1)
        domain = int(node.attrs.get("num_groups", node.attrs.get("size", 1)))
        s = min(1.0, up(0) * max(rows, 1) / max(domain, 1))
        if node.op == "sel_mask":
            from .feedback import active_feedback, sel_mask_site
            fb = active_feedback()
            if fb is not None:
                s = fb.blend(sel_mask_site(node.attrs), s)
    else:
        s = 1.0
    s = float(min(max(s, 0.0), 1.0))
    memo[nid] = s
    return s


def _rebuild(plan: Plan, skip: set, replace_fn) -> Plan:
    """Rebuild ``plan`` skipping ``skip`` node ids; ``replace_fn(node, out,
    remap)`` may emit a replacement and return its id (or None to copy)."""
    out = Plan(plan.name, {}, dict(plan.inputs), plan.outputs, {}, plan._ctr)
    remap: dict = {i: i for i in plan.inputs}
    for node in plan.topo():
        if node.id in skip:
            continue
        rid = replace_fn(node, out, remap)
        if rid is None:
            rid = out.add(node.op, [remap[i] for i in node.inputs],
                          dict(node.attrs), node.subplan, id=node.id)
        remap[node.id] = rid
    out.outputs = tuple(remap[o] for o in plan.outputs)
    return out


def _dce(plan: Plan) -> Plan:
    """Drop nodes unreachable from the outputs (pushdown leaves the
    replaced ``text_scores``/``masked_topk`` producers dangling)."""
    live: set = set(plan.outputs)
    for node in reversed(list(plan.topo())):
        if node.id in live:
            live.update(node.inputs)
    dead = {n.id for n in plan.topo() if n.id not in live}
    if not dead:
        return plan
    return _rebuild(plan, dead, lambda n, o, r: None)


def _sink_filters_below_joins(plan: Plan, catalog: FunctionCatalog,
                              info: list) -> Plan:
    """``rel_filter(rel_join(L, R), col ∈ L)`` → ``rel_join(rel_filter(L),
    R)`` to fixpoint, when the join's only consumer is the filter."""
    from .ir import TableT
    changed = True
    while changed:
        changed = False
        cons = plan.consumers()
        for node in plan.topo():
            if node.op != "rel_filter":
                continue
            src = node.inputs[0]
            if src in plan.inputs:
                continue
            j = plan.nodes[src]
            if j.op != "rel_join" or len(cons[src]) != 1:
                continue
            lt = plan.types.get(j.inputs[0])
            if not (isinstance(lt, TableT) and lt.has_col(node.attrs["col"])):
                continue        # predicate reads a build-side column

            def repl(n, out, remap, _f=node, _j=j):
                if n.id == _j.id:
                    f2 = out.add("rel_filter", [remap[_j.inputs[0]]],
                                 dict(_f.attrs), id=_f.id + "_sunk")
                    return out.add("rel_join", [f2, remap[_j.inputs[1]]],
                                   dict(_j.attrs), id=_j.id)
                if n.id == _f.id:
                    return remap[_j.id]
                return None

            info.append({"rule": "filter_below_join", "filter": node.id,
                         "join": j.id, "col": node.attrs["col"]})
            plan = infer_types(_rebuild(plan, set(), repl), catalog)
            changed = True
            break
    return plan


def push_predicates(plan: Plan, catalog: FunctionCatalog) -> Plan:
    """Propagate relational selection masks across engine boundaries."""
    if _pure_xla(plan, catalog):
        return plan
    infer_types(plan, catalog)
    info: list = []
    plan = _sink_filters_below_joins(plan, catalog, info)

    memo: dict = {}
    cons = plan.consumers()
    # mask-into-text: masked_topk(text_scores(cx, q), m) -> text_topk(cx,
    # q, m) when the full score vector has no other consumer
    pushed: dict = {}       # masked_topk id -> (scores node, mask id)
    for node in plan.topo():
        if node.op != "masked_topk":
            continue
        sc_id, m_id = node.inputs
        if sc_id in plan.inputs:
            continue
        sc = plan.nodes[sc_id]
        if sc.op == "text_scores" and len(cons[sc_id]) == 1:
            pushed[node.id] = (sc, m_id)

    def repl(node, out, remap):
        if node.id in pushed:
            sc, m_id = pushed[node.id]
            sel = float(node.attrs.get(
                "selectivity",
                estimate_selectivity(plan, m_id, catalog, memo)))
            attrs = {"k": node.attrs["k"], "pushed": True,
                     "selectivity": sel}
            info.append({"rule": "mask_into_text", "op": node.id,
                         "mask": m_id, "selectivity": round(sel, 4)})
            return out.add(
                "text_topk",
                [remap[sc.inputs[0]], remap[sc.inputs[1]], remap[m_id]],
                attrs, id=node.id + "_pushed")
        if node.op in ("graph_expand", "graph_pagerank") \
                and len(node.inputs) == 2:
            sel = estimate_selectivity(plan, node.inputs[1], catalog, memo)
            if sel < 1.0:
                key = ("frontier_selectivity" if node.op == "graph_expand"
                       else "personalization_selectivity")
                attrs = dict(node.attrs)
                attrs[key] = float(round(sel, 6))
                info.append({"rule": "mask_into_graph", "op": node.id,
                             key: round(sel, 4)})
                return out.add(node.op, [remap[i] for i in node.inputs],
                               attrs, id=node.id)
        return None

    out = _dce(_rebuild(plan, set(), repl))
    out = infer_types(out, catalog)
    if info:
        out.__dict__["_pass_info"] = {"pushed": info}
    return out


# --------------------------------------------------------------------------
# 5b. compaction placement + cardinality annotation (bounded relations)
# --------------------------------------------------------------------------
#
# Masked execution drags every relation at full capacity through every
# downstream operator: a 1%-selective filter still probes, aggregates, and
# exports masks over 100% of the rows.  ``choose_compaction`` inserts a
# ``compact`` node — stable prefix compaction into a small capacity sized
# from the expected count — below low-selectivity filters, and reroutes the
# shape-agnostic consumers (further filters, group-by, mask export, and the
# *probe* side of joins) onto the compacted relation.  Compaction is only
# placed where the cardinality estimate is **trustworthy** (an explicit
# ``selectivity=`` hint or an observed-feedback site, on an otherwise
# unnarrowed input), because an underestimate would overflow the bound
# and drop rows; the capacity carries 2x slack and the runtime overflow
# flag makes any residual miss observable rather than silent.  (Dropped
# rows contribute exactly +/-0.0 to every mask-weighted consumer, so
# compaction is bitwise-neutral for *finite* column data; a masked NaN/inf
# value would poison a masked-dense sum but not a compacted one.)
#
# The same pass annotates every join with its build/probe cardinalities
# (``build_rows`` / ``build_expected`` / ``probe_expected``), the attrs the
# physical layer's Pallas probe-kernel candidate is gated and priced on.

COMPACT_SELECTIVITY = 0.125    # compact only below this expected fraction
COMPACT_SLACK = 2.0            # capacity headroom over the expected count
COMPACT_MIN_CAPACITY = 8

def _round_up(n: int, mult: int = 8) -> int:
    return ((int(n) + mult - 1) // mult) * mult


def _confident_selectivity(plan: Plan, node: Node, catalog, memo) -> float:
    """The filter's expected fraction, but only when the estimate is
    trustworthy enough to size a lossy capacity bound: the site must carry
    an explicit hint or an observed-feedback record, the filter's input
    must be **unnarrowed** (any upstream selection — hinted or not —
    disqualifies the site: the bound is sized from this filter's fraction
    alone, so compounded upstream narrowing has no backing estimate here;
    compound-confidence tracking is future work), and the site must not
    have been *observed to overflow* a previous compaction.  Returns a
    fraction, or -1 when not confident."""
    from .feedback import active_feedback
    fb = active_feedback()
    site = _filter_site_of(plan, node)
    if fb is not None and fb.is_overflowed(site):
        return -1.0            # a prior bound dropped rows: back off
    observed = fb is not None and fb.lookup(site) is not None
    if "selectivity" not in node.attrs and not observed:
        return -1.0
    up = estimate_selectivity(plan, node.inputs[0], catalog, memo)
    if up < 1.0 - 1e-9:
        return -1.0
    return _filter_selectivity(node, site)


def _capacity_safe(plan: Plan, cons: dict, nid: str, memo: dict) -> bool:
    """Whether every *transitive* consumer of ``nid`` re-bases onto a
    fixed domain before any capacity-sensitive use.  A compacted relation
    has a smaller capacity and prefix-reordered rows, so it may only flow
    into consumers whose output shape/content is independent of the input
    capacity: group-bys and mask exports (fixed domains), ``bounded_join``
    (fixed declared capacity, duplicate/masked build rows handled), and —
    recursively — filters, further compacts, and unique-join *probe* sides
    whose own outputs are capacity-safe.  ``col_tensor`` (capacity-long
    tensor out), a unique-join *build* side (padding would duplicate
    keys), and being a plan output are all capacity-sensitive."""
    if nid in memo:
        return memo[nid]
    if nid in set(plan.outputs):
        memo[nid] = False
        return False
    ok = True
    for c in cons[nid]:
        cn = plan.nodes[c]
        if cn.op in ("rel_group_agg", "sel_mask", "bounded_join"):
            continue
        if cn.op in ("rel_filter", "compact", "rel_scan") \
                and cn.inputs[0] == nid:
            ok = _capacity_safe(plan, cons, c, memo)
        elif cn.op == "rel_join" and cn.inputs[0] == nid \
                and cn.inputs[1] != nid:
            ok = _capacity_safe(plan, cons, c, memo)
        else:
            ok = False
        if not ok:
            break
    memo[nid] = ok
    return ok


def choose_compaction(plan: Plan, catalog: FunctionCatalog) -> Plan:
    """Insert ``compact`` below confidently low-selectivity filters and
    annotate joins with build/probe cardinalities."""
    if _pure_xla(plan, catalog):
        return plan
    infer_types(plan, catalog)
    memo: dict = {}
    cons = plan.consumers()
    info: list = []

    safe_memo: dict = {}
    targets: dict = {}        # filter node id -> (capacity, expected, site)
    reroute: set = set()      # (consumer id, input position) pairs
    for node in plan.topo():
        if node.op != "rel_filter":
            continue
        t = plan.types.get(node.id)
        rows = getattr(t, "rows", 0)
        sel = _confident_selectivity(plan, node, catalog, memo)
        if sel < 0.0 or sel > COMPACT_SELECTIVITY:
            continue
        expected = max(1, int(math.ceil(rows * sel)))
        capacity = _round_up(max(COMPACT_MIN_CAPACITY,
                                 int(math.ceil(expected * COMPACT_SLACK))))
        if capacity >= rows:
            continue          # nothing to gain
        elig = []
        for c in cons[node.id]:
            cn = plan.nodes[c]
            for pos, i in enumerate(cn.inputs):
                if i != node.id:
                    continue
                if cn.op in ("rel_group_agg", "sel_mask", "bounded_join"):
                    elig.append((c, pos))      # fixed-domain consumers
                elif cn.op == "rel_filter" and pos == 0 \
                        and _capacity_safe(plan, cons, c, safe_memo):
                    elig.append((c, pos))
                elif cn.op == "rel_join" and pos == 0 \
                        and _capacity_safe(plan, cons, c, safe_memo):
                    elig.append((c, pos))      # probe side, safe downstream
        if not elig:
            continue
        targets[node.id] = (capacity, expected, _filter_site_of(plan, node))
        reroute.update(elig)
        info.append({"rule": "compact_below_filter", "filter": node.id,
                     "capacity": capacity, "expected": expected,
                     "rows": int(rows), "selectivity": round(sel, 4)})

    out = Plan(plan.name, {}, dict(plan.inputs), plan.outputs, {}, plan._ctr)
    remap: dict = {i: i for i in plan.inputs}
    compact_of: dict = {}
    for node in plan.topo():
        ins = []
        for pos, i in enumerate(node.inputs):
            if (node.id, pos) in reroute and i in compact_of:
                ins.append(compact_of[i])
            else:
                ins.append(remap[i])
        attrs = dict(node.attrs)
        if node.op == "rel_filter":
            # stamp the feedback site computed from the *pre-compaction*
            # view: a filter rerouted onto a compact sees a different
            # capacity at run time, so without the stamp its observations
            # would be recorded under a key no planning run ever looks up
            attrs["site"] = _filter_site_of(plan, node)
        if node.op in ("rel_join", "bounded_join"):
            # cardinality annotation for the physical probe-kernel gate
            bt = plan.types.get(node.inputs[1])
            pt = plan.types.get(node.inputs[0])
            if hasattr(bt, "expected_rows"):
                attrs["build_rows"] = int(bt.rows)
                attrs["build_expected"] = bt.expected_rows()
            if hasattr(pt, "expected_rows"):
                attrs["probe_expected"] = pt.expected_rows()
        nid = out.add(node.op, ins, attrs, node.subplan, id=node.id)
        remap[node.id] = nid
        if node.id in targets:
            cap, exp, site = targets[node.id]
            t = plan.types.get(node.id)
            compact_of[node.id] = out.add(
                "compact", [nid],
                {"capacity": cap, "expected_count": exp,
                 # the predicate site (overflow observations feed back to
                 # _confident_selectivity) and the column dtypes (the
                 # Pallas one-hot candidate is float/bool-exact only)
                 "site": site,
                 "col_dtypes": tuple(d for _, d in t.columns)},
                id=node.id + "_compact")

    out.outputs = tuple(remap[o] for o in plan.outputs)
    out = infer_types(out, catalog)
    if info:
        out.__dict__["_pass_info"] = {"compacted": info}
    return out


# --------------------------------------------------------------------------
# 6. same-engine store-op fusion (the Fig. 7 larger-pattern argument, for
#    store chains: masks never round-trip as full-width intermediates)
# --------------------------------------------------------------------------

# compact and bounded_join fuse like any other rel op (their step fns are
# in the executor's shared _REL_STEPS table), so inserting a compaction
# below a filter does not split a scan->filter->join->group_agg chain —
# the low-selectivity regime compaction targets is exactly where the
# fused-superkernel win matters most
_REL_FUSABLE = ("rel_scan", "rel_filter", "compact", "rel_join",
                "bounded_join", "rel_group_agg")


def fuse_store_ops(plan: Plan, catalog: FunctionCatalog) -> Plan:
    """Collapse single-consumer chains of relational store ops into one
    ``rel_fused`` node whose ``chain`` attr records the steps.  The fused
    node is a *larger logical pattern* for the physical layer: one engine
    call per chain (the masked segment-aggregate kernel slots in here), and
    interior tables never surface as plan-level intermediates.
    """
    if _pure_xla(plan, catalog):
        return plan
    infer_types(plan, catalog)
    cons = plan.consumers()
    out_set = set(plan.outputs)

    fusable = _REL_FUSABLE
    syscat = _ACTIVE_SYSCAT.get()
    if (syscat is not None and syscat.axis_size("data") > 1
            and any(getattr(t, "partitioning", None)
                    for t in plan.inputs.values())):
        # under mesh sharding, joins stay standalone plan nodes: the
        # distributed join kernels (broadcast build / all-to-all
        # co-partition) dispatch on the node's ``dist`` attr, which
        # ``shard_stores`` cannot stamp on a step buried inside a chain
        fusable = tuple(op for op in fusable
                        if op not in ("rel_join", "bounded_join"))

    # group maximal chains by walking producers of the first (table) input
    group_of: dict = {}       # node id -> chain head id
    chains: dict = {}         # head id -> [Node, ...] in order
    for node in plan.topo():
        if node.op not in fusable:
            continue
        src = node.inputs[0]
        head = group_of.get(src)
        if (head is not None and len(cons[src]) == 1
                and src not in out_set):
            group_of[node.id] = head
            chains[head].append(node)
        else:
            group_of[node.id] = node.id
            chains[node.id] = [node]

    fused = {h: c for h, c in chains.items() if len(c) >= 2}
    if not fused:
        return plan
    in_chain = {n.id: h for h, c in fused.items() for n in c}
    info = [{"head": h, "ops": [n.op for n in c], "len": len(c)}
            for h, c in fused.items()]

    out = Plan(plan.name, {}, dict(plan.inputs), plan.outputs, {}, plan._ctr)
    remap: dict = {i: i for i in plan.inputs}
    for node in plan.topo():
        head = in_chain.get(node.id)
        if head is None:
            nid = out.add(node.op, [remap[i] for i in node.inputs],
                          dict(node.attrs), node.subplan, id=node.id)
            remap[node.id] = nid
            continue
        chain = fused[head]
        if node.id != chain[-1].id:
            # interior members are consumed only inside the chain: defer
            # emission to the tail's position, where every external input
            # (e.g. a later join's build side) is already remapped
            continue
        members = {n.id for n in chain}
        ext_inputs: list = []   # external producer ids, in first-use order
        steps = []
        prev_id = None
        for n in chain:
            srcs = []
            for i in n.inputs:
                # the chain is linear along first inputs: only the previous
                # member is reachable as "prev"; anything else (e.g. a
                # join's build side) is an external input
                if i in members and i == prev_id:
                    srcs.append("prev")
                else:
                    key = remap[i]
                    if key not in ext_inputs:
                        ext_inputs.append(key)
                    srcs.append(ext_inputs.index(key))
            steps.append((n.op, dict(n.attrs), tuple(srcs),
                          plan.types.get(n.id)))
            prev_id = n.id
        nid = out.add("rel_fused", ext_inputs,
                      {"chain": tuple(steps)}, id="fused_" + head)
        for n in chain:
            remap[n.id] = nid

    out.outputs = tuple(remap[o] for o in plan.outputs)
    out = infer_types(out, catalog)
    out.__dict__["_pass_info"] = {"fused_chains": info}
    return out


# --------------------------------------------------------------------------
# 7. store sharding over the device mesh ("shard_stores")
# --------------------------------------------------------------------------
#
# When any bound store is declared partitioned over the mesh's ``data`` axis
# (``ColumnStore.with_shards`` / ``GraphStore.with_shards`` /
# ``TextStore.with_shards``), this pass (a) propagates partitioned-ness
# through the dataflow, (b) stamps a ``dist`` attr on every store op the
# runtime can execute shard-locally, (c) picks the distributed join strategy
# (broadcast the build side vs co-partition both sides) from the build
# side's *expected* cardinality, and (d) kinds every cross-engine ``xfer``
# as ``local`` / ``replicate`` / ``repartition`` so the cost model prices
# its wire bytes.  Values stay logically global throughout — ``dist`` is a
# pure performance annotation (shard_map slices the global value; any op
# without a sharded realization falls back to the dense global kernel), so
# there is no correctness cliff when a shape fails a divisibility check.

_ACTIVE_SYSCAT = contextvars.ContextVar("rewrite_syscat", default=None)

# build sides at or under this many expected rows replicate (all-gather);
# larger builds co-partition both sides with an all-to-all shuffle
BROADCAST_BUILD_MAX = 4096
# headroom multiplier on the expected per-(sender, owner) shuffle bucket
SHUFFLE_SLACK = 4

_DTYPE_BYTES = {"float64": 8, "int64": 8, "float32": 4, "int32": 4,
                "float16": 2, "bfloat16": 2, "int16": 2, "int8": 1, "bool": 1}


def _value_bytes(t) -> int:
    """Expected wire size of a value: tables by expected (not capacity)
    rows, tensors dense, stores by their edge/posting payloads."""
    from .ir import CorpusT, GraphT, TableT, TensorT
    if isinstance(t, TableT):
        row = sum(_DTYPE_BYTES.get(str(d), 4) for _, d in t.columns) + 1
        return int(t.expected_rows()) * row
    if isinstance(t, TensorT):
        size = 1
        for s in t.shape:
            size *= int(s)
        return size * _DTYPE_BYTES.get(str(t.dtype), 4)
    if isinstance(t, GraphT):
        return int(t.edges) * 12          # (src, dst, weight) per edge
    if isinstance(t, CorpusT):
        return int(t.postings) * 12       # (doc, term, tf) per posting
    return 0


# per-op partitioned-ness transfer for fused-chain steps: ops that keep the
# row partition of their first input vs ops whose output is replicated
_PART_KEEPS = {"rel_scan", "rel_filter", "rel_join", "bounded_join",
               "col_tensor"}
_PART_DROPS = {"rel_group_agg", "compact", "sel_mask", "text_topk",
               "masked_topk", "graph_tricount"}


def shard_stores(plan: Plan, catalog: FunctionCatalog) -> Plan:
    syscat = _ACTIVE_SYSCAT.get()
    n = 1 if syscat is None else int(syscat.axis_size("data"))
    if n <= 1:
        return plan
    infer_types(plan, catalog)
    if not any(getattr(t, "partitioning", None)
               for t in plan.inputs.values()):
        return plan

    out = Plan(plan.name, {}, dict(plan.inputs), plan.outputs, {}, plan._ctr)
    remap: dict = {i: i for i in plan.inputs}
    part: dict = {i: bool(getattr(t, "partitioning", None))
                  for i, t in plan.inputs.items()}
    xfers, dist_nodes = [], []

    def table_divides(t) -> bool:
        return int(t.rows) % n == 0

    def reshard(src: str, owner: str, side: str, est: int) -> str:
        nid = out.add("xfer", [src],
                      {"src_engine": "rel", "dst_engine": "rel",
                       "kind": "repartition", "est_bytes": est},
                      id=f"reshard_{owner}_{side}")
        part[nid] = True
        xfers.append({"id": nid, "kind": "repartition", "est_bytes": est})
        return nid

    for node in plan.topo():
        tys = [plan.types[i] if i in plan.nodes else plan.inputs[i]
               for i in node.inputs]
        ins = [remap[i] for i in node.inputs]
        attrs = dict(node.attrs)
        p_in = part.get(node.inputs[0], False) if node.inputs else False
        p_out = False
        ty = plan.types[node.id]

        if node.op == "xfer":
            if attrs.get("spill_only"):
                kind = None               # the naive spill path stays priced
            elif not p_in:
                kind = "local"            # replicated value: pointer move
            elif attrs.get("dst_engine") == "xla":
                kind = "replicate"        # dense consumers need it whole
            else:
                kind = "local"            # stays partitioned in the store
                p_out = True
            if kind is not None:
                b = _value_bytes(tys[0])
                est = (0 if kind == "local"
                       else b * (n - 1) // n)
                attrs["kind"] = kind
                attrs["est_bytes"] = est
                xfers.append({"id": node.id, "kind": kind, "est_bytes": est})
        elif node.op in ("rel_join", "bounded_join") and p_in:
            lt, rt = tys
            be = attrs.get("build_expected", rt.expected_rows())
            cap = int(attrs.get("capacity", 0))
            can_partition = (node.op == "bounded_join" and cap % n == 0
                             and table_divides(lt) and table_divides(rt))
            if int(be) <= BROADCAST_BUILD_MAX or not can_partition:
                attrs["dist"] = "broadcast"
                # build side replicates: price its all-gather on this node
                attrs["bcast_bytes"] = _value_bytes(rt) * (n - 1) // n
            else:
                attrs["dist"] = "partitioned"
                per_bucket = max(lt.expected_rows(), rt.expected_rows())
                attrs["bucket_cap"] = max(
                    16, -(-SHUFFLE_SLACK * int(per_bucket)) // (n * n))
                est = (_value_bytes(lt) + _value_bytes(rt)) * (n - 1) // (n * n)
                ins = [reshard(ins[0], node.id, "l", est // 2),
                       reshard(ins[1], node.id, "r", est - est // 2)]
            p_out = True
            dist_nodes.append({"id": node.id, "op": node.op,
                               "dist": attrs["dist"],
                               "build_expected": int(be)})
        elif node.op in ("rel_scan", "rel_filter", "col_tensor", "sel_mask",
                         "rel_group_agg") and p_in:
            attrs["dist"] = "row"
            p_out = node.op in _PART_KEEPS
            dist_nodes.append({"id": node.id, "op": node.op, "dist": "row"})
        elif node.op == "rel_fused" and p_in:
            attrs["dist"] = "row"
            p = True
            for op, _a, _s, _t in attrs["chain"]:
                p = p and op in _PART_KEEPS
            p_out = p
            dist_nodes.append({"id": node.id, "op": node.op, "dist": "row"})
        elif (node.op in ("graph_expand", "graph_pagerank")
              and getattr(tys[0], "partitioning", None) == "block"):
            attrs["dist"] = "block"
            p_out = True
            dist_nodes.append({"id": node.id, "op": node.op, "dist": "block"})
        elif (node.op == "text_topk" and len(node.inputs) == 2
              and getattr(tys[0], "partitioning", None) == "doc"):
            attrs["dist"] = "doc"
            dist_nodes.append({"id": node.id, "op": node.op, "dist": "doc"})
        elif node.op == "compact":
            p_out = False
        else:
            # dense / xla ops consume the global value and emit replicated;
            # fall back to the output type's own declaration when present
            p_out = bool(getattr(ty, "partitioning", None))

        nid = out.add(node.op, ins, attrs, node.subplan, id=node.id)
        remap[node.id] = nid
        part[nid] = p_out

    out.outputs = tuple(remap[o] for o in plan.outputs)
    out = infer_types(out, catalog)
    out.__dict__["_pass_info"] = {"xfers": xfers, "dist": dist_nodes}
    return out


# --------------------------------------------------------------------------
# pipelines
# --------------------------------------------------------------------------

DEFAULT_PIPELINE = ("decompose", "cse", "fuse_qkv", "fuse_scans", "cse",
                    "push_predicates", "choose_compaction", "fuse_store_ops",
                    "place_xfers", "shard_stores")

# the pipeline before pushdown (planned xfer placement, no cross-engine pushdown): the
# baseline the pushdown benchmark compares against
UNPUSHED_PIPELINE = ("decompose", "cse", "fuse_qkv", "fuse_scans", "cse",
                     "place_xfers", "shard_stores")

# the masked-dense baseline: full pushdown but no compaction — every
# relation stays at base capacity behind its mask (what the --bounded
# benchmark compares compact-then-dense against)
UNCOMPACTED_PIPELINE = tuple(p for p in DEFAULT_PIPELINE
                             if p != "choose_compaction")

_PASSES: dict = {
    "decompose": decompose,
    "cse": eliminate_redundancy,
    "fuse_qkv": fuse_qkv,
    "fuse_scans": fuse_scans,
    "push_predicates": push_predicates,
    "choose_compaction": choose_compaction,
    "fuse_store_ops": fuse_store_ops,
    "place_xfers": place_xfers,
    "place_xfers_naive": place_xfers_naive,
    "shard_stores": shard_stores,
}


def rewrite(plan: Plan, catalog: FunctionCatalog,
            pipeline=DEFAULT_PIPELINE) -> Plan:
    """Run the logical-rewrite pipeline (the paper's Fig. 6 sequencing:
    decompose → merge redundancy → fuse)."""
    out, _ = rewrite_with_trace(plan, catalog, pipeline)
    return out


def rewrite_with_trace(plan: Plan, catalog: FunctionCatalog,
                       pipeline=DEFAULT_PIPELINE, syscat=None) -> tuple:
    """Like :func:`rewrite`, also returning per-rule timing/size records
    ``[{"rule", "wall_ms", "nodes_before", "nodes_after"}, ...]`` for the
    EXPLAIN report of the staged plan pipeline.  ``syscat`` (the mesh-aware
    system catalog) is installed for passes that shard against the mesh —
    without it ``shard_stores`` no-ops."""
    import time

    token = _ACTIVE_SYSCAT.set(syscat)
    try:
        return _rewrite_with_trace(plan, catalog, pipeline)
    finally:
        _ACTIVE_SYSCAT.reset(token)


def _rewrite_with_trace(plan: Plan, catalog: FunctionCatalog,
                        pipeline=DEFAULT_PIPELINE) -> tuple:
    import time

    infer_types(plan, catalog)
    trace = []
    for name in pipeline:
        before = count_nodes(plan)
        t0 = time.perf_counter()
        plan = _PASSES[name](plan, catalog)
        rec = {
            "rule": name,
            "wall_ms": (time.perf_counter() - t0) * 1e3,
            "nodes_before": before,
            "nodes_after": count_nodes(plan),
        }
        # passes may leave a side-channel report (e.g. push_predicates:
        # which ops received masks and at what estimated selectivity) —
        # surfaced per rule in the EXPLAIN trace
        extra = plan.__dict__.pop("_pass_info", None)
        if extra:
            rec["info"] = extra
        trace.append(rec)
    return plan, trace
