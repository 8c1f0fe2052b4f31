"""Physical planning (paper §5, Algorithms 1–2).

The logical plan is transformed into *candidate physical plans*:

  * an **ordered pattern set** maps logical sub-DAGs to sets of physical
    sub-plans, matched largest-first (Def. 5.1, Alg. 2 line 2);
  * a pattern with exactly one candidate is substituted in place
    (Alg. 2 lines 6–7);
  * a pattern with several candidates becomes a **virtual node** whose
    candidate sub-plans live in the ``PM`` map (Alg. 2 lines 8–9) and whose
    winner is chosen by the learned cost model once input sizes are known
    (trace time, §6.3).

Every physical operator carries the paper's capability annotations
(Table 3 / Table 5): data-parallel capability ``ST``/``PR``/``EX`` with a
``capOn`` input dimension, and buffering capability ``SI``/``SO``/``B``/``SS``.
``EX`` operators (Pallas kernels — our "external engines") are excluded from
the partitioning rewrites, exactly as the paper excludes external-library
operators from its data-parallelism optimization.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

from ..kernels.masked_kernels import JOIN_PROBE_MAX_BUILD
from .ir import Plan, Node, TensorT, TupleT, ValidationError

# --------------------------------------------------------------------------
# Physical operator definitions (capability catalog — paper Table 3/5)
# --------------------------------------------------------------------------

ST, PR, EX = "ST", "PR", "EX"          # data-parallel capability
SI, SO, B, SS = "SI", "SO", "B", "SS"  # buffering capability


@dataclass(frozen=True)
class PhysicalOpDef:
    name: str
    dp_cap: str = PR
    buf_cap: str = SS
    cap_on: Optional[str] = "batch"   # semantic dim the op partitions/streams on
    backend: str = "xla"              # "xla" | "pallas"
    cap_all: bool = False             # PR on *every* input (elementwise joins)


PHYS_OPS: dict = {}


def defop(name, dp_cap=PR, buf_cap=SS, cap_on="batch", backend="xla",
          cap_all=False):
    PHYS_OPS[name] = PhysicalOpDef(name, dp_cap, buf_cap, cap_on, backend,
                                   cap_all)
    return PHYS_OPS[name]


# --- query-analogue ops (data movement / bookkeeping)
defop("identity")
defop("partition", dp_cap=ST, buf_cap=SO, cap_on=None)   # §5.2 Partition step
defop("merge", dp_cap=ST, buf_cap=SI, cap_on=None)       # §5.2 Merge step
defop("const", dp_cap=ST, buf_cap=SO, cap_on=None)
# store is PR: a sharded sink — each host persists its own shard (sharded
# checkpointing), so no Merge is forced before it.  (Treating store as ST,
# per the paper's Table 5, all-gathered full 32k-prefill logits to every
# device: +1.17e12 wire bytes on gemma3-27b×prefill_32k.  See §Perf.)
defop("store", dp_cap=PR, buf_cap=SI)

# --- embedding / head
defop("embed_gather")                                     # PR over batch
defop("unembed_matmul", buf_cap=SS)
defop("softmax_xent_xla", buf_cap=SI, cap_all=True)       # logits+labels sharded

# --- norms / elementwise
defop("rmsnorm_xla")
defop("residual_add_xla", cap_all=True)
defop("concat_seq", cap_all=True)

# --- attention family
defop("q_proj_xla"); defop("k_proj_xla"); defop("v_proj_xla")
defop("qkv_proj_fused")                                   # fused projection
defop("pack_qkv_xla", cap_all=True)
defop("sdpa_xla")                                         # full masked attention
defop("sdpa_banded_xla")                                  # O(S·W) local window
defop("attn_flash_pallas", dp_cap=EX, buf_cap=SS, backend="pallas")
defop("out_proj_xla")
defop("cross_attention_xla")

# --- mlp family
defop("ffn_up_xla"); defop("ffn_gate_xla")
defop("ffn_glu_xla", cap_all=True)
defop("ffn_act_xla"); defop("ffn_down_xla")
defop("mlp_fused_xla")                                    # single fused GLU block

# --- MoE family
defop("moe_dense_onehot")                                 # dense dispatch einsum
defop("moe_dropping")                                     # capacity-dropped dispatch
defop("moe_gmm_pallas", dp_cap=EX, buf_cap=SS, backend="pallas")

# --- recurrent families
defop("rwkv_channel_mix")
defop("wkv6_scan_xla", buf_cap=SS)
defop("wkv6_pallas", dp_cap=EX, buf_cap=SS, backend="pallas")
defop("ssd_chunked_xla", buf_cap=SS)
defop("ssd_pallas", dp_cap=EX, buf_cap=SS, backend="pallas")

# --- higher order
defop("scan_layers_xla", buf_cap=B, cap_on="batch")
# tuple projection (KV-collecting scans return (carry, kv); the serving
# prefill plan extracts both).  Blocking for buffering purposes: the tuple
# is produced whole by the scan.
defop("tuple_get_xla", buf_cap=B)

# --- tri-store engines (relational / graph / text) + cross-engine movement.
# Store operators are ST (they run whole-relation/whole-graph inside their
# engine, excluded from batch partitioning exactly as the paper excludes
# external engines), and the graph Pallas kernels are EX like the other
# Pallas ops.
defop("rel_scan_col", dp_cap=ST, buf_cap=SO, cap_on=None, backend="rel")
defop("rel_filter_col", dp_cap=ST, buf_cap=SS, cap_on=None, backend="rel")
defop("rel_hash_join", dp_cap=ST, buf_cap=SI, cap_on=None, backend="rel")
# bounded relations: non-unique-build join into a capacity-bounded output,
# prefix compaction (XLA gather vs Pallas one-hot scatter), and the MXU
# probe kernel gated on the build side's expected count
defop("bounded_join_col", dp_cap=ST, buf_cap=SI, cap_on=None, backend="rel")
defop("rel_join_probe_pallas", dp_cap=EX, buf_cap=SI, cap_on=None,
      backend="pallas")
defop("compact_prefix_col", dp_cap=ST, buf_cap=SS, cap_on=None, backend="rel")
defop("compact_prefix_pallas", dp_cap=EX, buf_cap=SS, cap_on=None,
      backend="pallas")
defop("rel_group_agg_col", dp_cap=ST, buf_cap=SI, cap_on=None, backend="rel")
defop("col_tensor_rel", dp_cap=ST, buf_cap=SO, cap_on=None, backend="rel")
defop("graph_expand_csr", dp_cap=ST, buf_cap=SS, cap_on=None, backend="graph")
defop("graph_expand_pallas", dp_cap=EX, buf_cap=SS, cap_on=None,
      backend="pallas")
defop("graph_pagerank_csr", dp_cap=ST, buf_cap=SS, cap_on=None,
      backend="graph")
defop("graph_pagerank_skip", dp_cap=ST, buf_cap=SS, cap_on=None,
      backend="graph")
defop("graph_pagerank_pallas", dp_cap=EX, buf_cap=SS, cap_on=None,
      backend="pallas")
defop("graph_tricount_csr", dp_cap=ST, buf_cap=SI, cap_on=None,
      backend="graph")
defop("text_topk_inv", dp_cap=ST, buf_cap=SI, cap_on=None, backend="text")
# predicate-pushdown physical surface: mask export from the relational
# engine, full-corpus scoring, tensor-level masked top-k, and the masked
# scoring realizations (dense, block-skipping, Pallas one-hot superkernel)
defop("sel_mask_rel", dp_cap=ST, buf_cap=SO, cap_on=None, backend="rel")
defop("text_scores_inv", dp_cap=ST, buf_cap=SI, cap_on=None, backend="text")
defop("masked_topk_xla", dp_cap=ST, buf_cap=SI, cap_on=None)
defop("text_topk_skip_inv", dp_cap=ST, buf_cap=SI, cap_on=None,
      backend="text")
defop("text_topk_masked_pallas", dp_cap=EX, buf_cap=SS, cap_on=None,
      backend="pallas")
# fused same-engine store chains (fuse_store_ops product) + the masked
# segment-aggregate superkernel; block-skipping frontier expansion
defop("rel_fused_col", dp_cap=ST, buf_cap=SI, cap_on=None, backend="rel")
defop("rel_fused_agg_pallas", dp_cap=EX, buf_cap=SI, cap_on=None,
      backend="pallas")
defop("graph_expand_skip", dp_cap=ST, buf_cap=SS, cap_on=None,
      backend="graph")
# cross-engine transfer: pin keeps the value device-resident (AWESOME's
# in-memory placement), spill materializes it through the host (the
# federated-baseline behaviour).  Spill is blocking for buffering purposes.
defop("xfer_pin", dp_cap=ST, buf_cap=SS, cap_on=None)
defop("xfer_spill", dp_cap=ST, buf_cap=B, cap_on=None)
# mesh-kinded transfers (shard_stores product): local = layout-compatible
# pointer move (zero wire bytes), replicate = all-gather to every device,
# repartition = all-to-all reshuffle onto the join key's owner shards
defop("xfer_local", dp_cap=ST, buf_cap=SS, cap_on=None)
defop("xfer_replicate", dp_cap=ST, buf_cap=SS, cap_on=None)
defop("xfer_repartition", dp_cap=ST, buf_cap=SS, cap_on=None)


# --------------------------------------------------------------------------
# Physical plan structure
# --------------------------------------------------------------------------


@dataclass
class PhysNode:
    id: str
    impl: str                      # PHYS_OPS key, or "virtual"
    inputs: tuple = ()
    attrs: dict = field(default_factory=dict)
    subplan: Optional["PhysPlan"] = None   # for scan_layers
    virtual: bool = False

    @property
    def opdef(self) -> PhysicalOpDef:
        return PHYS_OPS[self.impl]


@dataclass
class Candidate:
    """One candidate physical sub-plan for a virtual node: a linear chain of
    impls applied in order (first consumes the virtual node's inputs)."""

    name: str
    impls: tuple                   # impl names, applied in sequence
    requires_backend: str = "xla"  # "xla" | "pallas"
    when: Optional[Callable] = None  # (logical nodes) -> bool availability


@dataclass
class PhysPlan:
    name: str = "pplan"
    nodes: dict = field(default_factory=dict)
    inputs: dict = field(default_factory=dict)
    outputs: tuple = ()
    types: dict = field(default_factory=dict)
    pm: dict = field(default_factory=dict)   # virtual node id -> [Candidate]
    logical_of: dict = field(default_factory=dict)  # phys id -> [logical Node]
    _ctr: int = 0

    def add(self, impl, inputs=(), attrs=None, subplan=None, id=None,
            virtual=False):
        nid = id or f"{impl}_{self._ctr}"
        self._ctr += 1
        if nid in self.nodes:
            raise ValidationError(f"duplicate phys node {nid}")
        self.nodes[nid] = PhysNode(nid, impl, tuple(inputs), dict(attrs or {}),
                                   subplan, virtual)
        return nid

    def topo(self):
        return list(self.nodes.values())

    def consumers(self):
        out = {i: [] for i in list(self.inputs) + list(self.nodes)}
        for n in self.nodes.values():
            for i in n.inputs:
                out[i].append(n.id)
        return out


# --------------------------------------------------------------------------
# Pattern set (Def. 5.1) — ordered by size, largest first
# --------------------------------------------------------------------------


@dataclass
class Pattern:
    name: str
    seq: tuple                     # logical op-name chain to match
    candidates: tuple              # tuple[Candidate]; len==1 → direct replace

    @property
    def size(self):
        return len(self.seq)


def _has_window(nodes):
    return any(n.attrs.get("window") for n in nodes)


def _not_spill_only(nodes):
    return not any(n.attrs.get("spill_only") for n in nodes)


def _unkinded(nodes):
    return (_not_spill_only(nodes)
            and not any(n.attrs.get("kind") for n in nodes))


def _kind_is(kind):
    def gate(nodes):
        return any(n.attrs.get("kind") == kind for n in nodes)
    return gate


# masked-candidate gates: the skip/fused realizations are offered only when
# a doc mask was pushed in *and* the estimated selectivity is low enough
# that skipping can plausibly win — above the threshold the dense plan is
# the only candidate, so at selectivity 1.0 the unpushed execution is kept
SKIP_SELECTIVITY_THRESHOLD = 0.25


def _skip_worthwhile(nodes):
    return (len(nodes[0].inputs) == 3
            and float(nodes[0].attrs.get("selectivity", 1.0))
            <= SKIP_SELECTIVITY_THRESHOLD)


def _frontier_sparse(nodes):
    return (float(nodes[0].attrs.get("frontier_selectivity", 1.0))
            <= SKIP_SELECTIVITY_THRESHOLD)


def _personalization_sparse(nodes):
    """First-iteration PageRank pushdown: offered only when a pushed
    selection made the personalization vector sparse."""
    return (len(nodes[0].inputs) == 2
            and float(nodes[0].attrs.get("personalization_selectivity", 1.0))
            <= SKIP_SELECTIVITY_THRESHOLD)


# the probe kernel holds the whole build side in one shared-memory table,
# so the gate bounds the build side's *physical capacity* (what actually
# rides in the table), and requires a known expected count — the quantity
# the cost model prices the candidate on


def _probe_kernel_ok(nodes):
    a = nodes[0].attrs
    return (0 < int(a.get("build_expected", 0))
            and 0 < int(a.get("build_rows", 0)) <= JOIN_PROBE_MAX_BUILD)


def _compact_kernel_ok(nodes):
    """The one-hot compaction kernel routes every column through a float32
    matmul: bit-exact for float/bool columns, lossy above 2^24 for integer
    keys — which cannot be bounded statically, so integer columns keep the
    gather realization."""
    dts = nodes[0].attrs.get("col_dtypes")
    return bool(dts) and all(str(d).startswith("float") or str(d) == "bool"
                             for d in dts)


def _agg_kernel_ok(nodes):
    """The masked segment-aggregate kernel covers the sum family only (max
    needs a segment-max reduction the one-hot matmul cannot express)."""
    chain = nodes[0].attrs.get("chain", ())
    if not chain or chain[-1][0] != "rel_group_agg":
        return False
    return all(fn in ("sum", "count", "mean")
               for _, fn, _c in chain[-1][1]["aggs"])


DEFAULT_PATTERNS = (
    # fused attention: the map-fusion product (Fig. 7's larger-pattern win)
    Pattern(
        "fused_attention", ("qkv_proj", "sdpa", "out_proj"),
        (
            Candidate("attn_xla", ("qkv_proj_fused", "sdpa_xla", "out_proj_xla")),
            Candidate("attn_flash",
                      ("qkv_proj_fused", "attn_flash_pallas", "out_proj_xla"),
                      requires_backend="pallas"),
            Candidate("attn_banded",
                      ("qkv_proj_fused", "sdpa_banded_xla", "out_proj_xla"),
                      when=_has_window),
        ),
    ),
    # unfused attention still plannable (pre-fusion plans work, just worse)
    Pattern(
        "sdpa_only", ("sdpa",),
        (
            Candidate("sdpa_xla", ("sdpa_xla",)),
            Candidate("sdpa_flash", ("attn_flash_pallas",),
                      requires_backend="pallas"),
            Candidate("sdpa_banded", ("sdpa_banded_xla",), when=_has_window),
        ),
    ),
    Pattern(
        "moe_block", ("moe",),
        (
            Candidate("moe_dense", ("moe_dense_onehot",)),
            Candidate("moe_drop", ("moe_dropping",)),
            Candidate("moe_gmm", ("moe_gmm_pallas",), requires_backend="pallas"),
        ),
    ),
    Pattern(
        "wkv6_block", ("wkv6",),
        (
            Candidate("wkv6_xla", ("wkv6_scan_xla",)),
            Candidate("wkv6_pallas", ("wkv6_pallas",), requires_backend="pallas"),
        ),
    ),
    Pattern(
        "ssd_block", ("ssd",),
        (
            Candidate("ssd_xla", ("ssd_chunked_xla",)),
            Candidate("ssd_pallas", ("ssd_pallas",), requires_backend="pallas"),
        ),
    ),
    # graph frontier ops: Pallas scatter-add kernel on TPU-capable engines,
    # segment_sum CSR fallback otherwise (the paper's external-engine story)
    Pattern(
        "graph_expand_op", ("graph_expand",),
        (
            Candidate("expand_csr", ("graph_expand_csr",),
                      requires_backend="graph"),
            Candidate("expand_pallas", ("graph_expand_pallas",),
                      requires_backend="pallas"),
            # frontier-mask pushdown: per-hop block-skipping SpMV, offered
            # when the estimated frontier sparsity makes skipping plausible
            Candidate("expand_skip", ("graph_expand_skip",),
                      requires_backend="graph", when=_frontier_sparse),
        ),
    ),
    # text top-k: dense scoring always; with a pushed candidate-doc mask at
    # low estimated selectivity, the block-skipping and Pallas masked
    # superkernels compete on the cost model's selectivity-priced features
    Pattern(
        "text_topk_op", ("text_topk",),
        (
            Candidate("topk_dense", ("text_topk_inv",),
                      requires_backend="text"),
            Candidate("topk_blockskip", ("text_topk_skip_inv",),
                      requires_backend="text", when=_skip_worthwhile),
            Candidate("topk_masked_pallas", ("text_topk_masked_pallas",),
                      requires_backend="pallas", when=_skip_worthwhile),
        ),
    ),
    # fused store chains: the single-call columnar realization vs the
    # masked segment-aggregate Pallas superkernel for agg-terminated chains
    Pattern(
        "rel_fused_op", ("rel_fused",),
        (
            Candidate("rel_fused_col", ("rel_fused_col",),
                      requires_backend="rel"),
            Candidate("rel_fused_agg", ("rel_fused_agg_pallas",),
                      requires_backend="pallas", when=_agg_kernel_ok),
        ),
    ),
    Pattern(
        "graph_pagerank_op", ("graph_pagerank",),
        (
            Candidate("pagerank_csr", ("graph_pagerank_csr",),
                      requires_backend="graph"),
            Candidate("pagerank_pallas", ("graph_pagerank_pallas",),
                      requires_backend="pallas"),
            # personalization-sparsity pushdown: iteration 0's SpMV
            # block-skips on the pushed mask's support (bitwise-identical)
            Candidate("pagerank_skip", ("graph_pagerank_skip",),
                      requires_backend="graph",
                      when=_personalization_sparse),
        ),
    ),
    # equi-join probe: the sort + binary-search realization always; the MXU
    # key-equality kernel when the build side's expected count is bounded
    # enough to ride in VMEM (capacity-bounded builds: compacted filters,
    # top-k relations)
    Pattern(
        "rel_join_op", ("rel_join",),
        (
            Candidate("join_sort_probe", ("rel_hash_join",),
                      requires_backend="rel"),
            Candidate("join_probe_kernel", ("rel_join_probe_pallas",),
                      requires_backend="pallas", when=_probe_kernel_ok),
        ),
    ),
    # prefix compaction: XLA gather vs the Pallas one-hot scatter kernel
    Pattern(
        "compact_op", ("compact",),
        (
            Candidate("compact_gather", ("compact_prefix_col",),
                      requires_backend="rel"),
            Candidate("compact_onehot", ("compact_prefix_pallas",),
                      requires_backend="pallas", when=_compact_kernel_ok),
        ),
    ),
    # cross-engine transfer: the cost model chooses the materialization
    # point per boundary (pin = stay in device memory, spill = host
    # round-trip).  ``spill_only`` xfers (the naive-placement baseline)
    # exclude the pin candidate.
    Pattern(
        "xfer_op", ("xfer",),
        (
            # mesh-kinded xfers (shard_stores) pair with the spill fallback
            # so the cost model genuinely prices all-gather/all-to-all wire
            # bytes against the host round-trip
            Candidate("xfer_local", ("xfer_local",), when=_kind_is("local")),
            Candidate("xfer_replicate", ("xfer_replicate",),
                      when=_kind_is("replicate")),
            Candidate("xfer_repartition", ("xfer_repartition",),
                      when=_kind_is("repartition")),
            Candidate("xfer_pin", ("xfer_pin",), when=_unkinded),
            Candidate("xfer_spill", ("xfer_spill",)),
        ),
    ),
)

# single-candidate direct mappings (Alg. 2 lines 6–7)
DIRECT_IMPL = {
    "const": "const",
    "embed": "embed_gather",
    "rmsnorm": "rmsnorm_xla",
    "residual_add": "residual_add_xla",
    "unembed": "unembed_matmul",
    "softmax_xent": "softmax_xent_xla",
    "q_proj": "q_proj_xla",
    "k_proj": "k_proj_xla",
    "v_proj": "v_proj_xla",
    "pack_qkv": "pack_qkv_xla",
    "qkv_proj": "qkv_proj_fused",
    "out_proj": "out_proj_xla",
    "ffn_up": "ffn_up_xla",
    "ffn_gate": "ffn_gate_xla",
    "ffn_glu": "ffn_glu_xla",
    "ffn_act": "ffn_act_xla",
    "ffn_down": "ffn_down_xla",
    "mlp": "mlp_fused_xla",
    "rwkv_channel_mix": "rwkv_channel_mix",
    "concat_seq": "concat_seq",
    "cross_attention": "cross_attention_xla",
    "attention": None,   # must be decomposed first; see rewrite.decompose
    "store": "store",
    "tuple_get": "tuple_get_xla",
    # tri-store single-candidate ops
    "rel_scan": "rel_scan_col",
    "rel_filter": "rel_filter_col",
    # rel_join and compact are pattern-matched (probe-kernel / Pallas
    # compaction candidates); bounded_join has one realization
    "bounded_join": "bounded_join_col",
    "rel_group_agg": "rel_group_agg_col",
    "col_tensor": "col_tensor_rel",
    "graph_tricount": "graph_tricount_csr",
    # text_topk is pattern-matched (masked candidates); these stay direct
    "sel_mask": "sel_mask_rel",
    "text_scores": "text_scores_inv",
    "masked_topk": "masked_topk_xla",
}


# --------------------------------------------------------------------------
# Algorithm 2 — candidate physical plan generation
# --------------------------------------------------------------------------


def _find_chain_matches(plan: Plan, seq, claimed):
    """Find non-overlapping linear chains matching ``seq`` where interior
    nodes have a single consumer (so substitution is sound)."""
    cons = plan.consumers()
    matches = []
    for n in plan.topo():
        if n.op != seq[0] or n.id in claimed:
            continue
        chain = [n]
        ok = True
        cur = n
        for want in seq[1:]:
            nxt_ids = cons[cur.id]
            if len(nxt_ids) != 1:
                ok = False
                break
            nxt = plan.nodes[nxt_ids[0]]
            if nxt.op != want or nxt.id in claimed:
                ok = False
                break
            chain.append(nxt)
            cur = nxt
        if ok:
            matches.append(chain)
            claimed.update(c.id for c in chain)
    return matches


def generate_candidates(plan: Plan, patterns=DEFAULT_PATTERNS,
                        engines=None, allow_pallas=None,
                        threads: int = 1) -> PhysPlan:
    """Alg. 2: largest-first pattern matching over the optimized logical plan.

    ``engines`` names the execution engines whose candidates may be offered
    (default: the always-available ``xla`` interpreter engine; on CPU
    dry-runs the Pallas engines are excluded, exactly as the paper excludes
    EX engines from optimization choices it cannot calibrate).  The legacy
    ``allow_pallas`` boolean is still accepted and maps onto the registry.

    ``threads > 1`` generates the candidate sub-plans of scan-groups
    (``scan_layers``/higher-order subplans) in a thread pool.  Generation is
    pure per subplan, so the product is identical to the serial path — only
    wall time changes.
    """
    from .engines import resolve_engines
    engines = resolve_engines(engines, allow_pallas=allow_pallas)

    # parallel scan-group prepass: each higher-order node's subplan is an
    # independent generation problem
    pregen: dict = {}
    sub_nodes = [n for n in plan.topo()
                 if n.subplan is not None
                 and n.op in ("scan_layers", "map", "filter", "reduce")]
    if threads and threads > 1 and len(sub_nodes) > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=int(threads)) as ex:
            futs = {n.id: ex.submit(generate_candidates, n.subplan, patterns,
                                    engines, None, threads)
                    for n in sub_nodes}
            pregen = {nid: f.result() for nid, f in futs.items()}

    ordered = sorted(patterns, key=lambda p: -p.size)
    claimed: set = set()
    pat_of: dict = {}           # head node id -> (Pattern, chain)
    for pat in ordered:
        for chain in _find_chain_matches(plan, pat.seq, claimed):
            pat_of[chain[0].id] = (pat, chain)

    pp = PhysPlan(plan.name, {}, dict(plan.inputs), (), dict(plan.types))
    remap: dict = {i: i for i in plan.inputs}
    in_chain: dict = {}
    for head, (pat, chain) in pat_of.items():
        for c in chain:
            in_chain[c.id] = head

    emitted: set = set()
    remap_target: dict = {}
    for node in plan.topo():
        if node.id in in_chain:
            head = in_chain[node.id]
            if head in emitted:
                remap[node.id] = remap_target[head]
                continue
            pat, chain = pat_of[head]
            cands = [c for c in pat.candidates
                     if c.requires_backend in engines
                     and (c.when is None or c.when(chain))]
            attrs = {}
            for c in chain:
                attrs.update(c.attrs)
            attrs["pattern"] = pat.name
            attrs.setdefault("pp", chain[0].attrs.get("pp"))
            ext_inputs = [remap[i] for i in chain[0].inputs]
            out_t = plan.types.get(chain[-1].id)
            if len(cands) == 1:
                # single candidate → direct replacement (Alg.2 lines 6–7)
                nid = _emit_chain(pp, cands[0], ext_inputs, attrs, chain)
            else:
                nid = pp.add("identity", ext_inputs, attrs,
                             id=f"virt_{plan.name}_{pat.name}_{chain[0].id}",
                             virtual=True)
                pp.pm[nid] = cands
                pp.logical_of[nid] = chain
            pp.types[nid] = out_t
            emitted.add(head)
            remap_target[head] = nid
            for c in chain:
                remap[c.id] = nid
            continue

        impl = DIRECT_IMPL.get(node.op)
        sub = None
        if node.op == "scan_layers":
            impl = "scan_layers_xla"
            sub = pregen.get(node.id) or generate_candidates(
                node.subplan, patterns, engines, threads=threads)
        elif node.op in ("map", "filter", "reduce"):
            impl = node.op  # handled natively by the executor
            if node.subplan is not None:
                sub = pregen.get(node.id) or generate_candidates(
                    node.subplan, patterns, engines, threads=threads)
            if impl not in PHYS_OPS:
                defop(impl, dp_cap=PR, buf_cap=SS, cap_on="elem")
        if impl is None:
            raise ValidationError(
                f"no physical impl for logical op {node.op!r} "
                f"(did you run rewrite.decompose?)")
        nid = pp.add(impl, [remap[i] for i in node.inputs], dict(node.attrs),
                     sub, id=node.id)
        pp.types[nid] = plan.types.get(node.id)
        pp.logical_of[nid] = [node]
        remap[node.id] = nid

    pp.outputs = tuple(remap[o] for o in plan.outputs)
    return pp


def _emit_chain(pp: PhysPlan, cand: Candidate, ext_inputs, attrs, chain):
    prev = None
    nid = None
    for j, impl in enumerate(cand.impls):
        ins = ext_inputs if j == 0 else [prev]
        nid = pp.add(impl, ins, dict(attrs),
                     id=f"{chain[0].id}__{cand.name}_{j}")
        pp.logical_of[nid] = chain if j == 0 else []
        prev = nid
    return nid


def materialize_choice(pp: PhysPlan, choices: dict) -> PhysPlan:
    """Replace each virtual node with its chosen candidate chain (§6.3:
    'the best sub-plan with the lowest cost will be selected')."""
    out = PhysPlan(pp.name, {}, dict(pp.inputs), (), dict(pp.types))
    remap = {i: i for i in pp.inputs}
    for n in pp.topo():
        sub = n.subplan
        if sub is not None:
            sub = materialize_choice(sub, choices)
        if n.virtual:
            cand = choices[n.id]
            nid = _emit_chain(out, cand, [remap[i] for i in n.inputs],
                              dict(n.attrs), [n])
            out.types[nid] = pp.types.get(n.id)
        else:
            nid = out.add(n.impl, [remap[i] for i in n.inputs], dict(n.attrs),
                          sub, id=n.id)
            out.types[nid] = pp.types.get(n.id)
        remap[n.id] = nid
    out.outputs = tuple(remap[o] for o in pp.outputs)
    return out
