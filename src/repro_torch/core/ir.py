"""Typed logical IR for AWESOME-JAX (paper §2–§3).

The paper's ADIL is a strongly-typed dataflow language: a workload is a DAG of
assignment statements whose RHS expressions are constants, queries, function
calls, or higher-order map/filter/reduce expressions.  Validation happens
*before* execution against three sources of truth:

  * the **system catalog**   — metadata of external stores      (here: mesh +
    hardware description + parameter collections),
  * the **function catalog** — signatures of registered ops     (here:
    ``OpSignature`` registry),
  * the **variable metadata map** — inferred per-variable types (here:
    ``Plan.types``; populated by :func:`infer_types`).

Types carry *semantic dimension names* (``batch``/``seq``/``embed``/…) in
addition to shape+dtype; these names drive sharding rules, the ``capOn``
data-parallel capability checks (§5.2), and cost-model features (§6).
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import math
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Iterable, Mapping, Optional, Sequence

# --------------------------------------------------------------------------
# Types (paper §2.1 — ADIL data types)
# --------------------------------------------------------------------------


class Type:
    """Base class for ADIL-style types."""


@dataclass(frozen=True)
class TensorT(Type):
    """A dense tensor with semantic dimension names.

    ``dims`` plays the role of the paper's per-type metadata (Table 1): it is
    the Relation *schema* / Matrix *row–column map* analogue, and is what the
    planner consults when deciding how an operator may be partitioned.
    """

    shape: tuple
    dtype: str = "float32"
    dims: tuple = ()  # semantic names, len == len(shape) (or () if unknown)

    def __post_init__(self):
        if self.dims and len(self.dims) != len(self.shape):
            raise ValidationError(
                f"dims {self.dims} incompatible with shape {self.shape}"
            )

    @property
    def rank(self) -> int:
        return len(self.shape)

    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= int(s)
        return n

    def bytesize(self) -> int:
        return self.size() * dtype_bytes(self.dtype)

    def dim(self, name: str) -> int:
        """Size of the named dimension (ValidationError if absent)."""
        if name not in self.dims:
            raise ValidationError(f"no dim {name!r} in {self}")
        return int(self.shape[self.dims.index(name)])

    def has_dim(self, name: str) -> bool:
        return name in self.dims

    def __repr__(self):
        inner = ", ".join(
            f"{d}={s}" if d else str(s)
            for d, s in itertools.zip_longest(self.dims, self.shape, fillvalue="")
        )
        return f"TensorT[{self.dtype}]({inner})"


@dataclass(frozen=True)
class ListT(Type):
    """Homogeneous collection (paper: List) — e.g. per-layer or per-topic."""

    elem: Type
    size: int

    def __repr__(self):
        return f"ListT({self.elem!r} x {self.size})"


@dataclass(frozen=True)
class TupleT(Type):
    """Heterogeneous finite collection (paper: Tuple)."""

    elems: tuple

    def __repr__(self):
        return f"TupleT{self.elems!r}"


@dataclass(frozen=True)
class ScalarT(Type):
    dtype: str = "float32"

    def __repr__(self):
        return f"ScalarT[{self.dtype}]"


# -- tri-store data-model types (paper Table 1: Relation / Graph / Text) ----
#
# AWESOME's ADIL is natively aware of its three data models.  The tensor
# reproduction mirrors that: a Table is a struct-of-arrays relation, a Graph
# is CSR adjacency, and a Corpus is a tokenized document set with an
# inverted index.  Each type carries the metadata the planner needs to price
# cross-engine movement (rows / edges / postings -> bytes).


@dataclass(frozen=True)
class TableT(Type):
    """Relational table: named, typed columns over a fixed row *capacity*.

    The runtime value is a :class:`~repro_torch.stores.bounded.BoundedRel` —
    struct-of-JAX-arrays columns plus a ``valid`` vector and a traced row
    ``count`` — so filters narrow validity rather than the physical row
    count and every relational kernel stays static-shaped and jittable.

    ``rows`` is the **capacity** (the static array length; ``capacity`` is
    its explicit alias).  ``expected_count`` is the planner's cardinality
    estimate — how many rows are expected to be *valid* at run time.
    ``None`` means "all of them" (a base table, an unfiltered scan).  The
    cost model prices relational work on the expected count, and the
    ``choose_compaction`` rewrite inserts ``compact`` nodes where the
    expected count sits far below capacity.
    """

    columns: tuple            # ((name, dtype), ...)
    rows: int
    expected_count: Optional[int] = None
    # mesh placement over the data axis: None = single-device / replicated,
    # "row" = row-range sharded.  Part of the repr (hence the plan id) only
    # when set, so unpartitioned plans keep their pre-sharding identity.
    partitioning: Optional[str] = None

    def __post_init__(self):
        names = [c[0] for c in self.columns]
        if len(set(names)) != len(names):
            raise ValidationError(f"duplicate column names in {names}")
        if self.expected_count is not None and self.expected_count > self.rows:
            raise ValidationError(
                f"expected_count {self.expected_count} exceeds "
                f"capacity {self.rows}")

    @property
    def capacity(self) -> int:
        return int(self.rows)

    def expected_rows(self) -> int:
        """The cardinality estimate the cost model prices with: the
        expected valid-row count, defaulting to the full capacity."""
        return int(self.rows if self.expected_count is None
                   else self.expected_count)

    def col_names(self) -> tuple:
        return tuple(c[0] for c in self.columns)

    def has_col(self, name: str) -> bool:
        return name in self.col_names()

    def col_dtype(self, name: str) -> str:
        for n, d in self.columns:
            if n == name:
                return d
        raise ValidationError(f"no column {name!r} in {self}")

    def bytesize(self) -> int:
        per_row = sum(dtype_bytes(d) for _, d in self.columns) + 1  # + valid
        return int(self.rows) * per_row

    def __repr__(self):
        cols = ", ".join(f"{n}:{d}" for n, d in self.columns)
        exp = ("" if self.expected_count is None
               else f", count~{self.expected_count}")
        part = "" if self.partitioning is None else f"; part={self.partitioning}"
        return f"TableT({cols}; capacity={self.rows}{exp}{part})"


@dataclass(frozen=True)
class GraphT(Type):
    """Graph in CSR form: ``nodes`` vertices, ``edges`` directed edges."""

    nodes: int
    edges: int
    weighted: bool = False
    # None = single-device; "block" = CSR row(dst)-block partitioned
    partitioning: Optional[str] = None

    def bytesize(self) -> int:
        # indptr + indices + per-edge src expansion (+ weights) + out-degree
        per_edge = 8 + (4 if self.weighted else 0)
        return (self.nodes + 1) * 4 + int(self.edges) * per_edge + self.nodes * 4

    def __repr__(self):
        w = ", weighted" if self.weighted else ""
        part = "" if self.partitioning is None else f", part={self.partitioning}"
        return f"GraphT(nodes={self.nodes}, edges={self.edges}{w}{part})"


@dataclass(frozen=True)
class CorpusT(Type):
    """Tokenized corpus with an inverted index: ``postings`` = nnz of the
    term-document matrix (what TF-IDF scoring streams over)."""

    docs: int
    vocab: int
    postings: int
    # None = single-device; "doc" = document-range partitioned
    partitioning: Optional[str] = None

    def bytesize(self) -> int:
        # (doc, term, tf) per posting + doc lengths + idf table
        return int(self.postings) * 12 + self.docs * 4 + self.vocab * 4

    def __repr__(self):
        part = "" if self.partitioning is None else f", part={self.partitioning}"
        return (f"CorpusT(docs={self.docs}, vocab={self.vocab}, "
                f"postings={self.postings}{part})")


_DTYPE_BYTES = {
    "float64": 8, "int64": 8,
    "float32": 4, "int32": 4, "uint32": 4,
    "bfloat16": 2, "float16": 2, "int16": 2,
    "int8": 1, "uint8": 1, "bool": 1,
    "float8_e4m3fn": 1, "float8_e5m2": 1,
}


def dtype_bytes(dtype: str) -> int:
    try:
        return _DTYPE_BYTES[str(dtype)]
    except KeyError:
        raise ValidationError(f"unknown dtype {dtype!r}")


class ValidationError(Exception):
    """Raised by compile-time validation (paper design decision 5)."""


# per-comparator selected-fraction heuristics, the single source shared by
# type inference (TableT.expected_count) and the rewrite layer's
# estimate_selectivity — both halves of the planner must reason from the
# same cardinalities (an explicit ``selectivity=`` attr wins over these)
CMP_SELECTIVITY = {"eq": 0.1, "ne": 0.9,
                   "lt": 1 / 3, "le": 1 / 3, "gt": 1 / 3, "ge": 1 / 3}


# --------------------------------------------------------------------------
# Logical operators and plans (paper §4)
# --------------------------------------------------------------------------


@dataclass
class Node:
    """One logical operator in the plan DAG.

    ``subplan`` holds the sub-operator of a higher-order node (the paper's
    Map/Filter consume a sub-plan via the dashed "sub-operator" edge in
    Fig. 4); for us the main higher-order node is ``scan_layers``.
    """

    id: str
    op: str
    inputs: tuple = ()           # ids of producer nodes
    attrs: dict = field(default_factory=dict)
    subplan: Optional["Plan"] = None

    def signature_key(self):
        """Hashable identity used by redundancy elimination (§4.2.2)."""
        items = tuple(sorted((k, _freeze(v)) for k, v in self.attrs.items()))
        sub = self.subplan.structure_key() if self.subplan is not None else None
        return (self.op, self.inputs, items, sub)


def _freeze(v):
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, set):
        return tuple(sorted(_freeze(x) for x in v))
    if callable(v):
        return getattr(v, "__name__", repr(v))
    return v


@dataclass
class Plan:
    """A logical plan: DAG of nodes, in topological insertion order."""

    name: str = "plan"
    nodes: dict = field(default_factory=dict)       # id -> Node
    inputs: dict = field(default_factory=dict)      # id -> Type   (plan inputs)
    outputs: tuple = ()                              # output node ids
    types: dict = field(default_factory=dict)       # id -> Type   (metadata map)
    _ctr: int = 0

    # -- construction ------------------------------------------------------
    def _bump(self):
        """Structural-revision counter (non-field attr): invalidates the
        memoized content fingerprint (see :func:`plan_fingerprint`)."""
        self.__dict__["_rev"] = self.__dict__.get("_rev", 0) + 1

    def _rev_key(self):
        subs = tuple(n.subplan._rev_key() for n in self.nodes.values()
                     if n.subplan is not None)
        return (self.__dict__.get("_rev", 0), subs)

    def add_input(self, name: str, typ: Type) -> str:
        if name in self.nodes or name in self.inputs:
            raise ValidationError(f"duplicate input {name!r}")
        self.inputs[name] = typ
        self.types[name] = typ
        self._bump()
        return name

    def add(self, op: str, inputs: Sequence[str] = (), attrs: dict | None = None,
            subplan: Optional["Plan"] = None, id: str | None = None) -> str:
        nid = id or f"{op}_{self._ctr}"
        self._ctr += 1
        if nid in self.nodes:
            raise ValidationError(f"duplicate node id {nid!r}")
        for i in inputs:
            if i not in self.nodes and i not in self.inputs:
                raise ValidationError(f"node {nid!r}: unknown input {i!r}")
        self.nodes[nid] = Node(nid, op, tuple(inputs), dict(attrs or {}), subplan)
        self._bump()
        return nid

    def set_outputs(self, *ids: str):
        for i in ids:
            if i not in self.nodes and i not in self.inputs:
                raise ValidationError(f"unknown output {i!r}")
        self.outputs = tuple(ids)
        self._bump()

    # -- views -------------------------------------------------------------
    def topo(self) -> Iterable[Node]:
        """Nodes in topological order (insertion order is topological)."""
        return list(self.nodes.values())

    def consumers(self) -> dict:
        out: dict = {i: [] for i in list(self.inputs) + list(self.nodes)}
        for n in self.nodes.values():
            for i in n.inputs:
                out[i].append(n.id)
        return out

    def type_of(self, nid: str) -> Type:
        if nid not in self.types:
            raise ValidationError(f"type of {nid!r} not inferred yet")
        return self.types[nid]

    def structure_key(self):
        return tuple(n.signature_key() for n in self.topo()) + (self.outputs,)

    def copy(self) -> "Plan":
        p = Plan(self.name, {}, dict(self.inputs), self.outputs,
                 dict(self.types), self._ctr)
        p.nodes = {k: Node(v.id, v.op, v.inputs, dict(v.attrs),
                           v.subplan.copy() if v.subplan else None)
                   for k, v in self.nodes.items()}
        return p

    def __len__(self):
        return len(self.nodes)


def count_nodes(plan) -> int:
    """Total node count, recursing into higher-order subplans.  Duck-typed:
    works on both logical Plans and physical PhysPlans (same topo()/subplan
    shape).  Used by the rewrite trace and the pipeline EXPLAIN deltas."""
    if plan is None:
        return 0
    n = len(plan.nodes)
    for node in plan.topo():
        if node.subplan is not None:
            n += count_nodes(node.subplan)
    return n


# --------------------------------------------------------------------------
# Canonical serialization + content hashing (plan identity)
# --------------------------------------------------------------------------
#
# A logical plan's identity is *structural*: node ids are replaced by
# topological position so the textual ADIL front end and the embedded
# DSL hash identically, and attrs are frozen into a deterministic
# nested-tuple form.  ``plan_id`` additionally covers the function-catalog
# signature and the system-catalog fingerprint, so the same workload
# compiled against a different op library or mesh gets a different id —
# this is what keys the plan cache (see ``core/plan_cache.py``).


def _const_bytes(c) -> bytes:
    """Process-stable bytes for one code const: nested code objects recurse
    (their ``repr`` embeds a memory address), frozensets sort (literal
    ``in {...}`` membership sets iterate in PYTHONHASHSEED order), tuples
    recurse element-wise."""
    if hasattr(c, "co_code"):
        return _code_bytes(c)
    if isinstance(c, frozenset):
        return b"fs{" + b",".join(sorted(_const_bytes(x) for x in c)) + b"}"
    if isinstance(c, tuple):
        return b"t(" + b",".join(_const_bytes(x) for x in c) + b")"
    return repr(c).encode()


def _code_bytes(code) -> bytes:
    """Process-stable byte representation of a code object: bytecode plus
    canonicalized consts.  Anything repr-unstable across processes (nested
    code objects' addresses, frozenset iteration order) would make plan ids
    differ between runs and defeat the persisted plan cache."""
    return b"\x00".join([code.co_code] +
                        [_const_bytes(c) for c in code.co_consts])


def _canon(v):
    """Deterministic, hash-stable form of an attr value."""
    if isinstance(v, dict):
        return ("dict", tuple(sorted((str(k), _canon(x)) for k, x in v.items())))
    if isinstance(v, (list, tuple)):
        return ("seq", tuple(_canon(x) for x in v))
    if isinstance(v, set):
        return ("set", tuple(sorted(repr(_canon(x)) for x in v)))
    if hasattr(v, "shape") and hasattr(v, "dtype"):
        # ndarray-like (e.g. a const node's value): repr truncates large
        # arrays, so hash the bytes instead
        import numpy as _np
        a = _np.asarray(v)
        return ("array", str(a.dtype), tuple(a.shape),
                hashlib.sha256(a.tobytes()).hexdigest())
    if callable(v):
        # name alone is ambiguous for lambdas; mix in the bytecode, the
        # closure-captured values, and the default args so two different
        # predicates never collide to one cache entry
        code = getattr(v, "__code__", None)
        tag = getattr(v, "__qualname__", getattr(v, "__name__", repr(v)))
        if code is not None:
            h = hashlib.sha256(_code_bytes(code))
            captured = []
            try:
                for cell in (getattr(v, "__closure__", None) or ()):
                    try:
                        captured.append(_canon(cell.cell_contents))
                    except ValueError:       # empty cell
                        captured.append(("cell", "<empty>"))
                for d in (getattr(v, "__defaults__", None) or ()):
                    captured.append(_canon(d))
            except RecursionError:           # self-referential closure
                captured.append(("cell", "<recursive>"))
            return ("fn", tag, h.hexdigest()[:16], tuple(captured))
        return ("fn", tag)
    if isinstance(v, Type):
        return ("type", repr(v))
    return (type(v).__name__, repr(v))


def canonicalize_plan(plan: "Plan") -> tuple:
    """Structural canonical form of a logical plan.

    Node ids are replaced by topological index, plan inputs keep their names
    (they are the call-time binding keys) plus their declared types, and
    subplans recurse.  Two plans built through different front ends (textual
    ADIL vs the embedded DSL) canonicalize identically iff they describe
    the same workload.
    """
    index: dict = {}
    for i, name in enumerate(plan.inputs):
        index[name] = ("in", i)
    for i, n in enumerate(plan.topo()):
        index[n.id] = ("n", i)
    nodes = tuple(
        (n.op,
         tuple(index[i] for i in n.inputs),
         tuple(sorted((str(k), _canon(v)) for k, v in n.attrs.items())),
         canonicalize_plan(n.subplan) if n.subplan is not None else None)
        for n in plan.topo())
    ins = tuple((name, repr(t)) for name, t in plan.inputs.items())
    outs = tuple(index[o] for o in plan.outputs)
    return ("plan", ins, nodes, outs)


def plan_fingerprint(plan: "Plan") -> str:
    """sha256 over the canonical structural form of a logical plan.

    Memoized on the plan's (recursive) structural-revision counter so a
    second compile of the same plan object pays only a cache lookup.  The
    counter tracks construction through ``add``/``add_input``/
    ``set_outputs``; callers that mutate node attrs *in place after* a first
    hash must re-create the plan (every rewrite pass already does)."""
    key = plan._rev_key()
    cached = plan.__dict__.get("_fp_cache")
    if cached is not None and cached[0] == key:
        return cached[1]
    fp = hashlib.sha256(repr(canonicalize_plan(plan)).encode()).hexdigest()
    plan.__dict__["_fp_cache"] = (key, fp)
    return fp


def plan_id(plan: "Plan", catalog: "FunctionCatalog",
            syscat: "SystemCatalog", extra: tuple = ()) -> str:
    """Stable content hash identifying one planning problem.

    Covers plan structure, the function-catalog signature, the system-catalog
    fingerprint, and any ``extra`` planning options (engines, rewrite
    pipeline, …).  Every compile of the same workload against the same
    catalogs gets the same id — the plan cache key.
    """
    payload = repr((plan_fingerprint(plan), catalog.signature(),
                    syscat.fingerprint(), _canon(extra)))
    return hashlib.sha256(payload.encode()).hexdigest()


def subdag_fingerprints(plan, *, leaf_keys=None, salt: str = "") -> dict:
    """Per-node content hashes of each node's **transitive sub-DAG**.

    Returns ``{ref: sha256 hex}`` for every node id *and* every plan input
    of ``plan``.  A node's hash covers its op/impl, canonicalized attrs
    (same ``_canon`` as ``plan_id``), its inputs' hashes in positional
    order, and its subplan (recursively) — so two nodes hash identically
    iff the entire computations rooted at them are identical.  Node *ids*
    never enter the hash: two textually different programs that share a
    subtree share its fingerprint.

    Duck-typed over logical :class:`Plan` and physical ``PhysPlan`` (both
    expose ``topo()`` / ``nodes`` / ``inputs``; logical nodes carry ``op``,
    physical nodes ``impl``).

    ``leaf_keys``: optional ``{input name: key string}`` binding plan
    inputs to runtime identities (store versions, argument content hashes).
    Unbound inputs fall back to their declared type — the *structural*
    fingerprint, stable across processes but blind to data.  With every
    reachable input bound, the hash identifies the sub-DAG's **value**:
    the key the cross-query subplan cache (``core/mqo.py``) shares
    materialized intermediates under.

    ``salt``: extra identity material folded into every hash (cost-model /
    feedback fingerprints) so re-calibration provably misses the cache.
    """
    lk = leaf_keys or {}
    fps: dict = {}

    def fp_of(ref):
        hit = fps.get(ref)
        if hit is not None:
            return hit
        n = plan.nodes.get(ref)
        if n is None:                    # a plan input leaf
            key = lk.get(ref)
            if key is None:
                key = "type:" + repr(plan.inputs.get(ref))
            payload = ("leaf", salt, str(key))
        else:
            op = getattr(n, "op", None) or getattr(n, "impl", "?")
            ins = tuple(fp_of(i) for i in n.inputs)
            attrs = tuple(sorted((str(k), _canon(v))
                                 for k, v in n.attrs.items()))
            sub = None
            if n.subplan is not None:
                sub = tuple(sorted(subdag_fingerprints(
                    n.subplan, salt=salt).items()))
            payload = ("node", salt, op, attrs, ins, sub)
        h = hashlib.sha256(repr(payload).encode()).hexdigest()
        fps[ref] = h
        return h

    for name in plan.inputs:
        fp_of(name)
    for n in plan.topo():                # topo order keeps recursion shallow
        fp_of(n.id)
    return fps


# --------------------------------------------------------------------------
# Function catalog (paper §3.1.2)
# --------------------------------------------------------------------------


@dataclass
class OpSignature:
    """Registered operator: arity/attr validation + output-type inference.

    ``infer``     : (input_types, attrs) -> Type         (raises ValidationError)
    ``n_inputs``  : exact arity, or (min, max) tuple, or None (any)
    ``engine``    : the named engine this op logically executes on (the
                    tri-store's per-op engine attribution — "rel"/"graph"/
                    "text" for store ops, "xla" for tensor ops).  The
                    ``place_xfers`` rewrite consults it to insert cross-
                    engine transfer nodes at engine boundaries.
    """

    name: str
    infer: Callable
    n_inputs: Any = None
    required_attrs: tuple = ()
    doc: str = ""
    engine: str = "xla"


class FunctionCatalog:
    def __init__(self):
        self._sigs: dict = {}
        self._sig_cache: Optional[str] = None

    def register(self, sig: OpSignature):
        if sig.name in self._sigs:
            raise ValidationError(f"op {sig.name!r} already registered")
        self._sigs[sig.name] = sig
        self._sig_cache = None

    def op(self, name: str, n_inputs=None, required_attrs=(), doc="",
           engine="xla"):
        """Decorator form: ``@catalog.op("matmul", n_inputs=2)``."""

        def deco(fn):
            self.register(OpSignature(name, fn, n_inputs, tuple(required_attrs),
                                      doc, engine))
            return fn

        return deco

    def get(self, name: str) -> OpSignature:
        if name not in self._sigs:
            raise ValidationError(f"unknown op {name!r} (function catalog)")
        return self._sigs[name]

    def __contains__(self, name: str):
        return name in self._sigs

    def names(self):
        return sorted(self._sigs)

    def signature(self) -> str:
        """Content hash of the registered-op surface (names, arities,
        required attrs).  Part of ``plan_id``: the same workload against a
        different op library is a different planning problem.  Memoized,
        invalidated by ``register``."""
        if self._sig_cache is None:
            rows = tuple((name, repr(s.n_inputs), s.required_attrs, s.engine)
                         for name, s in sorted(self._sigs.items()))
            self._sig_cache = hashlib.sha256(repr(rows).encode()).hexdigest()
        return self._sig_cache


# --------------------------------------------------------------------------
# Validation + metadata inference (paper §3)
# --------------------------------------------------------------------------


def infer_types(plan: Plan, catalog: FunctionCatalog) -> Plan:
    """Validate the plan and populate its variable-metadata map.

    Mirrors §3: every statement is validated against the function catalog and
    the already-inferred variable metadata; inference proceeds innermost-first
    for higher-order nodes (their ``subplan`` is inferred before the node's
    own output type).
    """
    plan.types = dict(plan.inputs)
    for node in plan.topo():
        sig = catalog.get(node.op)
        # arity check
        if sig.n_inputs is not None:
            lo, hi = (sig.n_inputs, sig.n_inputs) if isinstance(sig.n_inputs, int) \
                else sig.n_inputs
            if not (lo <= len(node.inputs) <= hi):
                raise ValidationError(
                    f"{node.id}: op {node.op!r} expects {sig.n_inputs} inputs, "
                    f"got {len(node.inputs)}")
        for a in sig.required_attrs:
            if a not in node.attrs:
                raise ValidationError(f"{node.id}: missing attr {a!r}")
        in_types = [plan.types[i] for i in node.inputs]
        # innermost-first for higher-order nodes (§3.1.4)
        if node.subplan is not None:
            infer_types(node.subplan, catalog)
        try:
            out = sig.infer(in_types, dict(node.attrs), node.subplan)
        except ValidationError:
            raise
        except Exception as e:  # surface inference bugs as validation errors
            raise ValidationError(f"{node.id} ({node.op}): {e}") from e
        plan.types[node.id] = out
    for o in plan.outputs:
        if o not in plan.types:
            raise ValidationError(f"output {o!r} has no type")
    return plan


# --------------------------------------------------------------------------
# Shared inference helpers used by the standard catalog
# --------------------------------------------------------------------------


def expect_tensor(t: Type, what: str = "input") -> TensorT:
    if not isinstance(t, TensorT):
        raise ValidationError(f"{what}: expected TensorT, got {t!r}")
    return t


def expect_table(t: Type, what: str = "input") -> "TableT":
    if not isinstance(t, TableT):
        raise ValidationError(f"{what}: expected TableT, got {t!r}")
    return t


def expect_graph(t: Type, what: str = "input") -> "GraphT":
    if not isinstance(t, GraphT):
        raise ValidationError(f"{what}: expected GraphT, got {t!r}")
    return t


def expect_corpus(t: Type, what: str = "input") -> "CorpusT":
    if not isinstance(t, CorpusT):
        raise ValidationError(f"{what}: expected CorpusT, got {t!r}")
    return t


def promote_dtype(a: str, b: str) -> str:
    order = ["bool", "int8", "int16", "int32", "int64",
             "bfloat16", "float16", "float32", "float64"]
    ia, ib = order.index(str(a)), order.index(str(b))
    return order[max(ia, ib)]


def standard_catalog() -> FunctionCatalog:
    """The registered-op library (paper Table 2 analogue for the tensor world)."""
    cat = FunctionCatalog()

    @cat.op("const", n_inputs=0, required_attrs=("type",))
    def _const(ins, attrs, sub):
        return attrs["type"]

    @cat.op("embed", n_inputs=1, required_attrs=("vocab", "embed"))
    def _embed(ins, attrs, sub):
        t = expect_tensor(ins[0], "embed ids")
        if not str(t.dtype).startswith("int"):
            raise ValidationError(f"embed: ids must be integer, got {t.dtype}")
        return TensorT(t.shape + (attrs["embed"],),
                       attrs.get("dtype", "bfloat16"), t.dims + ("embed",))

    @cat.op("rmsnorm", n_inputs=1)
    def _rmsnorm(ins, attrs, sub):
        return expect_tensor(ins[0])

    @cat.op("residual_add", n_inputs=2)
    def _resid(ins, attrs, sub):
        a, b = expect_tensor(ins[0]), expect_tensor(ins[1])
        if a.shape != b.shape:
            raise ValidationError(f"residual_add: {a.shape} vs {b.shape}")
        return replace(a, dtype=promote_dtype(a.dtype, b.dtype))

    @cat.op("attention", n_inputs=1,
            required_attrs=("heads", "kv_heads", "head_dim"))
    def _attention(ins, attrs, sub):
        t = expect_tensor(ins[0])
        if not t.has_dim("seq"):
            raise ValidationError("attention input needs a 'seq' dim")
        return t

    @cat.op("cross_attention", n_inputs=2,
            required_attrs=("heads", "kv_heads", "head_dim"))
    def _xattention(ins, attrs, sub):
        t = expect_tensor(ins[0])
        m = expect_tensor(ins[1], "memory")
        if t.dim("embed") != m.dim("embed"):
            # cross-attn projects from memory width; allow mismatch via attr
            if "memory_embed" not in attrs:
                raise ValidationError("cross_attention: embed mismatch")
        return t

    @cat.op("mlp", n_inputs=1, required_attrs=("ffn",))
    def _mlp(ins, attrs, sub):
        return expect_tensor(ins[0])

    @cat.op("moe", n_inputs=1, required_attrs=("ffn", "experts", "top_k"))
    def _moe(ins, attrs, sub):
        return expect_tensor(ins[0])

    @cat.op("wkv6", n_inputs=1, required_attrs=("heads", "head_dim"))
    def _wkv6(ins, attrs, sub):
        return expect_tensor(ins[0])

    @cat.op("ssd", n_inputs=1, required_attrs=("heads", "head_dim", "state"))
    def _ssd(ins, attrs, sub):
        return expect_tensor(ins[0])

    @cat.op("rwkv_channel_mix", n_inputs=1, required_attrs=("ffn",))
    def _rwkv_cm(ins, attrs, sub):
        return expect_tensor(ins[0])

    @cat.op("unembed", n_inputs=1, required_attrs=("vocab",))
    def _unembed(ins, attrs, sub):
        t = expect_tensor(ins[0])
        if not t.has_dim("embed"):
            raise ValidationError("unembed input needs an 'embed' dim")
        i = t.dims.index("embed")
        shape = t.shape[:i] + (attrs["vocab"],) + t.shape[i + 1:]
        dims = t.dims[:i] + ("vocab",) + t.dims[i + 1:]
        return TensorT(shape, "float32", dims)

    @cat.op("softmax_xent", n_inputs=2)
    def _xent(ins, attrs, sub):
        logits = expect_tensor(ins[0], "logits")
        labels = expect_tensor(ins[1], "labels")
        if logits.shape[:-1] != labels.shape:
            raise ValidationError(
                f"softmax_xent: logits {logits.shape} vs labels {labels.shape}")
        return ScalarT("float32")

    @cat.op("scan_layers", n_inputs=(1, 2), required_attrs=("n_layers",))
    def _scan(ins, attrs, sub):
        # higher-order: validates like the paper's Map — the subplan is typed
        # with the carry as its input; output type == carry type.
        t = expect_tensor(ins[0])
        if sub is None:
            raise ValidationError("scan_layers needs a subplan")
        if len(sub.outputs) != 1:
            raise ValidationError("scan_layers subplan must have 1 output")
        out_t = sub.types.get(sub.outputs[0])
        if out_t is not None and isinstance(out_t, TensorT) and out_t.shape != t.shape:
            raise ValidationError(
                f"scan_layers: carry {t.shape} != subplan out {out_t.shape}")
        if not attrs.get("collect_kv"):
            return t
        # KV-collecting scan (serving prefill): alongside the carry, the
        # per-layer K/V of every ``emit_kv`` attention in the subplan are
        # stacked over layers — TupleT((carry, ((K, V), ...))) — so the
        # serving runtime seeds its KV pool from the planned forward instead
        # of replaying the prompt through decode_step.
        kv_elems = []
        n = attrs["n_layers"]
        b = t.dim("batch") if t.has_dim("batch") else int(t.shape[0])
        s = t.dim("seq") if t.has_dim("seq") else int(t.shape[1])
        for node in sub.topo():
            if node.op in ("attention", "sdpa") and node.attrs.get("emit_kv"):
                kv_t = TensorT(
                    (n, b, s, node.attrs["kv_heads"], node.attrs["head_dim"]),
                    t.dtype,
                    ("layers", "batch", "seq", "kv_heads", "head_dim"))
                kv_elems.append(TupleT((kv_t, kv_t)))
        if not kv_elems:
            raise ValidationError(
                "scan_layers collect_kv=True but the subplan has no "
                "emit_kv attention node")
        return TupleT((t, TupleT(tuple(kv_elems))))

    @cat.op("tuple_get", n_inputs=1, required_attrs=("index",))
    def _tuple_get(ins, attrs, sub):
        tt = ins[0]
        if not isinstance(tt, TupleT):
            raise ValidationError(f"tuple_get input must be TupleT, got {tt!r}")
        i = int(attrs["index"])
        if not 0 <= i < len(tt.elems):
            raise ValidationError(
                f"tuple_get: index {i} out of range for {tt!r}")
        return tt.elems[i]

    @cat.op("map", n_inputs=1)
    def _map(ins, attrs, sub):
        lt = ins[0]
        if not isinstance(lt, ListT):
            raise ValidationError(f"map input must be ListT, got {lt!r}")
        if sub is None or len(sub.outputs) != 1:
            raise ValidationError("map needs a single-output subplan")
        return ListT(sub.types[sub.outputs[0]], lt.size)

    @cat.op("filter", n_inputs=1, required_attrs=("predicate",))
    def _filter(ins, attrs, sub):
        lt = ins[0]
        if not isinstance(lt, ListT):
            raise ValidationError(f"filter input must be ListT, got {lt!r}")
        return lt  # size is an upper bound; paper keeps Size metadata fuzzy here

    @cat.op("reduce", n_inputs=1, required_attrs=("fn",))
    def _reduce(ins, attrs, sub):
        lt = ins[0]
        if not isinstance(lt, ListT):
            raise ValidationError(f"reduce input must be ListT, got {lt!r}")
        return lt.elem

    @cat.op("store", n_inputs=1)
    def _store(ins, attrs, sub):
        return ins[0]

    @cat.op("concat_seq", n_inputs=2)
    def _concat_seq(ins, attrs, sub):
        a, b = expect_tensor(ins[0]), expect_tensor(ins[1])
        if not (a.has_dim("seq") and b.has_dim("seq")):
            raise ValidationError("concat_seq operands need 'seq' dims")
        if a.shape[-1] != b.shape[-1]:
            raise ValidationError(f"concat_seq: {a.shape} vs {b.shape}")
        i = a.dims.index("seq")
        shape = a.shape[:i] + (a.dim("seq") + b.dim("seq"),) + a.shape[i + 1:]
        return TensorT(shape, promote_dtype(a.dtype, b.dtype), a.dims)

    # decomposed primitives (targets of §4.2.1 function decomposition)
    @cat.op("qkv_proj", n_inputs=1, required_attrs=("heads", "kv_heads", "head_dim"))
    def _qkv(ins, attrs, sub):
        t = expect_tensor(ins[0])
        h, k, d = attrs["heads"], attrs["kv_heads"], attrs["head_dim"]
        return TupleT((
            TensorT(t.shape[:-1] + (h, d), t.dtype, t.dims[:-1] + ("heads", "head_dim")),
            TensorT(t.shape[:-1] + (k, d), t.dtype, t.dims[:-1] + ("kv_heads", "head_dim")),
            TensorT(t.shape[:-1] + (k, d), t.dtype, t.dims[:-1] + ("kv_heads", "head_dim")),
        ))

    @cat.op("sdpa", n_inputs=1, required_attrs=("heads", "kv_heads", "head_dim"))
    def _sdpa(ins, attrs, sub):
        tt = ins[0]
        if not isinstance(tt, TupleT) or len(tt.elems) != 3:
            raise ValidationError("sdpa expects (q, k, v) TupleT")
        return tt.elems[0]

    @cat.op("out_proj", n_inputs=1, required_attrs=("embed",))
    def _outp(ins, attrs, sub):
        t = expect_tensor(ins[0])
        return TensorT(t.shape[:-2] + (attrs["embed"],), t.dtype,
                       t.dims[:-2] + ("embed",))

    def _head_proj(kind):
        def infer(ins, attrs, sub):
            t = expect_tensor(ins[0])
            h = attrs["heads"] if kind == "q" else attrs["kv_heads"]
            d = attrs["head_dim"]
            dim = "heads" if kind == "q" else "kv_heads"
            return TensorT(t.shape[:-1] + (h, d), t.dtype,
                           t.dims[:-1] + (dim, "head_dim"))
        return infer

    for _k in ("q", "k", "v"):
        cat.register(OpSignature(f"{_k}_proj", _head_proj(_k), 1,
                                 ("heads", "kv_heads", "head_dim")))

    @cat.op("pack_qkv", n_inputs=3)
    def _pack_qkv(ins, attrs, sub):
        return TupleT(tuple(ins))

    @cat.op("ffn_up", n_inputs=1, required_attrs=("ffn",))
    def _ffn_up(ins, attrs, sub):
        t = expect_tensor(ins[0])
        return TensorT(t.shape[:-1] + (attrs["ffn"],), t.dtype,
                       t.dims[:-1] + ("ffn",))

    @cat.op("ffn_gate", n_inputs=1, required_attrs=("ffn",))
    def _ffn_gate(ins, attrs, sub):
        t = expect_tensor(ins[0])
        return TensorT(t.shape[:-1] + (attrs["ffn"],), t.dtype,
                       t.dims[:-1] + ("ffn",))

    @cat.op("ffn_glu", n_inputs=2)
    def _ffn_glu(ins, attrs, sub):
        a, b = expect_tensor(ins[0]), expect_tensor(ins[1])
        if a.shape != b.shape:
            raise ValidationError(f"ffn_glu: {a.shape} vs {b.shape}")
        return a

    @cat.op("ffn_act", n_inputs=1)
    def _ffn_act(ins, attrs, sub):
        return expect_tensor(ins[0])

    @cat.op("ffn_down", n_inputs=1, required_attrs=("embed",))
    def _ffn_down(ins, attrs, sub):
        t = expect_tensor(ins[0])
        return TensorT(t.shape[:-1] + (attrs["embed"],), t.dtype,
                       t.dims[:-1] + ("embed",))

    # -- tri-store ops (relational / graph / text engines + cross-engine
    #    movement).  Each op declares the engine it logically runs on; the
    #    ``place_xfers`` rewrite turns engine boundaries into explicit
    #    ``xfer`` nodes whose materialization the cost model decides.

    def _expected_after_filter(t: "TableT", attrs) -> Optional[int]:
        sel = attrs.get("selectivity")
        if sel is None:
            sel = CMP_SELECTIVITY.get(attrs.get("cmp"), 0.5)
        base = t.rows if t.expected_count is None else t.expected_count
        return min(int(t.rows), max(1, int(math.ceil(base * float(sel)))))

    @cat.op("rel_scan", n_inputs=1, engine="rel")
    def _rel_scan(ins, attrs, sub):
        t = expect_table(ins[0], "rel_scan")
        cols = attrs.get("cols")
        if not cols:
            return t
        for c in cols:
            if not t.has_col(c):
                raise ValidationError(f"rel_scan: no column {c!r} in {t!r}")
        return TableT(tuple((n, d) for n, d in t.columns if n in tuple(cols)),
                      t.rows, t.expected_count, t.partitioning)

    @cat.op("rel_filter", n_inputs=1, required_attrs=("col", "cmp", "value"),
            engine="rel")
    def _rel_filter(ins, attrs, sub):
        t = expect_table(ins[0], "rel_filter")
        if not t.has_col(attrs["col"]):
            raise ValidationError(
                f"rel_filter: no column {attrs['col']!r} in {t!r}")
        if attrs["cmp"] not in ("eq", "ne", "lt", "le", "gt", "ge"):
            raise ValidationError(f"rel_filter: bad cmp {attrs['cmp']!r}")
        # selection narrows validity, not capacity; the expected count
        # shrinks by the (hinted or heuristic) selectivity
        return replace(t, expected_count=_expected_after_filter(t, attrs))

    @cat.op("compact", n_inputs=1, engine="rel")
    def _compact(ins, attrs, sub):
        """Prefix-compaction: valid rows move, in order, to the front of a
        (usually smaller) capacity.  Capacity narrower than the run-time
        survivor count drops rows and raises the relation's overflow flag."""
        t = expect_table(ins[0], "compact")
        cap = int(attrs.get("capacity", t.rows))
        if cap < 1:
            raise ValidationError(f"compact: capacity={cap} out of range")
        cap = min(cap, t.rows)
        exp = attrs.get("expected_count", t.expected_count)
        exp = None if exp is None else min(int(exp), cap)
        return TableT(t.columns, cap, exp)

    def _join_columns(lt, rt, attrs, what):
        lo, ro = attrs["left_on"], attrs["right_on"]
        if not lt.has_col(lo):
            raise ValidationError(f"{what}: no left column {lo!r}")
        if not rt.has_col(ro):
            raise ValidationError(f"{what}: no right column {ro!r}")
        taken = set(lt.col_names())
        extra = tuple((n, d) for n, d in rt.columns
                      if n != ro and n not in taken)
        return lt.columns + extra

    @cat.op("rel_join", n_inputs=2, required_attrs=("left_on", "right_on"),
            engine="rel")
    def _rel_join(ins, attrs, sub):
        lt = expect_table(ins[0], "rel_join left")
        rt = expect_table(ins[1], "rel_join right")
        # unique-build-key probe: output rows mirror the probe side, so the
        # probe side's expected count (and row partitioning) pass through
        # (joins only narrow)
        return TableT(_join_columns(lt, rt, attrs, "rel_join"), lt.rows,
                      lt.expected_count, lt.partitioning)

    @cat.op("bounded_join", n_inputs=2,
            required_attrs=("left_on", "right_on", "capacity"), engine="rel")
    def _bounded_join(ins, attrs, sub):
        """Equi-join with **non-unique build keys**: every (probe, build)
        key match emits a row into a capacity-bounded output.  Matches
        beyond ``capacity`` are dropped with the overflow flag raised."""
        lt = expect_table(ins[0], "bounded_join left")
        rt = expect_table(ins[1], "bounded_join right")
        cap = int(attrs["capacity"])
        if cap < 1:
            raise ValidationError(f"bounded_join: capacity={cap} "
                                  f"out of range")
        exp = attrs.get("expected_count")
        exp = None if exp is None else min(int(exp), cap)
        return TableT(_join_columns(lt, rt, attrs, "bounded_join"), cap, exp)

    @cat.op("rel_group_agg", n_inputs=1,
            required_attrs=("key", "num_groups", "aggs"), engine="rel")
    def _rel_group_agg(ins, attrs, sub):
        t = expect_table(ins[0], "rel_group_agg")
        if not t.has_col(attrs["key"]):
            raise ValidationError(
                f"rel_group_agg: no key column {attrs['key']!r}")
        key_dt = str(t.col_dtype(attrs["key"]))
        if not (key_dt.startswith("int") or key_dt.startswith("uint")):
            raise ValidationError(
                f"rel_group_agg: key column {attrs['key']!r} must be "
                f"integer (group ids), got {key_dt}")
        cols = [(attrs["key"], "int32")]
        for out_name, fn, col in attrs["aggs"]:
            if fn not in ("sum", "count", "mean", "max"):
                raise ValidationError(f"rel_group_agg: bad agg fn {fn!r}")
            if fn != "count" and not t.has_col(col):
                raise ValidationError(f"rel_group_agg: no column {col!r}")
            cols.append((out_name, "float32"))
        groups = int(attrs["num_groups"])
        # at most one valid output row per occupied group: the expected
        # input count upper-bounds the occupied-group count
        exp = (None if t.expected_count is None
               else min(groups, int(t.expected_count)))
        return TableT(tuple(cols), groups, exp)

    @cat.op("col_tensor", n_inputs=1, required_attrs=("col",), engine="rel")
    def _col_tensor(ins, attrs, sub):
        t = expect_table(ins[0], "col_tensor")
        if not t.has_col(attrs["col"]):
            raise ValidationError(f"col_tensor: no column {attrs['col']!r}")
        dim = attrs.get("dim", "rows")
        return TensorT((t.rows,), attrs.get("dtype", "float32"), (dim,))

    @cat.op("graph_expand", n_inputs=2, engine="graph")
    def _graph_expand(ins, attrs, sub):
        g = expect_graph(ins[0], "graph_expand")
        f = expect_tensor(ins[1], "graph_expand frontier")
        if f.shape != (g.nodes,):
            raise ValidationError(
                f"graph_expand: frontier {f.shape} vs nodes {g.nodes}")
        return TensorT((g.nodes,), "float32", ("nodes",))

    @cat.op("graph_pagerank", n_inputs=(1, 2), engine="graph")
    def _graph_pagerank(ins, attrs, sub):
        g = expect_graph(ins[0], "graph_pagerank")
        if len(ins) == 2:
            p = expect_tensor(ins[1], "graph_pagerank personalization")
            if p.shape != (g.nodes,):
                raise ValidationError(
                    f"graph_pagerank: personalization {p.shape} vs "
                    f"nodes {g.nodes}")
        return TensorT((g.nodes,), "float32", ("nodes",))

    @cat.op("graph_tricount", n_inputs=1, engine="graph")
    def _graph_tricount(ins, attrs, sub):
        expect_graph(ins[0], "graph_tricount")
        return ScalarT("float32")

    @cat.op("text_topk", n_inputs=(2, 3), required_attrs=("k",), engine="text")
    def _text_topk(ins, attrs, sub):
        c = expect_corpus(ins[0], "text_topk")
        q = expect_tensor(ins[1], "text_topk query")
        if q.shape != (c.vocab,):
            raise ValidationError(
                f"text_topk: query {q.shape} vs vocab {c.vocab}")
        if len(ins) == 3:
            # candidate-doc mask (predicate pushdown): score only unmasked
            # docs; rows beyond the unmasked count come back mask=False
            m = expect_tensor(ins[2], "text_topk doc mask")
            if m.shape != (c.docs,) or str(m.dtype) != "bool":
                raise ValidationError(
                    f"text_topk: doc mask must be bool ({c.docs},), got {m!r}")
        k = int(attrs["k"])
        if k < 1:
            raise ValidationError(f"text_topk: k={k} out of range")
        # k is clamped to the document count (the true result size); rows
        # whose score slot is unfilled (k > unmasked count under a pushed
        # mask) are masked out at run time rather than over-reported here
        return TableT((("doc", "int32"), ("score", "float32")),
                      min(k, c.docs))

    @cat.op("text_scores", n_inputs=2, engine="text")
    def _text_scores(ins, attrs, sub):
        c = expect_corpus(ins[0], "text_scores")
        q = expect_tensor(ins[1], "text_scores query")
        if q.shape != (c.vocab,):
            raise ValidationError(
                f"text_scores: query {q.shape} vs vocab {c.vocab}")
        return TensorT((c.docs,), "float32", ("docs",))

    @cat.op("masked_topk", n_inputs=2, required_attrs=("k",))
    def _masked_topk(ins, attrs, sub):
        s = expect_tensor(ins[0], "masked_topk scores")
        m = expect_tensor(ins[1], "masked_topk mask")
        if s.rank != 1 or m.shape != s.shape:
            raise ValidationError(
                f"masked_topk: scores {s!r} vs mask {m!r}")
        if str(m.dtype) != "bool":
            raise ValidationError(f"masked_topk: mask must be bool, got {m!r}")
        k = int(attrs["k"])
        if k < 1:
            raise ValidationError(f"masked_topk: k={k} out of range")
        return TableT((("doc", "int32"), ("score", "float32")),
                      min(k, int(s.shape[0])))

    @cat.op("sel_mask", n_inputs=1, required_attrs=("col", "size"),
            engine="rel")
    def _sel_mask(ins, attrs, sub):
        """Selection-mask export: the relation's mask scattered over an
        entity domain (``mask[v] = any selected row with col == v``) — the
        boolean that predicate pushdown carries into the other engines."""
        t = expect_table(ins[0], "sel_mask")
        if not t.has_col(attrs["col"]):
            raise ValidationError(f"sel_mask: no column {attrs['col']!r}")
        dt = str(t.col_dtype(attrs["col"]))
        if not (dt.startswith("int") or dt.startswith("uint")):
            raise ValidationError(
                f"sel_mask: column {attrs['col']!r} must be integer "
                f"(entity ids), got {dt}")
        return TensorT((int(attrs["size"]),), "bool",
                       (attrs.get("dim", "docs"),))

    @cat.op("rel_fused", n_inputs=(1, 8), required_attrs=("chain",),
            engine="rel")
    def _rel_fused(ins, attrs, sub):
        """Fused same-engine chain (the ``fuse_store_ops`` product): each
        step is (op, attrs, srcs, out_type) where srcs name either "prev"
        (the previous step's output) or an integer input position."""
        prev = None
        for op, step_attrs, srcs, _out in attrs["chain"]:
            step_ins = []
            for s in srcs:
                if s == "prev":
                    if prev is None:
                        raise ValidationError("rel_fused: 'prev' in 1st step")
                    step_ins.append(prev)
                else:
                    step_ins.append(ins[int(s)])
            prev = cat.get(op).infer(step_ins, dict(step_attrs), None)
        return prev

    @cat.op("xfer", n_inputs=1)
    def _xfer(ins, attrs, sub):
        return ins[0]  # pure movement: the value is unchanged

    return cat


# --------------------------------------------------------------------------
# System catalog (paper §2.2): hardware + mesh description
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class HardwareSpec:
    """Per-chip peaks for the target part (defaults: NVIDIA H100 SXM, from
    its data sheet).  The field names are the reference package's, since
    the syscat fingerprint is this dataclass's ``repr``: ``ici_bw`` holds
    the NVLink rate per direction and ``vmem_bytes`` the shared memory one
    block can use."""

    name: str = "h100-sxm"
    peak_flops: float = 989e12       # bf16 dense FLOP/s
    hbm_bw: float = 3.35e12          # bytes/s
    ici_bw: float = 450e9            # bytes/s per direction (NVLink)
    hbm_bytes: float = 80e9
    vmem_bytes: float = 232_448


# data-sheet figures of the two H100 parts (dense bf16, HBM, NVLink per
# direction, memory); the PCIe card has no NVLink switch, so its peer rate
# is the PCIe Gen5 x16 rate
H100_SXM = HardwareSpec()
H100_PCIE = HardwareSpec(name="h100-pcie", peak_flops=756e12, hbm_bw=2.0e12,
                         ici_bw=64e9, hbm_bytes=80e9)


def hardware_for_device(device_name: Optional[str] = None) -> HardwareSpec:
    """The data-sheet HardwareSpec of the card ``device_name`` names (by
    default ``torch.cuda.get_device_properties(0).name``): the PCIe part
    when the name says so, else the SXM part."""
    if device_name is None:
        import torch
        device_name = torch.cuda.get_device_properties(0).name
    return H100_PCIE if "pcie" in device_name.lower() else H100_SXM


@dataclass(frozen=True)
class SystemCatalog:
    """Registered 'stores' — here the mesh axes + hardware description."""

    hardware: HardwareSpec = HardwareSpec()
    mesh_axes: tuple = ("data", "model")
    mesh_shape: tuple = (1, 1)

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.mesh_shape:
            n *= s
        return n

    def axis_size(self, name: str) -> int:
        if name not in self.mesh_axes:
            return 1
        return self.mesh_shape[self.mesh_axes.index(name)]

    def fingerprint(self) -> str:
        """Content hash of the store metadata (hardware peaks + mesh).  Part
        of ``plan_id``: a syscat change invalidates cached plans because the
        cost model's roofline features depend on it."""
        return hashlib.sha256(repr(
            (self.hardware, self.mesh_axes, self.mesh_shape)).encode()
        ).hexdigest()
