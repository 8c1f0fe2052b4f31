"""Physical-plan executor of the port: walks the chosen physical DAG and runs
it as PyTorch operations on one device.

The counterpart of the reference package's ``core/executor.py``: the
execution context, the impl table over the port's own engine registry (the
generic and the language-model impls live here; the store impls register
from ``repro_torch.stores.runtime``), the fast ``run_plan`` path, and
:class:`PlannedFunction`, the staged plan bound to a device.  The LM impls
cover the dense, moe, rwkv and hybrid families' prefill:
``scan_layers_xla`` runs its subplan in a Python loop over the stacked
per-layer parameters under ``torch.inference_mode()`` (``remat`` means
nothing without a backward); ``attn_flash_pallas``, ``moe_gmm_pallas``,
``wkv6_pallas`` and ``ssd_pallas`` are the flash-attention, grouped expert
matmul, WKV6 and SSD kernels, ``moe_dense_onehot`` and ``moe_dropping``
the capacity dispatch with einsum experts (cf 2.0 and 1.0),
``wkv6_scan_xla`` and ``ssd_chunked_xla`` the recurrences' chunked plain
forms.  ``map`` / ``filter`` / ``reduce`` run ADIL's collection ops over
a ``ListT`` value, a Python list of tensors (a ``filter`` predicate that
reads a device value synchronizes with the host, as it must to decide).
The moe impls ignore the ``pin_moe`` attr: the reference's sharding
constraints have no counterpart on one card.  Planning is the
copied staged pipeline, so a plan id here equals the reference package's
for the same analysis and catalogs.

EXPLAIN ANALYZE is the reference's: ``PlannedFunction.analyze`` runs the
plan under a span tracer (``ExecContext.tracer``, ``core/tracing.py``),
one span per physical op, and synchronizes the device once at the end;
``observe`` records the count sink's cardinalities into a
``SelectivityFeedback``; both move the run's device values to the host in
one copy.  With no tracer and no fault injector, ``run_plan`` is the
untouched fast path: one check per call, none per op.

Fault injection is the reference's too: a
:class:`~repro_torch.core.faults.FaultInjector` on the planned function
(``PlannedFunction.faults``) rides in ``ExecContext.faults``, and the run
checks it at every node boundary (``_run_plan_faulted``, or inside each
span of the traced path), wrapping any impl exception into the
:class:`~repro_torch.core.resilience.ExecError` taxonomy with its site.

Every entry point runs on the card unless the caller passes
``device="cpu"``; without a card they raise (:func:`resolve_device`) rather
than carry on on the CPU.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Any, Optional

import torch

from .buffering import BufferingDecision
from .cost_model import CostModel, raw_features
from .engines import dispatch, get_engine, resolve_engines
from .ir import FunctionCatalog, Plan, SystemCatalog, hardware_for_device
from .physical import PHYS_OPS, PhysPlan
from ..layers import attention as A
from ..layers import embedding as E
from ..layers import mamba as M
from ..layers import mlp as F
from ..layers import moe as X
from ..layers import rwkv as R
from ..layers.common import layer_slice, rmsnorm, torch_dtype


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card (``"cuda"``) unless the
    caller names another.  Raises when that is a CUDA device and PyTorch
    sees none — the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False;"
            f" pass device='cpu' to run the plain path on the CPU")
    return dev


def default_syscat(device) -> SystemCatalog:
    """The system catalog to plan for on ``device``: the data sheet of the
    card in use, or of the H100 SXM when planning for the CPU."""
    if torch.device(device).type == "cuda":
        return SystemCatalog(hardware=hardware_for_device())
    return SystemCatalog()


def _tensors(value):
    """Every tensor inside a plan value (tensor, dict payload, relation)."""
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _tensors(v)
    elif hasattr(value, "cols") and hasattr(value, "valid"):
        # duck-typed BoundedRel (no core -> stores import)
        yield from _tensors(value.cols)
        yield value.valid


# --------------------------------------------------------------------------
# execution context
# --------------------------------------------------------------------------

@dataclass
class ExecContext:
    root: Any                       # full param tree
    scope: Any                      # current scope
    device: torch.device            # where the plan's tensors live
    aux: dict = field(default_factory=dict)   # count_sink, positions, ...
    tracer: Optional[Any] = None    # core.tracing.Tracer; None = fast path
    faults: Optional[Any] = None    # core.faults.FaultInjector; None = off

    def params_for(self, node):
        """The parameters under the node's ``pp`` path: from the root for
        ``shared`` nodes, else from the current scope (a layer slice inside
        ``scan_layers``)."""
        path = node.attrs.get("pp")
        if path is None:
            return self.scope
        base = self.root if node.attrs.get("shared") else self.scope
        for k in path:
            base = base[k]
        return base


# --------------------------------------------------------------------------
# impl registration — each engine owns its dispatch table (engines.py)
# --------------------------------------------------------------------------

def impl(*names, engine: str = "xla"):
    """Register a physical-op implementation under a named engine."""
    return get_engine(engine).impl(*names)


@impl("identity", "store")
def _i_identity(ctx, args, node):
    return args[0]


@impl("const")
def _i_const(ctx, args, node):
    return node.attrs["value"]


@impl("residual_add_xla")
def _i_resid(ctx, args, node):
    return args[0] + args[1]


# --------------------------------------------------------------------------
# language-model impls (one device: partition and merge are identities)
# --------------------------------------------------------------------------

@impl("partition", "merge")
def _i_partition(ctx, args, node):
    return args[0]


@impl("embed_gather")
def _i_embed(ctx, args, node):
    out = E.embed(ctx.params_for(node), args[0].long(),
                  scale=node.attrs.get("scale", False))
    dt = node.attrs.get("dtype")
    return out.to(torch_dtype(dt)) if dt else out


@impl("rmsnorm_xla")
def _i_rmsnorm(ctx, args, node):
    return rmsnorm(args[0], ctx.params_for(node)["scale"])


def _attn_cfg(node):
    a = node.attrs
    return a["heads"], a["kv_heads"], a["head_dim"]


@impl("q_proj_xla")
def _i_qproj(ctx, args, node):
    h, k, d = _attn_cfg(node)
    return A.project_q(ctx.params_for(node), args[0], h, d)


@impl("k_proj_xla")
def _i_kproj(ctx, args, node):
    h, k, d = _attn_cfg(node)
    return A.project_kv(ctx.params_for(node), args[0], k, d)[0]


@impl("v_proj_xla")
def _i_vproj(ctx, args, node):
    h, k, d = _attn_cfg(node)
    return A.project_kv(ctx.params_for(node), args[0], k, d)[1]


@impl("pack_qkv_xla")
def _i_pack(ctx, args, node):
    return tuple(args)


@impl("qkv_proj_fused")
def _i_qkv_fused(ctx, args, node):
    h, k, d = _attn_cfg(node)
    return A.project_qkv_fused(ctx.params_for(node), args[0], h, k, d)


def _prep(ctx, node, q, k):
    pos = ctx.aux.get("positions")
    if pos is None:
        pos = torch.arange(q.shape[1], device=q.device)[None, :]
    return A.qk_prep(ctx.params_for(node), q, k, pos,
                     qk_norm=node.attrs.get("qk_norm", False),
                     use_rope=node.attrs.get("rope", True),
                     rope_theta=node.attrs.get("rope_theta", 10000.0))


def _emit_kv(ctx, node, k, v):
    """KV export hook: inside a ``collect_kv`` scan, sdpa impls append their
    prepped K (post qk-norm/RoPE — exactly what the decode cache stores) and
    raw V to the sink the scan body planted in ``ctx.aux``."""
    sink = ctx.aux.get("kv_sink")
    if sink is not None and node.attrs.get("emit_kv"):
        sink.append((k, v))


@impl("sdpa_xla")
def _i_sdpa(ctx, args, node):
    q, k, v = args[0]
    q, k = _prep(ctx, node, q, k)
    _emit_kv(ctx, node, k, v)
    return A.sdpa_full(q, k, v, causal=node.attrs.get("causal", True),
                       window=node.attrs.get("window", 0) or 0)


@impl("attn_flash_pallas", engine="pallas")
def _i_flash(ctx, args, node):
    q, k, v = args[0]
    q, k = _prep(ctx, node, q, k)
    _emit_kv(ctx, node, k, v)
    return A.sdpa_flash(q, k, v, causal=node.attrs.get("causal", True),
                        window=node.attrs.get("window", 0) or 0)


@impl("out_proj_xla")
def _i_outproj(ctx, args, node):
    return A.out_project(ctx.params_for(node), args[0])


@impl("ffn_up_xla")
def _i_ffn_up(ctx, args, node):
    return F.ffn_up(ctx.params_for(node), args[0])


@impl("ffn_gate_xla")
def _i_ffn_gate(ctx, args, node):
    return F.ffn_gate(ctx.params_for(node), args[0])


@impl("ffn_glu_xla")
def _i_ffn_glu(ctx, args, node):
    return F.ffn_glu(args[0], args[1], node.attrs.get("act", "silu"))


@impl("ffn_act_xla")
def _i_ffn_act(ctx, args, node):
    return F.ffn_act(args[0], node.attrs.get("act", "gelu"))


@impl("ffn_down_xla")
def _i_ffn_down(ctx, args, node):
    return F.ffn_down(ctx.params_for(node), args[0])


@impl("mlp_fused_xla")
def _i_mlp(ctx, args, node):
    return F.mlp_fused(ctx.params_for(node), args[0],
                       gated=node.attrs.get("gated", True),
                       act=node.attrs.get("act"))


@impl("moe_dense_onehot")
def _i_moe_dense(ctx, args, node):
    a = node.attrs
    return X.moe_dense(ctx.params_for(node), args[0], top_k=a["top_k"],
                       experts=a["experts"], act=a.get("act", "silu"),
                       capacity_factor=a.get("capacity_factor", 2.0))


@impl("moe_dropping")
def _i_moe_drop(ctx, args, node):
    a = node.attrs
    return X.moe_dropping(ctx.params_for(node), args[0], top_k=a["top_k"],
                          experts=a["experts"], act=a.get("act", "silu"))


@impl("moe_gmm_pallas", engine="pallas")
def _i_moe_gmm(ctx, args, node):
    a = node.attrs
    return X.moe_gmm(ctx.params_for(node), args[0], top_k=a["top_k"],
                     experts=a["experts"], act=a.get("act", "silu"))


@impl("wkv6_scan_xla")
def _i_wkv_xla(ctx, args, node):
    a = node.attrs
    return R.rwkv_time_mix(ctx.params_for(node), args[0], heads=a["heads"],
                           head_dim=a["head_dim"], use_kernel=False)


@impl("wkv6_pallas", engine="pallas")
def _i_wkv_kernel(ctx, args, node):
    a = node.attrs
    return R.rwkv_time_mix(ctx.params_for(node), args[0], heads=a["heads"],
                           head_dim=a["head_dim"], use_kernel=True)


def _mamba_node_cfg(node):
    """The mamba block config a planned ssd node carries."""
    a = node.attrs
    return {"embed": a["embed"], "state": a["state"],
            "expand": a.get("expand", 2), "head_dim": a["head_dim"]}


@impl("ssd_chunked_xla")
def _i_ssd_xla(ctx, args, node):
    return M.mamba2_block(ctx.params_for(node), args[0],
                          _mamba_node_cfg(node), use_kernel=False)


@impl("ssd_pallas", engine="pallas")
def _i_ssd_kernel(ctx, args, node):
    return M.mamba2_block(ctx.params_for(node), args[0],
                          _mamba_node_cfg(node), use_kernel=True)


@impl("rwkv_channel_mix")
def _i_rwkv_cm(ctx, args, node):
    return R.rwkv_channel_mix(ctx.params_for(node), args[0])


@impl("unembed_matmul")
def _i_unembed(ctx, args, node):
    out = E.unembed(ctx.params_for(node), args[0])
    true_v = node.attrs.get("true_vocab")
    if true_v and true_v < out.shape[-1]:
        out = E.mask_padded_logits(out, true_v)
    return out


@impl("tuple_get_xla")
def _i_tuple_get(ctx, args, node):
    return args[0][node.attrs["index"]]


@impl("scan_layers_xla")
def _i_scan(ctx, args, node):
    """The reference's ``lax.scan`` over stacked layers as a Python loop.
    With ``collect_kv`` each layer's emitting sdpa impls append (K, V) to a
    fresh sink, stacked over layers to ``(layers, B, S, KV, D)`` — the
    decode cache layout; returns ``(carry, ((K, V), ...))`` then."""
    carry = args[0]
    p_stack = ctx.params_for(node)
    sub = node.subplan
    in_names = list(sub.inputs.keys())
    extra_env = dict(zip(in_names[1:], args[1:]))
    collect_kv = bool(node.attrs.get("collect_kv"))
    per_layer = []
    with torch.inference_mode():
        for i in range(int(node.attrs["n_layers"])):
            sink: list = []
            aux = {**ctx.aux, "kv_sink": sink} if collect_kv else ctx.aux
            ctx2 = replace(ctx, scope=layer_slice(p_stack, i), aux=aux)
            carry = run_plan(sub, ctx2, {in_names[0]: carry, **extra_env})[0]
            per_layer.append(tuple(sink))
        if not collect_kv:
            return carry
        kv = tuple((torch.stack([layer[j][0] for layer in per_layer]),
                    torch.stack([layer[j][1] for layer in per_layer]))
                   for j in range(len(per_layer[0])))
    return (carry, kv)


# --------------------------------------------------------------------------
# ADIL's collection ops over a ListT value (a Python list of plan values)
# --------------------------------------------------------------------------

@impl("map")
def _i_map(ctx, args, node):
    sub = node.subplan
    (in_name,) = sub.inputs.keys()
    return [run_plan(sub, ctx, {in_name: v})[0] for v in args[0]]


@impl("reduce")
def _i_reduce(ctx, args, node):
    fn = node.attrs["fn"]
    vals = args[0]
    acc = vals[0]
    for v in vals[1:]:
        acc = fn(acc, v) if callable(fn) else acc + v
    return acc


@impl("filter")
def _i_filter(ctx, args, node):
    pred = node.attrs["predicate"]
    return [v for v in args[0] if pred(v)]


# --------------------------------------------------------------------------
# plan execution
# --------------------------------------------------------------------------

def _impl_fn(n):
    opdef = PHYS_OPS.get(n.impl)
    fn = dispatch(n.impl, opdef.backend if opdef else None)
    if fn is None:
        raise NotImplementedError(f"no engine implements {n.impl!r}")
    return fn


def run_plan(pplan: PhysPlan, ctx: ExecContext, values: dict) -> tuple:
    """Run every node of a concrete physical plan in topo order.  Nothing
    here reads a device value back to the host.  With a tracer in the
    context the traced path runs instead (:func:`_run_plan_traced`), with
    a fault injector and no tracer the faulted one
    (:func:`_run_plan_faulted`)."""
    if ctx.tracer is None and ctx.faults is None:
        # the untouched fast path: tracing and fault injection both off
        env = dict(values)
        for n in pplan.topo():
            env[n.id] = _impl_fn(n)(ctx, [env[i] for i in n.inputs], n)
        return tuple(env[o] for o in pplan.outputs)
    if ctx.tracer is not None:
        return _run_plan_traced(pplan, ctx, values)
    return _run_plan_faulted(pplan, ctx, values)


def _fault_site(n) -> tuple:
    """Site key for a physical node: xfer/collective nodes get their own
    category (the "sharded" failure class), everything else is "node"."""
    if n.impl.startswith("xfer_"):
        return ("xfer", n.id, n.impl)
    return ("node", n.id, n.impl)


def _run_plan_faulted(pplan: PhysPlan, ctx: ExecContext,
                      values: dict) -> tuple:
    """run_plan with a FaultInjector at every node boundary.  Impl
    exceptions (injected or real) are wrapped into the ExecError taxonomy
    with their site attached, so the resilience layer can classify and the
    breaker can pick a fallback class."""
    from .resilience import classify
    faults = ctx.faults
    env = dict(values)
    for n in pplan.topo():
        fn = _impl_fn(n)
        opdef = PHYS_OPS.get(n.impl)
        engine = (opdef.backend or "xla") if opdef else "xla"
        try:
            faults.check(_fault_site(n))
            env[n.id] = fn(ctx, [env[i] for i in n.inputs], n)
        except Exception as exc:
            raise classify(exc, node=n, engine=engine) from exc
    return tuple(env[o] for o in pplan.outputs)


def _run_plan_traced(pplan: PhysPlan, ctx: ExecContext,
                     values: dict) -> tuple:
    """run_plan with one span per physical op.  Span durations are dispatch
    times (CUDA launches are asynchronous); the caller synchronizes once
    per run.  Device-side observations (BoundedRel counts, overflow flags)
    are *deferred* into the tracer and fetched in one transfer at
    ``resolve()`` — a relation's lazy count is computed here, on the traced
    path only."""
    from .tracing import tree_bytes, xfer_wire_bytes
    tracer = ctx.tracer
    n_data = 1                       # one device: no data axis
    env = dict(values)
    for n in pplan.topo():
        fn = _impl_fn(n)
        opdef = PHYS_OPS.get(n.impl)
        attrs = {"impl": n.impl,
                 "engine": (opdef.backend or "xla") if opdef else "xla"}
        if "dist" in n.attrs:
            attrs["dist"] = n.attrs["dist"]
        with tracer.span(n.id, "op", **attrs) as sp:
            if ctx.faults is not None:
                ctx.faults.check(_fault_site(n))
            out = fn(ctx, [env[i] for i in n.inputs], n)
            if n.impl.startswith("xfer_"):
                kind = n.impl[len("xfer_"):]
                payload = tree_bytes(out)
                sp.attrs["xfer_kind"] = kind
                sp.attrs["payload_bytes"] = payload
                sp.attrs["wire_bytes"] = xfer_wire_bytes(kind, payload,
                                                         n_data)
            # duck-typed BoundedRel (no core -> stores import): its
            # count / overflow are device scalars — defer, don't fetch
            if hasattr(out, "cols") and hasattr(out, "valid"):
                tracer.defer("count", out.count)
                tracer.defer("overflow", out.overflow)
                sp.attrs["capacity"] = int(out.capacity)
        env[n.id] = out
    return tuple(env[o] for o in pplan.outputs)


def run_plan_subset(pplan: PhysPlan, ctx: ExecContext, values: dict,
                    node_ids) -> dict:
    """Execute only ``node_ids`` of a physical plan (in plan topo order),
    seeding the environment from ``values`` — plan inputs *plus* any
    already-materialized node outputs.  Returns the full environment."""
    wanted = set(node_ids)
    env = dict(values)
    for n in pplan.topo():
        if n.id in wanted:
            env[n.id] = _impl_fn(n)(ctx, [env[i] for i in n.inputs], n)
    return env


# --------------------------------------------------------------------------
# end-to-end: logical plan -> planned function on one device
# --------------------------------------------------------------------------

def _drain_counts(resolved, feedback) -> None:
    """Fold already-resolved count-sink entries into a feedback store."""
    for site, count, capacity in resolved:
        if site and site[0] == "compact_overflow":
            # a capacity bound dropped rows: flag the originating
            # predicate site so re-planning backs off from compacting it
            if count > 0:
                feedback.note_overflow(tuple(site[1]))
            continue
        feedback.record(site, count, capacity)


@dataclass
class PlannedFunction:
    """A staged plan bound to one device."""

    logical: Plan
    pplan: PhysPlan                  # with virtual nodes (pre-choice)
    concrete: PhysPlan               # chosen + data-parallelized
    choices: dict
    report: list
    buffering: BufferingDecision
    syscat: SystemCatalog
    device: torch.device
    plan_id: str = ""
    staged: Optional[Any] = None     # StagedPhysicalPlan
    faults: Optional[Any] = None     # core.faults.FaultInjector; None = off
    last_run_trace: Optional[Any] = None   # RunTrace of the last analyze()
    _predicted: Optional[dict] = None      # node id -> (seconds, features)

    @classmethod
    def from_staged(cls, staged, syscat: SystemCatalog, *,
                    device="cuda") -> "PlannedFunction":
        return cls(staged.logical, staged.pplan, staged.concrete,
                   staged.choices, staged.report, staged.buffering,
                   syscat, resolve_device(device), staged.plan_id, staged)

    def explain(self, analyze=False) -> str:
        """The plan-time EXPLAIN report; with ``analyze`` the runtime
        section merges in.  ``analyze=True`` uses the last :meth:`analyze`
        run's trace; a RunTrace may also be passed directly."""
        if self.staged is None:
            return ""
        trace = None
        if analyze is not False and analyze is not None:
            trace = analyze if hasattr(analyze, "spans") \
                else self.last_run_trace
            if trace is None:
                raise ValueError(
                    "explain(analyze=True) needs a run trace: call "
                    ".analyze(params, inputs) first")
        return self.staged.explain(analyze=trace)

    def chosen_impls(self) -> list:
        """The concrete plan's impl names, in topo order."""
        return [n.impl for n in self.concrete.topo()]

    def _context(self, params, inputs: dict, aux, tracer=None):
        """The execution context of one run on this plan's device; refuses
        inputs that hold a tensor on another device."""
        dev = resolve_device(self.device)
        for name, value in inputs.items():
            for t in _tensors(value):
                if t.device.type != dev.type:
                    raise ValueError(
                        f"input {name!r} holds a tensor on {t.device}, but "
                        f"this plan runs on {dev}: build it with "
                        f"payload(device={str(dev)!r})")
        return ExecContext(root=params, scope=params, device=dev,
                           aux=aux or {}, tracer=tracer, faults=self.faults)

    def __call__(self, params, inputs: dict, aux: Optional[dict] = None):
        outs = run_plan(self.concrete, self._context(params, inputs, aux),
                        inputs)
        return outs if len(outs) > 1 else outs[0]

    # -- EXPLAIN ANALYZE ----------------------------------------------------
    def _predict_costs(self, cost_model=None) -> dict:
        """Cost-model predictions per concrete node (memoized: the plan is
        immutable, so one walk serves every analyze run)."""
        if self._predicted is not None and cost_model is None:
            return self._predicted
        cm = cost_model or CostModel()
        predicted: dict = {}

        def visit(plan):
            for n in plan.topo():
                if n.subplan is not None:
                    visit(n.subplan)
                in_types = [plan.types.get(i) or plan.inputs.get(i)
                            for i in n.inputs]
                try:
                    feats = raw_features(n.impl, in_types, n.attrs,
                                         self.syscat)
                    sec = cm.op_seconds(n.impl, in_types, n.attrs,
                                        self.syscat)
                except Exception:
                    continue
                predicted[n.id] = (float(sec), feats)

        visit(self.concrete)
        if cost_model is None:
            self._predicted = predicted
        return predicted

    def analyze(self, params, inputs: dict, aux: Optional[dict] = None, *,
                feedback=None, cost_model=None, recorder=None,
                trip_context=None):
        """EXPLAIN ANALYZE execution: run the plan under a span tracer,
        synchronize the device **once** at the end (``torch.cuda.
        synchronize`` in the ``device_sync`` span; empty on the CPU), and
        build a :class:`~repro_torch.core.tracing.RunTrace` pairing every
        physical node's observed dispatch ms / counts / xfer bytes with the
        cost model's prediction.  The trace lands in
        ``self.last_run_trace`` (rendered by ``explain(analyze=True)``) and
        its ``(impl, features, observed_s)`` samples feed
        ``core.feedback.fit_weights``.  With ``feedback`` given, the count
        sink also drains into it (superset of :meth:`observe`).  With
        ``recorder`` (a :class:`~repro_torch.core.ledger.FlightRecorder`),
        the run's trace summary lands in the ring, and two incident
        triggers trip a dump: an executor exception (which then re-raises)
        and any BoundedRel overflow observed in the resolved counts.
        ``trip_context`` — a zero-arg callable returning a dict — is merged
        into the ``executor_error`` trip detail.  The outputs are
        ``__call__``'s, on the same device.  Returns the plan outputs."""
        from .tracing import RunTrace, Tracer
        tracer = Tracer()
        sink: list = []
        run_aux = dict(aux or {})
        run_aux["count_sink"] = sink
        sync_sp = None
        t0 = time.perf_counter()
        try:
            ctx = self._context(params, inputs, run_aux, tracer=tracer)
            with tracer.span("run", "run", plan_id=self.plan_id):
                outs = run_plan(self.concrete, ctx, inputs)
            with tracer.span("device_sync", "sync") as sync_sp:
                if ctx.device.type == "cuda":
                    torch.cuda.synchronize(ctx.device)
        except Exception as exc:
            if recorder is not None:
                detail = {"plan_id": self.plan_id, "error": repr(exc)}
                if trip_context is not None:
                    try:
                        detail.update(trip_context() or {})
                    except Exception:
                        pass
                recorder.trip("executor_error", detail)
            raise
        wall_ms = (time.perf_counter() - t0) * 1e3
        # ONE device -> host copy: deferred span attrs + the count sink
        counts = tracer.resolve(sink)
        predicted = self._predict_costs(cost_model)
        samples = []
        for sp in tracer.spans:
            hit = predicted.get(sp.name)
            if hit is None:
                continue
            sec, feats = hit
            sp.attrs["predicted_s"] = sec
            samples.append((sp.attrs.get("impl", sp.name), feats, sp.dur))
        trace = RunTrace(spans=list(tracer.spans), wall_ms=wall_ms,
                         sync_ms=sync_sp.dur_ms if sync_sp else 0.0,
                         counts=counts, samples=samples,
                         plan_id=self.plan_id)
        self.last_run_trace = trace
        if recorder is not None:
            recorder.record_trace(trace)
            overflows = [
                {"site": list(map(str, site)), "count": float(c),
                 "capacity": int(cap)}
                for site, c, cap in counts
                if site and site[0] == "compact_overflow" and c > 0]
            overflows += [
                {"span": sp.name, "capacity": sp.attrs.get("capacity")}
                for sp in trace.spans if sp.attrs.get("overflow")]
            if overflows:
                recorder.trip("overflow", {"plan_id": self.plan_id,
                                           "overflows": overflows})
        if feedback is not None:
            _drain_counts(counts, feedback)
        return outs if len(outs) > 1 else outs[0]

    def observe(self, params, inputs: dict, feedback,
                aux: Optional[dict] = None):
        """Run the plan while recording observed cardinalities: every
        ``rel_filter`` / ``sel_mask`` site reports its actual ``count /
        capacity`` into ``feedback`` (a ``SelectivityFeedback``).  The
        counts stay on the device during the run and move to the host in
        **one** copy at the end (``resolve_counts`` — the transfer point
        EXPLAIN ANALYZE uses too), never per site.  Re-compiling with the
        same feedback object then re-plans under the observed
        selectivities (and misses the plan cache by construction).
        Returns the plan outputs, exactly like ``__call__``."""
        from .tracing import resolve_counts
        sink: list = []
        out_aux = dict(aux or {})
        out_aux["count_sink"] = sink
        outs = self.__call__(params, inputs, aux=out_aux)
        _drain_counts(resolve_counts(sink), feedback)
        return outs


def plan_and_compile(logical: Plan, catalog: FunctionCatalog,
                     syscat: SystemCatalog, *,
                     cost_model: Optional[CostModel] = None,
                     engines=None,
                     allow_pallas=None,
                     data_parallel: bool = True,
                     buffering: bool = False,
                     global_batch: int = 1,
                     rewrite_pipeline=None,
                     cache=None,
                     pipeline=None,
                     plan_threads: int = 1,
                     feedback=None,
                     store_versions: tuple = (),
                     device="cuda") -> PlannedFunction:
    """Run — or fetch from the plan cache — the staged plan pipeline and
    bind the staged plan to ``device``.  The options are the reference
    package's, so equal options give an equal plan id."""
    from .pipeline import PlanOptions, compile_staged
    from .rewrite import DEFAULT_PIPELINE
    dev = resolve_device(device)
    opts = PlanOptions(
        engines=resolve_engines(engines, allow_pallas=allow_pallas),
        data_parallel=data_parallel,
        buffering=buffering,
        global_batch=global_batch,
        rewrite_pipeline=tuple(rewrite_pipeline or DEFAULT_PIPELINE),
        plan_threads=plan_threads)
    extra_key = (("store_versions", tuple(store_versions))
                 if store_versions else ())
    staged = compile_staged(logical, catalog, syscat, options=opts,
                            cost_model=cost_model, pipeline=pipeline,
                            cache=cache, feedback=feedback,
                            extra_key=extra_key)
    return PlannedFunction.from_staged(staged, syscat, device=dev)
