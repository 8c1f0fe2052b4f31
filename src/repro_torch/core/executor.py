"""Physical-plan executor of the port: walks the chosen physical DAG and runs
it as PyTorch operations on one device.

The counterpart of the reference package's ``core/executor.py``: the
execution context, the impl table over the port's own engine registry (the
generic and the language-model impls live here; the store impls register
from ``repro_torch.stores.runtime``), the fast ``run_plan`` path, and
:class:`PlannedFunction`, the staged plan bound to a device.  The LM impls
cover every family's prefill and train plans (dense, moe, rwkv, hybrid,
vlm, encdec; ``softmax_xent_xla`` the loss): ``scan_layers_xla`` runs its
subplan in a Python loop over the stacked per-layer parameters, under
``torch.inference_mode()`` unless a parameter or an input requires grad;
then each layer runs as its node's ``remat`` attr says, as the reference's
``jax.checkpoint`` (``"full"``: ``torch.utils.checkpoint``; ``"dots"`` /
``"dots_no_batch"``: selective checkpointing that keeps the matmuls'
outputs; ``"none"``: plain).  ``attn_flash_pallas``, ``moe_gmm_pallas``,
``wkv6_pallas`` and ``ssd_pallas`` are the flash-attention, grouped expert
matmul, WKV6 and SSD kernels (differentiable: the backward is each plain
version's VJP, ``kernels/autograd.py``), ``moe_dense_onehot`` and
``moe_dropping`` the capacity dispatch with einsum experts (cf 2.0 and 1.0),
``wkv6_scan_xla`` and ``ssd_chunked_xla`` the recurrences' chunked plain
forms, ``sdpa_banded_xla`` the chunked local-window attention,
``concat_seq`` the vlm's frontend prefix and ``cross_attention_xla`` the
encdec decoder's plain attention to the encoder's output.
``map`` / ``filter`` / ``reduce`` run ADIL's collection ops over a
``ListT`` value, a Python list of tensors (a ``filter`` predicate that
reads a device value synchronizes with the host, as it must to decide).
On one card the moe impls ignore the ``pin_moe`` attr (the
reference's sharding constraints only place values).  Planning is the
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

On a mesh (``plan_and_compile(..., mesh=)``, a
:class:`~repro_torch.launch.mesh.DataMesh` whose rank device is the plan's)
every rank runs the same plan on the same global values, and the store
impls of ``dist``-stamped nodes run their sharded operators through the
mesh's collectives (``ExecContext.mesh``).

The model side of the mesh: :class:`ShardingRules` and
:func:`params_sharding` are the reference's (rule tables, "first dim wins"
per mesh axis, ``no_fsdp_experts``), a spec being a tuple with an axis
name, a tuple of names or None per dim; :class:`Sharding` adds the shard
shape and, on a live mesh, the rank's block.  On a
:class:`~repro_torch.launch.mesh.RankMesh` (``plan_and_compile(...,
mesh=, param_specs=)``) the LM impls run GSPMD's layout written out: each
rank holds its block of every parameter (``embed`` over ``data``, heads,
ffn, vocab and experts over ``model``) and of the batch (over ``(pod,
data)``), and calls the collectives of :mod:`.collectives` itself.
``partition`` takes the rank's rows of a global value and ``merge``
gathers them;
``scan_layers_xla`` gathers each layer's ``data`` shards just before the
layer (FSDP; again in a ``remat`` recompute); ``embed_gather`` gathers
its rows of a vocab-sharded table and sums over ``model``; the q / k / v
projections are column-parallel on heads (every KV head a rank's query
heads read, when ``kv_heads`` does not divide over ``model``; when the
query heads do not divide, the first ranks take one more, gathering and
narrowing the projections: ``layers.attention.head_block``); the out and
down projections row-parallel with a sum over ``model``;
``unembed_matmul`` gives the rank's vocab columns and
``softmax_xent_xla`` is the vocab-parallel cross-entropy, a mean over the
global batch (sums over ``pod`` and ``data``); the moe impls run the rank's experts (``layers/moe.py``);
the rwkv time and channel mixes and the mamba block run the rank's heads
and ffn columns (``layers/rwkv.py``, ``layers/mamba.py``), the encdec
decoder's cross attention its heads of q from ``x`` and of K/V from the
encoder's output.  A plan value is then the rank's block of the global
value; the loss is whole on every rank.  A stored dim a family cuts over
``model`` that does not divide is refused when the plan is bound
(:func:`_mesh_shardings`), before any rank runs it.

Every entry point runs on the card unless the caller passes
``device="cpu"``; without a card they raise (:func:`resolve_device`) rather
than carry on on the CPU.
"""
from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field, replace
from typing import Any, Optional

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from . import collectives as C
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
    sees none — the port never falls back to the CPU on its own.
    ``"meta"`` (shapes and dtypes only, nothing computed) is taken only
    when the caller names it: the dry run traces a step there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}: use 'cuda', 'cpu' or "
                         f"'meta'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False;"
            f" pass device='cpu' to run the plain path on the CPU")
    return dev


def _same_device(a: torch.device, b: torch.device) -> bool:
    """One device, where ``cuda`` names the current card."""
    if a.type != b.type:
        return False
    if a.type != "cuda" or a.index == b.index:
        return True
    here = torch.cuda.current_device()
    return (a.index if a.index is not None else here) == (
        b.index if b.index is not None else here)


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
# sharding rules: semantic dim name -> mesh axes
# --------------------------------------------------------------------------

def _is_spec(s) -> bool:
    return isinstance(s, tuple) and all(isinstance(x, str) for x in s)


@dataclass(frozen=True)
class ShardingRules:
    """MaxText-style logical-axis rules.  ``param`` maps weight dim names,
    ``act`` maps activation dim names."""

    act: tuple = (
        ("batch", ("pod", "data")),
        ("heads", ("model",)),
        ("kv_heads", ("model",)),
        ("ffn", ("model",)),
        ("vocab", ("model",)),
        ("experts", ("model",)),
    )
    param: tuple = (
        ("embed", ("data",)),          # FSDP / ZeRO-3: shard embed over data
        ("vocab", ("model",)),
        ("ffn", ("model",)),
        ("heads_flat", ("model",)),
        ("kv_flat", ("model",)),
        ("experts", ("model",)),
        ("inner", ("model",)),
        ("inner_cat", ("model",)),
        ("inner_cat2", ("model",)),
    )
    # expert weights already divide over `model` via EP; FSDP-sharding
    # their embed dim over `data` as well makes every expert matmul a
    # partial sum.  True => replicate expert weights over data.
    no_fsdp_experts: bool = False

    def _lookup(self, table, dim, mesh):
        for d, axes in table:
            if d == dim:
                ax = tuple(a for a in axes if a in mesh.axis_names)
                if len(ax) == 1:
                    return ax[0]
                return ax if ax else None
        return None

    def _spec(self, table, dims, mesh, *, is_param=False) -> tuple:
        # each mesh axis may appear at most once per spec: first dim wins
        used: set = set()
        out = []
        skip_fsdp = (is_param and self.no_fsdp_experts
                     and "experts" in dims)
        for d in dims:
            if skip_fsdp and d == "embed":
                out.append(None)
                continue
            ax = self._lookup(table, d, mesh)
            axes = (ax,) if isinstance(ax, str) else (ax or ())
            if any(a in used for a in axes):
                out.append(None)
                continue
            used.update(axes)
            out.append(ax)
        return tuple(out)

    def act_spec(self, dims, mesh) -> tuple:
        return self._spec(self.act, dims, mesh)

    def param_spec(self, dims, mesh) -> tuple:
        return self._spec(self.param, dims, mesh, is_param=True)


@dataclass(frozen=True)
class Sharding:
    """A leaf's layout on a mesh: ``spec`` has, per dim, the mesh axis it
    is cut over (a name, a tuple of names, or None: whole).  ``mesh`` is a
    process-free ``MeshLayout`` or a live ``RankMesh`` (both have
    ``axis_names`` and ``shape``); on a live one :meth:`block` is this
    rank's part.  ``name`` and ``dims`` (the leaf's path and dim names)
    name the leaf in errors."""

    mesh: Any
    spec: tuple
    name: str = ""
    dims: tuple = ()

    def axes(self, i: int) -> tuple:
        """The mesh axes dim ``i`` is cut over (empty: whole)."""
        ax = self.spec[i] if i < len(self.spec) else None
        return (ax,) if isinstance(ax, str) else tuple(ax or ())

    def parts(self, i: int) -> int:
        n = 1
        for a in self.axes(i):
            n *= int(self.mesh.shape[a])
        return n

    def shard_shape(self, shape) -> tuple:
        """The block's shape of a leaf of global ``shape``.  A dim that
        does not divide over its axes raises ``ValueError`` naming the
        leaf and the dim (no padded uneven shards, unlike GSPMD)."""
        out = []
        for i, size in enumerate(shape):
            k = self.parts(i)
            if size % k:
                dim = self.dims[i] if i < len(self.dims) else i
                raise ValueError(
                    f"{self.name or 'leaf'}: dim {dim!r} of size {size} does "
                    f"not divide over mesh axes {self.axes(i)} ({k} ranks)")
            out.append(size // k)
        return tuple(out)

    def index(self, shape) -> tuple:
        """Slices of this rank's block of a leaf of global ``shape``."""
        local = self.shard_shape(shape)
        out = []
        for i, n in enumerate(local):
            c = 0
            for a in self.axes(i):
                c = c * int(self.mesh.shape[a]) + int(self.mesh.coords[a])
            out.append(slice(c * n, (c + 1) * n))
        return tuple(out)

    def block(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the global ``x``: a tensor of its own."""
        return x[self.index(x.shape)].clone()

    def sharded_axes(self) -> set:
        return {a for i in range(len(self.spec)) for a in self.axes(i)}

    def layer(self) -> "Sharding":
        """The sharding of one layer of a stacked leaf (its leading
        ``layers`` dim, which no rule cuts, dropped)."""
        if self.axes(0):
            raise ValueError(f"{self.name}: the layers dim is cut")
        return Sharding(self.mesh, self.spec[1:], self.name, self.dims[1:])


def params_sharding(specs_tree, mesh, rules: ShardingRules, path=()):
    """Map a specs tree (tuples of dim names) to :class:`Sharding`
    records."""
    if _is_spec(specs_tree):
        return Sharding(mesh, rules.param_spec(specs_tree, mesh),
                        ".".join(path), specs_tree)
    return {k: params_sharding(v, mesh, rules, path + (k,))
            for k, v in specs_tree.items()}


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
    mesh: Optional[Any] = None      # launch.mesh.DataMesh / RankMesh
    # on a rank mesh: the Sharding tree of the root params and of the
    # current scope (a layer's, inside scan_layers), whether the scope's
    # data shards are already gathered, and the plan's global batch
    shardings: Optional[Any] = None
    sh_scope: Optional[Any] = None
    gathered: bool = False
    global_batch: Optional[int] = None

    def _walk(self, node):
        path = node.attrs.get("pp")
        if path is None:
            return self.scope, self.sh_scope, self.gathered
        shared = bool(node.attrs.get("shared"))
        base = self.root if shared else self.scope
        sh = self.shardings if shared else self.sh_scope
        for k in path:
            base = base[k]
            sh = None if sh is None else sh[k]
        return base, sh, self.gathered and not shared

    def params_for(self, node):
        """The parameters under the node's ``pp`` path: from the root for
        ``shared`` nodes, else from the current scope (a layer slice inside
        ``scan_layers``).  On a rank mesh, with the ``data`` shards
        gathered (FSDP) unless the scope holds them gathered already."""
        p, sh, gathered = self._walk(node)
        if sh is None or gathered:
            return p
        return gather_params(self, p, sh)

    def local_params_for(self, node):
        """``(params, shardings)`` under the node's path, as this rank
        holds them (shardings None off a rank mesh)."""
        p, sh, _ = self._walk(node)
        return p, sh

    def constrain(self, x, dims):
        """The reference's layout pin (``with_sharding_constraint`` to
        ``act_spec(dims)``).  The port's impls build each value in its
        layout themselves, so ``x`` comes back as it is; the moe impls take
        a given ``constrain`` as ``pin_moe``'s switch to the pinned
        exchange (``layers/moe.py``)."""
        return x

    def axis(self, name: str):
        """The mesh's sub-group along ``name`` when it has more than one
        rank, else None (one device, a store's data mesh, no such axis)."""
        m = self.mesh
        if m is None or not hasattr(m, "axis") or name not in m.axis_names:
            return None
        ax = m.axis(name)
        return ax if int(ax.world) > 1 else None


def _tree_items(p, sh, path=()):
    """``(path, leaf, sharding)`` of a nested dict and its Sharding tree."""
    if isinstance(p, dict):
        for k, v in p.items():
            yield from _tree_items(v, sh[k], path + (k,))
    else:
        yield path, p, sh


def _tree_put(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _copy_tree(p):
    return {k: _copy_tree(v) for k, v in p.items()} if isinstance(p, dict) \
        else p


def gather_params(ctx, p, sh):
    """``p`` (a subtree of this rank's parameter blocks) with each leaf's
    ``data``-cut dim gathered over the ``data`` axis, one collective per
    dtype (FSDP; the backward sums the ranks' gradients and keeps the
    block).  A leaf that is whole over ``data`` passes through
    :func:`~.collectives.copy_to`, so its gradient, a partial sum of the
    rank's rows, is summed over ``data`` too."""
    data = ctx.axis("data")
    if data is None:
        return p
    items = list(_tree_items(p, sh))
    cut, dims = [], []
    out = _copy_tree(p)
    for path, leaf, s in items:
        d = [i for i in range(leaf.dim()) if "data" in s.axes(i)]
        if d and s.axes(d[0]) != ("data",):
            raise NotImplementedError(
                f"{s.name}: dim {d[0]} is cut over {s.axes(d[0])}")
        if d:
            cut.append((path, leaf))
            dims.append(d[0])
        else:
            _tree_put(out, path, C.copy_to(data, leaf))
    full = C.gather_leaves(data, [leaf for _, leaf in cut], dims)
    for (path, _), t in zip(cut, full):
        _tree_put(out, path, t)
    return out


def layer_shardings(sh):
    """The shardings of one layer of a stacked tree (``Sharding.layer``
    of each leaf; None stays None)."""
    if sh is None:
        return None
    if isinstance(sh, dict):
        return {k: layer_shardings(v) for k, v in sh.items()}
    return sh.layer()


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
# language-model impls
# --------------------------------------------------------------------------

def _batch_axes(ctx) -> list:
    """The live axes the batch is cut over, outermost first: ``pod``, then
    ``data`` (the reference's ``("pod", "data")``)."""
    return [ax for ax in (ctx.axis("pod"), ctx.axis("data"))
            if ax is not None]


def _batch_block(ctx, x):
    """Whether ``x`` (batch-leading) is the global value (True) or this
    rank's rows already (False); anything else is refused."""
    n = 1
    for ax in _batch_axes(ctx):
        n *= int(ax.world)
    gb = ctx.global_batch
    if gb is None or gb % n:
        raise ValueError(f"global batch {gb} does not divide over the "
                         f"batch axes (pod, data: {n} ranks)")
    if x.shape[0] == gb and n > 1:
        return True
    if x.shape[0] == gb // n:
        return False
    raise ValueError(f"a batch of {x.shape[0]} rows is neither the global "
                     f"batch {gb} nor a rank's {gb // n}")


def _rank_rows(ctx, x):
    """This rank's rows of the batch-leading ``x``: ``x`` itself when it
    holds them already (or off the batch axes).  Block ``p * data + d`` of
    the rows is the rank's at ``(pod p, data d)``."""
    axes = _batch_axes(ctx)
    if not axes or not isinstance(x, torch.Tensor) or \
            not _batch_block(ctx, x):
        return x
    i, n = 0, 1
    for ax in axes:
        i = i * int(ax.world) + int(ax.rank)
        n *= int(ax.world)
    rows = x.shape[0] // n
    return x[i * rows:(i + 1) * rows]


@impl("partition")
def _i_partition(ctx, args, node):
    """This rank's rows of a batch-leading value (the reference's
    constraint of the batch dim to ``(pod, data)``); a value already cut
    passes through.  One device: the identity."""
    return _rank_rows(ctx, args[0])


@impl("merge")
def _i_merge(ctx, args, node):
    """The global value of this rank's rows, replicated (the reference's
    replicating constraint): an all-gather over ``data``, then over
    ``pod``, whose backward slices.  One device: the identity."""
    x = args[0]
    axes = _batch_axes(ctx)
    if not axes or not isinstance(x, torch.Tensor) or \
            _batch_block(ctx, x):
        return x
    for ax in reversed(axes):
        x = C.gather(ax, x, 0, partial=False)
    return x


@impl("embed_gather")
def _i_embed(ctx, args, node):
    """Rows of the table; on a ``model`` axis the table's vocab rows are
    cut, so each rank looks up the ids in its rows (zeros elsewhere) and
    the rows are summed over ``model`` — exact, every other term is 0."""
    p = ctx.params_for(node)
    dt = node.attrs.get("dtype")
    ids = args[0].long()
    model = ctx.axis("model")
    if model is None:
        out = E.embed(p, ids, scale=node.attrs.get("scale", False))
        return out.to(torch_dtype(dt)) if dt else out
    rows = p["table"].shape[0]
    local = ids - int(model.rank) * rows
    inside = (local >= 0) & (local < rows)
    out = E.embed(p, local.clamp(0, rows - 1),
                  scale=node.attrs.get("scale", False))
    out = out.to(torch_dtype(dt)) if dt else out
    out = torch.where(inside[..., None], out,
                      torch.zeros((), dtype=out.dtype, device=out.device))
    return C.reduce_from(model, out)


@impl("rmsnorm_xla")
def _i_rmsnorm(ctx, args, node):
    return rmsnorm(args[0], ctx.params_for(node)["scale"])


def _attn_cfg(node):
    a = node.attrs
    return a["heads"], a["kv_heads"], a["head_dim"]


def _local_heads(ctx, node):
    """``(model axis, (lo, hi), (klo, khi, index))``: the rank's query
    heads (``A.head_block``), the KV heads they read and how they group
    over them (``A.kv_heads_read``); the axis None and every head on one
    device."""
    h, k, d = _attn_cfg(node)
    model = ctx.axis("model")
    if model is None:
        return None, (0, h), (0, k, None)
    lo, hi = A.head_block(h, int(model.world), int(model.rank))
    return model, (lo, hi), A.kv_heads_read(h, k, lo, hi)


def _q_weight(model, p, d, heads):
    """``wq``'s columns of the rank's query heads: its stored block when
    the heads divide over ``model``, else gathered and narrowed."""
    lo, hi = heads
    return C.span(model, [p["wq"]], 1, lo * d, hi * d)[0]


def _kv_weights(model, p, d, kv):
    """``wk`` / ``wv`` of the KV heads ``[klo, khi)``.  They are stored cut
    over ``model`` (``kv_flat``); when those heads are the rank's block
    they are used as stored, else every rank gathers the columns
    (backward: summed over ``model``) and keeps the heads it reads."""
    klo, khi, _ = kv
    return C.span(model, [p["wk"], p["wv"]], 1, klo * d, khi * d)


@impl("q_proj_xla")
def _i_qproj(ctx, args, node):
    h, k, d = _attn_cfg(node)
    p = ctx.params_for(node)
    model, heads, _ = _local_heads(ctx, node)
    if model is not None:
        p = {"wq": _q_weight(model, p, d, heads)}
    return A.project_q(p, C.copy_to(model, args[0]), heads[1] - heads[0], d)


def _kv_proj(ctx, args, node, which):
    h, k, d = _attn_cfg(node)
    p = ctx.params_for(node)
    model, _, kv = _local_heads(ctx, node)
    if model is not None:
        wk, wv = _kv_weights(model, p, d, kv)
        p = {"wk": wk, "wv": wv}
    out = A.project_kv(p, C.copy_to(model, args[0]), kv[1] - kv[0], d)
    return A.expand_heads(out[which], kv[2])


@impl("k_proj_xla")
def _i_kproj(ctx, args, node):
    return _kv_proj(ctx, args, node, 0)


@impl("v_proj_xla")
def _i_vproj(ctx, args, node):
    return _kv_proj(ctx, args, node, 1)


@impl("pack_qkv_xla")
def _i_pack(ctx, args, node):
    return tuple(args)


@impl("qkv_proj_fused")
def _i_qkv_fused(ctx, args, node):
    """One gemm over the concatenated projection; on a ``model`` axis
    column-parallel: the rank's query heads and the KV heads they read."""
    h, k, d = _attn_cfg(node)
    p = ctx.params_for(node)
    model, heads, kv = _local_heads(ctx, node)
    if model is not None:
        wk, wv = _kv_weights(model, p, d, kv)
        p = {"wq": _q_weight(model, p, d, heads), "wk": wk, "wv": wv}
    q, kk, vv = A.project_qkv_fused(p, C.copy_to(model, args[0]),
                                    heads[1] - heads[0], kv[1] - kv[0], d)
    return q, A.expand_heads(kk, kv[2]), A.expand_heads(vv, kv[2])


def _prep(ctx, node, q, k):
    pos = ctx.aux.get("positions")
    if pos is None:
        pos = torch.arange(q.shape[1], device=q.device)[None, :]
    p = ctx.params_for(node)
    model = ctx.axis("model")
    if model is not None and "q_norm" in p:
        # whole norms applied to the rank's heads: their gradients are
        # partial sums over model
        p = {**p, "q_norm": C.copy_to(model, p["q_norm"]),
             "k_norm": C.copy_to(model, p["k_norm"])}
    return A.qk_prep(p, q, k, pos,
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


@impl("sdpa_banded_xla")
def _i_banded(ctx, args, node):
    q, k, v = args[0]
    q, k = _prep(ctx, node, q, k)
    _emit_kv(ctx, node, k, v)
    return A.sdpa_banded(q, k, v, window=node.attrs.get("window", 0) or 0,
                         causal=node.attrs.get("causal", True))


@impl("attn_flash_pallas", engine="pallas")
def _i_flash(ctx, args, node):
    q, k, v = args[0]
    q, k = _prep(ctx, node, q, k)
    _emit_kv(ctx, node, k, v)
    return A.sdpa_flash(q, k, v, causal=node.attrs.get("causal", True),
                        window=node.attrs.get("window", 0) or 0)


def _o_weight(model, p, d, heads):
    """``wo``'s rows of the rank's query heads (stored, or gathered and
    narrowed as :func:`_q_weight`)."""
    lo, hi = heads
    return C.span(model, [p["wo"]], 0, lo * d, hi * d)[0]


@impl("out_proj_xla")
def _i_outproj(ctx, args, node):
    """Row-parallel on a ``model`` axis: the rank's heads against its rows
    of ``wo``, summed over ``model``.  The node carries no head count: it
    is the rank's stored rows times the axis over the head size."""
    p = ctx.params_for(node)
    model = ctx.axis("model")
    if model is not None:
        m, d = int(model.world), args[0].shape[-1]
        heads = A.head_block(p["wo"].shape[0] * m // d, m, int(model.rank))
        p = {"wo": _o_weight(model, p, d, heads)}
    return C.reduce_from(model, A.out_project(p, args[0]))


@impl("cross_attention_xla")
def _i_xattn(ctx, args, node):
    """The decoder's attention to the encoder's output: q from x, K/V from
    ``memory``, no RoPE or qk-norm, full non-causal attention in plain
    PyTorch (the reference computes it in XLA, outside any kernel).  On a
    ``model`` axis q and K/V are column-parallel on the rank's heads (both
    inputs through ``copy_to``: every decoder layer's gradient into
    ``memory`` is a partial sum) and the out projection row-parallel.  On
    a ``data`` axis ``memory`` comes replicated (the plan's ``merge``) and
    the rank reads the rows of its own ``x``."""
    x, mem = args
    p = ctx.params_for(node)
    h, k, d = _attn_cfg(node)
    model, heads, kv = None, (0, h), (0, k, None)
    if getattr(ctx, "mesh", None) is not None:   # else one device (also
        model, heads, kv = _local_heads(ctx, node)   # a bare context)
        mem = _rank_rows(ctx, mem)
    if model is not None:
        wk, wv = _kv_weights(model, p, d, kv)
        p = {"wq": _q_weight(model, p, d, heads), "wk": wk, "wv": wv,
             "wo": _o_weight(model, p, d, heads)}
    q = A.project_q(p, C.copy_to(model, x), heads[1] - heads[0], d)
    kk, vv = (A.expand_heads(t, kv[2]) for t in A.project_kv(
        p, C.copy_to(model, mem), kv[1] - kv[0], d))
    return C.reduce_from(model, A.out_project(
        p, A.sdpa_full(q, kk, vv, causal=False)))


@impl("ffn_up_xla")
def _i_ffn_up(ctx, args, node):
    return F.ffn_up(ctx.params_for(node),
                    C.copy_to(ctx.axis("model"), args[0]))


@impl("ffn_gate_xla")
def _i_ffn_gate(ctx, args, node):
    return F.ffn_gate(ctx.params_for(node),
                      C.copy_to(ctx.axis("model"), args[0]))


@impl("ffn_glu_xla")
def _i_ffn_glu(ctx, args, node):
    return F.ffn_glu(args[0], args[1], node.attrs.get("act", "silu"))


@impl("ffn_act_xla")
def _i_ffn_act(ctx, args, node):
    return F.ffn_act(args[0], node.attrs.get("act", "gelu"))


@impl("ffn_down_xla")
def _i_ffn_down(ctx, args, node):
    return C.reduce_from(ctx.axis("model"),
                         F.ffn_down(ctx.params_for(node), args[0]))


@impl("mlp_fused_xla")
def _i_mlp(ctx, args, node):
    """Column-parallel up / gate, row-parallel down on a ``model`` axis."""
    model = ctx.axis("model")
    return C.reduce_from(model, F.mlp_fused(
        ctx.params_for(node), C.copy_to(model, args[0]),
        gated=node.attrs.get("gated", True), act=node.attrs.get("act")))


def _moe_kw(ctx, node) -> dict:
    """The moe impls' mesh arguments: the ``model`` axis the experts are
    cut over, and ``constrain`` when the node pins the layout."""
    return {"experts_axis": ctx.axis("model"),
            "constrain": ctx.constrain if node.attrs.get("pin_moe")
            else None}


@impl("moe_dense_onehot")
def _i_moe_dense(ctx, args, node):
    a = node.attrs
    return X.moe_dense(ctx.params_for(node), args[0], top_k=a["top_k"],
                       experts=a["experts"], act=a.get("act", "silu"),
                       capacity_factor=a.get("capacity_factor", 2.0),
                       **_moe_kw(ctx, node))


@impl("moe_dropping")
def _i_moe_drop(ctx, args, node):
    a = node.attrs
    return X.moe_dropping(ctx.params_for(node), args[0], top_k=a["top_k"],
                          experts=a["experts"], act=a.get("act", "silu"),
                          **_moe_kw(ctx, node))


@impl("moe_gmm_pallas", engine="pallas")
def _i_moe_gmm(ctx, args, node):
    a = node.attrs
    return X.moe_gmm(ctx.params_for(node), args[0], top_k=a["top_k"],
                     experts=a["experts"], act=a.get("act", "silu"),
                     **_moe_kw(ctx, node))


@impl("wkv6_scan_xla")
def _i_wkv_xla(ctx, args, node):
    """The time mix; on a ``model`` axis on the rank's ``heads / model``
    heads (the node's ``heads`` stays the global count)."""
    a = node.attrs
    return R.rwkv_time_mix(ctx.params_for(node), args[0], heads=a["heads"],
                           head_dim=a["head_dim"], use_kernel=False,
                           axis=ctx.axis("model"))


@impl("wkv6_pallas", engine="pallas")
def _i_wkv_kernel(ctx, args, node):
    a = node.attrs
    return R.rwkv_time_mix(ctx.params_for(node), args[0], heads=a["heads"],
                           head_dim=a["head_dim"], use_kernel=True,
                           axis=ctx.axis("model"))


def _mamba_node_cfg(node):
    """The mamba block config a planned ssd node carries."""
    a = node.attrs
    return {"embed": a["embed"], "state": a["state"],
            "expand": a.get("expand", 2), "head_dim": a["head_dim"]}


@impl("ssd_chunked_xla")
def _i_ssd_xla(ctx, args, node):
    """The mamba block; on a ``model`` axis on the rank's heads."""
    return M.mamba2_block(ctx.params_for(node), args[0],
                          _mamba_node_cfg(node), use_kernel=False,
                          axis=ctx.axis("model"))


@impl("ssd_pallas", engine="pallas")
def _i_ssd_kernel(ctx, args, node):
    return M.mamba2_block(ctx.params_for(node), args[0],
                          _mamba_node_cfg(node), use_kernel=True,
                          axis=ctx.axis("model"))


@impl("rwkv_channel_mix")
def _i_rwkv_cm(ctx, args, node):
    """On a ``model`` axis on the rank's ffn columns."""
    return R.rwkv_channel_mix(ctx.params_for(node), args[0],
                              axis=ctx.axis("model"))


@impl("unembed_matmul")
def _i_unembed(ctx, args, node):
    """float32 logits; on a ``model`` axis vocab-parallel: the rank's
    vocab columns (the padded ones past ``true_vocab`` masked by their
    global ids)."""
    model = ctx.axis("model")
    out = E.unembed(ctx.params_for(node), C.copy_to(model, args[0]))
    lo = 0 if model is None else int(model.rank) * out.shape[-1]
    vocab = out.shape[-1] * (1 if model is None else int(model.world))
    true_v = node.attrs.get("true_vocab")
    if true_v and true_v < vocab:
        out = E.mask_padded_logits(out, true_v - lo)
    return out


@impl("softmax_xent_xla")
def _i_xent(ctx, args, node):
    """The mean cross-entropy.  On a mesh the logits are the rank's rows
    (``data``) and vocab columns (``model``): the log-partition takes the
    max and the sum over ``model``, the gold logit comes from the rank
    holding its column, and the mean is over the global batch (sums over
    ``data``), so every rank holds the whole loss."""
    model = ctx.axis("model")
    if model is None and not _batch_axes(ctx):
        return E.softmax_xent(args[0], args[1])
    logits, labels = args
    valid = labels != -100
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    if model is None:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    else:
        with torch.no_grad():
            mx = C.all_max(model, logits.amax(dim=-1))
        logz = mx + torch.log(C.reduce_from(
            model, torch.exp(logits - mx[..., None]).sum(dim=-1)))
        cols = logits.shape[-1]
        local = safe - int(model.rank) * cols
        inside = (local >= 0) & (local < cols)
        gold = torch.gather(logits, -1, local.clamp(0, cols - 1)[..., None])
        gold = C.reduce_from(model, torch.where(
            inside, gold[..., 0], torch.zeros((), dtype=logits.dtype,
                                              device=logits.device)))
    weight = valid.to(logits.dtype)
    total = (logz - gold).mul(weight).sum()
    count = weight.sum()
    for ax in _batch_axes(ctx):
        total = C.reduce_from(ax, total)
        count = ax.all_reduce(count)
    return total / count.clamp(min=1.0)


@impl("concat_seq")
def _i_concat_seq(ctx, args, node):
    """The vlm's frontend prefix before the text embeddings: ``a`` cast to
    ``b``'s dtype, then joined along ``axis``.  Both must hold the same
    rows (on a mesh: the rank's)."""
    a, b = args
    if a.shape[0] != b.shape[0]:
        raise ValueError(f"frontend_embeds holds {a.shape[0]} rows, the "
                         f"text embeddings {b.shape[0]}: not this rank's "
                         f"rows")
    return torch.cat([a.to(b.dtype), b], dim=node.attrs.get("axis", 1))


@impl("tuple_get_xla")
def _i_tuple_get(ctx, args, node):
    return args[0][node.attrs["index"]]


def _requires_grad(tree) -> bool:
    return any(t.requires_grad for t in _tensors(tree))


# the ops whose outputs selective checkpointing keeps: the reference's
# ``checkpoint_dots`` / ``checkpoint_dots_with_no_batch_dims`` policies
_SAVED_DOTS = {
    "dots": (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
             torch.ops.aten.bmm.default),
    "dots_no_batch": (torch.ops.aten.mm.default,
                      torch.ops.aten.addmm.default)}


def _remat(remat: str):
    """A layer runner ``run(fn, carry)`` for the scan node's ``remat``
    attr: ``"none"`` calls ``fn``; ``"dots"`` / ``"dots_no_batch"``
    checkpoint it keeping the matmuls' outputs; anything else (``"full"``,
    and a name the reference's policy table lacks, which it checkpoints
    with no policy) recomputes the whole layer in the backward."""
    if remat in (None, "none"):
        return lambda fn, carry: fn(carry)
    kw = {}
    if remat in _SAVED_DOTS:
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, list(_SAVED_DOTS[remat]))
    return lambda fn, carry: checkpoint(fn, carry, use_reentrant=False,
                                        **kw)


def _scan_grad(ctx, node, args):
    """The scan with a gradient: every layer under :func:`_remat`.  A
    ``collect_kv`` (serving) plan is refused."""
    if node.attrs.get("collect_kv"):
        raise NotImplementedError(
            "scan_layers_xla: collect_kv plans serve; they take no gradient")
    sub = node.subplan
    in_names = list(sub.inputs.keys())
    extra_env = dict(zip(in_names[1:], args[1:]))
    run = _remat(node.attrs.get("remat", "none"))
    carry = args[0]
    for i in range(int(node.attrs["n_layers"])):
        def layer(h, i=i):
            return run_plan(sub, _layer_context(ctx, node, i),
                            {in_names[0]: h, **extra_env})[0]
        carry = run(layer, carry)
    return carry


def _layer_context(ctx, node, i, aux=None):
    """The context of layer ``i`` of a scan node: the layer's slice of the
    stacked parameters as the scope; on a rank mesh with its ``data``
    shards gathered here (FSDP: inside a ``remat`` layer they are gathered
    again for the recompute, and freed after either)."""
    p_stack, sh_stack = ctx.local_params_for(node)
    scope = layer_slice(p_stack, i)
    sh = layer_shardings(sh_stack)
    if sh is not None:
        scope = gather_params(ctx, scope, sh)
    return replace(ctx, scope=scope, sh_scope=sh, gathered=sh is not None,
                   aux=ctx.aux if aux is None else aux)


@impl("scan_layers_xla")
def _i_scan(ctx, args, node):
    """The reference's ``lax.scan`` over stacked layers as a Python loop.
    Inputs after the carry (the encdec decoder's ``memory``) reach every
    layer unchanged, bound to the subplan's later inputs.  With
    ``collect_kv`` each layer's emitting sdpa impls append (K, V) to a
    fresh sink, stacked over layers to ``(layers, B, S, KV, D)`` — the
    decode cache layout; returns ``(carry, ((K, V), ...))`` then.  When
    grad mode is on and a parameter of the stack or an input requires
    grad, :func:`_scan_grad` runs the layers instead, with ``remat``."""
    p_stack, _ = ctx.local_params_for(node)
    if torch.is_grad_enabled() and (_requires_grad(p_stack)
                                    or _requires_grad(args)):
        return _scan_grad(ctx, node, args)
    carry = args[0]
    sub = node.subplan
    in_names = list(sub.inputs.keys())
    extra_env = dict(zip(in_names[1:], args[1:]))
    collect_kv = bool(node.attrs.get("collect_kv"))
    per_layer = []
    with torch.inference_mode():
        for i in range(int(node.attrs["n_layers"])):
            sink: list = []
            aux = {**ctx.aux, "kv_sink": sink} if collect_kv else ctx.aux
            carry = run_plan(sub, _layer_context(ctx, node, i, aux),
                             {in_names[0]: carry, **extra_env})[0]
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
    n_data = 1 if ctx.mesh is None else int(ctx.mesh.shape.get("data", 1))
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


_LM_IMPLS = {"embed_gather", "scan_layers_xla", "unembed_matmul"}
# the impl that names a plan's family (the first found, in this order)
_FAMILY_OF = (("concat_seq", "vlm"), ("cross_attention_xla", "encdec"),
              ("ssd_pallas", "hybrid"), ("ssd_chunked_xla", "hybrid"),
              ("wkv6_pallas", "rwkv"), ("wkv6_scan_xla", "rwkv"),
              ("rwkv_channel_mix", "rwkv"))


def _all_nodes(plan):
    for n in plan.topo():
        yield n
        if n.subplan is not None:
            yield from _all_nodes(n.subplan)


def _mesh_size(mesh) -> int:
    n = 1
    for a in getattr(mesh, "axis_names", ()):
        n *= int(mesh.shape[a])
    return n


def _model_cut_dims(n) -> list:
    """``(dim name, size)`` of each stored dim node ``n`` cuts over
    ``model``: the query heads' width of every attention and of the rwkv
    time mix (their head counts may not divide: ``A.head_block``), the
    rwkv ffn, the mamba heads and its in-projection's and conv's
    concatenated widths."""
    a = n.attrs
    if n.impl in ("wkv6_pallas", "wkv6_scan_xla"):
        return [("heads_flat", a["heads"] * a["head_dim"])]
    if n.impl == "rwkv_channel_mix":
        return [("ffn", a["ffn"])]
    if n.impl in ("ssd_pallas", "ssd_chunked_xla"):
        ei = a.get("expand", 2) * a["embed"]
        return [("heads", a["heads"]),
                ("inner_cat", 2 * ei + 2 * a["state"] + a["heads"]),
                ("inner_cat2", ei + 2 * a["state"])]
    if "kv_heads" in a and "heads" in a:
        return [("heads_flat", a["heads"] * a["head_dim"])]
    return []


def _check_model_cuts(nodes, mesh):
    """Refuse a plan with a dim its family cuts over ``model`` that does
    not divide (every rank would otherwise need the whole layer)."""
    m = int(mesh.shape.get("model", 1))
    if m <= 1:
        return
    impls = {n.impl for n in nodes}
    family = next((f for i, f in _FAMILY_OF if i in impls), "dense")
    own = {i for i, _f in _FAMILY_OF}
    for n in sorted(nodes, key=lambda n: n.impl not in own):
        for dim, size in _model_cut_dims(n):
            if int(size) % m:
                raise ValueError(
                    f"the {family} family cuts {dim!r} ({size}, at "
                    f"{n.impl}) over the model axis, which does not divide "
                    f"over {m} ranks of the mesh {dict(mesh.shape)}")


def _mesh_shardings(concrete, mesh, rules, param_specs):
    """The parameters' Sharding tree of an LM plan on a rank mesh of more
    than one rank (None otherwise).  Refuses a dim cut over ``model`` that
    does not divide, a serving (``collect_kv``) plan, a store's data mesh,
    and a missing ``param_specs``."""
    nodes = list(_all_nodes(concrete))
    if mesh is None or _mesh_size(mesh) <= 1 or \
            not any(n.impl in _LM_IMPLS for n in nodes):
        return None
    _check_model_cuts(nodes, mesh)
    for n in nodes:
        if n.attrs.get("collect_kv"):
            raise ValueError("a collect_kv (serving prefill) plan runs on "
                             "one rank")
    if not hasattr(mesh, "axis"):
        raise ValueError("an LM plan runs on a RankMesh (launch.mesh."
                         "make_rank_mesh), not a store's data mesh")
    if param_specs is None:
        raise ValueError("an LM plan on a mesh needs param_specs= (the "
                         "model's param_specs())")
    return params_sharding(param_specs, mesh, rules)


def _global_batch(concrete) -> Optional[int]:
    """The leading size of the plan's first batch-leading input."""
    for t in concrete.inputs.values():
        dims = getattr(t, "dims", None)
        if dims and dims[0] == "batch":
            return int(t.shape[0])
    return None


@dataclass
class PlannedFunction:
    """A staged plan bound to one device, and on a mesh to its rank."""

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
    mesh: Optional[Any] = None       # launch.mesh.DataMesh / RankMesh
    # on a rank mesh: the Sharding tree of the parameters (their specs
    # under ``rules``), the layout every call's params are held in
    param_shardings: Optional[Any] = None

    @classmethod
    def from_staged(cls, staged, syscat: SystemCatalog, *,
                    device="cuda", mesh=None, rules=None,
                    param_specs=None) -> "PlannedFunction":
        dev = resolve_device(device)
        if mesh is not None and not _same_device(mesh.device, dev):
            raise ValueError(f"the mesh's rank runs on {mesh.device}, but "
                             f"the plan is compiled for {dev}")
        shardings = _mesh_shardings(staged.concrete, mesh,
                                    rules or ShardingRules(), param_specs)
        return cls(staged.logical, staged.pplan, staged.concrete,
                   staged.choices, staged.report, staged.buffering,
                   syscat, dev, staged.plan_id, staged, mesh=mesh,
                   param_shardings=shardings)

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
                           aux=aux or {}, tracer=tracer, faults=self.faults,
                           mesh=self.mesh, shardings=self.param_shardings,
                           sh_scope=self.param_shardings,
                           global_batch=_global_batch(self.concrete))

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
                     device="cuda", mesh=None,
                     rules: Optional[ShardingRules] = None,
                     param_specs=None) -> PlannedFunction:
    """Run — or fetch from the plan cache — the staged plan pipeline and
    bind the staged plan to ``device`` and, on a mesh
    (:class:`~repro_torch.launch.mesh.DataMesh` or
    :class:`~repro_torch.launch.mesh.RankMesh`, whose rank device must be
    ``device``), to the rank.  An LM plan on a rank mesh takes
    ``param_specs`` (the model's ``param_specs()``): with ``rules`` (the
    reference's by default) they say how each rank holds the parameters.
    The options are the reference package's, so equal options give an
    equal plan id."""
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
    return PlannedFunction.from_staged(staged, syscat, device=dev, mesh=mesh,
                                       rules=rules, param_specs=param_specs)
