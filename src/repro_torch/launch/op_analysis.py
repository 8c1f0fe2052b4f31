"""What one traced step costs a rank: dot FLOPs, HBM bytes, memory and the
collective schedule, read off the aten ops it runs.

The port's counterpart of the reference package's
``launch/hlo_analysis.py``, which parses the post-SPMD HLO text of a
compiled step.  The port has no compiler and no HLO: :class:`OpAnalysis`
is a ``TorchDispatchMode`` that sees every aten op of the step as it runs
(on the meta device in a dry run, so nothing is computed or allocated) and
sums the same terms:

  * ``flops``: dots only, ``2 * numel(out) * K`` over ``mm`` / ``addmm`` /
    ``bmm`` / ``baddbmm`` (the reference's rule; elementwise and
    transcendental work is left out).  The reference multiplies a ``while``
    body by its trip count; here every layer's ops run, so nothing needs
    multiplying;
  * ``hbm_bytes``: 2 x the bytes each op materializes (a write and a later
    read).  Views and aliases (an output on an input's storage) cost
    nothing; an in-place op costs the bytes it writes (an indexed write
    its values', the reference's ``dynamic-update-slice`` rule);
  * ``memory``: ``argument_bytes`` (the storages resident before the step:
    the state or the params, the inputs and the cache), ``output_bytes``
    (the storages of what the step returns) and ``temp_bytes`` (the peak of
    live storage above the arguments, storages tracked with
    ``StorageWeakRef``; a meta tensor's storage has its ``nbytes`` though
    nothing is allocated).  XLA's buffer assignment reuses and fuses where
    the eager ops here allocate, so ``temp_bytes`` is an eager step's peak,
    not the reference's;
  * ``collectives``: by kind and by axis, from a rank mesh's counters
    (``RankMesh.stats``), each kind's ``bytes`` the results' (an
    all-gather's is the axis size times its input, as the HLO's result
    shapes), and ``wire_bytes`` with the reference's factors (all-reduce
    x2).  The port's reduce-scatter is an all-reduce and then a slice
    (``core/collectives.py``), so it counts as one all-reduce.
"""
from __future__ import annotations

from collections import Counter

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

aten = torch.ops.aten
_has_kernel = torch._C._dispatch_has_kernel_for_dispatch_key
# (the op, the index of its left operand)
_DOTS = {aten.mm.default: 0, aten.addmm.default: 1, aten.bmm.default: 0,
         aten.baddbmm.default: 1}
# in-place writes through an index: their bytes are the values' (the
# argument at this index, or the output where it is None)
_INDEXED = {aten.index_put_.default: 2, aten.index_put.default: 2,
            aten._index_put_impl_.default: 2, aten.scatter_.src: 3,
            aten.scatter_add_.default: 3, aten.index_copy_.default: 3,
            aten.slice_scatter.default: 1, aten.select_scatter.default: 1}
ALG_FACTOR = {"all_reduce": 2.0, "all_gather": 1.0, "all_to_all": 1.0}
# backward formulas that fill a fresh zeros tensor in place (gather's,
# index's, sort's and top-k's: ``zeros.scatter_add_(...)``) take their
# out-of-place branch when a dispatch mode is active (PyTorch's "composite
# compliance"), which allocates the result beside the zeros.  Such an op
# right after the factory that made its ``self`` is counted as the
# in-place write it is without the mode (the values' bytes, no new
# storage), so the peak is the unobserved step's.
_ZEROS = {aten.new_zeros.default, aten.zeros.default, aten.zeros_like.default}
_FILLS = {aten.scatter_add.default: 3, aten.scatter.src: 3,
          aten.index_put.default: 2, aten.index_add.default: 3}


# shape queries a dispatch mode must leave alone (FlopCounterMode's list)
_QUERIES = {aten.sym_is_contiguous.default, aten.is_contiguous.default,
            aten.is_contiguous.memory_format,
            aten.is_strides_like_format.default,
            aten.is_non_overlapping_and_dense.default, aten.size.default,
            aten.sym_size.default, aten.stride.default,
            aten.sym_stride.default, aten.storage_offset.default,
            aten.sym_storage_offset.default, aten.numel.default,
            aten.sym_numel.default, aten.dim.default,
            torch.ops.prim.layout.default, torch.ops.prim.device.default}


def _tensors(tree) -> list:
    """Every tensor under ``tree`` (dicts, sequences, and records with
    ``step`` / ``params`` / ``opt_state`` such as a ``TrainState``)."""
    if hasattr(tree, "params") and hasattr(tree, "opt_state"):
        tree = (tree.step, tree.params, tree.opt_state)
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _flat(seq):
    """The tensors among ``seq`` and its lists (an op's arguments)."""
    for a in seq:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            yield from (b for b in a if isinstance(b, torch.Tensor))


def storage_bytes(tree) -> int:
    """The bytes of the distinct storages under ``tree`` (a view shares its
    base's)."""
    seen = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def dot_flops(func, args, out) -> int:
    """``2 * numel(out) * K`` of a dot op (0 for any other)."""
    i = _DOTS.get(func)
    if i is None:
        return 0
    return 2 * out.numel() * int(args[i].shape[-1])


class OpAnalysis(TorchDispatchMode):
    """Records the aten ops run under it.  ``arguments``: the trees resident
    before the step (their storages are the arguments, never temporaries).
    After the step, :meth:`result` gives the record.  Storages are keyed by
    their address and held by a ``StorageWeakRef``, which keeps a freed
    storage's address from being reused while it is counted."""

    def __init__(self, arguments=()):
        super().__init__()
        self.flops = 0
        self.written = 0
        self.ops = Counter()
        self._info = {}
        self._args = {}
        for t in _tensors(arguments):
            st = t.untyped_storage()
            self._args[st._cdata] = (StorageWeakRef(st), st.nbytes())
        self._live = {}                # address -> (weak ref, nbytes)
        self._zeros = None             # address made by the last op, zeros
        self._now = 0
        self.peak = 0

    def _purge(self):
        dead = [k for k, (ref, _) in self._live.items() if ref.expired()]
        for k in dead:
            self._now -= self._live.pop(k)[1]

    def _op_info(self, func) -> tuple:
        """``(shape query, composite, mutable, values index)`` of ``func``,
        looked up once."""
        info = self._info.get(func)
        if info is None:
            info = self._info[func] = (
                func in _QUERIES,
                func not in _DOTS and _has_kernel(
                    func.name(), "CompositeImplicitAutograd"),
                func._schema.is_mutable, _INDEXED.get(func))
        return info

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        query, composite, mutable, src = self._op_info(func)
        if query:
            return NotImplemented
        if composite:
            # a composite op (``matmul``, ``einsum`` under inference mode)
            # runs as the ops it decomposes into, each seen here
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        self.ops[func] += 1
        outs = [out] if isinstance(out, torch.Tensor) else list(_flat(
            out if isinstance(out, (list, tuple)) else ()))
        if not outs:
            return out
        if func in _DOTS:
            self.flops += dot_flops(func, args, outs[0])
        zeros, self._zeros = self._zeros, None
        if func in _FILLS and zeros in self._live and isinstance(
                args[0], torch.Tensor) and \
                args[0].untyped_storage()._cdata == zeros:
            st = outs[0].untyped_storage()
            self._live[st._cdata] = (StorageWeakRef(st),
                                     self._live.pop(zeros)[1])
            w = args[_FILLS[func]]
            self.written += w.numel() * w.element_size()
            return out
        ins = {t.untyped_storage()._cdata
               for t in _flat((*args, *kwargs.values()))}
        for t in outs:
            st = t.untyped_storage()
            k = st._cdata
            if k in ins:                            # a view, or in place
                if mutable:
                    w = args[src] if src is not None and src < len(args) \
                        and isinstance(args[src], torch.Tensor) else t
                    self.written += w.numel() * w.element_size()
                continue
            if k in self._live or k in self._args:
                continue
            nbytes = st.nbytes()
            self.written += t.numel() * t.element_size()
            self._live[k] = (StorageWeakRef(st), nbytes)
            self._now += nbytes
            if func in _ZEROS:
                self._zeros = k
        if self._now > self.peak:
            # freed storages are dropped only here: the live sum can pass
            # the peak only while some are still counted
            self._purge()
            self.peak = max(self.peak, self._now)
        return out

    def result(self, outputs=None, mesh=None) -> dict:
        """The record: ``flops``, ``hbm_bytes``, ``memory``, ``collectives``
        and ``wire_bytes`` (the last two from ``mesh``'s counters, zero
        without a mesh)."""
        coll, wire = collectives(mesh)
        return {"flops": float(self.flops),
                "hbm_bytes": float(2 * self.written),
                "memory": {"argument_bytes": sum(
                    n for _, n in self._args.values()),
                           "output_bytes": (storage_bytes(outputs)
                                            if outputs is not None else 0),
                           "temp_bytes": self.peak},
                "collectives": coll, "wire_bytes": wire,
                "ops": sum(self.ops.values())}


def collectives(mesh) -> tuple:
    """``({kind: {"count", "bytes", "by_axis": {axis: {"count",
    "bytes"}}}}, wire bytes)`` from a rank mesh's counters: a kind's
    ``bytes`` are its results' (an all-gather's input times the axis
    size), the wire bytes those times the kind's algorithm factor."""
    out = {k: {"count": 0, "bytes": 0.0, "by_axis": {}} for k in ALG_FACTOR}
    if mesh is None:
        return out, 0.0
    stats = mesh.stats
    for name in mesh.axis_names:
        size = int(mesh.shape[name])
        for kind in ALG_FACTOR:
            n = int(stats.get(f"{name}.{kind}_calls", 0))
            if not n:
                continue
            b = float(stats.get(f"{name}.{kind}_bytes", 0))
            if kind == "all_gather":
                b *= size
            out[kind]["count"] += n
            out[kind]["bytes"] += b
            out[kind]["by_axis"][name] = {"count": n, "bytes": b}
    wire = sum(v["bytes"] * ALG_FACTOR[k] for k, v in out.items())
    return out, wire
