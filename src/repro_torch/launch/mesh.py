"""Meshes of ranks: the sharded tri-store's data mesh, and the model's
(data, model) mesh.

The port's counterpart of the reference package's ``launch/mesh.py``.

**The store side.**  The reference's mesh is a ``jax.sharding.Mesh`` with
a ``data`` axis, and its sharded operators are ``shard_map`` programs over
it; here a mesh is a process group (:class:`DataMesh`), one process a
shard, and the operators of :mod:`repro_torch.stores.sharded` call its
collectives.

Values stay logically global, as in the reference: every rank holds the
whole payload of every store (:func:`shard_store_inputs` only moves it to
the rank's device), a sharded operator slices the rank's block, computes
on it and merges through a collective, and every rank returns the global
value the dense operator would.

The transport is gloo.  A CPU tensor goes through it as it is; a CUDA
tensor is staged card -> pinned host -> gloo -> card, and the mesh counts
the staged bytes and each collective's bytes in :attr:`DataMesh.stats`.
The ranks :func:`run_ranks` starts share one host and talk over its
loopback device; they may share one card, which NCCL would refuse.

**The model side.**  :class:`MeshLayout` is a mesh's axis names and
shape with no process behind it: :func:`make_production_mesh` (the
reference's (16, 16) and (2, 16, 16)) and :func:`make_cpu_mesh` give one,
so shard shapes at 512 ranks are reckoned without starting any.
:class:`RankMesh` is a live (data, model) mesh over a world's ranks
(:func:`make_rank_mesh`), with a ``pod`` axis before them for more than
one pod: this rank's coordinates and one sub-group per axis, each a
:class:`DataMesh` over the ranks that differ along that axis only, with
its collectives (host-staged, counted; the layers' autograd forms are
``core/collectives.py``).  :func:`placeholder_rank_mesh` is a rank with
no world behind it (the dry run, ``launch/dryrun.py``): its axes are
:class:`PlaceholderAxis` records whose collectives return tensors of the
right shapes, move nothing and count as a live rank's do.  The reference's
helpers follow it: :func:`syscat_for_mesh`, :func:`data_spec`,
:func:`data_axis_size`, :func:`input_shardings` and
:func:`state_shardings` (``core.executor.Sharding`` records: spec, shard
shape, and on a live mesh the rank's block); :func:`shard_params` /
:func:`shard_state` slice a global tree to this rank's blocks and
:func:`gather_state` gathers it back.  A dim that does not divide over
its axes raises ``ValueError``: GSPMD's padded uneven shards have no
counterpart here.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue as queue_mod
import time
import traceback
import warnings
from collections import Counter
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..core.executor import (Sharding, ShardingRules, params_sharding,
                             resolve_device)
from ..core.ir import SystemCatalog
from ..stores.bounded import BoundedRel

COLLECTIVE_TIMEOUT_S = 60


@dataclass
class DataMesh:
    """A 1-D mesh over the ``data`` axis: the process group, this process's
    rank in it, the world size and the rank's device.  ``stats`` counts
    what the collectives moved: ``<kind>_calls`` and ``<kind>_bytes`` (the
    bytes this rank handed in) for ``all_reduce`` / ``all_gather`` /
    ``all_to_all``, and ``staged_bytes`` (card -> host plus host -> card
    copies)."""

    group: Any
    rank: int
    world: int
    device: torch.device
    stats: Counter = field(default_factory=Counter)

    axis_names = ("data", "model")

    @property
    def shape(self) -> dict:
        return {"data": self.world, "model": 1}

    # -- collectives (each returns a new tensor on the input's device) ------
    def _note(self, kind: str, t: torch.Tensor):
        self.stats[f"{kind}_calls"] += 1
        self.stats[f"{kind}_bytes"] += t.numel() * t.element_size()

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        """A contiguous copy of ``t`` that gloo may write into: a pinned
        host copy (counted) for a CUDA tensor."""
        if t.device.type == "cpu":
            return t.clone(memory_format=torch.contiguous_format)
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        self.stats["staged_bytes"] += h.numel() * h.element_size()
        return h

    def _empty(self, shape, like: torch.Tensor) -> torch.Tensor:
        return torch.empty(shape, dtype=like.dtype,
                           pin_memory=like.device.type == "cuda")

    def _back(self, h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        if like.device.type == "cpu":
            return h
        self.stats["staged_bytes"] += h.numel() * h.element_size()
        return h.to(like.device)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``psum`` (``op="sum"``) or ``pmax`` (``op="max"``) of ``t``."""
        self._note("all_reduce", t)
        h = self._host(t)
        dist.all_reduce(h, op={"sum": dist.ReduceOp.SUM,
                               "max": dist.ReduceOp.MAX}[op],
                        group=self.group)
        return self._back(h, t)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` concatenated along dim 0 in rank order (the
        reference's ``all_gather(tiled=True)``)."""
        self._note("all_gather", t)
        h = self._host(t)
        out = self._empty((self.world * h.shape[0],) + tuple(h.shape[1:]), t)
        with warnings.catch_warnings():
            # newer releases rename it; every release since 2.0 has it
            warnings.simplefilter("ignore", FutureWarning)
            dist.all_gather_into_tensor(out, h, group=self.group)
        return self._back(out, t)

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """Block ``j`` of ``t`` (dim 0 cut into ``world`` equal blocks) goes
        to rank ``j``; block ``i`` of the result came from rank ``i`` (the
        reference's ``all_to_all(split_axis=0, concat_axis=0)``)."""
        self._note("all_to_all", t)
        h = self._host(t)
        out = self._empty(h.shape, t)
        dist.all_to_all_single(out, h, group=self.group)
        return self._back(out, t)

    def barrier(self):
        dist.barrier(group=self.group)

    def close(self):
        """Leave the group: a barrier, so no rank leaves while another still
        reads from it, then the group's teardown."""
        self.barrier()
        dist.destroy_process_group()


def make_mesh(rank: int, world: int, *, device="cuda", init_file,
              timeout: float = COLLECTIVE_TIMEOUT_S) -> DataMesh:
    """Join the ``world``-rank gloo group as ``rank`` (the counterpart of
    the reference's ``make_cpu_mesh``).  The group meets through the file
    ``init_file`` (no TCP port to agree on); a collective that waits longer
    than ``timeout`` seconds raises."""
    dev = resolve_device(device)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=int(rank), world_size=int(world),
                            timeout=timedelta(seconds=timeout))
    return DataMesh(dist.group.WORLD, int(rank), int(world), dev)


def syscat_for_mesh(mesh) -> SystemCatalog:
    """The system catalog of ``mesh``: its axes and their sizes, as the
    reference's (a store's :class:`DataMesh` of ``world`` ranks is
    ``("data", "model")`` of shape ``(world, 1)``)."""
    if mesh is None or not hasattr(mesh, "axis_names"):
        return SystemCatalog(mesh_axes=("data", "model"),
                             mesh_shape=(data_axis_size(mesh), 1))
    return SystemCatalog(mesh_axes=tuple(mesh.axis_names),
                         mesh_shape=tuple(int(mesh.shape[a])
                                          for a in mesh.axis_names))


def data_axis_size(mesh) -> int:
    """Ranks along the ``data`` axis (1 for no mesh / no data axis)."""
    if mesh is None:
        return 1
    if not hasattr(mesh, "axis_names"):
        return int(mesh.world)
    return int(mesh.shape.get("data", 1))


def _to(value, dev):
    if isinstance(value, torch.Tensor):
        return value.to(dev)
    if isinstance(value, BoundedRel):
        return BoundedRel({k: _to(v, dev) for k, v in value.cols.items()},
                          _to(value.valid, dev), _to(value._count, dev),
                          _to(value.overflow, dev))
    if isinstance(value, dict):
        return {k: _to(v, dev) for k, v in value.items()}
    return value


def shard_store_inputs(mesh, values: dict) -> dict:
    """The plan inputs ``values`` on the rank's device.  Every rank holds
    the *global* value of every payload (the sharded operators slice their
    block themselves), so the same inputs also run unsharded."""
    if mesh is None:
        return values
    return {k: _to(v, mesh.device) for k, v in values.items()}


def _tensors_in(value, dev):
    if isinstance(value, np.ndarray):
        return torch.from_numpy(value).to(dev)
    if isinstance(value, dict):
        return {k: _tensors_in(v, dev) for k, v in value.items()}
    return value


def _numpy_out(value):
    if isinstance(value, torch.Tensor):
        return value.cpu().numpy()
    if isinstance(value, (tuple, list)):
        return type(value)(_numpy_out(v) for v in value)
    return value


def run_calls(mesh, calls) -> list:
    """``fn(*args, mesh=mesh, **kwargs)`` for each ``(fn, args, kwargs)`` of
    ``calls`` in order (a rank entry for :func:`run_ranks`): numpy arrays
    in ``args`` and ``kwargs`` (also inside dicts) become tensors on the
    rank's device, tensor results come back as numpy arrays."""
    dev = mesh.device
    return [_numpy_out(fn(*[_tensors_in(a, dev) for a in args], mesh=mesh,
                          **{k: _tensors_in(v, dev)
                             for k, v in kwargs.items()}))
            for fn, args, kwargs in calls]


# --------------------------------------------------------------------------
# the model side: layouts, the live (data, model) mesh, shardings
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class MeshLayout:
    """A mesh's axis names and sizes, with no process behind it (the
    reference's ``jax.make_mesh`` of placeholder devices)."""

    sizes: tuple
    axis_names: tuple = ("data", "model")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.sizes))


def make_production_mesh(*, multi_pod: bool = False) -> MeshLayout:
    """Single-pod (data=16, model=16) = 256 ranks; multi-pod (pod=2,
    data=16, model=16) = 512."""
    if multi_pod:
        return MeshLayout((2, 16, 16), ("pod", "data", "model"))
    return MeshLayout((16, 16), ("data", "model"))


def make_cpu_mesh(n_data: int = 1, n_model: int = 1) -> MeshLayout:
    """The (data, model) layout of ``n_data x n_model`` ranks."""
    return MeshLayout((int(n_data), int(n_model)), ("data", "model"))


class RankMesh:
    """A live mesh over the first ``pod x data x model`` ranks of a world:
    rank ``(p * data + d) * model + m`` sits at coordinates ``(p, d, m)``
    (no ``pod`` axis when there is one pod).  ``axis(name)`` is this rank's
    sub-group along ``name`` (a :class:`DataMesh` whose ``rank`` is the
    coordinate and ``world`` the axis size; an axis of one rank has no
    group and is never called).  The batch is cut over ``(pod, data)``,
    FSDP over ``data`` alone, and every gradient is also summed over
    ``pod``.  ``stats`` counts every collective by axis
    (``data.all_gather_bytes``, ``model.all_reduce_calls``, ...) and the
    staged host bytes."""

    def __init__(self, world, layout: MeshLayout, coords: dict, axes: dict):
        self.world = world
        self.layout = layout
        self.coords = coords
        self._axes = axes

    axis_names = property(lambda self: self.layout.axis_names)
    shape = property(lambda self: self.layout.shape)
    device = property(lambda self: self.world.device)
    rank = property(lambda self: self.world.rank)

    def axis(self, name: str) -> DataMesh:
        return self._axes[name]

    @property
    def stats(self) -> Counter:
        out: Counter = Counter()
        for name, ax in self._axes.items():
            for k, v in ax.stats.items():
                if k == "staged_bytes":
                    out[k] += v
                else:
                    out[f"{name}.{k}"] += v
        return out

    def reset_stats(self):
        for ax in self._axes.values():
            ax.stats.clear()

    def barrier(self):
        self.world.barrier()


def make_rank_mesh(world: DataMesh, n_data: int, n_model: int,
                   n_pod: int = 1):
    """The ``n_pod x n_data x n_model`` :class:`RankMesh` over the first
    ranks of ``world`` (the :class:`DataMesh` of every rank); with one pod
    the layout is ``(data, model)``.  Every rank of the world calls it (it
    makes the sub-groups, in one order on every rank); a rank past the
    mesh gets None."""
    sizes = {"pod": int(n_pod), "data": int(n_data), "model": int(n_model)}
    names = ("pod", "data", "model") if sizes["pod"] > 1 \
        else ("data", "model")
    total = int(np.prod([sizes[a] for a in names]))
    if total > world.world:
        raise ValueError(f"a {' x '.join(str(sizes[a]) for a in names)} "
                         f"mesh needs {total} ranks; the world has "
                         f"{world.world}")
    me = world.rank
    strides = {"model": 1, "data": sizes["model"],
               "pod": sizes["model"] * sizes["data"]}
    groups = {}
    for a in names:
        others = [b for b in names if b != a]
        for base in sorted({sum(((r // strides[b]) % sizes[b]) * strides[b]
                                for b in others) for r in range(total)}):
            ranks = [base + i * strides[a] for i in range(sizes[a])]
            g = dist.new_group(ranks) if sizes[a] > 1 else None
            if me in ranks:
                groups[a] = g
    if me >= total:
        return None
    coords = {a: (me // strides[a]) % sizes[a] for a in names}
    axes = {a: DataMesh(groups[a], coords[a], sizes[a], world.device)
            for a in names}
    layout = MeshLayout(tuple(sizes[a] for a in names), names)
    return RankMesh(world, layout, coords, axes)


@dataclass
class PlaceholderAxis:
    """An axis of a rank that runs without a world (the dry run): the
    coordinate ``rank`` and the axis size ``world``, no process group.  Its
    collectives take and return meta tensors (a new one of the right shape
    and dtype) and move no data; each is counted under the keys
    :class:`DataMesh` uses (nothing is staged)."""

    rank: int
    world: int
    device: torch.device
    stats: Counter = field(default_factory=Counter)

    group = None
    _note = DataMesh._note

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        self._note("all_reduce", t)
        return torch.empty_like(t, memory_format=torch.contiguous_format)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        self._note("all_gather", t)
        return t.new_empty((self.world * t.shape[0],) + tuple(t.shape[1:]))

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        self._note("all_to_all", t)
        return torch.empty_like(t, memory_format=torch.contiguous_format)

    def barrier(self):
        pass


def placeholder_rank_mesh(layout: MeshLayout, coords=None) -> RankMesh:
    """A :class:`RankMesh` of ``layout`` for one rank that runs without a
    world (coordinates ``coords``, 0 on every axis by default) on the meta
    device: every axis a :class:`PlaceholderAxis`.  A step traced on it
    calls and counts the collectives a live rank at those coordinates
    would."""
    coords = {a: int((coords or {}).get(a, 0)) for a in layout.axis_names}
    dev = torch.device("meta")
    sizes = layout.shape
    linear = 0
    for a in layout.axis_names:
        linear = linear * int(sizes[a]) + coords[a]
    axes = {a: PlaceholderAxis(coords[a], int(sizes[a]), dev)
            for a in layout.axis_names}
    return RankMesh(PlaceholderAxis(linear, layout.size, dev), layout,
                    coords, axes)


def data_spec(mesh) -> tuple:
    """The spec of a batch-leading 1-D value: its rows over (pod, data)."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return (axes if len(axes) > 1 else (axes[0] if axes else None),)


def input_shardings(mesh, input_specs: dict) -> dict:
    """Batch-leading inputs shard over (pod, data).  ``input_specs``: name
    -> anything with a ``shape`` (a tensor, a meta tensor)."""
    out = {}
    for name, sds in input_specs.items():
        spec = [None] * len(sds.shape)
        if len(sds.shape) >= 1:
            spec[0] = data_spec(mesh)[0]
        out[name] = Sharding(mesh, tuple(spec), name)
    return out


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def state_shardings(mesh, model, optimizer, rules=None):
    """Shardings of the whole train state (params + optimizer slots), a
    ``TrainState`` of :class:`~repro_torch.core.executor.Sharding`.

    m / v (and a master copy) mirror the params'; Adafactor's factored
    slots drop the last (vr) / second-to-last (vc) dim of the padded param
    spec; scalars replicate.  The optimizer's state structure comes from
    its ``init`` on the model's meta-tensor params: nothing allocated."""
    from ..train.train_step import TrainState
    rules = rules or ShardingRules()
    p_shard = params_sharding(model.param_specs(), mesh, rules)
    abstract = model.abstract_params()
    replicated = Sharding(mesh, (), "count")

    def padded_spec(p_sh, rank):
        s = tuple(p_sh.spec)
        return s + (None,) * (rank - len(s))

    opt_abstract = optimizer.init(abstract)
    if set(opt_abstract) >= {"m", "v", "count"}:
        opt_shard = {"m": p_shard, "v": p_shard, "count": replicated}
        if "master" in opt_abstract:
            opt_shard["master"] = p_shard
    elif set(opt_abstract) == {"slots", "count"}:
        with_master = bool(getattr(optimizer, "master", False))

        def slot(p_sh, p_abs):
            rank = len(p_abs.shape)
            if rank >= 2:
                full = padded_spec(p_sh, rank)
                out = {"vr": Sharding(mesh, full[:-1], p_sh.name + ".vr",
                                      p_sh.dims[:-1]),
                       "vc": Sharding(mesh, full[:-2] + full[-1:],
                                      p_sh.name + ".vc",
                                      p_sh.dims[:-2] + p_sh.dims[-1:])}
            else:
                out = {"v": p_sh}
            if with_master:
                out["master"] = p_sh
            return out

        opt_shard = {"slots": _tree_map(slot, p_shard, abstract),
                     "count": replicated}
    else:
        raise ValueError("unknown optimizer state structure")
    return TrainState(step=Sharding(mesh, (), "step"), params=p_shard,
                      opt_state=opt_shard)


def _rebuild(tree, fn):
    """``tree`` (TrainState / dicts) with each leaf ``x`` and its Sharding
    ``s`` replaced by ``fn(x, s)``; ``tree`` is a pair (values, shardings)."""
    from ..train.train_step import TrainState
    values, sh = tree
    if isinstance(values, TrainState):
        return TrainState(*(_rebuild((getattr(values, f), getattr(sh, f)),
                                     fn)
                            for f in ("step", "params", "opt_state")))
    if isinstance(values, dict):
        return {k: _rebuild((v, sh[k]), fn) for k, v in values.items()}
    return fn(values, sh)


def shard_params(params, shardings):
    """A global tree (params, or a whole TrainState with
    :func:`state_shardings`) cut to this rank's blocks, each a tensor of
    its own (the global tree may then be freed)."""
    return _rebuild((params, shardings), lambda x, s: s.block(x))


shard_state = shard_params


def gather_leaf(x: torch.Tensor, sh: Sharding) -> torch.Tensor:
    """The global value of this rank's block ``x``: an all-gather over the
    axis of each cut dim."""
    mesh = sh.mesh
    for i in range(x.dim()):
        axes = sh.axes(i)
        if not axes:
            continue
        if len(axes) > 1:
            raise NotImplementedError(f"{sh.name}: dim {i} cut over {axes}")
        ax = mesh.axis(axes[0])
        if int(ax.world) > 1:
            x = ax.all_gather(x.movedim(i, 0).contiguous()).movedim(0, i)
    return x.contiguous()


def gather_state(state, shardings):
    """The global tree of this rank's blocks (every rank gets it)."""
    return _rebuild((state, shardings), gather_leaf)


# --------------------------------------------------------------------------
# spawning a world
# --------------------------------------------------------------------------


class RankError(RuntimeError):
    """A rank raised, died, or the world missed its deadline."""


def _rank_main(fn, rank, world, device, init_file, threads, args, results):
    """One rank: join the group, run ``fn(mesh, *args)``, report the value
    or the traceback on ``results``."""
    try:
        # the ranks share one host: gloo over its loopback device
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        torch.set_num_threads(threads)
        mesh = make_mesh(rank, world, device=device, init_file=init_file)
        value = fn(mesh, *args)
        mesh.close()
        results.put((rank, True, value))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world: int, *, device="cuda", init_file,
              timeout: float = 600.0, args: tuple = ()) -> list:
    """Run ``fn(mesh, *args)`` on ``world`` ranks and return their values
    in rank order.

    The ranks are processes started with ``spawn`` (CUDA needs it), so
    ``fn`` is a module-level function and ``args`` and the values are
    picklable; each rank takes the caller's intra-op thread count.  The
    group meets through ``init_file``, which must not exist yet.  The
    world is joined under one deadline of ``timeout`` seconds: a rank that
    raises or dies, or a deadline that passes, ends every rank and raises
    :class:`RankError` with the rank's traceback."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, str(device), str(init_file),
                               torch.get_num_threads(), tuple(args),
                               results))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + float(timeout)
    values: dict = {}
    try:
        while len(values) < world:
            try:
                rank, ok, value = results.get(timeout=0.5)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in values and p.exitcode is not None]
                if dead and results.empty():
                    raise RankError(
                        f"rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode} without a result")
                if time.monotonic() > deadline:
                    missing = sorted(set(range(world)) - set(values))
                    raise RankError(f"ranks {missing} did not finish within "
                                    f"{timeout} s")
                continue
            if not ok:
                raise RankError(f"rank {rank} of {world} raised:\n{value}")
            values[rank] = value
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5.0)
        results.close()
    return [values[r] for r in range(world)]
