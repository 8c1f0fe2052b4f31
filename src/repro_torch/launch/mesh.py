"""The data mesh of the sharded tri-store: one ``torch.distributed`` rank per
shard of the stores' partitioned axis.

The port's counterpart of the store side of the reference package's
``launch/mesh.py``.  The reference's mesh is a ``jax.sharding.Mesh`` with
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

from ..core.executor import resolve_device
from ..core.ir import SystemCatalog
from ..stores.bounded import BoundedRel
from ..stores.sharded import data_axis_size

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
    """The system catalog of ``mesh``: axes ``("data", "model")`` of shape
    ``(world, 1)``, as the reference's for a mesh of that shape."""
    return SystemCatalog(mesh_axes=("data", "model"),
                         mesh_shape=(data_axis_size(mesh), 1))


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
