"""Elastic scaling: re-mesh a training job onto the ranks that remain.

The port of the reference's ``launch/elastic.py``.  When ranks are lost the
job restarts on the N' < N that remain; this module picks the largest
valid (data, model) mesh of them and the checkpoint is restored *resharded*
onto it (``train/checkpoint.py``'s ``restore_checkpoint(..., shardings=)``
keeps each rank's block of the whole leaves, whatever mesh saved them).

The policy: keep the model axis as large as memory requires (params must
fit), give the rest to data; the global batch and the data stream are
unchanged, so training continues in sample order.

    mesh = remesh(world, min_model=min_model_axis(param_bytes, 80e9))
    state = restore_checkpoint(latest, template,
                               shardings=state_shardings(mesh, model, opt))
"""
from __future__ import annotations

from .mesh import make_rank_mesh


def largest_mesh_shape(n_devices: int, *, min_model: int = 1,
                       prefer_model: int = 16) -> tuple:
    """(data, model) with data*model == largest usable count ≤ n_devices."""
    model = min(prefer_model, n_devices)
    while model >= min_model:
        data = n_devices // model
        if data >= 1 and data * model <= n_devices:
            return (data, model)
        model //= 2
    raise ValueError(f"cannot build a mesh from {n_devices} devices "
                     f"with min_model={min_model}")


def remesh(world, *, min_model: int = 1, prefer_model: int = 16):
    """The largest (data, model) :class:`~.mesh.RankMesh` over the ranks of
    ``world`` (a store's :class:`~.mesh.DataMesh` of every rank): the
    first ``data x model`` of them.  Every rank of the world calls it; a
    rank it leaves out gets None."""
    data, model = largest_mesh_shape(int(world.world), min_model=min_model,
                                     prefer_model=prefer_model)
    return make_rank_mesh(world, data, model)


def min_model_axis(param_bytes: float, hbm_bytes: float = 16e9,
                   overhead: float = 3.0) -> int:
    """Smallest power-of-two model axis so params (+optimizer overhead)
    fit per device (``hbm_bytes``: the reference's default is a 16 GB
    TPU chip; an H100 has 80e9)."""
    need = param_bytes * overhead / hbm_bytes
    m = 1
    while m < need:
        m *= 2
    return m
