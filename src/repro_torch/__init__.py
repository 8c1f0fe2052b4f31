"""AWESOME tri-store analysis in PyTorch, for one NVIDIA H100.

The port of the JAX package ``src/repro`` (which stays the reference).  An
ADIL program is planned by the staged pipeline — the planner modules are
the reference's, copied, so plan ids agree — and its concrete plan runs
across the three stores as PyTorch operations on one device.

Engine names are the reference's.  ``"xla"`` is the plain PyTorch path;
``"pallas"`` is the kernel slot, which in the port means **the kernel
written by hand for Hopper** (CUDA C++ for ``sm_90a`` under
``kernels/csrc``).  A kernel's plain PyTorch version runs only on CPU
tensors; on a CUDA tensor the kernel launches or raises.

The same planner serves a language model: ``repro_torch.serving``'s
``AsyncServingRuntime`` plans one ``prefill_kv`` forward per prompt bucket
(``repro_torch.models``), seeds a paged KV pool from it and decodes with
continuous batching (``python -m repro_torch.launch.serve``).

Entry points run on the card unless the caller passes ``device="cpu"``:
:func:`compile`, ``PlannedFunction.__call__``, every store's
``payload(device=...)``, the serving runtime and ``serve_sequential``.
Without a card they raise.

    from repro_torch import compile
    from repro_torch.core.adil_parser import parse_adil
    fn = compile(parse_adil(script, standard_catalog()))
    score = fn({}, {"tweets": table.payload(), ...})
"""
from __future__ import annotations

from dataclasses import replace

from .core.executor import PlannedFunction, default_syscat, resolve_device
from .core.ir import SystemCatalog  # noqa: F401  (repro_torch.SystemCatalog)
from . import stores
from .stores import store_engines

__all__ = ["compile", "PlannedFunction", "resolve_device", "stores"]


def compile(analysis, syscat=None, *, engines=None, device="cuda",
            mesh=None, **kw) -> PlannedFunction:
    """Plan ``analysis`` (a port ``Analysis``) and bind it to ``device``
    and, on a ``mesh`` (``repro_torch.launch.mesh.DataMesh``), to the
    calling rank.

    ``syscat`` defaults to the data sheet of the card in use (of the H100
    SXM when planning for the CPU), with the mesh's shape on a mesh;
    ``engines`` defaults to the tri-store engines with the kernel slot.
    Raises without a card unless ``device="cpu"``."""
    dev = resolve_device(device)
    if syscat is None:
        syscat = default_syscat(dev)
        if mesh is not None:
            syscat = replace(syscat, mesh_axes=("data", "model"),
                             mesh_shape=(int(mesh.world), 1))
    if engines is None:
        engines = store_engines(pallas=True)
    return analysis.compile(syscat, engines=engines, device=dev, mesh=mesh,
                            **kw)
