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

Entry points run on the card unless the caller passes ``device="cpu"``:
:func:`compile`, ``PlannedFunction.__call__`` and every store's
``payload(device=...)``.  Without a card they raise.

    from repro_torch import compile
    from repro_torch.core.adil_parser import parse_adil
    fn = compile(parse_adil(script, standard_catalog()))
    score = fn({}, {"tweets": table.payload(), ...})
"""
from __future__ import annotations

from .core.executor import PlannedFunction, resolve_device
from .core.ir import SystemCatalog, hardware_for_device
from . import stores
from .stores import store_engines

__all__ = ["compile", "PlannedFunction", "resolve_device", "stores"]


def compile(analysis, syscat=None, *, engines=None, device="cuda",
            **kw) -> PlannedFunction:
    """Plan ``analysis`` (a port ``Analysis``) and bind it to ``device``.

    ``syscat`` defaults to the data sheet of the card in use (of the H100
    SXM when planning for the CPU); ``engines`` defaults to the tri-store
    engines with the kernel slot.  Raises without a card unless
    ``device="cpu"``."""
    dev = resolve_device(device)
    if syscat is None:
        syscat = (SystemCatalog(hardware=hardware_for_device())
                  if dev.type == "cuda" else SystemCatalog())
    if engines is None:
        engines = store_engines(pallas=True)
    return analysis.compile(syscat, engines=engines, device=dev, **kw)
