"""Pluggable engine registry (the tri-store's named engines, §2).

AWESOME routes each part of a workload to one of several registered engines
(SQL / Cypher / NLP in the paper).  The tensor-world analogue has two
execution engines today:

  * ``xla``    — the interpreter path: every physical op lowered through
    plain JAX/XLA primitives;
  * ``pallas`` — fused hand-written kernels (flash attention, grouped-matmul
    MoE, WKV6, SSD), the paper's "external library" engines.

Each engine owns its *implementation table* (impl name -> python callable).
The planner names engines, not booleans: candidate generation and
cost-model selection receive an ``engines`` tuple and only consider
candidates whose ``requires_backend`` is among them, and the executor
dispatches each physical node through the engine that registered its impl.
Registering a third engine (e.g. a future ``cuda`` path) is a
``register_engine`` call plus ``@<engine>.impl(...)`` registrations — no
planner change.

``resolve_engines`` also accepts the legacy ``allow_pallas`` boolean so old
call sites keep working while they migrate.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional, Sequence

from .ir import ValidationError


@dataclass
class Engine:
    """One named execution engine: an impl table plus availability."""

    name: str
    description: str = ""
    impls: dict = field(default_factory=dict)   # impl name -> callable
    # optional gate: engines that need hardware/runtime support can report
    # unavailability and the planner will not offer their candidates
    is_available: Optional[Callable[[], bool]] = None

    def impl(self, *names):
        """Decorator: register an op implementation under this engine."""
        def deco(fn):
            for n in names:
                self.impls[n] = fn
            return fn
        return deco

    def available(self) -> bool:
        return True if self.is_available is None else bool(self.is_available())

    def __contains__(self, impl_name: str) -> bool:
        return impl_name in self.impls


_REGISTRY: dict = {}


def register_engine(name: str, description: str = "",
                    is_available=None) -> Engine:
    """Register (or fetch, idempotently) an engine by name."""
    if name in _REGISTRY:
        return _REGISTRY[name]
    eng = Engine(name, description, {}, is_available)
    _REGISTRY[name] = eng
    return eng


def get_engine(name: str) -> Engine:
    if name not in _REGISTRY:
        raise ValidationError(
            f"unknown engine {name!r} (registered: {engine_names()})")
    return _REGISTRY[name]


def engine_names() -> tuple:
    return tuple(sorted(_REGISTRY))


def resolve_engines(engines=None, *, allow_pallas=None) -> tuple:
    """Normalize an engine selection to a validated tuple of engine names.

    ``engines`` wins when given (string or iterable of strings); otherwise
    the legacy ``allow_pallas`` boolean maps to ("xla",) / ("xla", "pallas");
    otherwise the default is the always-available interpreter engine.
    """
    if engines is not None:
        if isinstance(engines, str):
            engines = (engines,)
        out = tuple(engines)
        if not out:
            raise ValidationError("engine selection must name >= 1 engine")
        for e in out:
            get_engine(e)  # raises on unknown names
        return out
    if allow_pallas:
        return ("xla", "pallas")
    return ("xla",)


def dispatch(impl_name: str, backend: Optional[str] = None):
    """Find the callable implementing ``impl_name``.

    ``backend`` (the physical opdef's engine tag) short-circuits the search;
    without it every registered engine's table is scanned.  Returns None when
    no engine implements the op.
    """
    if backend is not None and backend in _REGISTRY:
        fn = _REGISTRY[backend].impls.get(impl_name)
        if fn is not None:
            return fn
    for eng in _REGISTRY.values():
        fn = eng.impls.get(impl_name)
        if fn is not None:
            return fn
    return None


# The two engines of this reproduction.  The executor module populates their
# impl tables at import time (see ``executor.impl``).
#
# The port keeps both names, since candidate gates and plan ids name them:
# ``xla`` is its plain PyTorch path, and ``pallas`` is the slot of the
# kernels written by hand for Hopper (``repro_torch.kernels``).
XLA_ENGINE = register_engine(
    "xla", "interpreter path: physical ops as plain PyTorch operations")
PALLAS_ENGINE = register_engine(
    "pallas", "hand-written CUDA kernels for Hopper (the kernel slot the "
              "reference package fills with Pallas)")
