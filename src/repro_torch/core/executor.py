"""Physical-plan executor of the port: walks the chosen physical DAG and runs
it as PyTorch operations on one device.

The counterpart of the reference package's ``core/executor.py``, store
subset only: the execution context, the impl table over the port's own
engine registry (the generic impls live here; the store impls register from
``repro_torch.stores.runtime``), the fast ``run_plan`` path, and
:class:`PlannedFunction`, the staged plan bound to a device.  Planning is
the copied staged pipeline, so a plan id here equals the reference
package's for the same analysis and catalogs.

Every entry point runs on the card unless the caller passes
``device="cpu"``; without a card they raise (:func:`resolve_device`) rather
than carry on on the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import torch

from .buffering import BufferingDecision
from .cost_model import CostModel
from .engines import dispatch, get_engine, resolve_engines
from .ir import FunctionCatalog, Plan, SystemCatalog
from .physical import PHYS_OPS, PhysPlan


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
    aux: dict = field(default_factory=dict)   # count_sink, ...


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
    here reads a device value back to the host."""
    env = dict(values)
    for n in pplan.topo():
        env[n.id] = _impl_fn(n)(ctx, [env[i] for i in n.inputs], n)
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

    @classmethod
    def from_staged(cls, staged, syscat: SystemCatalog, *,
                    device="cuda") -> "PlannedFunction":
        return cls(staged.logical, staged.pplan, staged.concrete,
                   staged.choices, staged.report, staged.buffering,
                   syscat, resolve_device(device), staged.plan_id, staged)

    def explain(self) -> str:
        """The plan-time EXPLAIN report."""
        return "" if self.staged is None else self.staged.explain()

    def chosen_impls(self) -> list:
        """The concrete plan's impl names, in topo order."""
        return [n.impl for n in self.concrete.topo()]

    def __call__(self, params, inputs: dict, aux: Optional[dict] = None):
        dev = resolve_device(self.device)
        for name, value in inputs.items():
            for t in _tensors(value):
                if t.device.type != dev.type:
                    raise ValueError(
                        f"input {name!r} holds a tensor on {t.device}, but "
                        f"this plan runs on {dev}: build it with "
                        f"payload(device={str(dev)!r})")
        ctx = ExecContext(root=params, scope=params, device=dev,
                          aux=aux or {})
        outs = run_plan(self.concrete, ctx, inputs)
        return outs if len(outs) > 1 else outs[0]


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
