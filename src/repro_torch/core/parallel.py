"""Partitioned data parallelism (paper §5.2, Fig. 8).

Every physical operator carries a data-parallel capability (``PR``/``ST``/
``EX``) and, for multi-input PR operators, a ``capOn`` attribute naming the
input it can partition on.  The pass walks the physical DAG and inserts

  * a **Partition** step when a PR operator's ``capOn`` input arrives
    unpartitioned,
  * a **Merge** step when a non-``capOn`` input arrives partitioned, and
  * a **Merge** step when an ST operator consumes a PR operator's output

— exactly the three insertion rules of §5.2.  In the TPU realization a
Partition step lowers to ``jax.lax.with_sharding_constraint`` pinning the
semantic ``capOn`` dimension to the ``data`` mesh axis (GSPMD then emits the
scatter), and a Merge lowers to a constraint that replicates the value over
``data`` (GSPMD emits the all-gather).  ``EX`` operators are opaque engines:
they inherit whatever layout their input has and are excluded from insertion
decisions, mirroring the paper's treatment of external-library operators.
"""
from __future__ import annotations

from dataclasses import dataclass

from .ir import TensorT
from .physical import PHYS_OPS, PR, ST, EX, PhysPlan, defop

# semantic dims that the 'data' mesh axis may partition (capOn universe)
DATA_PARTITIONABLE = ("batch",)


def _type_has_dim(t, dim: str) -> bool:
    """Whether a value of type ``t`` can be partitioned on ``dim``.  A
    TensorT with semantic dim names must actually carry the dim (a (nodes,)
    graph frontier has no batch axis to shard); unknown / un-annotated
    types keep the historical always-partitionable behaviour."""
    if isinstance(t, TensorT) and t.dims:
        return t.has_dim(dim)
    return True


def _cap(n):
    return PHYS_OPS[n.impl].dp_cap


def _cap_on(n):
    # node attrs may override the opdef default (paper: capOn is per-operator
    # but set per-instance when the operator is instantiated)
    return n.attrs.get("cap_on", PHYS_OPS[n.impl].cap_on)


def add_data_parallelism(pp: PhysPlan) -> PhysPlan:
    """AddDataParallelism (Alg. 1 line 2), applied to a candidate plan.

    Tracks a 'partitioned' bit per value, inserts partition/merge nodes, and
    records the decision in node attrs so the executor can emit sharding
    constraints.  Virtual nodes are treated as PR-on-batch (all their
    candidates are tensor ops over batched activations); their candidate
    chains inherit the surrounding partitioning when materialized.
    """
    out = PhysPlan(pp.name, {}, dict(pp.inputs), (), dict(pp.types),
                   dict(pp.pm), dict(pp.logical_of))
    remap = {i: i for i in pp.inputs}
    partitioned = {i: False for i in pp.inputs}  # plan inputs arrive whole

    def emit(impl, ins, attrs, id):
        nid = out.add(impl, ins, attrs, id=id)
        out.types[nid] = out.types.get(ins[0]) if ins else None
        return nid

    for n in pp.topo():
        sub = n.subplan
        if sub is not None:
            sub = add_data_parallelism(sub)
        cap = _cap(n) if not n.virtual else PR
        cap_on = _cap_on(n) if not n.virtual else "batch"
        cap_all = (PHYS_OPS[n.impl].cap_all if not n.virtual else True)
        new_inputs = []
        for idx, i in enumerate(n.inputs):
            src = remap[i]
            src_part = partitioned.get(i, False)
            is_cap_input = cap_all or (idx == n.attrs.get("cap_idx", 0))
            if cap == PR and is_cap_input and not src_part and \
                    cap_on in DATA_PARTITIONABLE and \
                    _type_has_dim(pp.types.get(i), cap_on):
                # rule 1: partition the capOn input
                src = emit("partition", [src],
                           {"dim": cap_on, "mesh_axis": "data"},
                           id=f"part_{n.id}_{idx}")
                src_part = True
            elif cap == PR and not is_cap_input and src_part:
                # rule 2: merge a partitioned non-capOn input
                src = emit("merge", [src], {"mesh_axis": "data"},
                           id=f"merge_{n.id}_{idx}")
                src_part = False
            elif cap == ST and src_part:
                # rule 3: ST consumer of partitioned producer
                src = emit("merge", [src], {"mesh_axis": "data"},
                           id=f"merge_{n.id}_{idx}")
                src_part = False
            new_inputs.append(src)

        nid = out.add(n.impl, new_inputs, dict(n.attrs), sub, id=n.id,
                      virtual=n.virtual)
        out.types[nid] = pp.types.get(n.id)
        remap[n.id] = nid
        # EX inherits its input's layout; PR produces partitioned output;
        # ST produces whole output.
        if cap == PR:
            partitioned[n.id] = True
        elif cap == EX:
            partitioned[n.id] = any(partitioned.get(i, False) for i in n.inputs)
        else:
            partitioned[n.id] = False

    out.outputs = tuple(remap[o] for o in pp.outputs)
    return out


def partition_stats(pp: PhysPlan) -> dict:
    """Counts used by tests/benchmarks (Fig. 8 structure check)."""
    ops = [n.impl for n in pp.topo()]
    return {
        "partition": ops.count("partition"),
        "merge": ops.count("merge"),
        # store ops the shard_stores rewrite marked for shard-local
        # execution over the mesh's data axis (orthogonal to the tensor
        # partition/merge machinery above, which is ST-capped for stores)
        "dist": sum(1 for n in pp.topo() if n.attrs.get("dist")),
        "total": len(ops),
    }
