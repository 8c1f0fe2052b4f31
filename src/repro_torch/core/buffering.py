"""Buffering mechanism (paper §5.3 + Appendix B).

Physical operators carry a buffering capability: ``SI`` (stream in, whole
out), ``SO`` (whole in, stream out), ``B`` (blocking), ``SS`` (stream both
ways).  The physical DAG is partitioned into **chains** by the three cut
rules of Appendix B (Fig. 18):

  1. cut edge (op1, op2) if op1 cannot stream output or op2 cannot stream
     input;
  2. cut edge (op1, op2) if the data is not op2's ``capOn`` input;
  3. cut all outgoing edges of an operator with >1 consumer.

Inside a chain, intermediates stream batch-by-batch and are never fully
materialized; data *between* chains is materialized.

TPU realization: a chain whose stream axis is ``batch`` executes as a
``lax.scan`` over microbatches — the gradient-accumulation loop.  The live
working set shrinks from (global-batch × activations) to (microbatch ×
activations), the direct analogue of the paper's −37 % heap result, at a
small step-overhead (their +8 %).  The chain partitioner below is also used
by the benchmark that reproduces Fig. 16.
"""
from __future__ import annotations

from dataclasses import dataclass

from .physical import PHYS_OPS, PhysPlan, SI, SO, B, SS


def _can_stream_out(n):
    return PHYS_OPS[n.impl].buf_cap in (SO, SS)


def _can_stream_in(n):
    return PHYS_OPS[n.impl].buf_cap in (SI, SS)


def partition_chains(pp: PhysPlan) -> list:
    """Cut the physical DAG into chains per Appendix B; returns a list of
    chains, each a list of node ids in topological order."""
    cons = pp.consumers()
    nodes = {n.id: n for n in pp.topo()}
    cut: set = set()  # edges (src, dst) that are cut

    for n in pp.topo():
        outs = cons[n.id]
        # rule 3: multiple outgoing edges -> cut all
        if len(outs) > 1:
            cut.update((n.id, o) for o in outs)
        for o in outs:
            dst = nodes[o]
            # rule 1: capability mismatch
            if not _can_stream_out(n) or not _can_stream_in(dst):
                cut.add((n.id, o))
            # rule 2: not the capOn input of dst
            cap_idx = dst.attrs.get("cap_idx", 0)
            if len(dst.inputs) > cap_idx and dst.inputs[cap_idx] != n.id:
                cut.add((n.id, o))

    # connected components over uncut edges (chains)
    parent = {nid: nid for nid in nodes}

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb

    for n in pp.topo():
        for o in cons[n.id]:
            if (n.id, o) not in cut and o in nodes:
                union(n.id, o)

    groups: dict = {}
    for n in pp.topo():  # topo order preserved within groups
        groups.setdefault(find(n.id), []).append(n.id)
    return list(groups.values())


@dataclass
class BufferingDecision:
    """What the executor consumes: whether to stream, and the microbatch
    count for the streamed (gradient-accumulation) execution."""

    enabled: bool
    num_microbatches: int
    chains: list

    @property
    def longest_chain(self):
        return max((len(c) for c in self.chains), default=0)


def plan_buffering(pp: PhysPlan, *, enabled: bool, global_batch: int,
                   target_microbatch: int = 0) -> BufferingDecision:
    """Decide streaming for a plan.  ``target_microbatch==0`` picks the
    largest divisor of ``global_batch`` that is ≤ global_batch/4 (stream in
    ≥4 slices), mirroring the paper's batch-by-batch semantics."""
    chains = partition_chains(pp)
    if not enabled:
        return BufferingDecision(False, 1, chains)
    if target_microbatch <= 0:
        num = 1
        for d in range(2, global_batch + 1):
            if global_batch % d == 0 and global_batch // d >= 1 and d <= 8:
                num = d
        # ``num`` = largest divisor of global_batch that is ≤ 8
    else:
        if global_batch % target_microbatch:
            raise ValueError(
                f"microbatch {target_microbatch} !| batch {global_batch}")
        num = global_batch // target_microbatch
    if num <= 1:
        return BufferingDecision(False, 1, chains)
    return BufferingDecision(True, num, chains)
