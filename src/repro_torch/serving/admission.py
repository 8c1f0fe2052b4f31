"""Bucketed admission control (serving front door).

Prompt lengths are rounded up to power-of-two buckets so that repeated
traffic with varying lengths maps onto a handful of cached
StagedPhysicalPlans: every request admitted into a **warm** bucket hits an
already-cached plan and never waits on the pass pipeline.  Cold buckets are
only planned in a low-load window (idle decode batch); under load they stay
queued — or are rejected outright when the queue is full — so a burst of
novel lengths cannot stall the in-flight decode batch behind planning.
"""
from __future__ import annotations

from dataclasses import dataclass


def bucket_len(n: int, lo: int = 8, hi: int | None = None) -> int:
    """Round a prompt length up to the next power-of-two bucket.

    ``lo`` is the smallest bucket (prompts shorter than ``lo`` — including
    empty prompts — share it); an exact power of two is its own bucket
    (no unnecessary promotion); ``hi`` is the model's max context — lengths
    above it are not servable and raise, and a non-power-of-two ``hi`` caps
    the top bucket at ``hi`` itself.
    """
    if n < 0:
        raise ValueError(f"prompt length must be >= 0, got {n}")
    if lo < 1:
        raise ValueError(f"smallest bucket must be >= 1, got {lo}")
    if hi is not None and n > hi:
        raise ValueError(
            f"prompt length {n} exceeds the max context {hi}")
    b = lo
    while b < n:
        b *= 2
    if hi is not None and b > hi:
        b = hi            # top bucket clamps to the (non-pow2) max context
    return b


@dataclass
class AdmissionController:
    """Per-request admission decisions.

    ``decide`` returns one of:
      * ``"admit"``  — enqueue for the scheduler (warm bucket, or a cold
        bucket while the system is quiet enough to plan it);
      * ``"queue"``  — cold bucket under load: hold until the decode batch
        drains enough to afford a planning pause;
      * ``"reject"`` — queue full (overload shedding).
    """

    max_queue: int = 64
    # a cold bucket may be planned inline while the decode batch occupancy
    # is at or below this fraction (0.0 == only when fully idle)
    cold_plan_occupancy: float = 0.5

    def decide(self, *, warm: bool, queue_depth: int, active: int,
               max_batch: int) -> str:
        if queue_depth >= self.max_queue:
            return "reject"
        if warm:
            return "admit"
        if active <= self.cold_plan_occupancy * max_batch:
            return "admit"          # quiet enough to plan the cold bucket
        return "queue"

    def can_plan_cold(self, *, active: int, max_batch: int) -> bool:
        """Scheduler-side re-check: a queued cold-bucket request may trigger
        planning once the decode batch has drained."""
        return active <= self.cold_plan_occupancy * max_batch
