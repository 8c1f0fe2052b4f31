"""Fault tolerance: resumable loop, step watchdog, straggler log, elastic
re-mesh.

The contract: the training loop is a pure function of (checkpoint, data
seed), so any failure mode — process crash, node loss, preemption — reduces
to "restart from the latest checkpoint", and the deterministic pipeline
(data/pipeline.py) replays the exact stream.  The watchdog flags steps whose
wall time exceeds ``straggler_factor`` × the running median (the classic
straggler signal on real pods; on multi-host it would be fed by per-host
heartbeats) and can trigger a checkpoint so a kill/reschedule loses nothing.

The port of the reference's ``train/fault_tolerance.py``, verbatim but for
three unused imports: pure Python over the port's checkpoints.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass
class Watchdog:
    straggler_factor: float = 3.0
    window: int = 32
    _times: deque = field(default_factory=lambda: deque(maxlen=128))
    events: list = field(default_factory=list)

    def observe(self, step: int, seconds: float) -> bool:
        """Returns True if this step is a straggler."""
        med = self.median()
        self._times.append(seconds)
        if med is not None and seconds > self.straggler_factor * med:
            self.events.append({"step": step, "seconds": seconds,
                                "median": med})
            return True
        return False

    def median(self) -> Optional[float]:
        if len(self._times) < 5:
            return None
        s = sorted(self._times)
        return s[len(s) // 2]


@dataclass
class FailureInjector:
    """Deterministic failure injection for resilience tests: raises at the
    configured steps (once each)."""

    fail_at: tuple = ()
    _fired: set = field(default_factory=set)

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self._fired:
            self._fired.add(step)
            raise RuntimeError(f"injected failure at step {step}")


def run_resumable(total_steps: int, *, make_loop: Callable,
                  ckpt_dir: str, max_restarts: int = 5) -> dict:
    """Supervisor: (re)starts the loop from the latest checkpoint until the
    step budget is done.  ``make_loop(start_step) -> (steps_done, info)``
    must checkpoint internally; on exception we restart from the last
    checkpoint (the node-failure path on a real cluster)."""
    from .checkpoint import latest_checkpoint, checkpoint_step

    restarts = 0
    history = []
    while True:
        latest = latest_checkpoint(ckpt_dir)
        start = (checkpoint_step(latest) if latest else 0)
        if start >= total_steps:
            return {"restarts": restarts, "history": history,
                    "final_step": start}
        try:
            done, info = make_loop(start)
            history.append({"start": start, "done": done, "info": info})
            if done >= total_steps:
                return {"restarts": restarts, "history": history,
                        "final_step": done}
        except RuntimeError as e:  # injected / real failure
            restarts += 1
            history.append({"start": start, "error": str(e)})
            if restarts > max_restarts:
                raise
