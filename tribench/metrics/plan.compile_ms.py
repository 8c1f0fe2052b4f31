"""``plan.compile_ms``: the mean wall time of ``repro_torch.compile`` over
the cell's plans, each timed in set-up (host clock)."""
UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"
LAYER, MOVES = "planner", "setup_s"


def read(run):
    ms = run.compile_ms
    return sum(ms) / len(ms) if ms else None
