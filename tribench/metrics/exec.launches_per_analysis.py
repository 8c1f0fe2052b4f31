"""``exec.launches_per_analysis``: device kernels in the traced window
over the analyses completed in it (device trace)."""
UNIT, BETTER, SOURCE = "launches", "lower", "device_trace"
LAYER, MOVES = "executor", "analyses_per_s"


def read(run):
    if run.trace is None or not run.trace_analyses:
        return None
    return len(run.trace.kernels) / run.trace_analyses
