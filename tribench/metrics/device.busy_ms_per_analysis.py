"""``device.busy_ms_per_analysis``: the time in which a device operation
ran in the traced window, over the analyses completed in it (device
trace)."""
UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"
LAYER, MOVES = "device", "analyses_per_s"


def read(run):
    if run.trace is None or not run.trace_analyses:
        return None
    return 1e3 * run.trace.busy_s / run.trace_analyses
