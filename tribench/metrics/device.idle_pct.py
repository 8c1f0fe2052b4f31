"""``device.idle_pct``: the share of the traced window in which no device
operation (kernel, copy, memset) runs (device trace)."""
UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER, MOVES = "device", "analyses_per_s"


def read(run):
    if run.trace is None or not run.trace_window_s:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace_window_s)
