"""``mq.shared_pct``: the share of the window's analyses answered without
a run of their own, from the runtime's analytics counters over the
window: deduped twins (riding an identical in-flight query) plus queries
run inside one vmapped batch, over all requests.  Each analysis is at
most one of the two.  A cell that bypasses the multi-query layer reads
0."""
UNIT, BETTER, SOURCE = "%", "higher", "program_counter"
LAYER, MOVES = "analytics serving", "analyses_per_s"


def read(run):
    c = run.window["counters"]
    if not c["requests"]:
        return None
    return 100.0 * (c["deduped"] + c["batched"]) / c["requests"]
