"""``stores.build_s``: the program's store constructors (``ColumnStore``,
``GraphStore.from_edges``, ``TextStore.from_flat``) plus their
``payload(device)`` with a device sync, in set-up (host clock)."""
UNIT, BETTER, SOURCE = "s", "lower", "host_clock"
LAYER, MOVES = "stores", "setup_s"


def read(run):
    return run.setup["store_build_s"] + run.setup["h2d_s"]
