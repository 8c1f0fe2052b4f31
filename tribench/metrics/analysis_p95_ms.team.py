"""``analysis_p95_ms.team``: the 95th percentile of every analysis's time
from its round's submission to its result on the host, in a round cell's
window (host clock).  A record of the tail, not a gate."""
import numpy as np

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"
LAYER, MOVES = "analytics serving", "analyses_per_s"


def read(run):
    lat = run.window["lat_ms"]
    return float(np.percentile(lat, 95)) if lat else None
