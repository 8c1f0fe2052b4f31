"""The device trace of a window: ``torch.profiler`` over the card and the
host, reduced to what the per-layer metrics read.

:func:`profiled` runs a callable under the profiler, ends in a device
sync, and exports the Chrome trace to a temporary file (under ``TMPDIR``,
removed at once).  :class:`Trace` reads that trace's events:

  * device operations are the ``kernel``, ``gpu_memcpy`` and ``gpu_memset``
    events; ``busy_s`` is the length of their union;
  * :meth:`Trace.kernel_time` sums the kernels whose name holds one of the
    given names, plus each one's direct follower on its stream where that
    follower's name holds one of ``followers`` (a kernel's second pass
    whose name another kernel shares);
  * :meth:`Trace.idle_gaps` charges each gap between device operations to
    what the host was doing at its midpoint: the innermost host event
    (an operator or a CUDA runtime call) that spans it, else ``python``.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
NAME_CHARS = 96            # a breakdown entry's name is cut to this length
HOST_LOOKBACK = 64         # host events searched back from a gap


def profiled(fn):
    """``(fn()'s result, Trace, window seconds)`` with the card (where
    there is one) and the host traced; the window ends in a device
    sync."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return out, Trace(events), window_s


class Trace:
    def __init__(self, events):
        dev, host = [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            rec = (float(e["ts"]), float(e["dur"]), str(e.get("name", "")),
                   e.get("cat", ""), (e.get("pid"), e.get("tid")))
            if rec[3] in DEVICE_CATS:
                dev.append(rec)
            elif rec[3] in HOST_CATS:
                host.append(rec)
        self.device = sorted(dev)
        self.host = sorted(host)
        self._host_starts = [h[0] for h in self.host]

    @property
    def kernels(self) -> list:
        return [d for d in self.device if d[3] == "kernel"]

    def _union(self) -> list:
        merged = []
        for ts, dur, *_ in self.device:
            end = ts + dur
            if merged and ts <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([ts, end])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._union()) * 1e-6

    def kernel_time(self, names, followers=()) -> tuple:
        """``(launches, seconds)`` of the kernels named by ``names`` (and
        their ``followers``, see the module note)."""
        by_stream = defaultdict(list)
        for k in self.kernels:
            by_stream[k[4]].append(k)
        n, us = 0, 0.0
        for ks in by_stream.values():
            for i, k in enumerate(ks):
                if not any(s in k[2] for s in names):
                    continue
                n += 1
                us += k[1]
                nxt = ks[i + 1] if i + 1 < len(ks) else None
                if nxt is not None and any(s in nxt[2] for s in followers):
                    us += nxt[1]
        return n, us * 1e-6

    def top_ops(self, n: int = 10) -> list:
        """The ``n`` device operations that took most time, by name."""
        acc = defaultdict(float)
        for _ts, dur, name, *_ in self.device:
            acc[name[:NAME_CHARS]] += dur * 1e-6
        return sorted(([k, v] for k, v in acc.items()),
                      key=lambda kv: -kv[1])[:n]

    def _host_at(self, t: float) -> str:
        i = bisect.bisect_right(self._host_starts, t) - 1
        for j in range(i, max(i - HOST_LOOKBACK, -1), -1):
            ts, dur, name, *_ = self.host[j]
            if ts + dur >= t:
                return name
        return "python"

    def idle_gaps(self, n: int = 10) -> list:
        """The host activities that the longest idle time fell in."""
        acc = defaultdict(float)
        merged = self._union()
        for (_a, end), (start, _b) in zip(merged, merged[1:]):
            gap = start - end
            if gap > 0:
                acc[self._host_at(end + gap / 2)[:NAME_CHARS]] += gap * 1e-6
        return sorted(([k, v] for k, v in acc.items()),
                      key=lambda kv: -kv[1])[:n]
