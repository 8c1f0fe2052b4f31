"""Serving metrics: per-request latency decomposition + runtime gauges.

Per request: queue wait, TTFT (submit → first token, i.e. admission + plan
fetch + prefill), and TPOT (mean decode seconds per generated token after
the first).  Runtime-wide: queue-depth and pool-occupancy gauges sampled at
every scheduler tick, plan-cache hit/miss deltas, and join/leave/reject
counters.

Distributions are held as :class:`Summary` objects — running count / mean /
min / max plus p50/p95/p99 **percentile summaries** (nearest-rank) over
every raw sample.

All summaries and counters live in a :class:`MetricsRegistry`
(``AsyncServingRuntime(registry=...)``), and one ``report()`` covers them.
The reference's analysis-request view (``analytics_summary``) and its
bounded-ring option (``keep_samples=False``) come with the slice that
ports the analysis requests.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class RequestMetrics:
    request_id: object
    bucket: int = 0
    prompt_len: int = 0
    gen: int = 0
    submitted_at: float = 0.0
    joined_at: float = 0.0
    first_token_at: float = 0.0
    finished_at: float = 0.0
    plan_ms: float = 0.0             # plan fetch/compile (cache hit ≈ free)
    prefill_ms: float = 0.0
    replay_ms: float = 0.0           # replay fallback: prompt replay ...
    adopt_ms: float = 0.0            # ... and its write into the slot

    @property
    def queue_wait_s(self) -> float:
        return max(self.joined_at - self.submitted_at, 0.0)

    @property
    def ttft_s(self) -> float:
        return max(self.first_token_at - self.submitted_at, 0.0)

    @property
    def tpot_s(self) -> float:
        if self.gen <= 1:
            return 0.0
        return max(self.finished_at - self.first_token_at, 0.0) / \
            (self.gen - 1)


class Summary:
    """One observed distribution: running count/mean/min/max plus
    nearest-rank percentiles over every raw sample."""

    __slots__ = ("name", "count", "total", "min", "max", "_samples")

    def __init__(self, name: str = ""):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._samples: list = []

    def observe(self, value) -> None:
        v = float(value)
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        self._samples.append(v)

    @property
    def samples(self) -> list:
        """The raw samples, in observation order."""
        return self._samples

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile over the samples (q in 0..100)."""
        if not self._samples:
            return 0.0
        xs = sorted(self._samples)
        rank = max(1, -(-int(q) * len(xs) // 100))   # ceil(q/100 * n)
        return xs[min(rank, len(xs)) - 1]

    def snapshot(self) -> dict:
        return {"count": self.count, "mean": self.mean,
                "min": self.min if self.count else 0.0,
                "max": self.max if self.count else 0.0,
                "p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99)}

    def __repr__(self):
        s = self.snapshot()
        return (f"Summary({self.name}: n={s['count']} mean={s['mean']:.4g} "
                f"p50={s['p50']:.4g} p95={s['p95']:.4g} "
                f"p99={s['p99']:.4g})")


class Gauge:
    """A point-in-time level (queue depth *now*, resident bytes *now*) —
    distinct from a Summary (a distribution of observations) and a counter
    (a monotone total).  Tracks its own peak/trough so intermittent
    snapshot readers still see the extremes between reads."""

    __slots__ = ("name", "value", "peak", "trough", "updates")

    def __init__(self, name: str = ""):
        self.name = name
        self.value = 0.0
        self.peak = float("-inf")
        self.trough = float("inf")
        self.updates = 0

    def set(self, value) -> float:
        v = float(value)
        self.value = v
        self.peak = max(self.peak, v)
        self.trough = min(self.trough, v)
        self.updates += 1
        return v

    def inc(self, delta=1.0) -> float:
        return self.set(self.value + float(delta))

    def dec(self, delta=1.0) -> float:
        return self.set(self.value - float(delta))

    def snapshot(self) -> dict:
        return {"value": self.value,
                "peak": self.peak if self.updates else 0.0,
                "trough": self.trough if self.updates else 0.0,
                "updates": self.updates}

    def __repr__(self):
        return f"Gauge({self.name}={self.value:.4g} peak={self.peak:.4g})"


class Counter:
    """Named monotone counter view over a registry's counter table (the
    table itself stays a plain ``{name: int}`` dict — existing consumers
    index ``registry.counters`` directly)."""

    __slots__ = ("name", "_counters")

    def __init__(self, name: str, counters: dict):
        self.name = name
        self._counters = counters
        self._counters.setdefault(name, 0)

    def inc(self, delta: int = 1) -> int:
        if delta < 0:
            raise ValueError(f"counter {self.name}: negative delta {delta}")
        self._counters[self.name] = self._counters.get(self.name, 0) + delta
        return self._counters[self.name]

    @property
    def value(self) -> int:
        return self._counters.get(self.name, 0)

    def __repr__(self):
        return f"Counter({self.name}={self.value})"


class MetricsRegistry:
    """Named summaries + gauges + counters: the LM serving path registers
    ``lm.*`` series — one registry, one report."""

    def __init__(self):
        self.summaries: dict = {}
        self.counters: dict = {}
        self.gauges: dict = {}

    def summary(self, name: str) -> Summary:
        s = self.summaries.get(name)
        if s is None:
            s = self.summaries[name] = Summary(name)
        return s

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge(name)
        return g

    def counter(self, name: str) -> Counter:
        return Counter(name, self.counters)

    def count(self, name: str, delta: int = 1) -> int:
        self.counters[name] = self.counters.get(name, 0) + delta
        return self.counters[name]

    def snapshot(self) -> dict:
        return {"summaries": {k: v.snapshot()
                              for k, v in sorted(self.summaries.items())},
                "gauges": {k: v.snapshot()
                           for k, v in sorted(self.gauges.items())},
                "counters": dict(sorted(self.counters.items()))}

    def report(self) -> str:
        lines = []
        for name in sorted(self.summaries):
            s = self.summaries[name].snapshot()
            lines.append(
                f"[metrics] {name}: n={s['count']} mean={s['mean']:.4g} "
                f"p50={s['p50']:.4g} p95={s['p95']:.4g} p99={s['p99']:.4g} "
                f"max={s['max']:.4g}")
        for name in sorted(self.gauges):
            g = self.gauges[name].snapshot()
            lines.append(f"[metrics] {name}: {g['value']:.4g} "
                         f"(peak {g['peak']:.4g})")
        for name in sorted(self.counters):
            lines.append(f"[metrics] {name}: {self.counters[name]}")
        return "\n".join(lines)


class ServingMetrics:
    """The LM serving path's view over a (possibly shared) registry.

    Request latency series (TTFT / TPOT / queue wait) and scheduler gauges
    (queue depth / pool fill) live as ``lm.*`` summaries in the registry;
    the legacy raw-list attributes (``queue_depth_samples`` etc.) remain as
    views over the Summary samples so existing consumers stay green."""

    def __init__(self, registry: MetricsRegistry | None = None,
                 prefix: str = "lm"):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.prefix = prefix
        self.requests: list = []      # finished RequestMetrics
        self.rejected = 0
        self.joins = 0
        self.leaves = 0
        self.ticks = 0
        self.plan_hits = 0
        self.plan_misses = 0
        r = self.registry
        self._ttft = r.summary(f"{prefix}.ttft_s")
        self._tpot = r.summary(f"{prefix}.tpot_s")
        self._queue_wait = r.summary(f"{prefix}.queue_wait_s")
        self._queue_depth = r.summary(f"{prefix}.queue_depth")
        self._pool_fill = r.summary(f"{prefix}.pool_fill")

    # legacy raw-list access (tests/benchmarks iterate these directly)
    @property
    def queue_depth_samples(self) -> list:
        return self._queue_depth.samples

    @property
    def pool_fill_samples(self) -> list:
        return self._pool_fill.samples

    def observe_tick(self, queue_depth: int, pool_fill: float) -> None:
        self.ticks += 1
        self._queue_depth.observe(queue_depth)
        self._pool_fill.observe(pool_fill)

    def observe_plan(self, *, hit: bool) -> None:
        if hit:
            self.plan_hits += 1
        else:
            self.plan_misses += 1

    def finish(self, rm: RequestMetrics) -> None:
        self.requests.append(rm)
        self.leaves += 1
        self._ttft.observe(rm.ttft_s)
        self._queue_wait.observe(rm.queue_wait_s)
        if rm.gen > 1:
            self._tpot.observe(rm.tpot_s)

    def summary(self) -> dict:
        rs = self.requests
        n = len(rs)
        total = self.plan_hits + self.plan_misses
        out = {
            "completed": n,
            "rejected": self.rejected,
            "ticks": self.ticks,
            "mean_ttft_s": self._ttft.mean,
            "mean_tpot_s": self._tpot.mean,
            "mean_queue_wait_s": self._queue_wait.mean,
            "mean_queue_depth": self._queue_depth.mean,
            "max_queue_depth": int(self._queue_depth.max)
            if self._queue_depth.count else 0,
            "mean_pool_fill": self._pool_fill.mean,
            "plan_hits": self.plan_hits,
            "plan_misses": self.plan_misses,
            "plan_hit_rate": (self.plan_hits / total) if total else 0.0,
            "generated_tokens": sum(r.gen for r in rs),
        }
        for key, s in (("ttft_s", self._ttft), ("tpot_s", self._tpot),
                       ("queue_wait_s", self._queue_wait)):
            for q in (50, 95, 99):
                out[f"p{q}_{key}"] = s.percentile(q)
        return out

    def report(self) -> str:
        s = self.summary()
        lines = [
            f"[serving] {s['completed']} completed, {s['rejected']} rejected "
            f"over {s['ticks']} ticks",
            f"[serving] TTFT {s['mean_ttft_s'] * 1e3:.1f} ms mean "
            f"(p50 {s['p50_ttft_s'] * 1e3:.1f} / "
            f"p95 {s['p95_ttft_s'] * 1e3:.1f} / "
            f"p99 {s['p99_ttft_s'] * 1e3:.1f})",
            f"[serving] TPOT {s['mean_tpot_s'] * 1e3:.2f} ms/token mean "
            f"(p50 {s['p50_tpot_s'] * 1e3:.2f} / "
            f"p95 {s['p95_tpot_s'] * 1e3:.2f} / "
            f"p99 {s['p99_tpot_s'] * 1e3:.2f})",
            f"[serving] queue wait {s['mean_queue_wait_s'] * 1e3:.1f} ms "
            f"mean (p95 {s['p95_queue_wait_s'] * 1e3:.1f}); "
            f"depth mean {s['mean_queue_depth']:.2f} "
            f"max {s['max_queue_depth']}; "
            f"pool fill mean {s['mean_pool_fill']:.2f}",
            f"[serving] plan cache: {s['plan_hits']} hits / "
            f"{s['plan_misses']} misses "
            f"(hit rate {s['plan_hit_rate']:.2f})",
        ]
        return "\n".join(lines)
