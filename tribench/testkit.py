"""Tiny copies of the benchmark for its CPU tests.

:func:`tiny_root` writes, under a temporary directory, a copy of every
configuration at a size the CPU runs in a second (same keys, the sizes
and the subplan budget cut) and a manifest whose cells are the real
ones, pointed at the copies.  :func:`run_cell` drives the harness there on
the CPU, past its look for a chip, and returns the result line.
"""
from __future__ import annotations

import io
import json
import time
from pathlib import Path

from tribench.registry import ROOT, Registry, load_manifest

TINY = {
    "pulse_10m": {"tweets": 6000, "users": 500, "hashtags": 128,
                  "vocab": 256, "terms_lo": 3, "terms_hi": 12,
                  "zipf_support": 1 << 14},
}
SEED = 3_000_000_019          # larger than 32 signed bits hold


def tiny_config(name: str) -> dict:
    cfg = Registry().config(name)
    cfg["sizes"] = dict(TINY[name])
    cfg["runtime"]["subplan_budget_bytes"] = 1 << 26
    return cfg


def tiny_root(tmp: Path) -> Path:
    """A search root with tiny configurations under the real names and the
    real manifest."""
    tmp = Path(tmp)
    (tmp / "configs").mkdir(parents=True, exist_ok=True)
    for name in TINY:
        (tmp / "configs" / f"{name}.json").write_text(
            json.dumps(tiny_config(name)))
    (tmp / "BENCHMARK.json").write_text(json.dumps(load_manifest(ROOT)))
    return tmp


def run_cell(root: Path, cell: str, *, seed: int = SEED,
             seconds: float = 0.5, trace: int = 0, roots=None):
    """``(exit code, result dict or None, standard error)`` of one run on
    the CPU.  A test process may hold JAX from other tests: the run's own
    look for it skips what was loaded before it."""
    from tribench.harness import forbidden_modules, main
    out, err = io.StringIO(), io.StringIO()
    rc = main(["--workload", cell, "--seed", str(seed), "--seconds",
               str(seconds), "--trace", str(trace)],
              t_start=time.perf_counter(), root=root,
              roots=[root] if roots is None else roots, device="cpu",
              out=out, err=err, preloaded=forbidden_modules())
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
