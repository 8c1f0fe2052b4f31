"""Discovery by name: the benchmark's data files and small modules.

Each kind lives in a folder of its own under a search root:

  * ``configs/<name>.json``  — a deployment: sizes, source, ``reduced``,
    ``assumed``, runtime settings and the correctness limits;
  * ``traffic/<name>.json``  — a traffic mix, read by the one generator in
    :mod:`tribench.gen`;
  * ``metrics/<name>.py``    — a per-layer metric's reader and facts;
  * ``analyses/<name>.py``   — an analysis: the program's ADIL plan and
    its plain reference;
  * ``datasets/<name>.py``   — a data generator that draws on the device.

A later change adds a file and an entry of ``BENCHMARK.json`` and edits
nothing: :class:`Registry` looks each name up in its roots in order (the
package folder last), so a test can put throw-away files first.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
KINDS = {"configs": ".json", "traffic": ".json", "metrics": ".py",
         "analyses": ".py", "datasets": ".py"}
# what a metric module must define besides read()
METRIC_FACTS = ("UNIT", "BETTER", "SOURCE", "LAYER", "MOVES")


class Registry:
    """Name -> file lookup over ``roots`` (default: this package only)."""

    def __init__(self, roots=()):
        self.roots = [Path(r) for r in roots] + [HERE]
        self._modules: dict = {}

    def path(self, kind: str, name: str) -> Path:
        if kind not in KINDS:
            raise KeyError(f"unknown kind {kind!r}")
        if not NAME.match(name):
            raise ValueError(f"{kind} name {name!r} is not a valid name")
        for root in self.roots:
            p = root / kind / f"{name}{KINDS[kind]}"
            if p.is_file():
                return p
        raise FileNotFoundError(
            f"no {kind} named {name!r} under {[str(r) for r in self.roots]}")

    def names(self, kind: str) -> list:
        """Every name of ``kind`` found under the roots."""
        out = set()
        for root in self.roots:
            for p in (root / kind).glob(f"*{KINDS[kind]}"):
                name = p.name[:-len(KINDS[kind])]
                if NAME.match(name):
                    out.add(name)
        return sorted(out)

    def data(self, kind: str, name: str) -> dict:
        with open(self.path(kind, name)) as f:
            return json.load(f)

    def module(self, kind: str, name: str):
        path = self.path(kind, name)
        mod = self._modules.get(path)
        if mod is None:
            key = f"tribench_{kind}_" + re.sub(r"\W", "_", name)
            spec = importlib.util.spec_from_file_location(key, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[path] = mod
        return mod

    def config(self, name: str) -> dict:
        cfg = self.data("configs", name)
        if cfg.get("name") != name:
            raise ValueError(f"config file {name!r} names {cfg.get('name')!r}")
        return cfg

    def traffic(self, name: str) -> dict:
        return self.data("traffic", name)

    def metric(self, name: str):
        mod = self.module("metrics", name)
        missing = [k for k in METRIC_FACTS if not hasattr(mod, k)]
        if missing or not callable(getattr(mod, "read", None)):
            raise ValueError(f"metric {name!r} lacks {missing or ['read']}")
        return mod

    def analysis(self, name: str):
        return self.module("analyses", name)

    def dataset(self, name: str):
        return self.module("datasets", name)


def load_manifest(root: Path = ROOT) -> dict:
    """The ``BENCHMARK.json`` at ``root``."""
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")
