"""BENCHMARK.json against the benchmark's contract and its own files."""
import json
import re

import pytest

from tribench import gen
from tribench.harness import applies
from tribench.registry import ROOT, Registry, load_manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def manifest():
    return load_manifest(ROOT)


def line(text, limit=200):
    return 1 <= len(text) <= limit and "\n" not in text and "\t" not in text


def test_shape_and_names(manifest):
    assert set(manifest) == KEYS["top"]
    assert len(json.dumps(manifest)) < 64 * 1024
    assert manifest["command"] == ["python3", "tribench/run.py"]
    assert manifest["paths"] == ["tribench"]
    assert all(PATH.match(p) for p in manifest["paths"])
    assert 1 <= manifest["run_seconds"] <= 51
    names = []
    for c in manifest["configs"]:
        assert set(c) == KEYS["config"]
        assert line(c["source"]) and line(c["why"])
        assert c["file"] == f"tribench/configs/{c['name']}.json"
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in manifest["workloads"]:
        assert set(w) == KEYS["workload"] and w["chips"] in (1, 4)
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert line(w["why"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    for kind in ("end_to_end", "per_layer"):
        for m in manifest[kind]:
            assert set(m) - {"workloads"} == KEYS[kind], m["name"]
            assert UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                              "higher")
            names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {w["config"] for w in manifest["workloads"]} == {
        c["name"] for c in manifest["configs"]}


def test_end_to_end(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = [w["name"] for w in manifest["workloads"]]
    for m in e2e.values():
        assert set(m.get("workloads", cells)) <= set(cells)
    for cell in cells:
        got = [m for m in e2e.values() if applies(m, cell, manifest)]
        assert "setup_s" in [m["name"] for m in got] and len(got) >= 2


def test_per_layer_metrics_and_their_files(manifest):
    reg = Registry()
    e2e = {m["name"] for m in manifest["end_to_end"]}
    cells = [w["name"] for w in manifest["workloads"]]
    for m in manifest["per_layer"]:
        assert m["source"] in SOURCES and line(m["layer"])
        assert m["moves"] in e2e
        mod = reg.metric(m["name"])
        assert (mod.UNIT, mod.BETTER, mod.SOURCE, mod.LAYER, mod.MOVES) == (
            m["unit"], m["better"], m["source"], m["layer"], m["moves"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        for cell in m.get("workloads", ()):
            assert cell in cells
            moved = next(x for x in manifest["end_to_end"]
                         if x["name"] == m["moves"])
            assert applies(moved, cell, manifest), (m["name"], cell)
    for cell in cells:
        assert any(applies(m, cell, manifest) for m in manifest["per_layer"])
    layers = {}
    for m in manifest["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_configs_mixes_and_analyses(manifest):
    reg = Registry()
    for c in manifest["configs"]:
        cfg = reg.config(c["name"])
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert reg.dataset(cfg["dataset"]).draw
        assert cfg["sizes"]["zipf_support"] % cfg["sizes"]["hashtags"] == 0
        assert cfg["sizes"]["zipf_support"] % cfg["sizes"]["vocab"] == 0
        # every size that differs from the source's is listed, no width is
        changed = sorted(k for k, v in cfg["source_sizes"].items()
                         if cfg["sizes"][k] != v)
        assert changed == sorted(c["reduced"]), (c["name"], changed)
        assert not set(c["reduced"]) & {"users", "hashtags", "vocab",
                                        "terms_lo", "terms_hi"}
        assert cfg["kernels"] and all(isinstance(k, str)
                                      for k in cfg["kernels"])
    for w in manifest["workloads"]:
        cfg, mix = reg.config(w["config"]), reg.traffic(w["traffic"])
        gen.check_mix(mix)
        for name, _params in gen.variants(mix):
            mod = reg.analysis(name)
            assert callable(mod.build) and callable(mod.reference)
            for k in ("graph_err", "text_err"):
                assert f"{name}.{k}" in cfg["limits"], (w["name"], name)
