"""A later change adds a configuration, a traffic mix and a per-layer metric
as new files and one cell to the manifest, and edits nothing: the
harness's discovery takes them up by name."""
import json

import torch

from tribench.registry import HERE, Registry
from tribench.testkit import TINY, run_cell, tiny_config, tiny_root

torch.set_num_threads(2)

METRIC = '''"""A throw-away metric: the traced window's analyses."""
UNIT, BETTER, SOURCE = "analyses", "higher", "program_counter"
LAYER, MOVES = "analytics serving", "analyses_per_s"


def read(run):
    return float(run.trace_analyses)
'''


def add_cell(root):
    """New files only: a config, a mix, a metric, and the manifest entry."""
    cfg = tiny_config("pulse_10m")
    cfg["name"] = "throwaway_cfg"
    cfg["sizes"] = dict(TINY["pulse_10m"], tweets=4000)
    (root / "configs" / "throwaway_cfg.json").write_text(json.dumps(cfg))
    (root / "traffic").mkdir(exist_ok=True)
    (root / "traffic" / "throwaway_mix.json").write_text(json.dumps({
        "why": "light queries one after another", "loop": "sequential",
        "subplan_cache": False, "query_terms": 3, "check_sample": 4,
        "cycle": [{"analysis": "mq_light"}]}))
    (root / "metrics").mkdir(exist_ok=True)
    (root / "metrics" / "throwaway.count.py").write_text(METRIC)
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({
        "name": "throwaway_cfg", "source": "a test", "reduced": [],
        "file": "tribench/configs/throwaway_cfg.json", "why": "a test"})
    manifest["workloads"].append({
        "name": "throwaway_cfg.throwaway_mix", "config": "throwaway_cfg",
        "traffic": "throwaway_mix", "chips": 1, "why": "a test"})
    manifest["per_layer"].append({
        "name": "throwaway.count", "unit": "analyses", "better": "higher",
        "source": "program_counter", "layer": "analytics serving",
        "moves": "analyses_per_s",
        "workloads": ["throwaway_cfg.throwaway_mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))


def test_new_files_are_found_by_name(tmp_path):
    root = tiny_root(tmp_path)
    before = {p: p.read_bytes() for p in HERE.rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    add_cell(root)
    reg = Registry([root])
    assert "throwaway_cfg" in reg.names("configs")
    assert {"throwaway_mix", "solo", "team16"} <= set(reg.names("traffic"))
    assert {"throwaway.count", "device.idle_pct"} <= set(
        reg.names("metrics"))
    assert reg.metric("throwaway.count").MOVES == "analyses_per_s"

    rc, res, err = run_cell(root, "throwaway_cfg.throwaway_mix", trace=1)
    assert rc == 0 and res["correct"] is True, err
    assert res["metrics"]["throwaway.count"]["value"] > 0
    assert "device.idle_pct" in res["metrics"]
    assert set(res["compared"]) == {"mq_light.graph_err",
                                    "mq_light.text_err"}
    rc, res, err = run_cell(root, "throwaway_cfg.throwaway_mix")
    assert rc == 0 and set(res["metrics"]) == {"analyses_per_s", "setup_s"}
    after = {p: p.read_bytes() for p in HERE.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert after == before
