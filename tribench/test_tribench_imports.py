"""What the harness and its reference import, and how a run refuses."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from tribench.harness import FORBIDDEN, forbidden_modules
from tribench.registry import ROOT

ENV = {**os.environ, "PYTHONPATH": ""}
# a whole tiny run of each cell on the CPU, then every module of the
# benchmark loaded: what the process holds at the end
LOAD_ALL = """
import json, sys, tempfile
sys.path[:0] = [{root!r}, {src!r}]
import torch
torch.set_num_threads(2)
import tribench.trace, tribench.calibrate
from tribench.registry import Registry
from tribench.testkit import run_cell, tiny_root
with tempfile.TemporaryDirectory() as tmp:
    root = tiny_root(tmp)
    for cell in ("pulse_10m.solo", "pulse_10m.team16"):
        rc, res, err = run_cell(root, cell, seconds=0.2)
        assert rc == 0 and res["correct"], err
reg = Registry()
for kind in ("metrics", "analyses", "datasets"):
    for name in reg.names(kind):
        reg.module(kind, name)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
REFERENCE_ONLY = """
import json, sys
sys.path[:0] = [{root!r}]
import tribench.reference, tribench.gen, tribench.work
from tribench.registry import Registry
reg = Registry()
for kind in ("analyses", "datasets"):
    for name in reg.names(kind):
        reg.module(kind, name)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level_names(code):
    out = subprocess.run([sys.executable, "-c", code.format(
        root=str(ROOT), src=str(ROOT / "src"))], capture_output=True,
        text=True, env=ENV, timeout=240)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_imports_no_jax_nor_the_jax_package():
    names = top_level_names(LOAD_ALL)
    assert "repro_torch" in names
    assert not names & set(FORBIDDEN), names & set(FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    names = top_level_names(REFERENCE_ONLY)
    assert not names & ({"repro_torch"} | set(FORBIDDEN))


def test_forbidden_names_are_compared_whole():
    assert forbidden_modules(["repro_torch", "repro_torch.core", "jaxlike",
                              "flaxen.x", "torch"]) == []
    assert forbidden_modules(["repro.core", "jax", "jaxlib.xla", "flax",
                              "repro_torch"]) == ["flax", "jax", "jaxlib",
                                                  "repro"]


def run_py(cwd):
    return subprocess.run(
        [sys.executable, "tribench/run.py", "--workload", "pulse_10m.solo",
         "--seed", "3000000021", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, env=ENV, timeout=240)


def test_run_without_a_chip_exits_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the run would measure")
    out = run_py(ROOT)
    assert out.returncode == 2 and out.stdout == "", out.stderr
    assert "needs 1 CUDA device" in out.stderr


def test_run_without_the_program_exits_and_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "tribench", tmp_path / "tribench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_py(tmp_path)
    assert out.returncode != 0 and out.stdout == "", out.stderr


def test_caches_sit_at_fixed_paths_inside_the_checkout(tmp_path, monkeypatch):
    from tribench.caches import use_checkout_caches
    monkeypatch.setattr(sys, "pycache_prefix", sys.pycache_prefix)
    monkeypatch.setattr(sys, "dont_write_bytecode", True)
    for key in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR"):
        monkeypatch.delenv(key, raising=False)
    cache = use_checkout_caches(tmp_path)
    assert cache == tmp_path / ".tribench_cache"
    assert sys.pycache_prefix == str(cache / "pycache")
    assert sys.dont_write_bytecode is False
    assert os.environ["TORCH_EXTENSIONS_DIR"] == str(cache /
                                                     "torch_extensions")
    assert os.environ["TRITON_CACHE_DIR"] == str(cache / "triton")
    assert use_checkout_caches(tmp_path) == cache     # the same each time
