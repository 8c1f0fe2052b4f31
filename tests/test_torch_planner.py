"""The port's planner copies against the reference planner, and the port's
import boundary.

Planning needs only store types, so ``hashtag_pulse`` is planned here both
at the example's size and at the full size the chip smoke runs (10M tweets)
without building any data.
"""
import os
import subprocess
import sys
from dataclasses import asdict
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
# two intra-op threads: the suite runs beside other test workers
torch.set_num_threads(2)

from repro.core import ir as jir  # noqa: E402
from repro.core.adil_parser import parse_adil as jparse  # noqa: E402
from repro.stores import store_engines as jengines  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.core import ir as tir  # noqa: E402
from repro_torch.core.adil_parser import parse_adil as tparse  # noqa: E402
from repro_torch.examples.tri_model_analysis import adil_script  # noqa

ROOT = Path(__file__).resolve().parents[1]

# (rows, hashtags, edges, docs, vocab, postings): the example's own size
# and the full size of the chip smoke
SIZES = [(20_000, 128, 24_602, 20_000, 256, 128_455),
         (10_000_000, 131_072, 17_400_000, 10_000_000, 65_536, 51_000_000)]
HW = dict(name="h100-sxm", peak_flops=989e12, hbm_bw=3.35e12, ici_bw=450e9,
          hbm_bytes=80e9, vmem_bytes=232_448)
COLS = (("user", "int32"), ("hashtag", "int32"), ("doc", "int32"),
        ("engagement", "float32"))


def _script(rows, hashtags, edges, docs, vocab, postings):
    stores = (SimpleNamespace(type=tir.TableT(COLS, rows)),
              SimpleNamespace(type=tir.GraphT(hashtags, edges)),
              SimpleNamespace(type=tir.CorpusT(docs, vocab, postings)))
    return adil_script(*stores)


@pytest.mark.parametrize("size", SIZES, ids=["example", "full"])
@pytest.mark.parametrize("hw", [HW, asdict(jir.HardwareSpec())],
                         ids=["h100", "reference-default"])
def test_plan_id_and_impls_equal_reference(size, hw):
    script = _script(*size)
    jhw, thw = jir.HardwareSpec(**hw), tir.HardwareSpec(**hw)
    jfn = jparse(script, jir.standard_catalog()).compile(
        jir.SystemCatalog(hardware=jhw), engines=jengines(pallas=True),
        cache=False)
    tfn = repro_torch.compile(tparse(script, tir.standard_catalog()),
                              tir.SystemCatalog(hardware=thw),
                              device="cpu", cache=False)
    assert tfn.plan_id == jfn.plan_id
    assert tfn.chosen_impls() == [n.impl for n in jfn.concrete.topo()]
    assert tfn.chosen_impls().count("rel_fused_agg_pallas") == 2
    assert "graph_expand_pallas" in tfn.chosen_impls()
    assert "graph_pagerank_pallas" in tfn.chosen_impls()


def test_hardware_for_device_reads_the_part():
    assert tir.hardware_for_device("NVIDIA H100 80GB HBM3").name == "h100-sxm"
    assert tir.hardware_for_device("NVIDIA H100 PCIe").name == "h100-pcie"
    assert tir.HardwareSpec() == tir.H100_SXM


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.path.insert(0, '.')\n"
        "import repro_torch, repro_torch.examples.tri_model_analysis\n"
        "import repro_torch.examples.windowed_ranking\n"
        "import repro_torch.examples.tri_influence\n"
        "import repro_torch.kernels.masked_kernels\n"
        "import repro_torch.kernels.graph_kernels\n"
        "import repro_torch.kernels.build\n"
        "import repro_torch.kernels.flash_attention\n"
        "import repro_torch.kernels.wkv6, repro_torch.kernels.ssd\n"
        "import repro_torch.kernels.moe_gmm\n"
        "import repro_torch.configs, repro_torch.configs.qwen3_0_6b\n"
        "import repro_torch.configs.rwkv6_3b, repro_torch.configs.zamba2_7b\n"
        "import repro_torch.configs.dbrx_132b\n"
        "import repro_torch.configs.llama4_maverick_400b_a17b\n"
        "import repro_torch.layers.common, repro_torch.layers.embedding\n"
        "import repro_torch.layers.mlp, repro_torch.layers.attention\n"
        "import repro_torch.layers.rwkv, repro_torch.layers.mamba\n"
        "import repro_torch.layers.moe\n"
        "import repro_torch.models, repro_torch.models.lm\n"
        "import repro_torch.models.decode\n"
        "import repro_torch.serving, repro_torch.serving.admission\n"
        "import repro_torch.serving.scheduler, repro_torch.serving.metrics\n"
        "import repro_torch.serving.kv_pool, repro_torch.serving.runtime\n"
        "import repro_torch.launch.serve\n"
        "import repro_torch.core.tracing, repro_torch.core.ledger\n"
        "import repro_torch.core.mqo, repro_torch.core.faults\n"
        "import repro_torch.core.resilience, repro_torch.serving.degrade\n"
        "import repro_torch.examples.multi_query\n"
        "import chip_smoke\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None "
        "and m.split('.')[0] in ('repro', 'jax', 'jaxlib')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
