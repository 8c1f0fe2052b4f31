"""The plain reference against the program on the CPU at a tiny size, the
bfloat16 control failing the same comparison, the seeded draws, and the
frozen work functions against the stores' shapes."""
import numpy as np
import pytest
import torch

from tribench import gen, work
from tribench.harness import build_stores, host_arrays
from tribench.reference import Reference, gaps
from tribench.registry import Registry
from tribench.testkit import SEED, TINY, tiny_root

torch.set_num_threads(2)
CASES = [("pulse_10m", "hashtag_pulse", {"threshold": 30.0, "iters": 8}),
         ("pulse_10m", "mq_heavy", {"threshold": 30.0, "iters": 24}),
         ("pulse_10m", "mq_light", {})]


def draw(config, seed=SEED):
    reg = Registry()
    cfg = reg.config(config)
    return reg.dataset(cfg["dataset"]).draw(
        TINY[config], gen.generator(seed, "cpu"), "cpu")


@pytest.fixture(scope="module")
def worlds():
    out = {}
    for config in TINY:
        raw = host_arrays(draw(config))
        stores = build_stores(raw)
        out[config] = (raw, stores,
                       {k: s.payload("cpu") for k, s in stores.items()},
                       Reference(raw, "cpu"),
                       Reference(raw, "cpu", control=True))
    return out


@pytest.mark.parametrize("config,name,params", CASES)
def test_program_matches_reference_and_control_fails(worlds, config, name,
                                                     params):
    import repro_torch
    raw, stores, payloads, ref, ctl = worlds[config]
    reg = Registry()
    mod = reg.analysis(name)
    limits = reg.config(config)["limits"]
    fn = repro_torch.compile(mod.build(stores, params), device="cpu")
    qs = gen.QueryStream(SEED, gen.STREAM_WINDOW, raw["vocab"], 6)
    for _ in range(3):
        q = qs.vector(qs.terms_next())
        inputs = {k: payloads[k] for k in mod.INPUTS if k != "q"}
        out = fn({}, {**inputs, "q": torch.from_numpy(q)})
        want = mod.reference(ref, params, q)
        got = gaps(out, *want)
        assert all(v <= limits[f"{name}.{k}"] for k, v in got.items()), got
        control = sum(p for p in mod.reference(ctl, params, q)
                      if p is not None)
        got = gaps(control, *want)
        assert any(v > limits[f"{name}.{k}"] for k, v in got.items()), got


def test_gaps():
    g = torch.tensor([0.0, 2.0, 4.0, 1e6], dtype=torch.float64)
    t = torch.tensor([0.0, 0.0, 1.0, 1.0], dtype=torch.float64)

    def f32(*v):
        return np.array(v, np.float32)

    assert gaps(f32(0, 2, 5, 1e6 + 1), g, t) == {"graph_err": 0.0,
                                                   "text_err": 0.0}
    assert gaps(f32(0, 2.5, 5, 1e6 + 1), g, t)["graph_err"] == 0.25
    assert gaps(f32(1e-9, 2, 5, 1e6 + 1), g, t)["graph_err"] == np.inf
    # a lost text part, against its own size, however large the graph's
    assert gaps(f32(0, 2, 4, 1e6 + 1), g, t)["text_err"] == 1.0
    assert gaps(f32(0, 2, 5, 1e6 + 65), g, t)["text_err"] == 64.0
    assert gaps(f32(0, 2), g, t)["graph_err"] == np.inf
    assert gaps(f32(0, 2, 5, np.nan), g, t)["text_err"] == np.inf
    assert gaps(f32(0, 0, 1, 1), None, t) == {"graph_err": 0.0,
                                               "text_err": 0.0}


@pytest.mark.parametrize("config", sorted(TINY))
def test_seeded_draws_repeat_exactly(config):
    a, b, c = draw(config), draw(config), draw(config, SEED + 1)
    for k in a["table"]:
        assert torch.equal(a["table"][k], b["table"][k])
    assert torch.equal(a["terms"], b["terms"])
    assert torch.equal(a["lens"], b["lens"])
    assert all(torch.equal(u, v) for u, v in zip(a["edges"], b["edges"]))
    assert not torch.equal(a["table"]["hashtag"], c["table"]["hashtag"])


def test_zipf_mod_matches_its_folded_pmf():
    g = gen.generator(7, "cpu")
    n, m, a = 400_000, 16, 1.3
    got = torch.bincount(gen.zipf_mod(g, a, n, m, 1 << 16, "cpu").long(),
                         minlength=m).double() / n
    # zipf(a) % m to 2**22, its tail beyond spread evenly over the residues
    big = 1 << 22
    k = np.arange(1, big + 1, dtype=np.float64)
    want = np.bincount(k.astype(np.int64) % m, weights=k ** -a, minlength=m)
    want += (big + 0.5) ** (1 - a) / (a - 1) / m
    want /= want.sum()
    assert np.abs(got.numpy() - want).max() < 3e-3
    assert abs(got[1].item() - want[1]) < 3e-3     # residue 1 is the mode


def test_work_functions_follow_the_stores(worlds):
    raw, stores, _payloads, ref, _ = worlds["pulse_10m"]
    g = stores["g"]
    w = work.spmv_scatter(int(ref.src.numel()), ref.nodes)
    assert w["bytes"] == 8 * g.n_edges + 4 * g.n_nodes
    # the masked scoring of the most recent tenth of the documents
    cx = stores["cx"]
    mask = np.arange(cx.n_docs) >= cx.n_docs - cx.n_docs // 10
    kept = np.flatnonzero(mask)
    # the program's index: the kept documents' postings and their terms
    in_window = mask[cx.doc_ids]
    terms = np.unique(cx.term_ids[in_window]).size
    w = work.masked_tfidf(cx.n_docs, kept.size, int(in_window.sum()), terms)
    assert kept.size == 600 and cx.n_docs == 6000
    assert w["bytes"] == (cx.n_docs * (1 + 4) + kept.size * (4 + 4)
                          + int(in_window.sum()) * (4 + 4) + terms * 4)
    assert w["flops"] == 3 * int(in_window.sum())


def test_calibration_readings_separate(tmp_path):
    """The chip's calibration path, at a tiny size on the CPU: the
    program's readings within every limit, the control's over one."""
    import io
    import json

    from tribench import calibrate
    from tribench.harness import forbidden_modules
    root = tiny_root(tmp_path)
    before = set(forbidden_modules())      # what other tests loaded
    out = io.StringIO()
    assert calibrate.main(["--config", "pulse_10m", "--mixes",
                           "solo,team16", "--seeds", f"{SEED},{SEED + 1}",
                           "--seconds", "0.3"], device="cpu",
                          roots=[root], out=out) == 0
    lines = [json.loads(x) for x in out.getvalue().splitlines()]
    assert [x["mix"] for x in lines[:-1]] == ["solo", "team16"] * 2
    limits = Registry([root]).config("pulse_10m")["limits"]
    last = lines[-1]
    assert set(last["forbidden"]) <= before
    assert all(v <= limits[k] for k, v in last["lower"].items())
    for name in ("hashtag_pulse", "mq_heavy", "mq_light"):
        assert any(last["upper"][f"{name}.{k}"] > limits[f"{name}.{k}"]
                   for k in ("graph_err", "text_err"))
