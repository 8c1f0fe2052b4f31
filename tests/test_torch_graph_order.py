"""The graph payload's dst-ordered edge copy, the scatter kernel's path over
it, and the kernel wrappers' typed-once C entries (``build.entry``).

The payload's ``dst_src`` / ``dst_dst`` / ``dst_w`` are the CSR's edges
permuted by a stable sort of ``indices``, whether the store built the
payload or it was carried over from the reference's arrays.  Because the
sort is stable, each node's contributions keep their CSR order, so on the
CPU (where the kernel path runs the plain scatter) the kernel path is
bitwise equal to the plain path; ``tests/test_torch_stores.py`` holds both
against the reference.
"""
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# two intra-op threads: the suite runs beside other test workers
torch.set_num_threads(2)

from repro.stores import graph_store as jgraph  # noqa: E402
from repro_torch.core.ir import ValidationError  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.stores import GraphStore, payload_from_numpy  # noqa: E402
from repro_torch.stores import graph_store as tgraph  # noqa: E402

DST_KEYS = {"dst_src": "src", "dst_dst": "indices", "dst_w": "weights"}


def _skewed_graph(rng, n=200, e=3000):
    """A graph whose in-degree is zipf-skewed (a few hub nodes), as the
    hashtag graph's is, with equal weights so ties in dst abound."""
    src = rng.randint(0, n, e)
    dst = np.minimum(rng.zipf(1.6, e) - 1, n - 1)
    w = rng.rand(e).astype(np.float32)
    jg = jgraph.GraphStore.from_edges(src, dst, n, weights=w, symmetric=True)
    tg = GraphStore.from_edges(src, dst, n, weights=w, symmetric=True)
    return jg, tg


def _payload(source, jg, tg):
    if source == "store":
        return tg.payload("cpu")
    return payload_from_numpy("graph", {k: np.asarray(v)
                                        for k, v in jg.payload().items()},
                              "cpu")


@pytest.mark.parametrize("source", ["store", "carry"])
def test_dst_copy_is_the_stable_dst_order(source, rng):
    jg, tg = _skewed_graph(rng)
    g = _payload(source, jg, tg)
    indices = np.asarray(jg.payload()["indices"])
    order = np.argsort(indices, kind="stable")
    for key, base in DST_KEYS.items():
        want = np.asarray(jg.payload()[base])[order]
        assert g[key].dtype == g[base].dtype, key
        np.testing.assert_array_equal(g[key].numpy(), want, err_msg=key)
    assert np.all(np.diff(g["dst_dst"].numpy()) >= 0)


@pytest.mark.parametrize("hops", [1, 2, 3])
def test_expand_frontier_kernel_path_is_bitwise_the_plain_path(hops, rng):
    jg, tg = _skewed_graph(rng)
    g = tg.payload("cpu")
    x = torch.from_numpy((rng.rand(tg.n_nodes) < 0.3).astype(np.float32)
                         * rng.rand(tg.n_nodes).astype(np.float32))
    got = tgraph.expand_frontier(g, x, hops=hops, use_kernel=True)
    want = tgraph.expand_frontier(g, x, hops=hops, use_kernel=False)
    assert torch.equal(got, want)


@pytest.mark.parametrize("personalized", [False, True])
@pytest.mark.parametrize("source", ["store", "carry"])
def test_pagerank_kernel_path_is_bitwise_the_plain_path(personalized, source,
                                                        rng):
    jg, tg = _skewed_graph(rng)
    g = _payload(source, jg, tg)
    p = (torch.from_numpy(rng.rand(tg.n_nodes).astype(np.float32))
         if personalized else None)
    got = tgraph.pagerank(g, iters=8, personalization=p, use_kernel=True)
    want = tgraph.pagerank(g, iters=8, personalization=p, use_kernel=False)
    assert torch.equal(got, want)


def test_kernel_path_needs_the_dst_copy(rng):
    _, tg = _skewed_graph(rng)
    g = {k: v for k, v in tg.payload("cpu").items() if k not in DST_KEYS}
    x = torch.ones(tg.n_nodes)
    with pytest.raises(ValidationError, match="dst-ordered"):
        tgraph.expand_frontier(g, x, use_kernel=True)
    with pytest.raises(ValidationError, match="dst-ordered"):
        tgraph.pagerank(g, iters=2, use_kernel=True)
    # the plain path and the block-skipping SpMV read the CSR order only
    tgraph.expand_frontier(g, x, use_kernel=False)
    tgraph.expand_frontier_blockskip(g, x)
    tgraph.pagerank(g, iters=2, personalization=x, skip_first=True)


def test_with_dst_order_keeps_the_csr_arrays(rng):
    _, tg = _skewed_graph(rng)
    g = tg.payload("cpu")
    before = {k: g[k].clone() for k in ("indptr", "indices", "src",
                                        "weights", "out_deg")}
    assert tgraph.with_dst_order(g) is g
    for k, v in before.items():
        assert torch.equal(g[k], v), k


class _FakeEntry:
    """A C entry that counts how often ctypes types it."""

    def __init__(self):
        self.typings = 0
        self._argtypes = None
        self.restype = None

    @property
    def argtypes(self):
        return self._argtypes

    @argtypes.setter
    def argtypes(self, value):
        self.typings += 1
        self._argtypes = value

    def __call__(self, *args):
        return 0


def test_entry_types_a_symbol_once(monkeypatch):
    lib = type("FakeLib", (), {})()
    lib.probe_i32 = _FakeEntry()
    monkeypatch.setitem(build._LIBS, "fake_probe", lib)
    monkeypatch.setattr(build, "_ENTRIES", {})
    loads = []
    real_load = build.load
    monkeypatch.setattr(build, "load",
                        lambda name: loads.append(name) or real_load(name))
    args = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int)
    first = build.entry("fake_probe", "probe_i32", *args)
    second = build.entry("fake_probe", "probe_i32", *args)
    assert first is second is lib.probe_i32
    assert lib.probe_i32.typings == 1 and loads == ["fake_probe"]
    assert lib.probe_i32.argtypes == list(args)
    assert lib.probe_i32.restype is ctypes.c_int

