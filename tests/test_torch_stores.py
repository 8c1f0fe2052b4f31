"""The port's store functions against the reference package's, on the same
numpy inputs (the reference's payloads carried over with
``payload_from_numpy``).

Tolerances: ids, counts, validity and top-k order exact; float sums
``rtol=1e-5, atol=1e-6``.
"""
from dataclasses import astuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# two intra-op threads: the suite runs beside other test workers
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.stores import bounded as jbounded  # noqa: E402
from repro.stores import column_store as jcol  # noqa: E402
from repro.stores import graph_store as jgraph  # noqa: E402
from repro.stores import text_store as jtext  # noqa: E402
from repro_torch.stores import (BoundedRel, ColumnStore,  # noqa: E402
                                GraphStore, TextStore, compact_rel,
                                payload_from_numpy)
from repro_torch.stores import column_store as tcol  # noqa: E402
from repro_torch.stores import graph_store as tgraph  # noqa: E402
from repro_torch.stores import text_store as ttext  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("cmp", ["eq", "ne", "lt", "le", "gt", "ge"])
def test_filter_mask(cmp, rng):
    col = rng.randint(0, 10, 500).astype(np.int32)
    got = tcol.filter_mask(torch.from_numpy(col), cmp, 4)
    np.testing.assert_array_equal(
        _np(got), _np(jcol.filter_mask(jnp.asarray(col), cmp, 4)))


@pytest.mark.parametrize("n_left,n_right", [(300, 200), (50, 0), (1, 1)])
def test_hash_join(n_left, n_right, rng):
    rkeys = rng.permutation(400)[:n_right].astype(np.int32)
    lkeys = rng.randint(0, 400, n_left).astype(np.int32)
    idx, matched = tcol.hash_join(torch.from_numpy(lkeys),
                                  torch.from_numpy(rkeys))
    jidx, jmatched = jcol.hash_join(jnp.asarray(lkeys), jnp.asarray(rkeys))
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(_np(matched), _np(jmatched))
    np.testing.assert_array_equal(_np(idx), _np(jidx))


@pytest.mark.parametrize("fn", ["count", "sum", "mean", "max"])
def test_group_agg(fn, rng):
    keys = rng.randint(-1, 40, 1000).astype(np.int32)   # -1: dropped
    vals = rng.randn(1000).astype(np.float32)
    mask = rng.rand(1000) < 0.7
    got = tcol.group_agg(torch.from_numpy(vals), torch.from_numpy(keys),
                         37, torch.from_numpy(mask), fn)
    want = jcol.group_agg(jnp.asarray(vals), jnp.asarray(keys), 37,
                          jnp.asarray(mask), fn)
    if fn == "max":
        np.testing.assert_array_equal(_np(got[1]), _np(want[1]))
        got, want = got[0], want[0]
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)


def _graph(rng, n=150, e=900):
    src = rng.randint(0, n, e)
    dst = rng.randint(0, n, e)
    w = rng.rand(e).astype(np.float32)
    jg = jgraph.GraphStore.from_edges(src, dst, n, weights=w, symmetric=True)
    tg = GraphStore.from_edges(src, dst, n, weights=w, symmetric=True)
    return jg, tg


def test_graph_store_arrays_and_carry_over(rng):
    jg, tg = _graph(rng)
    jp = jg.payload()
    tp = tg.payload("cpu")
    carried = payload_from_numpy("graph", {k: np.asarray(v)
                                           for k, v in jp.items()}, "cpu")
    assert astuple(tg.type) == astuple(jg.type)
    for k in jp:
        np.testing.assert_array_equal(_np(tp[k]), np.asarray(jp[k]))
        np.testing.assert_array_equal(_np(carried[k]), np.asarray(jp[k]))


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("hops", [1, 2])
def test_expand_frontier(use_kernel, hops, rng):
    jg, tg = _graph(rng)
    x = (rng.rand(jg.n_nodes) < 0.2).astype(np.float32)
    got = tgraph.expand_frontier(tg.payload("cpu"), torch.from_numpy(x),
                                 hops=hops, use_kernel=use_kernel)
    want = jgraph.expand_frontier(jg.payload(), jnp.asarray(x), hops=hops,
                                  use_pallas=use_kernel, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("personalized", [False, True])
def test_pagerank(use_kernel, personalized, rng):
    jg, tg = _graph(rng)
    p = rng.rand(jg.n_nodes).astype(np.float32) if personalized else None
    got = tgraph.pagerank(tg.payload("cpu"), iters=8, damping=0.85,
                          personalization=None if p is None
                          else torch.from_numpy(p), use_kernel=use_kernel)
    want = jgraph.pagerank(jg.payload(), iters=8, damping=0.85,
                           personalization=None if p is None
                           else jnp.asarray(p), use_pallas=use_kernel,
                           interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)


def _docs(rng, n=300, vocab=64, dup=True):
    docs = [rng.zipf(1.4, rng.randint(0, 9)) % vocab for _ in range(n)]
    if dup:
        # duplicate docs score equally, so the top-k set is decided by the
        # tie order (lower doc id first)
        for i in range(0, n, 7):
            docs[i] = docs[3].copy()
        docs[n - 1] = docs[3].copy()
    return docs


def test_text_store_from_docs_equals_reference(rng):
    docs = _docs(rng)
    j, t = jtext.TextStore.from_docs(docs, 64), TextStore.from_docs(docs, 64)
    for name in ("doc_ids", "term_ids", "tf", "doc_len", "idf"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert astuple(t.type) == astuple(j.type)
    with pytest.raises(Exception, match="doc 2"):
        TextStore.from_docs([[1], [2], [64]], 64)


def _corpora(rng, dup=True):
    docs = _docs(rng, dup=dup)
    j = jtext.TextStore.from_docs(docs, 64)
    carried = payload_from_numpy(
        "corpus", {k: np.asarray(v) for k, v in j.payload().items()}, "cpu")
    q = np.zeros(64, np.float32)
    q[[0, 1, 1, 2, 5, 9]] += 1.0
    return j.payload(), carried, q


def test_tfidf_scores(rng):
    jp, tp, q = _corpora(rng)
    got = ttext.tfidf_scores(tp, torch.from_numpy(q))
    want = jtext.tfidf_scores(jp, jnp.asarray(q))
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k", [1, 16, 64, 1000])
@pytest.mark.parametrize("dup", [True, False])
def test_tfidf_topk_tie_order_equals_lax_top_k(k, dup, rng):
    jp, tp, q = _corpora(rng, dup=dup)
    ids, vals, valid = ttext.tfidf_topk(tp, torch.from_numpy(q), k)
    jids, jvals, jvalid = jtext.tfidf_topk(jp, jnp.asarray(q), k)
    np.testing.assert_array_equal(_np(ids), _np(jids))
    np.testing.assert_allclose(_np(vals), _np(jvals), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(_np(valid), _np(jvalid))
    if dup and k >= 64:
        # equal docs got bitwise-equal scores, and the lower id ranks first
        s = _np(ttext.tfidf_scores(tp, torch.from_numpy(q)))
        assert s[3] == s[7] == s[299]
        order = list(_np(ids))
        if 299 in order:
            assert order.index(3) < order.index(7) < order.index(299)


def _rel(rng, n=200):
    cols = {"a": rng.randint(0, 9, n).astype(np.int32),
            "b": rng.randn(n).astype(np.float32)}
    valid = rng.rand(n) < 0.4
    return cols, valid


@pytest.mark.parametrize("cap", [None, 1, 50, 150])
def test_compact_rel(cap, rng):
    cols, valid = _rel(rng)
    jrel = jbounded.compact_rel(jbounded.BoundedRel(
        {k: jnp.asarray(v) for k, v in cols.items()}, jnp.asarray(valid)),
        cap)
    trel = compact_rel(payload_from_numpy(
        "table", {"cols": cols, "valid": valid, "count": valid.sum()},
        "cpu"), cap)
    np.testing.assert_array_equal(_np(trel.valid), np.asarray(jrel.valid))
    assert int(trel.count) == int(jrel.count)
    assert bool(trel.overflow) == bool(jrel.overflow)
    for k in cols:
        np.testing.assert_array_equal(_np(trel.cols[k]),
                                      np.asarray(jrel.cols[k]))


def test_column_store_payload_equals_reference(rng):
    cols = {"x": rng.randint(0, 5, 40).astype(np.int64),
            "y": rng.randn(40)}
    j = jcol.ColumnStore(cols, capacity=48)
    t = ColumnStore(cols, capacity=48)
    jp, tp = j.payload(), t.payload("cpu")
    assert isinstance(tp, BoundedRel)
    assert astuple(t.type) == astuple(j.type)
    for k in cols:
        assert _np(tp.cols[k]).dtype == np.asarray(jp.cols[k]).dtype
        np.testing.assert_array_equal(_np(tp.cols[k]), np.asarray(jp.cols[k]))
    np.testing.assert_array_equal(_np(tp.valid), np.asarray(jp.valid))
    assert int(tp.count) == int(jp.count) == 40
