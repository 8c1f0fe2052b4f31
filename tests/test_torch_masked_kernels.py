"""The port's three store kernels of the pushdown path against the
reference's Pallas kernels: masked TF-IDF, the join probe and prefix
compaction.

On the CPU a wrapper runs its kernel's plain PyTorch version, so these
tests hold that version against the reference Pallas kernel (interpret
mode) and the NumPy oracles of ``stores/ref.py``, on the same numpy inputs,
including the edge cases: no rows, everything masked, capacity overflow,
``out_capacity`` 0, invalid build rows and sizes that are not a multiple of
128.  Tolerance: scores ``rtol=1e-5, atol=1e-6`` against the reference
(summation order differs between frameworks), bitwise against the port's
own dense scoring; indices, flags and compacted words exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# two intra-op threads: the suite runs beside other test workers
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.stores import ref  # noqa: E402
from repro.stores.masked_kernels import (compact_prefix_pallas,  # noqa: E402
                                         join_probe_pallas,
                                         masked_tfidf_pallas)
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import (compact_prefix,  # noqa: E402
                                 compact_prefix_plain, join_probe,
                                 masked_tfidf)
from repro_torch.stores import TextStore  # noqa: E402
from repro_torch.stores.text_store import tfidf_scores  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6

# (docs, vocab, terms per doc up to, share of kept docs)
TFIDF_CASES = [(0, 8, 4, 0.5), (40, 8, 1, 0.5), (37, 16, 9, 0.5),
               (300, 64, 20, 1.0), (300, 64, 20, 0.0), (777, 128, 12, 0.05)]


def _corpus(seed, docs, vocab, terms_hi):
    r = np.random.RandomState(seed)
    lens = r.randint(0, terms_hi, docs) if terms_hi > 1 else np.zeros(
        docs, np.int64)
    flat = r.randint(0, vocab, int(lens.sum()))
    return TextStore.from_flat(flat, lens, vocab), r


@pytest.mark.parametrize("docs,vocab,terms_hi,keep", TFIDF_CASES)
def test_masked_tfidf_matches_pallas_and_ref(docs, vocab, terms_hi, keep):
    tx, r = _corpus(docs + vocab, docs, vocab, terms_hi)
    q = tx.query_vector(r.randint(0, vocab, 5))
    mask = r.rand(docs) < keep
    c = tx.payload("cpu")
    w = torch.from_numpy(q) * c["idf"]
    got = masked_tfidf(c["doc_ptr"], c["term_ids"], c["tf"], c["doc_len"], w,
                       torch.from_numpy(mask), c["max_doc_postings"])
    assert got.dtype == torch.float32 and got.shape == (docs,)
    wn = (q * tx.idf).astype(np.float32)
    want = masked_tfidf_pallas(
        jnp.asarray(tx.doc_ids), jnp.asarray(wn[tx.term_ids]),
        jnp.asarray(tx.tf), jnp.asarray(tx.doc_len[tx.doc_ids]),
        jnp.asarray(mask[tx.doc_ids].astype(np.float32)), n_docs=docs,
        interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    oracle = ref.masked_tfidf_scores_ref(tx.doc_ids, tx.term_ids, tx.tf,
                                         tx.doc_len, tx.idf, q, mask)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=RTOL, atol=ATOL)
    # a kept document scores bitwise as the dense ordered sum; masked ones 0
    dense = tfidf_scores(c, torch.from_numpy(q))
    m = torch.from_numpy(mask)
    assert torch.equal(got[m], dense[m])
    assert not got[~m].any()


def test_masked_tfidf_skips_masked_documents_whole():
    """An inf posting of a masked document reaches nothing: the port skips
    the document, where the reference multiplies its postings by 0 inside
    an active block (inf * 0 = NaN, which poisons the block's doc tile)."""
    tx, r = _corpus(3, 40, 16, 6)
    q = tx.query_vector(range(16))
    mask = np.arange(40) % 2 == 0
    bad = int(np.flatnonzero(~mask[tx.doc_ids])[0])
    tf = tx.tf.copy()
    tf[bad] = np.inf
    c = tx.payload("cpu")
    w = torch.from_numpy(q) * c["idf"]
    clean = masked_tfidf(c["doc_ptr"], c["term_ids"], c["tf"], c["doc_len"],
                         w, torch.from_numpy(mask), c["max_doc_postings"])
    got = masked_tfidf(c["doc_ptr"], c["term_ids"], torch.from_numpy(tf),
                       c["doc_len"], w, torch.from_numpy(mask),
                       c["max_doc_postings"])
    assert torch.equal(got, clean) and bool(torch.isfinite(got).all())
    wn = (q * tx.idf).astype(np.float32)
    want = masked_tfidf_pallas(
        jnp.asarray(tx.doc_ids), jnp.asarray(wn[tx.term_ids]),
        jnp.asarray(tf), jnp.asarray(tx.doc_len[tx.doc_ids]),
        jnp.asarray(mask[tx.doc_ids].astype(np.float32)), n_docs=40,
        interpret=True)
    assert not np.isfinite(np.asarray(want)).all()


# (build rows, probe rows, share of valid build rows)
PROBE_CASES = [(0, 50, 1.0), (30, 0, 1.0), (1, 1, 1.0), (37, 90, 0.7),
               (130, 777, 0.0), (4096, 1000, 0.5)]


@pytest.mark.parametrize("nr,p,valid", PROBE_CASES)
def test_join_probe_matches_pallas_and_ref(nr, p, valid):
    r = np.random.RandomState(nr + p)
    rk = r.permutation(3 * nr + 10)[:nr].astype(np.int32)   # unique keys
    rv = r.rand(nr) < valid
    lk = r.randint(0, 3 * nr + 10, p).astype(np.int32)
    gi, gm = join_probe(torch.from_numpy(lk), torch.from_numpy(rk),
                        torch.from_numpy(rv))
    assert gi.dtype == torch.int32 and gm.dtype == torch.bool
    pi, pm = join_probe_pallas(jnp.asarray(lk), jnp.asarray(rk),
                               jnp.asarray(rv), interpret=True)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(pm))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(pi))
    wi, wm = ref.join_probe_ref(lk, rk, rv)
    np.testing.assert_array_equal(gm.numpy(), wm)
    np.testing.assert_array_equal(gi.numpy(), wi)
    if valid == 0.0:
        assert not gm.any() and not gi.any()


def test_join_probe_on_repeated_valid_build_keys_returns_one_row():
    """Outside the unique-key contract: the port names one matching row;
    the reference's one-hot matmul returns the sum of their indices."""
    rk = np.array([5, 9, 5, 7], np.int32)
    rv = np.array([True, True, True, False])
    lk = np.array([5, 7, 9], np.int32)
    gi, gm = join_probe(torch.from_numpy(lk), torch.from_numpy(rk),
                        torch.from_numpy(rv))
    assert gm.tolist() == [True, False, True]
    assert int(gi[0]) in (0, 2) and int(gi[2]) == 1
    pi, _pm = join_probe_pallas(jnp.asarray(lk), jnp.asarray(rk),
                                jnp.asarray(rv), interpret=True)
    assert int(np.asarray(pi)[0]) == 0 + 2


# (columns, rows, share of kept rows, out_capacity)
COMPACT_CASES = [(3, 0, 0.5, 16), (3, 50, 0.5, 0), (2, 300, 0.0, 64),
                 (9, 777, 0.1, 200), (4, 500, 0.6, 100), (1, 129, 1.0, 129)]


@pytest.mark.parametrize("c,r,keep,cap", COMPACT_CASES)
def test_compact_prefix_matches_pallas_and_ref(c, r, keep, cap):
    rs = np.random.RandomState(c * 1000 + r)
    vals = rs.randn(c, r).astype(np.float32)
    valid = rs.rand(r) < keep
    pos = np.where(valid, np.cumsum(valid) - 1, -1).astype(np.int32)
    kp = valid.astype(np.float32)
    got = compact_prefix(torch.from_numpy(vals), torch.from_numpy(pos),
                         torch.from_numpy(kp), cap)
    assert got.dtype == torch.float32 and got.shape == (c, cap)
    want = compact_prefix_pallas(jnp.asarray(vals), jnp.asarray(pos),
                                 jnp.asarray(kp), out_capacity=cap,
                                 interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if cap and r:      # the oracle gathers row 0 for padding
        cols, out_valid, count, _ovf = ref.compact_ref(
            {i: vals[i] for i in range(c)}, valid, cap)
        for i in range(c):
            np.testing.assert_array_equal(got[i].numpy()[out_valid],
                                          cols[i][out_valid])
        assert not got[:, count:].any()      # overflow dropped, rest zero


def test_compact_prefix_moves_words_unchanged():
    """Signed zeros, NaN payloads and int32 words beyond 2^24 arrive
    bitwise: the compaction copies words, it does no arithmetic."""
    ints = np.array([2**31 - 1, -(2**24) - 3, 7, 2**24 + 1], np.int32)
    floats = np.array([-0.0, np.nan, 1.5, -2.0], np.float32)
    vals = torch.from_numpy(np.stack([ints.view(np.float32), floats]))
    keep = torch.tensor([1.0, 1.0, 0.0, 1.0])
    pos = torch.tensor([0, 1, -1, 2], dtype=torch.int32)
    out = compact_prefix(vals, pos, keep, 3)
    np.testing.assert_array_equal(out[0].numpy().view(np.int32),
                                  ints[[0, 1, 3]])
    np.testing.assert_array_equal(out[1].numpy().view(np.int32),
                                  floats[[0, 1, 3]].view(np.int32))


def test_cpu_tensors_never_launch_a_kernel():
    kernels.reset_launches()
    tx, r = _corpus(0, 50, 8, 5)
    c = tx.payload("cpu")
    masked_tfidf(c["doc_ptr"], c["term_ids"], c["tf"], c["doc_len"],
                 c["idf"], torch.ones(50, dtype=torch.bool),
                 c["max_doc_postings"])
    keys = torch.arange(20, dtype=torch.int32)
    join_probe(keys, keys[:8], torch.ones(8, dtype=torch.bool))
    compact_prefix(torch.rand(2, 20), keys, torch.ones(20), 10)
    assert kernels.launches() == {k.__name__: 0 for k in kernels.KERNELS}


def test_non_cpu_tensors_never_take_the_plain_version():
    """A tensor off the CPU goes to the kernel or raises: here meta tensors
    (no card on this machine) are refused, not computed plainly."""
    kernels.reset_launches()
    f = torch.zeros(8, device="meta")
    i = torch.zeros(8, dtype=torch.int32, device="meta")
    b = torch.zeros(8, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        masked_tfidf(torch.zeros(9, dtype=torch.int32, device="meta"), i, f,
                     f, f, b, 1)
    with pytest.raises(ValueError):
        join_probe(i, i, b)
    with pytest.raises(ValueError):
        compact_prefix(torch.zeros(2, 8, device="meta"), i, f, 4)
    # one tensor on the CPU and one off it: refused as well
    with pytest.raises(ValueError):
        join_probe(torch.zeros(8, dtype=torch.int32), i, b)
    assert kernels.launches() == {k.__name__: 0 for k in kernels.KERNELS}


def test_compact_plain_drops_rows_past_capacity():
    vals = torch.tensor([[1.0, 2.0, 4.0, 8.0]])
    pos = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    out = compact_prefix_plain(vals, pos, torch.tensor([1., 0., 1., 1.]), 3)
    assert out.tolist() == [[1.0, 0.0, 4.0]]
