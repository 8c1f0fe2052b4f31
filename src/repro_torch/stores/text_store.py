"""Inverted-index text store: tokenized corpus + top-k TF-IDF scoring.

The port's counterpart of the reference package's ``stores/text_store.py``.
The corpus is stored as the COO of its term-document matrix — one
``(doc_id, term_id, tf)`` triple per posting, sorted by document — plus
per-document lengths and the idf table.  Scoring a dense query vector is

    score[d] = Σ_{postings (d, t)}  q[t] · idf[t] · tf[d,t] / len[d]

followed by a top-k over documents, handed back as a (k,)-row relation.

Two choices keep the ranking equal to the reference's and stable from run
to run on the card:

  * each document's contributions are summed **in posting order**, one
    elementwise pass per posting rank (:func:`tfidf_scores`).  Elementwise
    float adds are correctly rounded and ordered on every device, so equal
    documents get bitwise-equal scores; a scatter with atomics would not;
  * the top-k is a stable descending sort, so ties go to the lower doc id,
    as ``lax.top_k`` breaks them.

Under a pushed candidate-doc mask (:func:`masked_topk`) masked documents
rank last; the dense (:func:`tfidf_topk_masked`), block-skipping
(:func:`tfidf_topk_blockskip`) and kernel (``masked_tfidf``) realizations
score every kept document with the same ordered sum, so all three give
bitwise-equal results.
"""
from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch

from ..core.executor import resolve_device
from ..core.ir import CorpusT, ValidationError
from ..core.ledger import register_store_payload
from ..core.tracing import tree_bytes
from ..kernels.masked_kernels import ordered_doc_sum


class TextStore:
    """Host-side container: tokenized documents -> inverted-index COO."""

    def __init__(self, doc_ids, term_ids, tf, doc_len, idf, vocab: int):
        self.doc_ids = np.asarray(doc_ids, np.int32)
        self.term_ids = np.asarray(term_ids, np.int32)
        self.tf = np.asarray(tf, np.float32)
        self.doc_len = np.asarray(doc_len, np.float32)
        self.idf = np.asarray(idf, np.float32)
        self.vocab = int(vocab)
        self.n_docs = int(self.doc_len.shape[0])
        self.n_postings = int(self.doc_ids.shape[0])
        self.version = 0

    @staticmethod
    def _index_flat(terms: np.ndarray, lengths: np.ndarray, vocab: int,
                    first_doc: int = 0):
        """Vectorized indexing of ``len(lengths)`` documents whose term ids
        lie back to back in ``terms``: one sort of the (doc, term) keys
        gives every document's unique terms in ascending order with their
        counts — the postings the reference builds one document at a time.
        """
        terms = np.asarray(terms, np.int64)
        lengths = np.asarray(lengths, np.int64)
        n = int(lengths.shape[0])
        if terms.size and (terms.min() < 0 or terms.max() >= vocab):
            bad = np.flatnonzero((terms < 0) | (terms >= vocab))[0]
            doc = int(np.searchsorted(np.cumsum(lengths), bad, side="right"))
            raise ValidationError(
                f"doc {first_doc + doc}: term id out of range")
        doc = np.repeat(np.arange(n, dtype=np.int64), lengths)
        keys, tfs = np.unique(doc * vocab + terms, return_counts=True)
        doc_ids, term_ids = np.divmod(keys, vocab)
        doc_len = np.maximum(lengths, 1).astype(np.float32)
        df = np.bincount(term_ids, minlength=vocab).astype(np.int64)
        return doc_ids, term_ids, tfs, doc_len, df

    @staticmethod
    def _idf(n_docs: int, df: np.ndarray) -> np.ndarray:
        return (np.log((1.0 + n_docs) / (1.0 + df)) + 1.0)  # smoothed idf

    @classmethod
    def from_flat(cls, terms, lengths, vocab: int) -> "TextStore":
        """``terms``: every document's term ids back to back; ``lengths``:
        the term count of each document."""
        doc_ids, term_ids, tfs, doc_len, df = cls._index_flat(
            terms, lengths, vocab)
        return cls(doc_ids, term_ids, tfs, doc_len,
                   cls._idf(len(lengths), df), vocab)

    @classmethod
    def from_docs(cls, docs: Sequence[Iterable[int]],
                  vocab: int) -> "TextStore":
        """``docs``: one iterable of term ids per document."""
        return cls.from_flat(*_flatten(docs), vocab)

    def append(self, docs: Sequence[Iterable[int]]) -> "TextStore":
        """Append documents (one iterable of term ids each) and reindex on
        the host: postings extend (doc ids continue from ``n_docs``) and
        the idf table is recomputed from the grown corpus's document
        frequencies, so the arrays equal a fresh ``from_flat`` over all the
        documents.
        Bumps ``version``; the next ``payload()`` carries the corpus to the
        device."""
        d_ids, t_ids, tfs, d_len, _df = self._index_flat(
            *_flatten(docs), self.vocab, self.n_docs)
        self.doc_ids = np.concatenate(
            [self.doc_ids, (d_ids + self.n_docs).astype(np.int32)])
        self.term_ids = np.concatenate([self.term_ids,
                                        t_ids.astype(np.int32)])
        self.tf = np.concatenate([self.tf, tfs.astype(np.float32)])
        self.doc_len = np.concatenate([self.doc_len, d_len])
        self.n_docs = int(self.doc_len.shape[0])
        self.n_postings = int(self.doc_ids.shape[0])
        df = np.bincount(self.term_ids, minlength=self.vocab)
        self.idf = self._idf(self.n_docs, df).astype(np.float32)
        self.version += 1
        return self

    @property
    def type(self) -> CorpusT:
        return CorpusT(self.n_docs, self.vocab, self.n_postings, None)

    def payload(self, device="cuda") -> dict:
        """The index on ``device`` (the card unless the caller asks for the
        CPU), registered in the default memory ledger."""
        out = text_payload(self.doc_ids, self.term_ids, self.tf,
                           self.doc_len, self.idf, resolve_device(device))
        return register_store_payload(
            self, out, "text_store",
            extra=tree_bytes([out[k] for k in PORT_KEYS]))

    def query_vector(self, terms: Iterable[int]) -> np.ndarray:
        """Dense (vocab,) query term-count vector for :func:`tfidf_scores`."""
        q = np.zeros(self.vocab, np.float32)
        for t in terms:
            q[int(t)] += 1.0
        return q


def _flatten(docs):
    """``(terms, lengths)``: the term ids of ``docs`` (one iterable per
    document) back to back, and each document's term count."""
    docs = [np.asarray(list(d), np.int64) for d in docs]
    lengths = np.array([d.size for d in docs], np.int64)
    flat = np.concatenate(docs) if docs else np.zeros(0, np.int64)
    return flat, lengths


# the keys text_payload adds to the reference's five arrays; the ledger
# adds their bytes to the predicted ones
PORT_KEYS = ("doc_ptr", "max_doc_postings")


def text_payload(doc_ids, term_ids, tf, doc_len, idf, device) -> dict:
    """A corpus payload on ``device`` from its host arrays.  Besides the
    reference's five arrays it carries ``doc_ptr`` (each document's first
    posting, CSR style) and ``max_doc_postings`` (a host int), which the
    ordered per-document sum needs without reading the device."""
    doc_ids = np.asarray(doc_ids, np.int32)
    n_docs = int(np.asarray(doc_len).shape[0])
    if doc_ids.size and np.any(np.diff(doc_ids) < 0):
        raise ValidationError("corpus postings must be sorted by doc id")
    per_doc = np.bincount(doc_ids, minlength=n_docs)
    doc_ptr = np.concatenate([[0], np.cumsum(per_doc)]).astype(np.int32)

    def dev(a, dt):
        return torch.from_numpy(np.require(a, dt, ["C", "W"])).to(device)

    return {
        "doc_ids": dev(doc_ids, np.int32),
        "term_ids": dev(term_ids, np.int32),
        "tf": dev(tf, np.float32),
        "doc_len": dev(doc_len, np.float32),
        "idf": dev(idf, np.float32),
        "doc_ptr": dev(doc_ptr, np.int32),
        "max_doc_postings": int(per_doc.max()) if per_doc.size else 0,
    }


# --------------------------------------------------------------------------
# scoring (pure functions over the payload)
# --------------------------------------------------------------------------


def tfidf_scores(corpus: dict, query: torch.Tensor) -> torch.Tensor:
    """TF-IDF score of every document against a dense query vector.  Pass
    ``j`` adds every document's ``j``-th posting, so each document sums its
    contributions in posting order (the order ``segment_sum`` uses on the
    CPU), and the result does not change from run to run."""
    w = query.to(torch.float32) * corpus["idf"]
    contrib = (w[corpus["term_ids"]] * corpus["tf"]
               / corpus["doc_len"][corpus["doc_ids"]])
    ptr = corpus["doc_ptr"]
    start, end = ptr[:-1], ptr[1:]
    scores = torch.zeros(start.shape[0], dtype=torch.float32,
                         device=contrib.device)
    last = max(int(contrib.shape[0]) - 1, 0)
    zero = torch.zeros((), dtype=torch.float32, device=contrib.device)
    for j in range(int(corpus["max_doc_postings"])):
        p = start + j
        scores = scores + torch.where(p < end,
                                      contrib[torch.clamp(p, max=last)], zero)
    return scores


def tfidf_topk(corpus: dict, query: torch.Tensor, k: int):
    """Top-k documents by TF-IDF: ``(doc ids, scores, valid)``, each of
    length ``min(k, n_docs)``.  Ties go to the lower doc id."""
    scores = tfidf_scores(corpus, query)
    k = min(int(k), int(scores.shape[0]))
    ids = torch.sort(scores, descending=True, stable=True).indices[:k]
    return (ids.to(torch.int32), scores[ids],
            torch.ones(k, dtype=torch.bool, device=scores.device))


def masked_topk(scores: torch.Tensor, doc_mask: torch.Tensor, k: int):
    """Top-k over ``scores`` restricted to ``doc_mask``: masked docs score
    ``-inf`` before a stable descending sort (ties to the lower doc id, as
    ``lax.top_k``); result rows whose slot holds a masked doc (k exceeds
    the kept count) come back ``valid=False`` with score 0.0, never
    ``-inf`` (a downstream mask-weighted sum would turn ``-inf * 0`` into
    NaN).  ``k`` is clamped to the doc count."""
    k = min(int(k), int(scores.shape[0]))
    neg = torch.where(doc_mask, scores,
                      torch.full_like(scores, -torch.inf))
    vals, ids = torch.sort(neg, descending=True, stable=True)
    vals, ids = vals[:k], ids[:k]
    valid = torch.isfinite(vals)
    return (ids.to(torch.int32), torch.where(valid, vals,
                                             torch.zeros_like(vals)), valid)


def tfidf_topk_masked(corpus: dict, query: torch.Tensor,
                      doc_mask: torch.Tensor, k: int):
    """Dense masked scoring: score the whole corpus, then mask + top-k (the
    always-available realization of a pushed mask, and the bitwise
    reference of the skipping ones)."""
    return masked_topk(tfidf_scores(corpus, query), doc_mask, k)


def tfidf_topk_blockskip(corpus: dict, query: torch.Tensor,
                         doc_mask: torch.Tensor, k: int, block: int = 8192):
    """Masked scoring that skips posting blocks whose docs are all masked.

    Postings are doc-sorted, so a block spans the doc range from its first
    to its last posting's doc, and a prefix sum over the mask tests each
    span in O(1), as in the reference.  Only documents with a posting in an
    active block are scored — every kept document is — each with the dense
    path's ordered float32 sum, so results are bitwise equal to
    :func:`tfidf_topk_masked`."""
    doc_ids = corpus["doc_ids"]
    n_docs, e = int(corpus["doc_len"].shape[0]), int(doc_ids.shape[0])
    scores = torch.zeros(n_docs, dtype=torch.float32,
                         device=corpus["doc_len"].device)
    if e == 0:
        return masked_topk(scores, doc_mask, k)
    b = max(8, min(int(block), e))
    first = doc_ids[::b].long()
    last = doc_ids[torch.clamp(torch.arange(b - 1, e + b - 1, b,
                                            device=doc_ids.device),
                               max=e - 1)].long()
    prefix = torch.cat([torch.zeros(1, dtype=torch.int64,
                                    device=doc_ids.device),
                        torch.cumsum(doc_mask.long(), 0)])
    active = (prefix[last + 1] - prefix[first]) > 0
    # a document is scored when the block of its first or of its last
    # posting is active; a kept document's blocks all are
    ptr = corpus["doc_ptr"].long()
    nonempty = ptr[1:] > ptr[:-1]
    touched = nonempty & (active[torch.clamp(ptr[:-1], max=e - 1) // b]
                          | active[torch.clamp(ptr[1:] - 1, min=0) // b])
    docs = torch.nonzero(touched).flatten()
    w = query.to(torch.float32) * corpus["idf"]
    # out of place: under torch.func.vmap a batched query's sums cannot be
    # written into the unbatched zeros (the same values as ``scores[docs]
    # = ...``)
    scores = scores.index_put((docs,), ordered_doc_sum(
        corpus["doc_ptr"], docs, corpus["term_ids"], corpus["tf"],
        corpus["doc_len"], w, corpus["max_doc_postings"]))
    return masked_topk(scores, doc_mask, k)
