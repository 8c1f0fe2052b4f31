"""The plain reference of the tri-store analyses, and the comparison.

Plain PyTorch and NumPy over the raw arrays the generator drew: it
imports nothing of ``repro_torch`` and takes nothing the program made.  It
builds its own tables, the mirrored edge list and the out-degrees, and
its own inverted index and idf, and computes each analysis's semantics
directly:

  * relational: a filter is a boolean mask over the columns, a group-by a
    sum into one slot per key, a join on ``doc`` a lookup through the
    column's own doc -> row map;
  * graph: one hop is ``y[dst] += x[src]`` over every mirrored edge;
    PageRank is the damped power iteration with out-degree normalisation
    and the expansion as personalisation;
  * text: ``score[d] = sum over d's postings of (q[t]·idf[t])·tf / len[d]``,
    each document summed in posting order (ascending term id), then a
    stable descending sort, so ties go to the lower document id.

Precision.  The configurations state float32.  The reference scores text
in float32 in the order above, which is the stated semantics of ties: a
different order of rounding can tie two documents that the stated order
does not, and so pick another top-k.  Everything it sums (graph hops,
PageRank, group-bys) it sums in float64.  The control
(``control=True``) computes all of it in bfloat16, the nearest precision
below float32.

:func:`gaps` gives the two numbers compared per analysis.  Every output
of these analyses is a graph part (a PageRank or an expansion, one value
a hashtag) plus a text part (the top hits' scores summed per hashtag,
zero outside the hashtags the hits name), each a sum of non-negative
terms, so each part is judged against its own magnitude.  The graph part
is a PageRank (a distribution, at most 1) and the text part a sum of
top scores (several units), so the float32 rounding of their sum stays
far below the text part that a fault would change.
"""
from __future__ import annotations

import numpy as np
import torch


def _dev(a, device, dtype=None):
    t = torch.as_tensor(a, device=device)
    return t if dtype is None else t.to(dtype)


class Reference:
    """The reference's own stores, built from the raw arrays ``raw`` (the
    generator's dict, host or device arrays)."""

    def __init__(self, raw: dict, device, *, control: bool = False):
        self.device = torch.device(device)
        self.text_dtype = torch.bfloat16 if control else torch.float32
        self.sum_dtype = torch.bfloat16 if control else torch.float64
        self.memo: dict = {}
        dev = self.device
        self.cols = {k: _dev(v, dev) for k, v in raw["table"].items()}
        self.rows = int(next(iter(self.cols.values())).shape[0])
        doc = self.cols["doc"].long()
        self.row_of_doc = torch.empty_like(doc)
        self.row_of_doc[doc] = torch.arange(self.rows, device=dev)
        # the graph, mirrored, and each node's out-degree (at least 1)
        self.nodes = int(raw["nodes"])
        s, d = (_dev(x, dev, torch.int64) for x in raw["edges"])
        self.src, self.dst = torch.cat([s, d]), torch.cat([d, s])
        deg = torch.bincount(self.src, minlength=self.nodes)
        self.out_deg = torch.clamp(deg, min=1).to(self.sum_dtype)
        self._index(_dev(raw["terms"], dev, torch.int64),
                    _dev(raw["lens"], dev, torch.int64), int(raw["vocab"]))

    def _index(self, terms, lens, vocab: int) -> None:
        """Postings: one per (document, distinct term), sorted by document
        and term; ``tf`` the term's count in the document."""
        n_docs = int(lens.shape[0])
        doc = torch.repeat_interleave(
            torch.arange(n_docs, device=self.device), lens)
        keys, tf = torch.unique(doc * vocab + terms, sorted=True,
                                return_counts=True)
        del doc
        self.doc_ids, self.term_ids = keys // vocab, keys % vocab
        del keys
        self.vocab, self.n_docs = vocab, n_docs
        per_doc = torch.bincount(self.doc_ids, minlength=n_docs)
        self.doc_ptr = torch.cat([torch.zeros(1, dtype=torch.int64,
                                              device=self.device),
                                  torch.cumsum(per_doc, 0)])
        self.max_postings = int(per_doc.max()) if n_docs else 0
        df = torch.bincount(self.term_ids, minlength=vocab).cpu().numpy()
        # the smoothed idf, as the deployment states it, in float64
        idf = np.log((1.0 + n_docs) / (1.0 + df.astype(np.float64))) + 1.0
        fdt = self.text_dtype
        self.idf = torch.from_numpy(idf.astype(np.float32)).to(
            self.device).to(fdt)
        self.tf = tf.to(torch.float32).to(fdt)
        self.doc_len = torch.clamp(lens, min=1).to(torch.float32).to(fdt)

    # -- graph ------------------------------------------------------------
    def hop(self, x):
        y = torch.zeros(self.nodes, dtype=self.sum_dtype, device=self.device)
        return y.index_add_(0, self.dst, x[self.src])

    def expand(self, frontier, hops: int):
        x = frontier.to(self.sum_dtype)
        for _ in range(int(hops)):
            x = self.hop(x)
        return x

    def pagerank(self, personalization, iters: int, damping: float):
        p = personalization.to(self.sum_dtype)
        p0 = p / torch.clamp(p.sum(), min=1e-30)
        r = p0
        for _ in range(int(iters)):
            r = (1.0 - damping) * p0 + damping * self.hop(r / self.out_deg)
        return r

    # -- relational ---------------------------------------------------------
    def count_by(self, key: str, rows_mask):
        keys = self.cols[key].long()[rows_mask]
        return torch.bincount(keys, minlength=self.nodes).to(self.sum_dtype)

    def sum_by_doc(self, key: str, docs, values):
        """Join ``(docs, values)`` to the table on ``doc`` and sum
        ``values`` per ``key``."""
        rows = self.row_of_doc[docs.long()]
        v = values.to(self.sum_dtype)
        out = torch.zeros(self.nodes, dtype=self.sum_dtype,
                          device=self.device)
        return out.index_add_(0, self.cols[key].long()[rows], v)

    # -- text ---------------------------------------------------------------
    def scores(self, q):
        """Every document's score, summed in posting order."""
        fdt = self.text_dtype
        w = _dev(q, self.device, torch.float32).to(fdt) * self.idf
        contrib = w[self.term_ids] * self.tf / self.doc_len[self.doc_ids]
        start, end = self.doc_ptr[:-1], self.doc_ptr[1:]
        last = max(int(contrib.shape[0]) - 1, 0)
        zero = torch.zeros((), dtype=fdt, device=self.device)
        out = torch.zeros(self.n_docs, dtype=fdt, device=self.device)
        for j in range(self.max_postings):
            p = start + j
            out = out + torch.where(p < end, contrib[torch.clamp(p, max=last)],
                                    zero)
        return out

    def topk(self, scores, k: int):
        """``(docs, scores)`` of the top ``k``, ties to the lower doc id."""
        vals, ids = torch.sort(scores, descending=True, stable=True)
        return ids[:k], vals[:k]


def gaps(prog, graph, text) -> dict:
    """The two numbers compared for one analysis's output ``prog``
    against the reference's parts, ``graph`` and ``text`` (either None for
    zeros), whose sum is the output:

      * ``graph_err``: at the hashtags the text part does not reach, the
        output is the graph part alone: the largest ``|prog - graph| /
        |graph|`` there (0 where both are 0, inf where only the reference
        is);
      * ``text_err``: at the hashtags it reaches, the largest
        ``|prog - (graph + text)| / text``.

    A non-finite output is inf."""
    p = torch.as_tensor(prog).to(torch.float64)
    ref = graph if graph is not None else text
    p = p.to(ref.device)
    g = (graph.to(torch.float64) if graph is not None
         else torch.zeros_like(p))
    t = (text.to(torch.float64) if text is not None
         else torch.zeros_like(p))
    if p.shape != g.shape or not bool(torch.isfinite(p).all()):
        return {"graph_err": float("inf"), "text_err": float("inf")}
    reach = t != 0
    gap_g = (p - g).abs()[~reach]
    g_out = g[~reach].abs()
    zero = g_out == 0
    if bool((gap_g[zero] > 0).any()):
        graph_err = float("inf")
    else:
        rel = gap_g[~zero] / g_out[~zero]
        graph_err = float(rel.max()) if rel.numel() else 0.0
    rel_t = (p - g - t).abs()[reach] / t[reach]
    text_err = float(rel_t.max()) if rel_t.numel() else 0.0
    return {"graph_err": graph_err, "text_err": text_err}
