"""The one generator: seeded draws on the device, and traffic from a mix.

Data.  Every draw takes a ``torch.Generator`` on the run's device, seeded
from ``--seed``, and makes its array in a few large calls, so a data set
of 10M tweets is drawn on the card in a fraction of a second and the same
seed gives the same arrays.  The distributions are the reference
generator's (``examples/tri_model_analysis.py``); the draws are not
numpy ``RandomState``'s.

  * :func:`zipf_mod` — ``zipf(a) % m`` by inverse CDF over the residues:
    the pmf ``k**-a`` of ``k = 1 .. support`` is folded onto ``k % m``,
    and the mass beyond ``support`` (``(support + 1/2)**(1-a) / (a-1)``,
    the Euler-Maclaurin tail) is spread evenly over the residues;
  * :func:`gamma2` — ``gamma(2, scale)`` as ``scale`` times the sum of two
    unit exponentials (exact for shape 2);
  * :func:`randint`, :func:`rand`.

Traffic.  A mix file (``traffic/<name>.json``) names its loop and what
each analyst sends; :func:`QueryStream` draws every query vector from the
seed, and :func:`round_specs` / :func:`solo_spec` lay out what is sent.
Every seed sends the same analyses in the same order: only the query
terms differ, never the sizes.
"""
from __future__ import annotations

import numpy as np
import torch

SEED_MOD = 1 << 63
CHUNK = 1 << 24                 # draws per call in zipf_mod
# independent streams drawn from one --seed
STREAM_DATA, STREAM_WINDOW, STREAM_WARMUP, STREAM_SAMPLE = 0, 1, 2, 3


def generator(seed: int, device, stream: int = STREAM_DATA):
    """A torch generator on ``device`` for ``(seed, stream)``."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 4 + stream) % SEED_MOD)
    return g


def numpy_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % SEED_MOD, stream])


def zipf_mod(gen, a: float, n: int, m: int, support: int, device):
    """``n`` draws of ``zipf(a) % m`` as int32 (see the module note)."""
    if support % m:
        raise ValueError(f"support {support} is not a multiple of {m}")
    k = torch.arange(1, support + 1, dtype=torch.float64, device=device)
    # row i, column j holds k = i*m + j + 1, whose residue is (j + 1) % m
    folded = torch.roll((k ** -a).view(support // m, m).sum(0), 1)
    folded += (support + 0.5) ** (1.0 - a) / (a - 1.0) / m
    cdf = torch.cumsum(folded, 0)
    cdf /= cdf[-1].clone()
    out = torch.empty(n, dtype=torch.int32, device=device)
    for lo in range(0, n, CHUNK):     # chunks keep the float64 draws small
        u = torch.rand(min(CHUNK, n - lo), generator=gen,
                       dtype=torch.float64, device=device)
        idx = torch.searchsorted(cdf, u, right=True)
        out[lo:lo + u.shape[0]] = torch.clamp_(idx, max=m - 1)
    return out


def gamma2(gen, scale: float, n: int, device):
    """``n`` draws of ``gamma(2, scale)`` as float32."""
    e = torch.empty((2, n), dtype=torch.float64, device=device)
    e.exponential_(generator=gen)
    return (e.sum(0) * scale).to(torch.float32)


def randint(gen, lo: int, hi: int, n: int, device):
    """``n`` int32 draws from ``[lo, hi)``."""
    return torch.randint(lo, hi, (n,), generator=gen, dtype=torch.int32,
                         device=device)


def rand(gen, n: int, device):
    return torch.rand(n, generator=gen, dtype=torch.float32, device=device)


# -- traffic ----------------------------------------------------------------


class QueryStream:
    """Query vectors: ``terms`` term ids drawn uniformly from the
    vocabulary (the reference's ``rng.randint(0, vocab, 6)``), as a dense
    float32 term-count vector.  One stream per purpose, from the seed."""

    def __init__(self, seed: int, stream: int, vocab: int, terms: int):
        self.rng = numpy_rng(seed, stream)
        self.vocab, self.terms = int(vocab), int(terms)

    def terms_next(self) -> np.ndarray:
        return self.rng.integers(0, self.vocab, self.terms)

    def vector(self, terms) -> np.ndarray:
        return query_vector(terms, self.vocab)


def query_vector(terms, vocab: int) -> np.ndarray:
    q = np.zeros(vocab, np.float32)
    np.add.at(q, np.asarray(terms, np.int64), 1.0)
    return q


def check_mix(mix: dict) -> None:
    """Refuse a mix the generator cannot read."""
    loop = mix.get("loop")
    if loop == "sequential":
        if not mix.get("cycle"):
            raise ValueError("a sequential mix needs a 'cycle' of analyses")
    elif loop == "rounds":
        if not mix.get("groups"):
            raise ValueError("a rounds mix needs 'groups'")
        for g in mix["groups"]:
            if g.get("query") not in ("own", "shared"):
                raise ValueError(f"group query {g.get('query')!r}: "
                                 f"'own' or 'shared'")
            if int(g.get("analysts", 0)) < 1:
                raise ValueError("a group needs analysts >= 1")
    else:
        raise ValueError(f"unknown loop {loop!r}")
    if int(mix.get("query_terms", 0)) < 1:
        raise ValueError("a mix needs query_terms >= 1")


def variants(mix: dict) -> list:
    """Every ``(analysis, params)`` pair the mix sends, in first-use
    order, without repeats: one compiled plan each."""
    entries = (mix["cycle"] if mix["loop"] == "sequential"
               else mix["groups"])
    out = []
    for e in entries:
        key = (e["analysis"], tuple(sorted(e.get("params", {}).items())))
        if key not in out:
            out.append(key)
    return out


def solo_spec(mix: dict, i: int):
    """The ``i``-th analysis of a sequential mix: ``(analysis, params)``;
    the cycle repeats."""
    e = mix["cycle"][i % len(mix["cycle"])]
    return e["analysis"], tuple(sorted(e.get("params", {}).items()))


def round_specs(mix: dict, queries: QueryStream) -> list:
    """One round of a rounds mix: per analyst ``(analysis, params,
    batch_param, terms)``.  A ``shared`` group's analysts send one query
    between them (exact twins); an ``own`` group's each draw theirs."""
    out = []
    for g in mix["groups"]:
        key = (g["analysis"], tuple(sorted(g.get("params", {}).items())))
        shared = queries.terms_next() if g["query"] == "shared" else None
        for _ in range(int(g["analysts"])):
            terms = shared if shared is not None else queries.terms_next()
            out.append((*key, g.get("batch_param"), terms))
    return out
