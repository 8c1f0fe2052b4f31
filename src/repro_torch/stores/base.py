"""Tri-store foundation: the three store engines.

AWESOME's tri-store registers a relational, a graph, and a text engine with
the mediator and plans *across* them (paper §2).  Each store is a **named
engine** in the port's engine registry — candidate generation and
cost-model selection gate store candidates on the engine names exactly as
they gate the ``pallas`` kernel slot — and a **host-side container** whose
``payload(device=...)`` puts the store's tensors on the device and whose
``type`` (TableT / GraphT / CorpusT) is the metadata the planner prices
cross-engine movement with.
"""
from __future__ import annotations

from ..core.engines import register_engine

# the three store engines of the paper's tri-store, registered alongside
# xla/pallas so planning options can name them (engines=("xla", "rel", ...))
REL_ENGINE = register_engine(
    "rel", "columnar relational store: struct-of-tensor tables with "
           "filter/project/hash-join/group-agg")
GRAPH_ENGINE = register_engine(
    "graph", "CSR graph store: frontier expansion and PageRank iteration "
             "(plain scatter; the CUDA kernel registers under the pallas "
             "engine)")
TEXT_ENGINE = register_engine(
    "text", "inverted-index text store: tokenized corpus with top-k TF-IDF "
            "scoring")

STORE_ENGINE_NAMES = ("rel", "graph", "text")


def store_engines(*, pallas: bool = False) -> tuple:
    """The engine tuple a tri-model analysis plans against: the interpreter
    engine, the three store engines, and optionally the kernel slot."""
    base = ("xla",) + STORE_ENGINE_NAMES
    return base + ("pallas",) if pallas else base
