"""AWESOME tri-store of the port: columnar relational, CSR graph, and
inverted-text stores, registered as planner engines.

Importing this package registers the ``rel``/``graph``/``text`` engines and
their physical-op implementations (``runtime``).
"""
from .base import (GRAPH_ENGINE, REL_ENGINE, STORE_ENGINE_NAMES, TEXT_ENGINE,
                   store_engines)
from .bounded import BoundedRel, as_bounded, compact_rel
from .carry import payload_from_numpy
from .column_store import ColumnStore
from .graph_store import GraphStore
from .text_store import TextStore
from . import runtime as _runtime  # noqa: F401  (impl registration)

__all__ = [
    "BoundedRel", "as_bounded", "compact_rel", "payload_from_numpy",
    "ColumnStore", "GraphStore", "TextStore", "store_engines",
    "STORE_ENGINE_NAMES", "REL_ENGINE", "GRAPH_ENGINE", "TEXT_ENGINE",
]
