"""State carry-over: store payloads given as numpy arrays, made into the
port's payloads.

This system has no weights; its stores are the state.  A payload of the
reference package, read out as numpy arrays (``np.asarray`` of each
relation column, ``valid`` and ``count``, or of each leaf of a graph or
corpus payload dict), becomes the port's payload on ``device`` here, so
both packages can compute on identical data.

A graph payload's dst-ordered edge copy (``dst_src``, ``dst_dst``,
``dst_w``; see :mod:`.graph_store`) is not carried: the reference's five
CSR arrays are, and the copy is derived from them on ``device``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.executor import resolve_device
from ..core.ir import ValidationError
from .bounded import BoundedRel
from .graph_store import with_dst_order
from .text_store import text_payload

_GRAPH_KEYS = ("indptr", "indices", "src", "weights", "out_deg")
_TEXT_KEYS = ("doc_ids", "term_ids", "tf", "doc_len", "idf")


def _tensor(a, device):
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def payload_from_numpy(kind: str, arrays: dict, device="cuda"):
    """The port's payload of one store from its numpy arrays.

    * ``kind="table"``: ``arrays = {"cols": {name: array}, "valid": array,
      "count": scalar, "overflow": scalar (optional)}`` -> BoundedRel;
    * ``kind="graph"``: the five arrays of a CSR payload
      (``indptr``, ``indices``, ``src``, ``weights``, ``out_deg``); the
      dst-ordered edge copy is added on ``device``;
    * ``kind="corpus"``: the five arrays of a corpus payload
      (``doc_ids``, ``term_ids``, ``tf``, ``doc_len``, ``idf``), postings
      sorted by document.
    """
    dev = resolve_device(device)
    if kind == "table":
        valid = _tensor(np.asarray(arrays["valid"], bool), dev)
        count = _tensor(np.asarray(arrays["count"], np.int32), dev)
        ovf = arrays.get("overflow")
        return BoundedRel(
            {k: _tensor(v, dev) for k, v in arrays["cols"].items()},
            valid, count,
            None if ovf is None else _tensor(np.asarray(ovf, bool), dev))
    if kind == "graph":
        missing = [k for k in _GRAPH_KEYS if k not in arrays]
        if missing:
            raise ValidationError(f"graph payload lacks {missing}")
        return with_dst_order({k: _tensor(arrays[k], dev)
                               for k in _GRAPH_KEYS})
    if kind == "corpus":
        missing = [k for k in _TEXT_KEYS if k not in arrays]
        if missing:
            raise ValidationError(f"corpus payload lacks {missing}")
        return text_payload(*(np.asarray(arrays[k]) for k in _TEXT_KEYS),
                            device=dev)
    raise ValidationError(f"unknown store kind {kind!r}: use 'table', "
                          f"'graph' or 'corpus'")
