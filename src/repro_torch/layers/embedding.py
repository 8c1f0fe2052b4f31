"""Token embedding, unembedding and the loss head (the port of the
reference's ``layers/embedding.py``)."""
from __future__ import annotations

import torch

from .common import he_init


def init_embedding(gen, vocab, embed, dtype=torch.float32, tied=True):
    p = {"table": he_init(gen, (vocab, embed), embed, dtype)}
    if not tied:
        p["head"] = he_init(gen, (embed, vocab), embed, dtype)
    return p


def embedding_specs(tied=True) -> dict:
    """The dim names of :func:`init_embedding`'s leaves."""
    s = {"table": ("vocab", "embed")}
    if not tied:
        s["head"] = ("embed", "vocab")
    return s


def embed(p, ids, *, scale=False):
    out = p["table"][ids]
    if scale:
        out = out * (p["table"].shape[-1] ** 0.5)
    return out


def unembed(p, x):
    """Logits in float32, as the reference (x and the head both cast)."""
    w = p.get("head")
    if w is None:
        w = p["table"].T
    return torch.matmul(x.float(), w.float())


def mask_padded_logits(logits, vocab):
    """Padding rows of a padded-vocab head must not leak probability mass."""
    ids = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(ids < vocab, logits,
                       torch.full((), -1e30, dtype=logits.dtype,
                                  device=logits.device))


def softmax_xent(logits, labels, *, ignore_index=-100):
    """Mean next-token cross-entropy over the labels that are not
    ``ignore_index``: logits (..., V) in their own dtype (float32 from
    :func:`unembed`), labels (...)."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    weight = valid.to(logits.dtype)
    return (logz - gold).mul(weight).sum() / weight.sum().clamp(min=1.0)
