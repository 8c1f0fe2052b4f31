"""Token embedding and unembedding (the port of the reference's
``layers/embedding.py``; the loss head waits for the training slice)."""
from __future__ import annotations

import torch

from .common import he_init


def init_embedding(gen, vocab, embed, dtype=torch.float32, tied=True):
    p = {"table": he_init(gen, (vocab, embed), embed, dtype)}
    if not tied:
        p["head"] = he_init(gen, (embed, vocab), embed, dtype)
    return p


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
