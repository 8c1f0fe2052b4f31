"""The PoliSci tri-store of the reference's ``build_social_data``
(``examples/tri_model_analysis.py``): tweets with a user, a hashtag
(Zipf 1.3 taken mod the hashtags), a document id and a gamma(2, 12)
engagement; the hashtag co-mention graph from consecutive tweets of one
user that name different hashtags (mirrored by the store); one document a
tweet of 3-11 terms drawn Zipf 1.4 taken mod the vocabulary.

Sizes (the config's ``sizes``): ``tweets``, ``users``, ``hashtags``,
``vocab``, ``terms_lo`` / ``terms_hi`` (``randint``'s bounds),
``zipf_support``.
"""
import torch

from tribench import gen


def draw(sizes: dict, g, device) -> dict:
    n, tags, vocab = sizes["tweets"], sizes["hashtags"], sizes["vocab"]
    support = sizes["zipf_support"]
    user = gen.randint(g, 0, sizes["users"], n, device)
    tag = gen.zipf_mod(g, 1.3, n, tags, support, device)
    engagement = gen.gamma2(g, 12.0, n, device)
    lens = gen.randint(g, sizes["terms_lo"], sizes["terms_hi"], n, device)
    terms = gen.zipf_mod(g, 1.4, int(lens.sum()), vocab, support, device)
    # co-mention edges: consecutive tweets of one user, different tags
    order = torch.sort(user, stable=True).indices
    u, t = user[order], tag[order]
    sel = (u[1:] == u[:-1]) & (t[1:] != t[:-1])
    return {"table": {"user": user, "hashtag": tag,
                      "doc": torch.arange(n, dtype=torch.int32,
                                          device=device),
                      "engagement": engagement},
            "edges": (t[:-1][sel], t[1:][sel]), "nodes": tags,
            "terms": terms, "lens": lens, "vocab": vocab}
