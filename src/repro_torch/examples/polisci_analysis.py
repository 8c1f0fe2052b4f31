"""The PoliSci workload pattern (paper Fig. 1/3), in the ADIL-style builder
(the port of the reference's ``examples/polisci_analysis.py``).

The paper's PoliSci pipes a Solr text query into NER, joins against a
Postgres relation, and queries a Neo4j graph.  The tensor-world analogue
composes heterogeneous *engines* the same way: embed (lookup engine) ->
attention (the planner chooses full / banded / flash per the cost model)
-> mlp -> head.  One logical analysis, several candidate physical plans
per virtual node, the cost model's argmin at sizes-known time.  Runs on
the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.examples.polisci_analysis \
        --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.core.adil import Analysis
from repro_torch.core.executor import resolve_device
from repro_torch.core.ir import SystemCatalog, TensorT, standard_catalog
from repro_torch.layers import attention as A
from repro_torch.layers import mlp as F

B, S, E, VOCAB = 2, 64, 32, 512
ATTN = {"embed": E, "heads": 4, "kv_heads": 2, "head_dim": 8}
MLP = {"embed": E, "ffn": 64}


def init_params(gen) -> dict:
    """The analysis's parameters drawn from ``gen`` (a ``torch.Generator``
    on the device they are made on)."""
    return {"embed": {"table": torch.randn((VOCAB, E), generator=gen,
                                           device=gen.device) * 0.02},
            "attn": A.init_attention(gen, ATTN),
            "mlp": F.init_mlp(gen, MLP)}


def main(argv=None, *, params=None) -> dict:
    """Plans and runs the analysis; ``params`` replaces the seeded
    parameters.  Returns the planner's decisions, the chosen impls and
    the output (B, S, vocab)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain path)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cat = standard_catalog()

    with Analysis("polisci", cat) as a:
        toks = a.input("tokens", TensorT((B, S), "int32", ("batch", "seq")))
        h = a.op("embed", toks, vocab=VOCAB, embed=E, pp=("embed",),
                 dtype="float32")
        # "query the text store": long-context attention — the planner must
        # choose between full / banded / flash engines
        h = a.op("attention", h, heads=4, kv_heads=2, head_dim=8, embed=E,
                 window=16, pp=("attn",))
        # "join with the relation": an MLP mixing step
        h = a.op("mlp", h, ffn=64, embed=E, pp=("mlp",))
        # "aggregate pagerank per topic": the head's logits
        logits = a.op("unembed", h, vocab=VOCAB, pp=("embed",))
        a.store(logits)

    fn = a.compile(SystemCatalog(), engines=("xla", "pallas"), device=dev)
    print("planner decisions (virtual node -> chosen engine):")
    for r in fn.report:
        print(f"  [{r['pattern']}] -> {r['chosen']}   "
              f"costs={ {k: f'{v:.2e}' for k, v in r['costs'].items()} }")

    if params is None:
        params = init_params(torch.Generator(device=dev).manual_seed(0))
    tokens = torch.as_tensor(np.random.RandomState(0).randint(0, VOCAB,
                                                              (B, S)),
                             dtype=torch.int32, device=dev)
    out = fn(params, {"tokens": tokens})
    print(f"analysis output: shape={tuple(out.shape)} finite="
          f"{bool(torch.isfinite(out).all())}")
    return {"decisions": [(r["pattern"], r["chosen"]) for r in fn.report],
            "chosen": fn.chosen_impls(), "plan_id": fn.plan_id,
            "output": out}


if __name__ == "__main__":
    main()
