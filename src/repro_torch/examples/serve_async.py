"""Async serving example: drive the runtime from asyncio directly, with
staggered arrivals — prefill of late arrivals interleaves with decode of
in-flight requests at token boundaries (continuous batching).  The port
of the reference's ``examples/serve_async.py``: qwen3-0.6b's SMOKE config
in float32, six requests 20 ms apart.  Runs on the card unless
``--device cpu``.

    PYTHONPATH=src python -m repro_torch.examples.serve_async --device cpu
"""
import argparse
import asyncio

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.executor import resolve_device
from repro_torch.models import build_model
from repro_torch.serving import AsyncServingRuntime, ServeRequest

LENS = (5, 12, 8, 20, 16, 3)
GEN = 16


async def main_async(dev, params=None) -> list:
    cfg = get_smoke_config("qwen3-0.6b").replace(dtype="float32")
    model = build_model(cfg)
    if params is None:
        params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    rng = np.random.RandomState(0)

    rt = AsyncServingRuntime(model, params, max_batch=4, max_seq=64,
                             device=dev)
    rt.warmup(LENS)

    # staggered arrivals: 20 ms apart — later requests are admitted and
    # prefilled while earlier ones are mid-decode, joining at the next
    # token boundary
    reqs = [ServeRequest(i, tuple(rng.randint(0, cfg.vocab, n).tolist()),
                         gen=GEN, arrival=0.02 * i)
            for i, n in enumerate(LENS)]
    results = await rt.run(reqs)

    for r in results:
        m = r.metrics
        print(f"req {r.rid}: bucket {m.bucket:3d} "
              f"ttft {m.ttft_s * 1e3:6.1f} ms  "
              f"tpot {m.tpot_s * 1e3:5.2f} ms/tok  tokens {r.tokens[:6]}...")
    print(rt.metrics.report())
    return results


def main(argv=None, *, params=None) -> list:
    """Runs :func:`main_async`; ``params`` replaces the seeded parameters.
    Returns the results in request order."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain path)")
    args = ap.parse_args(argv)
    return asyncio.run(main_async(resolve_device(args.device), params))


if __name__ == "__main__":
    main()
