"""Serving entry point: a thin CLI over the port's async serving runtime.

Requests (mixed prompt lengths) are admitted by power-of-two bucket so every
warm bucket hits an already-cached staged plan, prefilled through the
planned ``prefill_kv`` forward (per-layer K/V are plan outputs that seed the
paged KV pool directly) — or, for the recurrent families (rwkv6-3b,
zamba2-7b), through the planned ``prefill`` forward and a replay of the
prompt through the decode step (``mode=replay``) — and decoded with
continuous batching.  Runs on the card unless ``--device cpu``; without a
card it raises.  The vlm and encdec families (llava-next-34b,
seamless-m4t-medium) are refused before their parameters are made: their
forward needs ``frontend_embeds``, which no request carries.

CPU-scale demo:
  python -m repro_torch.launch.serve --arch qwen3-0.6b --smoke --device cpu \
      --requests 8 --gen 16 --max-batch 4
  python -m repro_torch.launch.serve --arch rwkv6-3b --smoke --device cpu
  python -m repro_torch.launch.serve --arch dbrx-132b --smoke --device cpu
  python -m repro_torch.launch.serve --arch gemma3-27b --smoke --device cpu \
      --engines xla
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config, get_smoke_config
from ..core.executor import resolve_device
from ..models import build_model
from ..serving import AsyncServingRuntime, ServeRequest, check_servable


def make_trace(rng, cfg, n_requests: int, prompt_lens, gen: int,
               arrival_spacing: float = 0.0) -> list:
    """A mixed-length request trace (round-robin over ``prompt_lens``)."""
    reqs = []
    for i in range(n_requests):
        n = prompt_lens[i % len(prompt_lens)]
        reqs.append(ServeRequest(
            i, tuple(rng.randint(0, cfg.vocab, n).tolist()), gen,
            arrival=i * arrival_spacing))
    return reqs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain path)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-lens", default="5,12,8,20,16,3,27,9",
                    help="comma-separated prompt lengths, cycled over "
                         "requests (mixed lengths exercise the buckets)")
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4,
                    help="decode-batch width (continuous batching slots)")
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=16,
                    help="KV-pool page size (tokens)")
    ap.add_argument("--arrival-spacing", type=float, default=0.0,
                    help="seconds between request arrivals")
    ap.add_argument("--engines", default="xla,pallas")
    ap.add_argument("--plan-cache-dir", default=None,
                    help="persist/warm-start the plan cache here")
    ap.add_argument("--explain", action="store_true",
                    help="print one bucket's EXPLAIN report")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    if args.smoke:
        cfg = cfg.replace(dtype="float32")
    model = build_model(cfg)
    check_servable(model)
    params = model.init_params(
        torch.Generator(device=dev).manual_seed(args.seed))
    rng = np.random.RandomState(args.seed)
    prompt_lens = [int(x) for x in args.prompt_lens.split(",")]

    rt = AsyncServingRuntime(
        model, params, max_batch=args.max_batch, max_seq=args.max_seq,
        page_size=args.page_size, engines=tuple(args.engines.split(",")),
        plan_cache_dir=args.plan_cache_dir, device=dev)
    print(f"[serve] arch={cfg.name} mode="
          f"{'prefill_kv (plan-seeded KV)' if rt.kv_mode else 'replay'} "
          f"max_batch={args.max_batch} max_seq={args.max_seq} device={dev}")

    t0 = time.time()
    rt.warmup(prompt_lens)
    print(f"[serve] warmup (plans + first runs) {time.time() - t0:.2f}s; "
          f"buckets {sorted(rt._prefill_fns)}")
    if args.explain:
        print(rt._prefill_fns[sorted(rt._prefill_fns)[0]].explain())

    reqs = make_trace(rng, cfg, args.requests, prompt_lens, args.gen,
                      args.arrival_spacing)
    t0 = time.time()
    results = rt.serve(reqs)
    wall = time.time() - t0
    toks = sum(len(r.tokens) for r in results)
    print(rt.metrics.report())
    print(f"[serve] {toks} tokens in {wall:.2f}s -> {toks / wall:.1f} tok/s; "
          f"pool {rt.pool.occupancy()}")
    s = rt.pc.stats()
    print(f"[serve] plan cache: {s['hits']} hits / {s['misses']} misses "
          f"(hit rate {s['hit_rate']:.2f})")
    sample = [r.tokens[:8] for r in results[:2]]
    print(f"[serve] sample generations (token ids): {sample}")
    return results


if __name__ == "__main__":
    main()
