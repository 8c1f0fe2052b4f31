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

``serve_request`` / ``planned_prefill`` are the sequential path's helpers,
the reference's compatibility wrappers: a planned prefill for the prompt
logits, then the prompt replayed through the decode step to build the
cache, then token-by-token decode.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config, get_smoke_config
from ..core.executor import plan_and_compile, resolve_device
from ..models import build_model
from ..models.decode import init_cache
from ..models.lm import CATALOG
from ..serving import AsyncServingRuntime, ServeRequest, check_servable
from ..serving.admission import bucket_len


def planned_prefill(model, syscat, batch: int, prompt_len: int,
                    cache=None, engines=("xla",), *, device=None):
    """Plan (or fetch from the plan cache ``cache``) the prefill forward
    of this request's power-of-two bucket, bound to ``device`` (the card
    unless the caller names another).  Returns (planned_fn, bucket)."""
    bucket = bucket_len(prompt_len)
    plan = model.build_plan(batch, bucket, mode="prefill")
    fwd = plan_and_compile(plan, CATALOG, syscat, engines=engines,
                           cache=cache, device=resolve_device(device))
    return fwd, bucket


@torch.inference_mode()
def serve_request(model, cfg, params, dstep, fwd, bucket, prompts, gen: int,
                  *, ring_local: bool = False, device=None):
    """One sequential request: the planned prefill ``fwd`` (of ``bucket``)
    for the prompt logits, then the prompt replayed through ``dstep(params,
    cache, tokens, index)`` (``models.decode.decode_step`` bound to the
    model) to build a fresh cache on ``device`` (the card unless the caller
    names another), then ``gen`` greedy tokens from it.  ``prompts``: (B,
    prompt_len) ints.  Returns (tokens (B, gen) numpy, prefill seconds,
    decode seconds)."""
    dev = resolve_device(device)
    prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.long,
                              device=dev)
    b, prompt_len = prompts.shape
    max_seq = prompt_len + gen

    t0 = time.time()
    padded = torch.zeros((b, bucket), dtype=torch.long, device=dev)
    padded[:, :prompt_len] = prompts
    logits_all = fwd(params, {"tokens": padded})
    tok = torch.argmax(logits_all[:, prompt_len - 1, :cfg.vocab],
                       dim=-1)[:, None]
    cache = init_cache(model, b, max_seq, device=dev, ring_local=ring_local)
    for t in range(prompt_len):
        _, cache = dstep(params, cache, prompts[:, t:t + 1], t)
    tok = tok.cpu()
    t_prefill = time.time() - t0

    out_tokens = []
    t0 = time.time()
    for t in range(prompt_len, max_seq):
        out_tokens.append(tok.numpy()[:, 0])
        logits, cache = dstep(params, cache, tok.to(dev), t)
        tok = torch.argmax(logits[:, :, :cfg.vocab], dim=-1).cpu()
    t_gen = time.time() - t0
    return np.stack(out_tokens, axis=1), t_prefill, t_gen


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


def main(argv=None, *, params=None):
    """The CLI; ``params`` replaces the seeded parameters (a tree of the
    model's shapes, e.g. ``models.lm.params_from_numpy`` of another
    package's).  Returns the results in request order."""
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
    if params is None:
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
