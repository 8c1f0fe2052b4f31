"""Training entry point: the planned train forward, autograd, the optimizer
and checkpoint / resume on one device.

The port of the reference's ``launch/train.py``, with its flags and
``--device`` (default ``cuda``; without a card it raises unless
``--device cpu``).  ``--engines`` defaults to ``xla,pallas``, as the
port's serving runtime: the planner picks the kernels (the flash
attention kernel in every layer of a dense model), whose backward is their
plain version's VJP.

CPU-scale demo:
  python -m repro_torch.launch.train --arch qwen3-0.6b --smoke \
      --device cpu --steps 50 --batch 4 --seq 64
On the card, full width:
  python -m repro_torch.launch.train --arch qwen3-0.6b --steps 20 \
      --batch 4 --seq 2048

Fault tolerance is on by default: checkpoints every ``--ckpt-every``
steps and at the end (once a step: the reference writes the last one
twice when ``--steps`` is a multiple of ``--ckpt-every``), resumes from
the latest checkpoint, the watchdog logs stragglers and checkpoints on
one, and the deterministic pipeline replays the stream on restart.
``--cycle-batches K`` trains on the stream's first K batches over and
over (batch ``step % K``), the reference's overfitting check
(``tests/test_integration.py::test_training_reduces_loss``).  The loop
reads the loss to the host only at ``--log-every``.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config, get_smoke_config
from ..core.executor import default_syscat, plan_and_compile, resolve_device
from ..core.plan_cache import (default_plan_cache, load_plan_cache,
                               save_plan_cache)
from ..data.pipeline import DataConfig, PrefetchPipeline, synth_batch
from ..layers.common import torch_dtype
from ..models import build_model
from ..models.lm import CATALOG
from ..train.checkpoint import (checkpoint_step, latest_checkpoint,
                                restore_checkpoint, save_checkpoint)
from ..train.fault_tolerance import Watchdog
from ..train.optim import cosine_schedule, make_optimizer
from ..train.train_step import init_state, make_train_step


def device_batch(batch: dict, dev, dtype) -> dict:
    """A pipeline batch on ``dev``: int32 tokens and labels, the frontend
    embeddings (float32 arrays holding ``dtype``'s values) in ``dtype``."""
    return {k: torch.from_numpy(v).to(
        dev, dtype=dtype if k == "frontend_embeds" else None)
        for k, v in batch.items()}


def main(argv=None) -> dict:
    """Runs the loop; returns the run's record: ``final_loss``, ``start``
    (the step it resumed at), and per step run ``losses`` and
    ``grad_norms`` (read to the host once, at the end) and ``logged``
    (``(step, perf_counter)`` after each logged host read)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-runnable)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain path)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--buffering", action="store_true")
    ap.add_argument("--engines", default="xla,pallas",
                    help="comma-separated engine names the planner may use "
                         "(registry: xla, pallas)")
    ap.add_argument("--plan-cache-dir", default=None,
                    help="persist the plan cache here and warm-start "
                         "planning from it on relaunch")
    ap.add_argument("--plan-threads", type=int, default=1,
                    help="generate physical candidates per scan-group in "
                         "this many threads (identical plans, lower "
                         "planning wall time)")
    ap.add_argument("--explain", action="store_true",
                    help="print the staged plan pipeline's EXPLAIN report")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--cycle-batches", type=int, default=0,
                    help="train on batches step %% K of the stream (0: the "
                         "whole stream)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    if args.smoke:
        cfg = cfg.replace(dtype="float32")
    model = build_model(cfg)
    syscat = default_syscat(dev)

    plan = model.build_plan(args.batch, args.seq, mode="train")
    # planned through the content-hashed plan cache: re-launching the same
    # workload reuses the staged plan; with --plan-cache-dir the cache
    # warm-starts across process restarts
    pc = default_plan_cache()
    if args.plan_cache_dir:
        load_plan_cache(args.plan_cache_dir, pc)
    fwd = plan_and_compile(plan, CATALOG, syscat, buffering=args.buffering,
                           global_batch=args.batch,
                           engines=tuple(args.engines.split(",")),
                           plan_threads=args.plan_threads, device=dev)
    if args.plan_cache_dir:
        n = save_plan_cache(pc, args.plan_cache_dir)
        print(f"[train] plan cache: {pc.stats()['hits']} hits, "
              f"persisted {n} new staged plan(s) to {args.plan_cache_dir}")
    print(f"[train] plan {fwd.plan_id[:12]} choices: "
          f"{[(r['pattern'], r['chosen']) for r in fwd.report]}")
    if args.explain:
        print(fwd.explain())
    if fwd.buffering.enabled:
        print(f"[train] buffering: {fwd.buffering.num_microbatches} "
              f"microbatches over {len(fwd.buffering.chains)} chains")

    opt = make_optimizer(cfg.optimizer, cosine_schedule(
        args.lr, max(args.steps // 20, 1), args.steps))
    nmb = (fwd.buffering.num_microbatches if fwd.buffering.enabled
           else args.microbatches)
    step = make_train_step(fwd, opt, num_microbatches=nmb,
                           grad_dtype="float32")

    params = model.init_params(torch.Generator(device=dev).manual_seed(
        args.seed))
    state = init_state(params, opt)
    del params

    ckpt_dir = args.ckpt_dir or f"checkpoints/{cfg.name}"
    start = 0
    latest = latest_checkpoint(ckpt_dir)
    if latest:
        state = restore_checkpoint(latest, state)
        start = checkpoint_step(latest)
        print(f"[train] resumed from {latest} at step {start}")

    dc = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                    global_batch=args.batch, seed=args.seed,
                    frontend_tokens=cfg.frontend_tokens,
                    d_model=cfg.d_model, encdec=cfg.family == "encdec",
                    dtype=cfg.dtype)
    dtype = torch_dtype(cfg.dtype)
    pipe = PrefetchPipeline(dc, start_step=start)
    wd = Watchdog()
    history, logged = [], []
    metrics, saved = None, None

    def checkpoint(at):
        """Save the state as step ``at``, unless that step was saved."""
        nonlocal saved
        if saved != at:
            save_checkpoint(ckpt_dir, at, state)
            saved = at

    t_last = time.time()
    try:
        for step_idx, batch in pipe:
            if step_idx >= args.steps:
                break
            if args.cycle_batches:
                batch = synth_batch(dc, step_idx % args.cycle_batches)
            state, metrics = step(state, device_batch(batch, dev, dtype))
            history.append(metrics)
            dt = time.time() - t_last
            t_last = time.time()
            if wd.observe(step_idx, dt):
                print(f"[train] straggler step {step_idx}: {dt:.2f}s "
                      f"(median {wd.median():.2f}s) — checkpointing")
                checkpoint(step_idx + 1)
            if step_idx % args.log_every == 0:
                print(f"[train] step {step_idx:5d} "
                      f"loss {float(metrics['loss']):.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"{dt * 1e3:.0f} ms")
                logged.append((step_idx, time.perf_counter()))
            if (step_idx + 1) % args.ckpt_every == 0:
                checkpoint(step_idx + 1)
    finally:
        pipe.close()
    checkpoint(args.steps)
    final = None if metrics is None else float(metrics["loss"])
    print(f"[train] done at step {args.steps}; final loss "
          + ("(no step run)" if final is None else f"{final:.4f}"))
    read = torch.stack([torch.stack([m["loss"].float(), m["grad_norm"]])
                        for m in history]).cpu().tolist() if history else []
    return {"final_loss": final, "start": start,
            "losses": [r[0] for r in read], "grad_norms": [r[1] for r in read],
            "logged": logged}


if __name__ == "__main__":
    main()
