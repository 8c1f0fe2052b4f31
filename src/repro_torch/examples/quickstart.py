"""Quickstart: define a model config, let the AWESOME planner pick physical
plans, and take a few training steps (the port of the reference's
``examples/quickstart.py``: gemma3-27b's SMOKE config in float32, batch 4
x 32, both engines offered, 20 AdamW steps).  Runs on the card unless
``--device cpu``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""
import argparse

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.executor import plan_and_compile, resolve_device
from repro_torch.core.ir import SystemCatalog
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.models import build_model
from repro_torch.models.lm import CATALOG
from repro_torch.train.optim import cosine_schedule, make_optimizer
from repro_torch.train.train_step import init_state, make_train_step

STEPS = 20


def main(argv=None, *, params=None) -> dict:
    """Plans and trains; ``params`` replaces the seeded parameters (e.g.
    ``models.lm.params_from_numpy`` of another package's; they are trained
    in place).  Returns the
    plan id, the planner's choices, each step's loss and the final
    state."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain path)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_smoke_config("gemma3-27b").replace(dtype="float32")
    model = build_model(cfg)
    b, s = 4, 32

    # 1. the workload's logical plan (ADIL analysis block)
    plan = model.build_plan(b, s, mode="train")
    print(f"logical plan: {len(plan)} nodes "
          f"(+{sum(len(n.subplan) for n in plan.topo() if n.subplan)} in "
          f"scan subplans)")

    # 2. the staged plan pipeline: rewrite -> candidates -> cost-model
    # selection -> data parallelism, with both engines offered
    fwd = plan_and_compile(plan, CATALOG, SystemCatalog(),
                           engines=("xla", "pallas"), device=dev)
    print(fwd.explain())
    for r in fwd.report:
        print(f"virtual node [{r['pattern']}] -> {r['chosen']} "
              f"(costs: { {k: f'{v:.2e}' for k, v in r['costs'].items()} })")

    # 3. train
    opt = make_optimizer("adamw", cosine_schedule(3e-3, 5, 100))
    step = make_train_step(fwd, opt, grad_dtype="float32")
    if params is None:
        params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    state = init_state(params, opt)
    dc = DataConfig(vocab=cfg.vocab, seq_len=s, global_batch=b)
    losses = []
    for i in range(STEPS):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in synth_batch(dc, i).items()}
        state, m = step(state, batch)
        losses.append(m["loss"])
        if i % 5 == 0:
            print(f"step {i:3d}  loss {float(m['loss']):.4f}")
    print("done.")
    return {"plan_id": fwd.plan_id,
            "chosen": [(r["pattern"], r["chosen"]) for r in fwd.report],
            "losses": [float(x) for x in losses], "state": state}


if __name__ == "__main__":
    main()
