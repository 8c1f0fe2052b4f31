"""Readings for the correctness limits, on the chip at the cells' own size.

    python3 tribench/calibrate.py --config pulse_10m --mixes solo,team16 \\
        --seeds 101,102,103 --seconds 3

For each seed, in one process: the configuration's data is drawn and
loaded once; each mix is set up over it and driven for ``--seconds`` at
its own load, its sample kept as a run keeps it; then the program's state
is freed and the sample is judged twice: the program's outputs against
the reference (the lower readings), and the reference computed in
bfloat16 in the program's place (the control: the upper readings).  One
JSON line per seed and mix; the last line gives, per number, the largest
program reading and the smallest control reading.  The benchmark's own
runs do not run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None, device="cuda", roots=(), out=None):
    import torch

    from tribench.harness import (Sample, check, drive, forbidden_modules,
                                  load_data, prepare)
    from tribench.registry import Registry
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--mixes", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    if device == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    reg = Registry(roots)
    out = sys.stdout if out is None else out
    cfg = reg.config(args.config)
    lower, upper = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        data = load_data(reg, cfg, seed, device)
        kept = {}
        for name in args.mixes.split(","):
            mix = reg.traffic(name)
            sess = prepare(reg, cfg, mix, data, seed, device, sys.stderr)
            sample = Sample(mix["check_sample"], seed)
            win = drive(sess, args.seconds, sample=sample)
            kept[name] = ([a for rnd in sample.items for a in rnd], win)
            del sess
        raw = data.raw
        del data
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        for name, (items, win) in kept.items():
            prog, _ref, hows = check(reg, raw, items, device)
            ctl, _ref, _ = check(reg, raw, items, device, control=True)
            for k, v in prog.items():
                lower[k] = max(lower.get(k, 0.0), v)
            for k, v in ctl.items():
                upper[k] = min(upper.get(k, float("inf")), v)
            print(json.dumps({"seed": seed, "mix": name, "program": prog,
                              "control": ctl, "checked": hows,
                              "analyses": win["analyses"],
                              "failed": win["failed"]}), file=out,
                  flush=True)
        del raw
        gc.collect()
    print(json.dumps({"lower": lower, "upper": upper,
                      "forbidden": forbidden_modules(),
                      "seconds": time.perf_counter() - T_START}),
          file=out, flush=True)
    return 0


if __name__ == "__main__":
    # as run.py: the package as tribench.*, caches inside the checkout
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if Path(p or ".").resolve() != HERE]
    from tribench.caches import use_checkout_caches
    use_checkout_caches(ROOT)
    sys.exit(main())
