"""Batched serving example over the async runtime: mixed-length prompts,
bucketed admission, continuous batching, plan-seeded KV pool (qwen3's dense
attention path) and the decode-replay fallback (rwkv's recurrent state).
The port of the reference's ``examples/serve_batched.py``, over the port's
serving CLI (``repro_torch.launch.serve``).  Runs on the card unless
``--device cpu``.

    PYTHONPATH=src python -m repro_torch.examples.serve_batched --device cpu
"""
import argparse

from repro_torch.launch import serve as serve_mod

RUNS = {
    "qwen3-0.6b": ["--requests", "6", "--prompt-lens", "5,12,8", "--gen",
                   "12", "--max-batch", "3", "--max-seq", "64"],
    "rwkv6-3b": ["--requests", "4", "--prompt-lens", "6,10", "--gen", "10",
                 "--max-batch", "2", "--max-seq", "64"],
}
TITLES = {
    "qwen3-0.6b": "== qwen3 (dense GQA: planned prefill seeds the KV pool) ==",
    "rwkv6-3b": "\n== rwkv6 (attention-free, O(1) state: replay fallback) ==",
}


def main(argv=None, *, params=None) -> dict:
    """Serves both configs through the CLI; ``params`` (arch -> tree)
    replaces the seeded parameters of either.  Returns each arch's
    results."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain path)")
    args = ap.parse_args(argv)
    params = params or {}
    out = {}
    for arch, argv_arch in RUNS.items():
        print(TITLES[arch])
        out[arch] = serve_mod.main(
            ["--arch", arch, "--smoke", "--device", args.device, *argv_arch],
            params=params.get(arch))
    return out


if __name__ == "__main__":
    main()
