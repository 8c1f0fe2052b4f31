"""End-to-end training example with checkpoint / resume, over the port's
CLI (``repro_torch.launch.train``).  The default is CPU-sized (qwen3's
SMOKE config); ``--model-100m`` trains a ~100M-parameter qwen3-family
config.  Runs on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200 \
        --device cpu
    PYTHONPATH=src python -m repro_torch.examples.train_lm --model-100m \
        --steps 300
"""
import argparse

from repro_torch.launch import train as train_mod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--model-100m", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain path)")
    args = ap.parse_args(argv)

    if args.model_100m:
        # ~100M params: 12 layers, d_model 768, the tied 32,000-row table
        import repro_torch.configs.qwen3_0_6b as q
        q.SMOKE = q.CONFIG.replace(
            name="qwen3-100m", n_layers=12, d_model=768, heads=12,
            kv_heads=4, head_dim=64, d_ff=2048, vocab=32000,
            dtype="float32")          # routed through --smoke
        return train_mod.main(["--arch", "qwen3-0.6b", "--smoke",
                               "--device", args.device,
                               "--steps", str(args.steps),
                               "--batch", "4", "--seq", "256",
                               "--ckpt-dir", "checkpoints/qwen3-100m"])
    return train_mod.main(["--arch", "qwen3-0.6b", "--smoke",
                           "--device", args.device,
                           "--steps", str(args.steps),
                           "--batch", "8", "--seq", "64"])


if __name__ == "__main__":
    main()
