"""End-to-end training driver example, on the port (counterpart of
``examples/train_lm.py``).

Default: a reduced qwen3-family model for a quick demo with checkpoint and
resume. ``--full-100m`` trains a ~100M-parameter config for a few hundred
steps.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.train_lm --full-100m \\
        --steps 200
"""
import argparse
import math
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.launch.train import TrainLoop
from repro_torch.models.config import TrainConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_example_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.full_100m:
        # ~100M params: 12L, d=768, 12H, d_ff=3072, vocab 32k
        cfg = get_config("qwen3_1p7b").reduced(
            n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, head_dim=64,
            d_ff=3072, vocab_size=32000)
        tcfg = TrainConfig(global_batch=8, seq_len=512, lr=3e-4,
                           total_steps=args.steps, warmup_steps=20,
                           checkpoint_every=50, checkpoint_dir=args.ckpt)
    else:
        cfg = get_config("qwen3_1p7b").reduced()
        tcfg = TrainConfig(global_batch=8, seq_len=128, lr=1e-3,
                           total_steps=args.steps, warmup_steps=10,
                           checkpoint_every=50, checkpoint_dir=args.ckpt)
    loop = TrainLoop(cfg, tcfg, device=args.device)
    _, _, losses = loop.run(resume="auto", max_steps=args.steps)
    print(f"loss: {losses[0]:.4f} -> {losses[-1]:.4f} over "
          f"{len(losses)} steps")
    print("losses finite:", all(math.isfinite(v) for v in losses))


if __name__ == "__main__":
    main()
