"""Batched serving example: prefill and decode with FLiMS top-k sampling,
on the port (counterpart of ``examples/serve_lm.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]
"""
import argparse

from repro_torch.configs import get_config
from repro_torch.launch.serve import serve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_config("qwen3_1p7b").reduced()
    toks, dt = serve(cfg, batch=4, prompt_len=8, gen=16, use_flims_topk=True,
                     device=args.device)
    print(f"generated {toks.shape[0]}x{toks.shape[1]} tokens in {dt:.2f}s")
    print(toks)
    print("tokens in the vocabulary:",
          bool(((toks >= 0) & (toks < cfg.vocab_size)).all()))


if __name__ == "__main__":
    main()
