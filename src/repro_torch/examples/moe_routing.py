"""FLiMS-sorted MoE dispatch: the paper's sorter inside the LM framework,
on the port (counterpart of ``examples/moe_routing.py``).

The token -> expert dispatch of the mixtral / moonshot layers: (token,
expert) pairs are stably sorted by expert id with the FLiMS merge sort
(the paper's algorithm 3 keeps the original token order inside every
expert slab), then the experts run on contiguous capacity slabs (K7 routes
them on the card).

    PYTHONPATH=src python -m repro_torch.examples.moe_routing [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.mergesort import flims_argsort
from repro_torch.models.moe import (moe_apply_dense, moe_apply_sorted,
                                    moe_init, router_probs)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = torch.device(ap.parse_args(argv).device)
    cfg = get_config("mixtral_8x22b").reduced()
    p = moe_init(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    x = torch.randn((2, 32, cfg.d_model),
                    generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev)

    # what the dispatch sort does:
    w, idx = router_probs(p, x, cfg)
    flat_e = idx.reshape(-1).to(torch.int32)
    order = flims_argsort(flat_e, descending=False)
    print("expert ids (first 16 pairs)  :", flat_e.cpu().numpy()[:16])
    print("FLiMS-sorted by expert       :",
          flat_e[order.long()].cpu().numpy()[:16])
    ref = np.argsort(flat_e.cpu().numpy(), kind="stable")
    print("stable by expert ok:", bool((order.cpu().numpy() == ref).all()))

    y_dense = moe_apply_dense(p, x, cfg)
    y_sorted = moe_apply_sorted(p, x, cfg, capacity_factor=8.0)
    print("sorted dispatch == dense masked compute:",
          bool((y_dense.float() - y_sorted.float()).abs().max() < 1e-2))
    print("dense path FLOPs ~ E/k =", cfg.n_experts / cfg.n_experts_active,
          "x more than sorted dispatch")


if __name__ == "__main__":
    main()
