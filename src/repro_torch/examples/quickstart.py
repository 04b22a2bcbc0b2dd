"""Quickstart: FLiMS merging and sorting (the paper's §3-§4 in five
minutes), on the port (counterpart of ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The last section runs the card's K2 merge and the K1 + K4 ``kernel_sort``
(on the CPU, their plain versions) where the JAX example runs the Pallas
kernels in interpret mode.
"""
import argparse

import numpy as np
import torch

from repro_torch.core.flims import (flims_merge, flims_merge_banked,
                                    flims_merge_kv_stable)
from repro_torch.core.mergesort import flims_sort
from repro_torch.core.topk import flims_topk
from repro_torch.kernels.ops import kernel_sort, merge as kernel_merge


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = torch.device(ap.parse_args(argv).device)
    rng = np.random.default_rng(0)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # --- 2-way high-throughput merge (paper §3) ----------------------------
    a = np.sort(rng.integers(0, 100, 12).astype(np.int32))[::-1]
    b = np.sort(rng.integers(0, 100, 8).astype(np.int32))[::-1]
    merged = flims_merge(T(a), T(b), w=4)
    print("A       :", a)
    print("B       :", b)
    print("merged  :", merged.cpu().numpy())
    print("merge ok:", bool((merged.cpu().numpy() ==
                             np.sort(np.concatenate([a, b]))[::-1]).all()))

    # --- skewness optimisation (paper §4.1) --------------------------------
    skewed_a = np.sort(rng.choice([1, 2, 3], 64).astype(np.int32))[::-1]
    skewed_b = np.sort(rng.choice([1, 2, 3], 64).astype(np.int32))[::-1]
    res = flims_merge_banked(T(skewed_a), T(skewed_b), 8, tie="skew",
                             with_stats=True)
    print("skew-balanced dequeues k/cycle:",
          res.k_per_cycle.cpu().numpy()[:8])

    # --- stable key/value merge (paper §4.2, algorithm 3) ------------------
    ka, va = np.array([5, 5, 2], np.int32), np.array([0, 1, 2], np.int32)
    kb = np.array([5, 3, 2], np.int32)
    vb = np.array([100, 101, 102], np.int32)
    mk, mv = flims_merge_kv_stable(T(ka), {"v": T(va)}, T(kb),
                                   {"v": T(vb)}, 4)
    print("stable keys  :", mk.cpu().numpy())
    print("stable values:", mv["v"].cpu().numpy(), "(A's duplicates first)")
    print("stable ok:", mv["v"].cpu().tolist() == [0, 1, 100, 101, 2, 102])

    # --- complete sorting (paper §8.2) + top-k ------------------------------
    x = rng.integers(-1000, 1000, 5000).astype(np.int32)
    print("flims_sort ok:", bool((flims_sort(T(x)).cpu().numpy()
                                  == np.sort(x)[::-1]).all()))
    vals, idx = flims_topk(T(x), 5)
    print("top-5:", vals.cpu().numpy())
    print("top-5 ok:", vals.cpu().tolist() == np.sort(x)[::-1][:5].tolist())

    # --- the card's kernels: K2 merge, K1 + K4 two-level sort ---------------
    big_a = np.sort(rng.integers(-10**6, 10**6, 4096).astype(np.int32))[::-1]
    big_b = np.sort(rng.integers(-10**6, 10**6, 4096).astype(np.int32))[::-1]
    km = kernel_merge(T(big_a), T(big_b), w=128)
    print(f"kernel merge ({dev.type}) ok:",
          bool((km.cpu().numpy() ==
                np.sort(np.concatenate([big_a, big_b]))[::-1]).all()))
    print(f"kernel two-level sort ({dev.type}) ok:",
          bool((kernel_sort(T(x)).cpu().numpy() == np.sort(x)[::-1]).all()))


if __name__ == "__main__":
    main()
