"""K9's time at each tree level taken apart: host, card, and the card's kernels.

On the GPU machine, from the repository root:

    python3 scripts/k9_profile.py [--cases sort,argsort,merge_runs,merge_runs_kv]
                                  [--sweep]

For every level of a ``tree_vmapped`` reduction at w 128 -- ``sort``: 2^22
float32 keys in runs of 256, key-only, the levels of ``sort(variant=
"ref")``; ``argsort``: the same with int32 ranks, as ``argsort(variant=
"flims")``; ``merge_runs`` / ``merge_runs_kv``: 2^25 keys in 64 runs of
2^19, the six levels of ``merge_runs(variant="tree_vmapped")`` over 64 runs
padded to 2^19 (here every slot is a real key) -- one JSON line: pairs,
cycle chain, blocks a pair and cycles a block; ``ms``, CUDA events around
one call (median of 7); ``host``, the wall time of one call with the card
idle (synchronised before, not after); ``card``, one replay of a CUDA graph
of the call (the kernels alone, no host work); ``kernels``, device ms per
kernel name from ``torch.profiler`` a call (the guard pass, its memset, the
merge; null if the profiler shows no device time); ``chain_card``, the
graph replay of the whole chain (``chain=True``); and the byte bound (each
key, and rank, read once and written once, over 3.35 TB/s). ``--sweep``
adds the card time of each case's last level at blocks of 4 to 128 cycles
(``_cycles=``). Each level's input is the last level's output. Last line:
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import lane_merge as k9  # noqa: E402
from repro_torch.launch.roofline import MEM_BW_BY_BACKEND  # noqa: E402

W = 128
SEED = 20


def med(f, reps=7):
    ts = sorted(f() for _ in range(reps))
    return ts[len(ts) // 2]


def event_ms(fn):
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e)


def host_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3


def card_ms(fn):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    g.replay()
    torch.cuda.synchronize()
    return med(lambda: event_ms(g.replay))


def kernel_ms(fn, calls=5):
    """Device ms a call per kernel name, from the profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            name = e.key.split("<")[0].split("(")[0].replace("void ", "")
            out[name] = out.get(name, 0.0) + us / 1e3 / calls
    return out or None


def start(case, gen):
    """The reduction's first buffer, its ranks (or None) and run length."""
    if case in ("sort", "argsort"):
        n, L = 1 << 22, 256
    else:
        n, L = 1 << 25, 1 << 19
    x = torch.randn(n // L, L, generator=gen, device="cuda")
    kv = case in ("argsort", "merge_runs_kv")
    v, i = torch.sort(x, dim=1, descending=True, stable=True)
    if not kv:
        return v.reshape(-1).contiguous(), None, L
    r = (torch.arange(n // L, device="cuda")[:, None] * L + i).to(torch.int32)
    return v.reshape(-1).contiguous(), r.reshape(-1).contiguous(), L


def level_line(case, buf, ranks, L, sweep_last):
    n = buf.numel()
    fn = lambda: k9.lane_merge_level(buf, ranks, L, w=W)
    chain = lambda: k9.lane_merge_level(buf, ranks, L, w=W, chain=True)
    fn()
    cycles, blocks = k9.level_blocks(buf, ranks, L, w=W)
    row = {"case": case, "run_len": L, "pairs": n // (2 * L),
           "chain_cycles": -(-2 * L // W), "blocks": blocks,
           "block_cycles": cycles, "ms": med(lambda: event_ms(fn)),
           "host": med(lambda: host_ms(fn)), "card": card_ms(fn),
           "kernels": kernel_ms(fn), "chain_card": card_ms(chain),
           "bound_ms": 2 * n * (4 if ranks is None else 8)
           / MEM_BW_BY_BACKEND["cuda"] * 1e3}
    if sweep_last:
        row["sweep_card"] = {
            c: card_ms(lambda c=c: k9.lane_merge_level(buf, ranks, L, w=W,
                                                       _cycles=c))
            for c in (4, 8, 16, 32, 64, 128)}
    print(json.dumps(row), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cases", default="sort,argsort,merge_runs,merge_runs_kv")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k9_profile: no CUDA device", file=sys.stderr)
        return 1
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    for case in args.cases.split(","):
        buf, ranks, L = start(case, gen)
        while L < buf.numel():
            level_line(case, buf, ranks, L, args.sweep and 2 * L == buf.numel())
            buf, ranks = k9.lane_merge_level(buf, ranks, L, w=W)
            L *= 2
        ref = torch.sort(buf, descending=True).values
        if not torch.equal(buf, ref):
            raise AssertionError(f"{case}: the reduction is not sorted")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
