"""Where K4 / K8's time goes on the card, the check of their runs
included: device time by kernel and CUDA-event ms.

    python3 scripts/k48_split.py

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit; it builds the port's library as ``chip_smoke.py`` does.
On float32 keys from a seeded generator (no NaN, runs sorted descending),
each line printed is one JSON object: the call's median ms over 7 calls
(``chip_smoke.time_ms``), the device ms summed over its kernels and the
ten costliest kernels by name with their device ms and launches a call,
averaged over 5 calls under ``torch.profiler``. Cases: K4 and K4kv over
2^24 keys in groups of 4 at w 128, in runs of 256 (block 1024), 4096 and
2^22 (block 4096: ``chip_smoke.py``'s K4 row and its ``k4_passes``);
``engine.sort`` and ``engine.argsort`` of 2^24 keys; K8 at fan-in 8 over
2^27 keys in runs of 2^20 (w 128, block 4096: the out-of-core passes).
"""
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from repro_torch import engine  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import merge_tree as k4  # noqa: E402
from repro_torch.kernels import stream_merge as k8  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402


def split(label, fn):
    """Print one case's line: its ms, its device ms, its costliest kernels."""
    ms = cs.time_ms(fn)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None) or \
            getattr(ev, "cuda_time_total", 0)
        if t:
            rows.append((ev.key[:70], round(t / 5 / 1000, 5), ev.count // 5))
    rows.sort(key=lambda r: -r[1])
    print(json.dumps({"case": label, "ms": ms,
                      "device_ms": round(sum(r[1] for r in rows), 5),
                      "kernels": rows[:10]}), flush=True)


def main() -> int:
    """Every case in turn; 1 without a card."""
    if not torch.cuda.is_available():
        print("k48_split: no CUDA device", file=sys.stderr)
        return 1
    _build.library()
    g = torch.Generator(device="cuda").manual_seed(0)
    n = 1 << 24
    x = torch.randn(n, generator=g, device="cuda")
    rk = torch.arange(n, dtype=torch.int32, device="cuda")
    for run_len, bo in ((256, 1024), (4096, 4096), (1 << 22, 4096)):
        runs = torch.sort(x.reshape(-1, run_len), dim=-1,
                          descending=True).values.reshape(-1)
        st = torch.arange(0, n, run_len, dtype=torch.int32, device="cuda")
        ln = torch.full_like(st, run_len)
        kw = dict(group=4, n_out=n, w=128, block_out=bo)
        split(f"K4 runs of {run_len}",
              lambda: k4.merge_tree_runs(runs, st, ln, **kw))
        split(f"K4kv runs of {run_len}",
              lambda: k4.merge_tree_runs_kv(runs, rk, st, ln, **kw))
    split("engine.sort 2^24", lambda: engine.sort(x))
    split("engine.argsort 2^24", lambda: engine.argsort(x))
    N = 1 << 27
    xb = torch.randn(N, generator=g, device="cuda")
    run_len = 1 << 20
    runs = torch.sort(xb.reshape(-1, run_len), dim=-1,
                      descending=True).values.reshape(-1)
    del xb
    split("K8 fan 8 runs of 2^20",
          lambda: k8.stream_merge_runs(runs, runs=N // run_len,
                                       run_len=run_len, fan_in=8, w=128,
                                       block_out=4096))
    return 0


if __name__ == "__main__":
    sys.exit(main())
