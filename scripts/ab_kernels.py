"""Float32 kernels of several versions of the port, timed in turns on one
card.

    python3 scripts/ab_kernels.py LABEL=ROOT [LABEL=ROOT ...] [--rounds 2]
                                  [--cases K2,K7,...] [--split]

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit. Each ``ROOT`` is a source tree holding
``src/repro_torch``: ``.`` for this one, or an earlier commit's unpacked
into a gitignored path (``git archive <rev> src/repro_torch | tar -x -C
build/ab/<label>``). A version runs in its own process with its own
wrappers and C interface, so kernels whose interface changed between the
versions compare too; each builds its kernels into its own
``build/repro_torch/<hash>/`` first, all builds started together. In each
round every version runs in turn, first to last and then last to first,
and times each case with CUDA events (median of 7 after a warm-up) on
float32 keys from a seeded generator, at the shapes ``chip_smoke.py``
times:

- ``K1``: ``sort_chunks`` at (65536, 256) on NaN-free rows; ``K1 nan``:
  rows holding NaNs (one payload), +0.0 and -0.0 (the exact lanes);
- ``K2`` / ``K2kv``: ``flims_merge`` / ``flims_merge_kv`` of two sorted
  2^23 runs (w 128, C 4096);
- ``K3`` / ``K3kv``: ``segmented_merge_runs`` / ``_kv`` of the same pair;
  ``K3 ragged``: 257 ragged run pairs totalling 2^22 keys (w 32, C 1024);
- ``K4``: ``merge_tree_runs``, a pass of engine.sort over 2^24 keys in
  sorted runs of 4096, groups of 4 (w 128, C 4096), and ``K4 first``, its
  first pass (runs of 256, C 1024);
- ``K5`` / ``K6``: ``segment_sort`` / ``segment_sort_kv`` at 2^22 keys in
  ragged segments of [0, 16384] (cap 16384) and, ``short``, at 2^20 keys
  in segments of [0, 512] (cap 512); keys 0..999;
- ``K7 mixtral`` / ``K7 sorted`` / ``K7 moonlight``: ``moe_route`` of
  (1, 2048, 8) k 2, (1, 4096, 8) k 2 and (1, 2048, 64) k 6 router logits
  at the layers' capacities;
- ``K8``: ``stream_merge_runs``, one fan-8 pass over 128 runs of 2^20;
- ``sort`` / ``argsort``: ``engine.sort`` / ``engine.argsort`` of 2^24
  ``randn`` keys, and ``sort nan`` / ``argsort nan`` of the same keys with
  a quiet NaN at 2^-12 of them (K4's run check flags nearly every group
  from the third pass on: the wide tree form merges them).

With ``--split`` each case's time is also taken apart into host and card
work (``"<case> split"``, ms a call): ``host``, the wall time of one call
with the card idle (synchronised before, not after: the Python wrapper,
the C call and its launches); ``host_py``, the same with the C call
skipped (``_build.launch`` made a no-op), so ``host - host_py`` is the C
call and its launches; ``card``, one replay of a CUDA graph captured from
the call, timed with CUDA events (the kernels alone, no host work; null
where the call cannot be captured); ``b2b``, 50 calls back to back under
one synchronisation, the wall time over 50 (the larger of host and card
work, as a loop of calls runs). Each is the median of 15.

Every result is held against the first version's: bit for bit, but K7's
weights lane within 8 ulps. Each line printed is one JSON object per
(round, version): the ms of every case; last, the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ROUTE_WEIGHT_ULPS = 8


def cases(torch, gen, wanted):
    """{name: call} at the shapes of the module docstring."""
    from repro_torch.kernels import bitonic_sort as k1
    from repro_torch.kernels import flims_merge as k2
    from repro_torch.kernels import merge_tree as k4
    from repro_torch.kernels import route_fuse as k7
    from repro_torch.kernels import segmented_merge as k3
    from repro_torch.kernels import stream_merge as k8
    sys.path.insert(0, str(ROOT / "scripts"))
    from k56_profile import ragged
    dev = "cuda"
    out = {}
    half = 1 << 23
    ma = torch.sort(torch.randn(half, generator=gen, device=dev),
                    descending=True).values
    mb = torch.sort(torch.randn(half, generator=gen, device=dev),
                    descending=True).values
    ra = torch.arange(half, dtype=torch.int32, device=dev)
    rb = half + ra
    cat = torch.cat([ma, mb])
    rcat = torch.arange(2 * half, dtype=torch.int32, device=dev)
    pair = [torch.tensor([v], dtype=torch.int32, device=dev)
            for v in (0, half, half, half)]
    M = dict(w=128, block_out=4096)
    out["K2"] = lambda: k2.flims_merge(ma, mb, **M)
    out["K2kv"] = lambda: k2.flims_merge_kv(ma, ra, mb, rb, **M)
    out["K3"] = lambda: k3.segmented_merge_runs(cat, cat, *pair,
                                                n_out=2 * half, **M)
    out["K3kv"] = lambda: k3.segmented_merge_runs_kv(
        cat, rcat, cat, rcat, *pair, n_out=2 * half, **M)
    lens = ragged(1 << 22, 1 << 14, gen)
    lens += [0] * (len(lens) % 2)
    buf = torch.cat([torch.sort(torch.randn(n, generator=gen, device=dev),
                                descending=True).values for n in lens])
    st = torch.tensor([0] + lens[:-1], dtype=torch.int64).cumsum(0).to(
        device=dev, dtype=torch.int32)
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    rp = (st[0::2].contiguous(), ln[0::2].contiguous(),
          st[1::2].contiguous(), ln[1::2].contiguous())
    out["K3 ragged"] = lambda: k3.segmented_merge_runs(buf, buf, *rp,
                                                       n_out=buf.numel())
    for name, (T, E, k, cap) in (("K7 mixtral", (2048, 8, 2, 641)),
                                 ("K7 sorted", (4096, 8, 2, 1281)),
                                 ("K7 moonlight", (2048, 64, 6, 241))):
        lg = torch.randn((1, T, E), generator=gen, device=dev)
        out[name] = (lambda lg=lg, k=k, cap=cap: k7.moe_route(lg, k, cap))
    pool = torch.tensor([float("nan"), 0.0, -0.0, 1.0, -2.5, float("-inf")],
                        device=dev)
    nan_rows = pool[torch.randint(0, pool.numel(), (65536 * 256,),
                                  generator=gen, device=dev)].reshape(-1, 256)
    rows = torch.randn(65536 * 256, generator=gen, device=dev).reshape(-1, 256)
    out["K1"] = lambda: k1.sort_chunks(rows)
    out["K1 nan"] = lambda: k1.sort_chunks(nan_rows)
    n4 = 1 << 24
    x4 = torch.randn(n4, generator=gen, device=dev)
    for name, rl, bo in (("K4", 4096, 4096), ("K4 first", 256, 1024)):
        r4 = torch.sort(x4.reshape(-1, rl), dim=-1,
                        descending=True).values.reshape(-1)
        s4 = torch.arange(0, n4, rl, dtype=torch.int32, device=dev)
        out[name] = (lambda r4=r4, s4=s4, bo=bo: k4.merge_tree_runs(
            r4, s4, torch.full_like(s4, r4.numel() // s4.numel()), group=4,
            n_out=n4, w=128, block_out=bo))
    for tag, total, longest in (("", 1 << 22, 16384), (" short", 1 << 20,
                                                        512)):
        sl = ragged(total, longest, gen)
        offs = torch.tensor([0] + sl, dtype=torch.int64).cumsum(0).to(
            device=dev, dtype=torch.int32)
        x = torch.randint(0, 1000, (total,), generator=gen,
                          device=dev).float()
        out["K5" + tag] = (lambda x=x, o=offs, c=longest:
                           k3.segment_sort(x, o, cap=c))
        out["K6" + tag] = (lambda x=x, o=offs, c=longest:
                           k3.segment_sort_kv(x, o, cap=c))
    if "K8" in wanted:
        n8, run_len = 1 << 27, 1 << 20
        runs = torch.sort(torch.randn(n8, generator=gen, device=dev).reshape(
            -1, run_len), dim=1, descending=True).values.reshape(-1)
        kbuf = torch.cat([runs, runs.new_full(
            (k8.stream_slack(16, 128, 4096),), float("-inf"))])
        out["K8"] = lambda: k8.stream_merge_runs(
            kbuf, runs=n8 // run_len, run_len=run_len, fan_in=8, w=128,
            block_out=4096)
    if any(k.startswith(("sort", "argsort")) for k in wanted):
        from repro_torch import engine
        ns = 1 << 24
        xs = torch.randn(ns, generator=gen, device=dev)
        xn = xs.clone()
        xn[torch.randperm(ns, generator=gen, device=dev)[:ns >> 12]] = \
            float("nan")
        out["sort"] = lambda: engine.sort(xs)
        out["argsort"] = lambda: engine.argsort(xs)
        out["sort nan"] = lambda: engine.sort(xn)
        out["argsort nan"] = lambda: engine.argsort(xn)
    return {k: v for k, v in out.items() if k in wanted}


def split_ms(torch, _build, fn, reps: int = 15) -> dict:
    """Host and card time of one call (module docstring, ``--split``)."""
    def wall(n=1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) * 1e3 / n

    def b2b(n=50):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    def med(f):
        ts = sorted(f() for _ in range(reps))
        return ts[len(ts) // 2]

    out = {"host": med(wall), "b2b": med(b2b)}
    launch = _build.launch
    _build.launch = lambda *args: None
    try:
        out["host_py"] = med(wall)
    finally:
        _build.launch = launch
    try:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn()
        g.replay()
        torch.cuda.synchronize()

        def replay():
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            g.replay()
            e.record()
            e.synchronize()
            return s.elapsed_time(e)
        out["card"] = med(replay)
    except RuntimeError:
        out["card"] = None
    return out


def worker(root: str, label: str, rnd: int, wanted, build_only: bool,
           split: bool) -> int:
    """One version's turn: build, then time every case and print one JSON
    line with the ms and each result's bits (to compare across turns)."""
    sys.path.insert(0, str(Path(root).resolve() / "src"))
    import torch
    from repro_torch.kernels import _build
    _build.library()
    if build_only:
        return 0
    sys.path.insert(0, str(ROOT / "scripts"))
    from k1_profile import time_ms
    calls = cases(torch, torch.Generator(device="cuda").manual_seed(0),
                  wanted)
    line, bits = {"round": rnd, "label": label}, {}
    for name, fn in calls.items():
        got = fn()
        got = got if isinstance(got, tuple) else (got,)
        bits[name] = [t.view(torch.int32).cpu() if t.dtype == torch.float32
                      else t.cpu() for t in got]
        line[name] = time_ms(fn)
        if split:
            line[name + " split"] = split_ms(torch, _build, fn)
    out = ROOT / "build" / "ab_kernels" / f"{label}.pt"
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.save(bits, out)
    print(json.dumps(line), flush=True)
    return 0


def same(name, got, ref) -> bool:
    import torch
    for i, (g, e) in enumerate(zip(got, ref)):
        if name.startswith("K7") and i == 3:  # the weights lane
            if int((g.long() - e.long()).abs().max()) > ROUTE_WEIGHT_ULPS:
                return False
        elif not torch.equal(g, e):
            return False
    return True


ALL = ("K1,K1 nan,K2,K2kv,K3,K3kv,K3 ragged,K4,K4 first,K5,K6,K5 short,"
       "K6 short,K7 mixtral,K7 sorted,K7 moonlight,K8,sort,argsort,sort nan,"
       "argsort nan")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("sources", nargs="*", help="LABEL=ROOT")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--cases", default=ALL)
    ap.add_argument("--worker", nargs=3, metavar=("ROOT", "LABEL", "ROUND"))
    ap.add_argument("--build-only", action="store_true")
    ap.add_argument("--split", action="store_true")
    args = ap.parse_args()
    wanted = args.cases.split(",")
    if args.worker:
        root, label, rnd = args.worker
        return worker(root, label, int(rnd), wanted, args.build_only,
                      args.split)
    import torch
    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device", file=sys.stderr)
        return 1
    if not args.sources:
        ap.error("give at least one LABEL=ROOT")
    roots = dict(s.split("=", 1) for s in args.sources)
    me = [sys.executable, str(Path(__file__).resolve())]

    def run(label, rnd, build_only=False):
        cmd = me + ["--cases", args.cases, "--worker", roots[label],
                    label, str(rnd)] + (["--build-only"] if build_only
                                        else []) + (["--split"] if args.split
                                                    else [])
        return subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)

    for label, p in [(lb, run(lb, 0, True)) for lb in roots]:
        if p.wait():
            raise SystemExit(f"ab_kernels: {label} failed to build")
    order = list(roots)
    ref = None
    for rnd in range(args.rounds):
        for label in order + order[::-1]:
            p = run(label, rnd)
            out, _ = p.communicate()
            if p.returncode:
                raise SystemExit(f"ab_kernels: {label} failed")
            print(out.strip(), flush=True)
            bits = torch.load(ROOT / "build" / "ab_kernels" / f"{label}.pt")
            if ref is None:
                ref = bits
            for name in ref:
                if not same(name, bits[name], ref[name]):
                    raise SystemExit(f"ab_kernels: {label} {name} differs "
                                     "from the first version's result")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
