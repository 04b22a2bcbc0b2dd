"""Float32 kernels built from several versions of the CUDA sources, timed
in turns on one card.

    python3 scripts/ab_kernels.py LABEL=CSRC_DIR [LABEL=CSRC_DIR ...]
                                  [--rounds 2]

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit. Each ``CSRC_DIR`` is a copy of ``src/repro_torch/csrc``
(this tree's, or an earlier commit's unpacked into a gitignored path). Its
``flims_merge.cu``, ``stream_merge.cu``, ``bitonic_sort.cu``,
``segment_sort.cu`` and ``merge_tree.cu`` are built with the port's nvcc
flags into ``build/ab_kernels/<label>/libflims.so``, every nvcc process
started together. In each round every library is put in turn under the
wrappers, first to last and then last to first, and each case is timed
with CUDA events (median of 7 after a warm-up), on float32 keys from a
seeded generator at the shapes ``chip_smoke.py`` times:

- ``K2``: ``flims_merge`` of two sorted 2^23 runs (w 128, C 4096);
- ``K3``: ``segmented_merge_runs`` of the same pair;
- ``K4``: ``merge_tree_runs``, a pass of engine.sort over 2^24 keys in
  sorted runs of 4096, groups of 4 (w 128, C 4096), and ``K4 first``, its
  first pass (runs of 256, C 1024);
- ``K8``: ``stream_merge_runs``, one fan-8 pass over 128 runs of 2^20;
- ``K1 nan``: ``sort_chunks`` at (65536, 256) on rows holding NaNs (one
  payload), +0.0 and -0.0 (the exact lanes), ``K1``: NaN-free rows;
- ``K5`` / ``K6``: ``segment_sort`` / ``segment_sort_kv`` at 2^22 keys in
  ragged segments of [0, 16384] (cap 16384) and, ``short``, at 2^20 keys
  in segments of [0, 512] (cap 512); keys 0..999.

Every result is held bit for bit against the first library's. Each line
printed is one JSON object per (round, label): the ms of every case; last,
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
sys.path.insert(0, str(ROOT / "src"))
from k1_profile import time_ms  # noqa: E402
from k56_profile import ragged  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import bitonic_sort as k1  # noqa: E402
from repro_torch.kernels import flims_merge as k2  # noqa: E402
from repro_torch.kernels import merge_tree as k4  # noqa: E402
from repro_torch.kernels import segmented_merge as k3  # noqa: E402
from repro_torch.kernels import stream_merge as k8  # noqa: E402

SOURCES = ("flims_merge.cu", "stream_merge.cu", "bitonic_sort.cu",
           "segment_sort.cu", "merge_tree.cu")


def build_all(dirs):
    """{label: loaded library}, every source of every directory compiled
    at once."""
    procs = []
    for label, csrc in dirs.items():
        out = ROOT / "build" / "ab_kernels" / label
        out.mkdir(parents=True, exist_ok=True)
        for src in SOURCES:
            obj = out / (Path(src).stem + ".o")
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-c",
                   str(Path(csrc) / src), "-o", str(obj)]
            procs.append((label, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    for label, _, p in procs:
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"ab_kernels: nvcc failed for {label}:\n{out}")
    libs = {}
    for label in dirs:
        out = ROOT / "build" / "ab_kernels" / label
        so = out / "libflims.so"
        subprocess.run([_build._nvcc(), "-shared", "-o", str(so)] +
                       [str(out / (Path(s).stem + ".o")) for s in SOURCES],
                       check=True)
        lib = ctypes.CDLL(str(so))
        for fn_name, (res, args) in _build._SIGNATURES.items():
            if hasattr(lib, fn_name):
                fn = getattr(lib, fn_name)
                fn.restype, fn.argtypes = res, args
        libs[label] = lib
    return libs


def cases(gen):
    """{name: call} at the shapes of the module docstring."""
    dev = "cuda"
    half = 1 << 22
    ma = torch.sort(torch.randn(half, generator=gen, device=dev),
                    descending=True).values
    mb = torch.sort(torch.randn(half, generator=gen, device=dev),
                    descending=True).values
    cat = torch.cat([ma, mb])
    pair = [torch.tensor([v], dtype=torch.int32, device=dev)
            for v in (0, half, half, half)]
    n8, run_len = 1 << 27, 1 << 20
    runs = torch.sort(torch.randn(n8, generator=gen, device=dev).reshape(
        -1, run_len), dim=1, descending=True).values.reshape(-1)
    kbuf = torch.cat([runs, runs.new_full((k8.stream_slack(16, 128, 4096),),
                                          float("-inf"))])
    pool = torch.tensor([float("nan"), 0.0, -0.0, 1.0, -2.5, float("-inf")],
                        device=dev)
    nan_rows = pool[torch.randint(0, pool.numel(), (65536 * 256,),
                                  generator=gen, device=dev)].reshape(-1, 256)
    rows = torch.randn(65536 * 256, generator=gen, device=dev).reshape(-1, 256)
    n4 = 1 << 24
    x4 = torch.randn(n4, generator=gen, device=dev)
    tree = {}
    for name, rl, bo in (("K4", 4096, 4096), ("K4 first", 256, 1024)):
        r4 = torch.sort(x4.reshape(-1, rl), dim=-1,
                        descending=True).values.reshape(-1)
        st = torch.arange(0, n4, rl, dtype=torch.int32, device=dev)
        tree[name] = (lambda r4=r4, st=st, bo=bo: k4.merge_tree_runs(
            r4, st, torch.full_like(st, r4.numel() // st.numel()), group=4,
            n_out=n4, w=128, block_out=bo))
    out = {
        **tree,
        "K2": lambda: k2.flims_merge(ma, mb, w=128, block_out=4096),
        "K3": lambda: k3.segmented_merge_runs(
            cat, cat, *pair, n_out=2 * half, w=128, block_out=4096),
        "K8": lambda: k8.stream_merge_runs(
            kbuf, runs=n8 // run_len, run_len=run_len, fan_in=8, w=128,
            block_out=4096),
        "K1 nan": lambda: k1.sort_chunks(nan_rows),
        "K1": lambda: k1.sort_chunks(rows)}
    for tag, total, longest in (("", 1 << 22, 16384), (" short", 1 << 20,
                                                        512)):
        lens = ragged(total, longest, gen)
        offs = torch.tensor([0] + lens, dtype=torch.int64).cumsum(0).to(
            device=dev, dtype=torch.int32)
        x = torch.randint(0, 1000, (total,), generator=gen,
                          device=dev).float()
        out["K5" + tag] = (lambda x=x, o=offs, c=longest:
                           k3.segment_sort(x, o, cap=c))
        out["K6" + tag] = (lambda x=x, o=offs, c=longest:
                           k3.segment_sort_kv(x, o, cap=c))
    return out


def bits(r):
    r = r if isinstance(r, tuple) else (r,)
    return [t.view(torch.int32) if t.dtype == torch.float32 else t
            for t in r]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("sources", nargs="+", help="LABEL=CSRC_DIR")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device", file=sys.stderr)
        return 1
    dirs = dict(s.split("=", 1) for s in args.sources)
    libs = build_all(dirs)
    calls = cases(torch.Generator(device="cuda").manual_seed(0))
    order = list(libs)
    ref = {}
    for rnd in range(args.rounds):
        for label in order + order[::-1]:
            _build._lib = libs[label]
            line = {"round": rnd, "label": label}
            for name, fn in calls.items():
                got = bits(fn())
                if name not in ref:
                    ref[name] = got
                elif not all(torch.equal(g, e) for g, e in zip(got,
                                                               ref[name])):
                    raise SystemExit(f"ab_kernels: {label} {name} differs "
                                     "from the first library's result")
                line[name] = time_ms(fn)
            print(json.dumps(line), flush=True)
    _build._lib = None
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
