"""Where the wide tree form's time goes on the card (``csrc/wide_merge.cu``,
``flims_wide_tree``): device ms by kernel and the tree kernel's clocks.

    python3 scripts/wide_profile.py [--source LABEL=PATH ...] [--keys N]
                                    [--cases k4_L4,k8_f32,...]

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit. Each ``--source`` (default: ``current=`` the repository's
``src/repro_torch/csrc/wide_merge.cu``; another version of the file that
has the ``WIDE_PROFILE`` counters, such as a later commit's from ``git show
<rev>:src/repro_torch/csrc/wide_merge.cu``, can be given beside it) is built
alone with the port's nvcc flags, as is and with ``-DWIDE_PROFILE``, under
``build/wide_profile/<label>/``, all builds started together.

Every case calls ``flims_wide_tree`` through ctypes with its own buffers, so
versions whose Python wrappers differ compare too. Cases, at ``--keys``
(default 2^22) float32 keys 0..999 in runs sorted descending (``chip_smoke``
``tie_keys``): ``chip_smoke.phase_params``' wide rows (K4 at 4 and 5 fused
levels at w 32, at w 4 and 256 in groups of 4; K8 at fan-in 32 at w 32 and
256 and at fan-in 8 at w 256; K2 at w 2048, one run pair), and the main
path's case: K4 at w 128, 2 levels, block 4096, runs of 4096 float32
``randn`` keys of which 2^-12 are a quiet NaN (``engine.sort``'s middle
passes, where the run check flags every group), key-only and KV.

Each line printed is one JSON object: the call's median ms (CUDA events, 7
calls), its byte bound over HBM counting the tables (:func:`bound_ms`),
each kernel's device ms by launch order from ``torch.profiler``
(prefix, the tables from level L - 1 down, the tree), the instrumented
build's ms, the tree kernel's clocks per block by phase (search: the nested
co-ranks; heads: the head reads and selector; count; butterfly; store: the
row or output writes and the state; pull: the walk between nodes; lane 0
of each warp sums its clocks), its FLiMS cycles per block, and whether the output equals
the first version's bit for bit. Last, the card's name, power limit and SM
clock.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
sys.path.insert(0, str(ROOT / "src"))
from k1_profile import time_ms  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flims_merge import block_size, search_steps  # noqa: E402
from repro_torch.kernels.stream_merge import _block, _wide_steps  # noqa: E402
from repro_torch.launch.roofline import HBM_BW, stream_bytes  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "csrc"
NAMES = ("search", "heads", "count", "butterfly", "store", "pull", "cycles",
         "blocks")

def build(sources):
    """{label: (plain library, instrumented library, ptxas log)}, every
    build started together."""
    procs = []
    for label, path in sources:
        d = ROOT / "build" / "wide_profile" / label
        d.mkdir(parents=True, exist_ok=True)
        src = Path(path).resolve()
        for name, extra in (("plain", []), ("prof", ["-DWIDE_PROFILE"])):
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *extra, "-I", str(CSRC),
                   "-shared", "-o", str(d / f"{name}.so"), str(src)]
            procs.append((label, name, d, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    libs = {}
    for label, name, d, p in procs:
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"wide_profile: nvcc failed on {label}:\n{out}")
        lib = ctypes.CDLL(str(d / f"{name}.so"))
        for fn in ("flims_wide_tree", "flims_wide_tree_scratch",
                   "flims_wide_tree_occupancy"):
            getattr(lib, fn).restype, getattr(lib, fn).argtypes = \
                _build._SIGNATURES[fn]
        if name == "prof":
            lib.wide_prof_read.argtypes = [ctypes.c_void_p]
        entry = libs.setdefault(label, {})
        entry[name] = lib
        if name == "plain":
            entry["ptxas"] = [ln for ln in out.splitlines()
                              if "registers" in ln or "spill" in ln]
    return libs


def uniform_runs(x, run_len):
    runs = torch.sort(x.view(-1, run_len), dim=-1,
                      descending=True).values.reshape(-1)
    st = torch.arange(0, x.numel(), run_len, dtype=torch.int32, device="cuda")
    return runs, st, torch.full_like(st, run_len)


def cases(n, gen):
    """(name, kwargs of one ``flims_wide_tree`` call) of every case."""
    x = torch.randint(0, 1000, (n,), generator=gen, device="cuda").float()
    out = []
    for name, L, w in (("k4_L4", 4, 32), ("k4_L5", 5, 32), ("k4_w4", 2, 4),
                       ("k4_w256", 2, 256)):
        runs, st, ln = uniform_runs(x, n >> L)
        C = block_size(n, w, 1024)
        out.append((name, dict(keys=runs, ranks=None, starts=st, lens=ln, L=L,
                               w=w, C=C, steps=search_steps(n), sel_max=0,
                               pairs=0, ntot=n if L > 1 else 0)))
    for name, fan, w in (("k8_f32", 32, 32), ("k8_f32_w256", 32, 256),
                         ("k8_f8_w256", 8, 256)):
        L = fan.bit_length() - 1
        run_len = n // fan
        runs, st, ln = uniform_runs(x, run_len)
        out.append((name, dict(keys=runs, ranks=None, starts=st, lens=ln, L=L,
                               w=w, C=_block(4096, run_len, fan, w),
                               steps=_wide_steps(L, run_len), sel_max=0,
                               pairs=0, ntot=n)))
    half = n // 2
    a, b = (torch.sort(v, descending=True).values for v in (x[:half],
                                                           x[half:]))
    ab = torch.cat([a, b])
    out.append(("k2_w2048", dict(
        keys=ab, ranks=None, kb=ab,
        starts=torch.tensor([0, half], dtype=torch.int32, device="cuda"),
        lens=torch.tensor([half, n - half], dtype=torch.int32, device="cuda"),
        L=1, w=2048, C=block_size(n, 2048, 4096), steps=search_steps(n),
        sel_max=1, pairs=1, ntot=0)))
    y = torch.randn(n, generator=gen, device="cuda")
    y[torch.randperm(n, generator=gen, device="cuda")[:n >> 12]] = float("nan")
    runs, st, ln = uniform_runs(y, 4096)
    for kv in (False, True):
        out.append(("main_nan" + ("_kv" if kv else ""), dict(
            keys=runs, ranks=torch.arange(n, dtype=torch.int32, device="cuda")
            if kv else None, starts=st, lens=ln, L=2, w=128, C=4096,
            steps=search_steps(n), sel_max=0, pairs=0, ntot=n)))
    return out


def call(lib, c):
    """One ``flims_wide_tree`` launch of case ``c`` on ``lib``: the output."""
    kv = c["ranks"] is not None
    n, L, w, C = c["keys"].numel(), c["L"], c["w"], c["C"]
    runs = c["starts"].numel()
    kb = c.get("kb", c["keys"])
    per_cta = lib.flims_wide_tree_scratch(int(kv), L, w, C)
    ctas = lib.flims_wide_tree_occupancy(1, int(kv), 1, L, w) * \
        torch.cuda.get_device_properties(0).multi_processor_count
    meta = torch.empty(runs + 1 + 3 * (runs // (1 << L) + 1),
                       dtype=torch.int32, device="cuda")
    tables = torch.empty(max(1, (L - 1) * c["ntot"] * (2 if kv else 1)),
                         dtype=torch.int32, device="cuda")
    scratch = torch.empty(max(1, ctas * per_cta), dtype=torch.uint8,
                          device="cuda")
    out = torch.empty(n, device="cuda")
    out_r = torch.empty(n, dtype=torch.int32, device="cuda") if kv else None
    rk = c["ranks"]
    P = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = lib.flims_wide_tree(
        1, int(kv), 1, c["sel_max"], L, P(c["keys"]), P(rk), P(kb), P(rk),
        c["pairs"], P(c["starts"]), P(c["lens"]), runs, n, C, w, c["steps"],
        None, P(meta), P(tables), c["ntot"], P(scratch), ctas, P(out),
        P(out_r), torch.cuda.current_stream().cuda_stream)
    if rc:
        raise SystemExit(f"wide_profile: flims_wide_tree returned {rc}")
    return (out, out_r) if kv else (out,)


def kernel_ms(fn, reps=5):
    """Each kernel's device ms by launch order in one call (the mean over
    the calls whose every launch the profiler kept; a call starts at its
    prefix kernel)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    calls = []
    for e in prof.events():
        if not str(e.device_type).endswith("CUDA"):
            continue
        if "prefix" in e.name or not calls:
            calls.append([])
        calls[-1].append((e.name, e.time_range.elapsed_us()))
    full = [c for c in calls if len(c) == max(len(c) for c in calls)]
    rows = {}
    for i, (name, _) in enumerate(full[0]):
        tag = ("prefix" if "prefix" in name else "tree" if "tree_kernel" in
               name else "table" if "table" in name else name[:40])
        rows[f"{i}:{tag}"] = round(sum(c[i][1] for c in full) / len(full)
                                   / 1e3, 5)
    return rows


def bound_ms(c) -> float:
    """The least time of case ``c`` over HBM: its keys (and ranks) read and
    written once, and each of its L - 1 inner levels' tables written once
    and read once, as many streaming passes as fused levels."""
    lane = 4 + (4 if c["ranks"] is not None else 0)
    return stream_bytes(c["keys"].numel(), lane, c["L"]) / HBM_BW * 1e3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append", default=[])
    ap.add_argument("--keys", type=int, default=1 << 22)
    ap.add_argument("--cases", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("wide_profile: no CUDA device", file=sys.stderr)
        return 1
    sources = [s.split("=", 1) for s in args.source] or \
        [("current", str(CSRC / "wide_merge.cu"))]
    libs = build(sources)
    for label, entry in libs.items():
        print(json.dumps({"label": label, "ptxas": entry["ptxas"]}),
              flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    want = set(args.cases.split(",")) if args.cases else None
    for name, c in cases(args.keys, gen):
        if want and name not in want:
            continue
        first = None
        for label, entry in libs.items():
            plain, prof = entry["plain"], entry["prof"]
            got = call(plain, c)
            torch.cuda.synchronize()
            first = first or got
            same = all(torch.equal(g.view(torch.int32), e.view(torch.int32))
                       for g, e in zip(got, first))
            ms = time_ms(lambda: call(plain, c))
            dev = kernel_ms(lambda: call(plain, c))
            ms_prof = time_ms(lambda: call(prof, c))
            prof.wide_prof_zero()
            call(prof, c)
            torch.cuda.synchronize()
            raw = (ctypes.c_ulonglong * len(NAMES))()
            prof.wide_prof_read(ctypes.addressof(raw))
            cnt = np.frombuffer(raw, dtype=np.uint64).astype(np.float64)
            blocks = max(cnt[7], 1.0)
            print(json.dumps({
                "label": label, "case": name, "keys": args.keys,
                "L": c["L"], "w": c["w"], "C": c["C"],
                "kv": c["ranks"] is not None, "ms": ms,
                "bound_ms": bound_ms(c),
                "ms_instrumented": ms_prof, "device_ms": dev,
                "device_ms_sum": round(sum(dev.values()), 5),
                "blocks": int(cnt[7]),
                "cycles_per_block": round(cnt[6] / blocks, 2),
                "clocks_per_block": {k: round(float(v) / blocks, 1)
                                     for k, v in zip(NAMES[:6], cnt[:6])},
                "same_as_first": same}), flush=True)
            if not same:
                print(f"wide_profile: {label} differs from the first version "
                      f"on {name}", file=sys.stderr)
                return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
