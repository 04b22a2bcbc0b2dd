"""Where K2 / K3's time goes on the card: the merge kernel's clock counters,
compiled in under ``-DK23_PROFILE``.

    python3 scripts/k23_profile.py [--csrc DIR] [--label NAME]
                                   [--cases k2,k2kv,k3,k3kv,k3r]

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit. It builds ``flims_merge.cu`` of one csrc directory
(``--csrc``, by default ``src/repro_torch/csrc``; an earlier commit's,
unpacked into a gitignored path with ``git archive <rev>
src/repro_torch/csrc``, can be given to compare two versions on one card)
twice with the port's nvcc flags, as is and with ``-DK23_PROFILE``, which
compiles in the kernel's ``clock64`` counters (per warp, for the first
``K23_PROF_CTAS`` CTAs, with each CTA's start, end and SM), into
``build/k23_profile/<label>/``. It puts each library in turn under the
wrappers and runs, on float32 keys from a seeded generator:

- ``k2`` / ``k2kv``: ``flims_merge`` / ``flims_merge_kv`` of two sorted
  2^23 runs (w 128, C 4096), the smoke's K2 shape;
- ``k3`` / ``k3kv``: ``segmented_merge_runs`` / ``_kv`` of the same pair
  as one run pair, the K3 launch of ``engine.merge_runs`` over 128 runs
  (its last level merges two runs);
- ``k3r``: ``segmented_merge_runs`` over 257 ragged run pairs totalling
  2^22 keys at the wrapper's defaults (w 32, C 1024), as
  ``engine.segment_merge`` calls it.

Each line printed is one JSON object: the call's median time with the plain
build and with the instrumented one (CUDA events), whether both builds gave
the same result, the CTAs that ran, the kernel's span on the card and the
most CTAs an SM ran at once, the blocks a warp took, and the mean SM clocks
per counter of a warp that did work (names from the source,
``k23_prof_names``). Before them, ptxas's registers, spills and shared
memory per kernel; last, the card's name, power limit and SM clock.
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
from k1_profile import ptxas_lines, residency, time_ms  # noqa: E402
from k56_profile import ragged  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flims_merge as k2  # noqa: E402
from repro_torch.kernels import segmented_merge as k3  # noqa: E402


def build(csrc: Path, label: str):
    """(plain library, instrumented library, ptxas lines) of
    ``csrc/flims_merge.cu``, built as is and with ``-DK23_PROFILE``."""
    d = ROOT / "build" / "k23_profile" / label
    d.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, extra in (("plain", []), ("prof", ["-DK23_PROFILE"])):
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *extra, "-I", str(csrc),
               "-shared", "-o", str(d / f"{name}.so"),
               str(csrc / "flims_merge.cu")]
        procs.append((name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs, log = {}, ""
    for name, p in procs:
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"k23_profile: nvcc failed:\n{out}")
        if name == "plain":
            log = out
        lib = ctypes.CDLL(str(d / f"{name}.so"))
        for fn_name, (res, argt) in _build._SIGNATURES.items():
            if hasattr(lib, fn_name):
                fn = getattr(lib, fn_name)
                fn.restype, fn.argtypes = res, argt
        libs[name] = lib
    prof = libs["prof"]
    prof.k23_prof_names.restype = ctypes.c_char_p
    prof.k23_prof_read.argtypes = [ctypes.c_void_p]
    prof.k23_when_read.argtypes = [ctypes.c_void_p]
    return libs["plain"], prof, ptxas_lines(log)


def cases(gen):
    """{name: call} at the shapes of the module docstring."""
    dev = "cuda"
    half = 1 << 22
    ma = torch.sort(torch.randn(half * 2, generator=gen, device=dev),
                    descending=True).values
    mb = torch.sort(torch.randn(half * 2, generator=gen, device=dev),
                    descending=True).values
    n = 4 * half
    ra = torch.arange(2 * half, dtype=torch.int32, device=dev)
    rb = 2 * half + ra
    cat = torch.cat([ma, mb])
    rcat = torch.arange(n, dtype=torch.int32, device=dev)
    pair = [torch.tensor([v], dtype=torch.int32, device=dev)
            for v in (0, 2 * half, 2 * half, 2 * half)]
    lens = ragged(1 << 22, 1 << 14, gen)
    lens += [0] * (len(lens) % 2)
    parts = [torch.sort(torch.randn(m, generator=gen, device=dev),
                        descending=True).values for m in lens]
    buf = torch.cat(parts)
    st = torch.tensor([0] + lens[:-1], dtype=torch.int64).cumsum(0).to(
        device=dev, dtype=torch.int32)
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    rpairs = (st[0::2].contiguous(), ln[0::2].contiguous(),
              st[1::2].contiguous(), ln[1::2].contiguous())
    M = dict(w=128, block_out=4096)
    return {
        "k2": lambda: k2.flims_merge(ma, mb, **M),
        "k2kv": lambda: k2.flims_merge_kv(ma, ra, mb, rb, **M),
        "k3": lambda: k3.segmented_merge_runs(cat, cat, *pair, n_out=n, **M),
        "k3kv": lambda: k3.segmented_merge_runs_kv(cat, rcat, cat, rcat,
                                                   *pair, n_out=n, **M),
        "k3r": lambda: k3.segmented_merge_runs(buf, buf, *rpairs,
                                               n_out=buf.numel())}


def bits(r):
    r = r if isinstance(r, tuple) else (r,)
    return [t.view(torch.int32) if t.dtype == torch.float32 else t
            for t in r]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--csrc", default=str(ROOT / "src" / "repro_torch" /
                                          "csrc"))
    ap.add_argument("--label", default="current")
    ap.add_argument("--cases", default="k2,k2kv,k3,k3kv,k3r")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k23_profile: no CUDA device", file=sys.stderr)
        return 1
    plain_lib, prof, ptxas = build(Path(args.csrc).resolve(), args.label)
    print(json.dumps({"label": args.label, "ptxas": ptxas}), flush=True)
    names = prof.k23_prof_names().decode().split(",")
    ctas, warps, counters = (ctypes.c_int() for _ in range(3))
    prof.k23_prof_layout(ctypes.byref(ctas), ctypes.byref(warps),
                         ctypes.byref(counters))
    ctas, warps, counters = ctas.value, warps.value, counters.value
    calls = cases(torch.Generator(device="cuda").manual_seed(0))
    for name in args.cases.split(","):
        fn = calls[name]
        _build._lib = plain_lib
        ms = time_ms(fn)
        expect = bits(fn())
        _build._lib = prof
        ms_prof = time_ms(fn)
        prof.k23_prof_zero()
        got = bits(fn())
        torch.cuda.synchronize()
        same = all(torch.equal(g, e) for g, e in zip(got, expect))
        raw = (ctypes.c_ulonglong * (ctas * warps * counters))()
        prof.k23_prof_read(ctypes.addressof(raw))
        P = np.frombuffer(raw, dtype=np.uint64).reshape(
            ctas, warps, counters).astype(np.float64)
        wraw = (ctypes.c_ulonglong * (ctas * 3))()
        prof.k23_when_read(ctypes.addressof(wraw))
        W = np.frombuffer(wraw, dtype=np.uint64).reshape(ctas, 3).astype(
            np.float64)
        ran = W[:, 1] > 0
        busy = P[ran].reshape(-1, counters)
        busy = busy[busy[:, names.index("total")] > 0]
        print(json.dumps({
            "label": args.label, "case": name, "ms": ms,
            "ms_instrumented": ms_prof, "same_as_plain_build": same,
            "ctas_sampled": int(ran.sum()), "warps_sampled": len(busy),
            **residency(W[ran]),
            "clocks_per_warp": dict(zip(names, (
                round(float(v), 1) for v in busy.mean(0))))}), flush=True)
    _build._lib = None
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
