"""Where K4's time goes on the card: the kernel's clock counters, compiled
in under ``-DK4_PROFILE``.

    python3 scripts/k4_profile.py [--cases timed,first,last]

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit. It builds ``src/repro_torch/csrc/merge_tree.cu`` with the
port's nvcc flags and ``-DK4_PROFILE``, which compiles in the kernel's
``clock64`` counters (summed in shared memory, written out once at the
kernel's end), into ``build/k4_profile/``, puts that library under the
wrapper (``kernels/merge_tree.py``) and runs one pass of ``merge_tree_runs``
and ``merge_tree_runs_kv`` (float32 keys, ranks riding them) per case:

  timed   2^24 keys in runs of 4096, groups of 4, w 128, block 4096 (the
          pass ``chip_smoke.py`` times)
  first   engine.sort's first pass: runs of 256, groups of 4, w 128,
          block 1024
  last    engine.sort's last pass: 4 runs of 2^22, w 128, block 4096

The counters' names and layout come from the kernel (``k4_prof_names``,
``k4_prof_layout``: CTAs x warps x counters); a kernel that counts per CTA
has one warp slot, one that counts per warp names each warp by its role
(``"0"`` the root, ``"1"``, ``"2"`` deeper tree depths, ``"prod"`` the leaf
producer). Each line printed is one JSON object with the pass's median time
(CUDA events, the instrumented build), the CTAs that ran and, per role, the
mean SM clocks of a CTA that did work. The last line is the card's name,
power limit and SM clock.
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
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.kernels import _build, merge_tree as k4  # noqa: E402

N = 1 << 24
#: (run length, block_out) per case; groups of 4, w 128
CASES = {"timed": (4096, 4096), "first": (256, 1024), "last": (1 << 22, 4096)}


def build() -> ctypes.CDLL:
    csrc = ROOT / "src" / "repro_torch" / "csrc"
    d = ROOT / "build" / "k4_profile"
    d.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-DK4_PROFILE", "-I",
           str(csrc), "-shared", "-o", str(d / "lib.so"),
           str(csrc / "merge_tree.cu"), str(csrc / "wide_merge.cu")]
    p = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True)
    if p.returncode:
        raise SystemExit(f"k4_profile: nvcc failed:\n{p.stdout}")
    lib = ctypes.CDLL(str(d / "lib.so"))
    for name, (res, args) in _build._SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, args
    lib.k4_prof_names.restype = ctypes.c_char_p
    lib.k4_prof_read.argtypes = [ctypes.c_void_p]
    if hasattr(lib, "k4_when_read"):
        lib.k4_when_read.argtypes = [ctypes.c_void_p]
    return lib


def residency(when: np.ndarray) -> dict:
    """From per-CTA (start ns, end ns, SM): the pass's span on the card,
    the CTAs' mean and longest run, and the most CTAs any SM ran at once."""
    start, end, sm = when[:, 0], when[:, 1], when[:, 2]
    most = 0
    for s in np.unique(sm):
        ev = sorted([(t, 1) for t in start[sm == s]] +
                    [(t, -1) for t in end[sm == s]], key=lambda e: (e[0], e[1]))
        live = 0
        for _, d in ev:
            live += d
            most = max(most, live)
    return {"wall_us": float(end.max() - start.min()) / 1e3,
            "cta_us_mean": float((end - start).mean()) / 1e3,
            "cta_us_max": float((end - start).max()) / 1e3,
            "most_ctas_on_an_sm": int(most)}


def time_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return sorted(ts)[len(ts) // 2]


def roles(warps: int, group: int):
    """Each counted warp's role: the CTA, or a tree depth and the
    producer (the kernel's ``group`` warps of its ``warps`` slots)."""
    if warps == 1:
        return ["cta"]
    return [str((wp + 1).bit_length() - 1) for wp in range(group - 1)] + \
        ["prod"]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default="timed,first,last")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k4_profile: no CUDA device", file=sys.stderr)
        return 1
    lib = build()
    _build._lib = lib            # the wrapper launches the instrumented build
    names = lib.k4_prof_names().decode().split(",")
    ctas, warps, counters = (ctypes.c_int() for _ in range(3))
    lib.k4_prof_layout(ctypes.byref(ctas), ctypes.byref(warps),
                       ctypes.byref(counters))
    ctas, warps, counters = ctas.value, warps.value, counters.value
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(N, generator=gen, device="cuda")
    rk = torch.arange(N, dtype=torch.int32, device="cuda")
    for case in args.cases.split(","):
        run_len, bo = CASES[case]
        runs = torch.sort(x.reshape(-1, run_len), dim=1,
                          descending=True).values.reshape(-1)
        st = torch.arange(0, N, run_len, dtype=torch.int32, device="cuda")
        ln = torch.full_like(st, run_len)
        kw = dict(group=4, n_out=N, w=128, block_out=bo)
        for kv in (False, True):
            fn = (lambda: k4.merge_tree_runs_kv(runs, rk, st, ln, **kw)) \
                if kv else (lambda: k4.merge_tree_runs(runs, st, ln, **kw))
            ms = time_ms(fn)
            lib.k4_prof_zero()
            fn()
            torch.cuda.synchronize()
            raw = (ctypes.c_ulonglong * (ctas * warps * counters))()
            lib.k4_prof_read(ctypes.addressof(raw))
            P = np.frombuffer(raw, dtype=np.uint64).reshape(
                ctas, warps, counters).astype(np.float64)
            ran = P.reshape(ctas, -1).any(1)
            extra = {}
            if hasattr(lib, "k4_when_read"):
                wraw = (ctypes.c_ulonglong * (ctas * 3))()
                lib.k4_when_read(ctypes.addressof(wraw))
                W = np.frombuffer(wraw, dtype=np.uint64).reshape(ctas, 3)
                extra = residency(W[ran].astype(np.float64))
            if warps > 1:
                sms = torch.cuda.get_device_properties(0).multi_processor_count
                extra["ms_by_ctas"] = {
                    k * sms: time_ms(lambda: (
                        k4.merge_tree_runs_kv(runs, rk, st, ln, _ctas=k * sms,
                                              **kw) if kv else
                        k4.merge_tree_runs(runs, st, ln, _ctas=k * sms, **kw)))
                    for k in (1, 2, 3, 4, 5, 6)}
            out = {}
            for wp, role in enumerate(roles(warps, kw["group"])):
                out.setdefault(role, []).append(P[ran, wp].mean(0))
            print(json.dumps({
                "case": case, "kv": kv, "run_len": run_len, "block_out": bo,
                "ms": ms, "ctas_ran": int(ran.sum()), **extra,
                "clocks_per_cta": {r: dict(zip(names, (
                    round(float(c), 1) for c in np.mean(v, 0))))
                    for r, v in out.items()}}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
