"""Where K1's time goes on the card: the kernel's clock counters, compiled
in under ``-DK1_PROFILE``.

    python3 scripts/k1_profile.py [--source PATH] [--label NAME]
                                  [--shapes 65536x256,524288x256]

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit. It builds one K1 source (``--source``, by default
``src/repro_torch/csrc/bitonic_sort.cu``; another version of the file, such
as an earlier commit's, can be given to compare the two on one card) twice
with the port's nvcc flags, as is and with ``-DK1_PROFILE``, which compiles
in the kernel's ``clock64`` counters (summed per warp in shared memory,
written out at the kernel's end for the first ``K1_PROF_CTAS`` CTAs), into
``build/k1_profile/<label>/``. It puts each library in turn under the
wrapper (``kernels/bitonic_sort.py``) and runs ``sort_chunks`` and
``sort_chunks_kv`` (float32 keys from a seeded generator, ranks
``arange``) at each (rows, c) shape.

The counters' names and layout come from the kernel (``k1_prof_names``,
``k1_prof_layout``: CTAs x warps x counters). Each line printed is one JSON
object: the call's median time with the plain build and with the
instrumented one (CUDA events), the CTAs that ran, the kernel's span on the
card and the most CTAs an SM ran at once (from per-CTA globaltimer stamps),
the resident CTAs an SM the occupancy query gives where the source has the
query, and the mean SM clocks per counter of a warp that did work. Before
them, ptxas's registers, spills and shared memory per kernel; last, the
card's name, power limit and SM clock.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.kernels import _build, bitonic_sort as k1  # noqa: E402


def build(source: Path, label: str, kernel: str = "k1"):
    """(plain library, instrumented library, ptxas lines) of ``source``,
    built as is and with ``-D<KERNEL>_PROFILE`` under
    ``build/<kernel>_profile/<label>/`` (``kernel``: the counters' prefix,
    ``k1`` or ``k56``)."""
    csrc = ROOT / "src" / "repro_torch" / "csrc"
    d = ROOT / "build" / f"{kernel}_profile" / label
    d.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, extra in (("plain", []),
                        ("prof", [f"-D{kernel.upper()}_PROFILE"])):
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *extra, "-I", str(csrc),
               "-shared", "-o", str(d / f"{name}.so"), str(source)]
        procs.append((name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs, log = {}, ""
    for name, p in procs:
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"{kernel}_profile: nvcc failed:\n{out}")
        if name == "plain":
            log = out
        lib = ctypes.CDLL(str(d / f"{name}.so"))
        for fn_name, (res, args) in _build._SIGNATURES.items():
            if hasattr(lib, fn_name):
                fn = getattr(lib, fn_name)
                fn.restype, fn.argtypes = res, args
        libs[name] = lib
    prof = libs["prof"]
    getattr(prof, f"{kernel}_prof_names").restype = ctypes.c_char_p
    getattr(prof, f"{kernel}_prof_read").argtypes = [ctypes.c_void_p]
    getattr(prof, f"{kernel}_when_read").argtypes = [ctypes.c_void_p]
    return libs["plain"], prof, ptxas_lines(log)


def ptxas_lines(log: str):
    """Per compiled kernel: its (mangled) name, registers, spill bytes and
    static shared memory, from nvcc's -Xptxas -v report."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            out.append({"kernel": name, "registers": int(m.group(1)),
                        "smem": int(smem.group(1)) if smem else 0})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and out:
            out[-1]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
    return out


def residency(when: np.ndarray) -> dict:
    """From per-CTA (start ns, end ns, SM): the span on the card, the CTAs'
    mean run and the most CTAs any SM ran at once."""
    start, end, sm = when[:, 0], when[:, 1], when[:, 2]
    most = 0
    for s in np.unique(sm):
        ev = sorted([(t, 1) for t in start[sm == s]] +
                    [(t, -1) for t in end[sm == s]], key=lambda e: (e[0], e[1]))
        live = 0
        for _, d in ev:
            live += d
            most = max(most, live)
    return {"span_us": float(end.max() - start.min()) / 1e3,
            "cta_us_mean": float((end - start).mean()) / 1e3,
            "most_ctas_on_an_sm": int(most)}


def time_ms(fn, reps=7):
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", default=str(
        ROOT / "src" / "repro_torch" / "csrc" / "bitonic_sort.cu"))
    ap.add_argument("--label", default="current")
    ap.add_argument("--shapes", default="65536x256,524288x256")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_profile: no CUDA device", file=sys.stderr)
        return 1
    plain_lib, prof, ptxas = build(Path(args.source), args.label)
    print(json.dumps({"label": args.label, "ptxas": ptxas}), flush=True)
    names = prof.k1_prof_names().decode().split(",")
    ctas, warps, counters = (ctypes.c_int() for _ in range(3))
    prof.k1_prof_layout(ctypes.byref(ctas), ctypes.byref(warps),
                        ctypes.byref(counters))
    ctas, warps, counters = ctas.value, warps.value, counters.value
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for shape in args.shapes.split(","):
        m, c = (int(v) for v in shape.split("x"))
        x = torch.randn(m * c, generator=gen, device="cuda").reshape(m, c)
        r = torch.arange(m * c, dtype=torch.int32,
                         device="cuda").reshape(m, c)
        for kv in (False, True):
            fn = (lambda: k1.sort_chunks_kv(x, r)) if kv else \
                (lambda: k1.sort_chunks(x))
            _build._lib = plain_lib
            ms = time_ms(fn)
            expect = fn()
            extra = {}
            if hasattr(plain_lib, "flims_bitonic_rows_occupancy"):
                per_sm = plain_lib.flims_bitonic_rows_occupancy(
                    _build.DTYPE_CODES[torch.float32], int(kv), 1, c)
                extra = {"resident_ctas_per_sm": per_sm,
                         "resident_ctas": per_sm * sms}
            _build._lib = prof
            ms_prof = time_ms(fn)
            prof.k1_prof_zero()
            got = fn()
            torch.cuda.synchronize()
            same = all(torch.equal(g.view(torch.int32), e.view(torch.int32))
                       for g, e in zip(got if kv else (got,),
                                       expect if kv else (expect,)))
            raw = (ctypes.c_ulonglong * (ctas * warps * counters))()
            prof.k1_prof_read(ctypes.addressof(raw))
            P = np.frombuffer(raw, dtype=np.uint64).reshape(
                ctas, warps, counters).astype(np.float64)
            wraw = (ctypes.c_ulonglong * (ctas * 3))()
            prof.k1_when_read(ctypes.addressof(wraw))
            W = np.frombuffer(wraw, dtype=np.uint64).reshape(ctas, 3)
            ran = W[:, 1] > 0
            busy = P[ran].reshape(-1, counters)
            busy = busy[busy.any(1)]
            print(json.dumps({
                "label": args.label, "rows": m, "c": c, "kv": kv, "ms": ms,
                "ms_instrumented": ms_prof, "same_as_plain_build": same,
                "ctas_sampled": int(ran.sum()), "warps_sampled": len(busy),
                **residency(W[ran].astype(np.float64)), **extra,
                "clocks_per_warp": dict(zip(names, (
                    round(float(v), 1) for v in busy.mean(0))))}),
                flush=True)
    _build._lib = None
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
