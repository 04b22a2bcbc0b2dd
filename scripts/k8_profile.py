"""Where K8's time goes on the card: the kernel's per-warp clock counters,
compiled in under ``-DK8_PROFILE``.

    python3 scripts/k8_profile.py [--fans 8,2] [--variants base,nobfly]

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit. It builds ``src/repro_torch/csrc/stream_merge.cu`` with
the port's nvcc flags and ``-DK8_PROFILE``, which compiles in the kernel's
``clock64`` counters (accumulated per warp in shared memory, written out
once at the kernel's end), into ``build/k8_profile/<variant>/``, and runs one
pass over 2^27 float32 keys in runs of 2^20 (fan 2 over two runs of 2^26)
at w 128, block 4096, on the CTA count the card holds, key-only and KV
(ranks riding the keys). Variants: ``base`` (the kernel as it is) and
``nobfly`` (``-DK8_NO_BUTTERFLY``: the butterfly left out, wrong results,
a floor that shows the butterfly's share). Each line printed is one JSON
object with the pass's median time (CUDA events) and, per tree depth
(``"0"`` the root, ``"prod"`` the leaf producer warp), the mean SM clocks
a warp spent:

  full_wait   waiting for a child's row (mbarrier full)
  empty_wait  waiting for a free slot in the parent's ring
  partition   in the span's partition
  node_total  from the partition's end to the node's last cycle
  prod_total  the producer's whole loop
  bfly        in the butterfly
  put         handing a row on (the root's stores, or the ring write
              with its empty wait)
  next        taking a row (with its full wait)

The last line is the card's name, power limit and SM clock.
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
from repro_torch.kernels import _build, stream_merge as k8  # noqa: E402

COUNTERS = ("full_wait", "empty_wait", "partition", "node_total",
            "prod_total", "bfly", "put", "next")
MAX_CTAS = 8192

#: the kernel's compile-time switches per variant (``csrc/stream_merge.cu``)
VARIANTS = {"base": ("-DK8_PROFILE",),
            "nobfly": ("-DK8_PROFILE", "-DK8_NO_BUTTERFLY")}


def build(variants):
    csrc = ROOT / "src" / "repro_torch" / "csrc"
    procs = []
    for v in variants:
        d = ROOT / "build" / "k8_profile" / v
        d.mkdir(parents=True, exist_ok=True)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *VARIANTS[v],
               f"-DK8_PROF_CTAS={MAX_CTAS}", "-I", str(csrc), "-shared",
               "-o", str(d / "lib.so"), str(csrc / "stream_merge.cu"),
               str(csrc / "wide_merge.cu")]
        procs.append((v, d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True)))
    libs = {}
    for v, d, p in procs:
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"k8_profile: nvcc failed on {v}:\n{out}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        for name in ("flims_stream_merge", "flims_stream_merge_occupancy",
                     "flims_wide_tree_scratch"):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = _build._SIGNATURES[name]
        lib.k8_prof_read.argtypes = [ctypes.c_void_p]
        libs[v] = lib
    return libs


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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fans", default="8,2")
    ap.add_argument("--variants", default="base,nobfly")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k8_profile: no CUDA device", file=sys.stderr)
        return 1
    libs = build(args.variants.split(","))
    n, w, C = 1 << 27, 128, 4096
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(n, generator=gen, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    slack = k8.stream_slack(16, w, C)
    for fan in (int(f) for f in args.fans.split(",")):
        run_len = 1 << 26 if fan == 2 else 1 << 20
        L = fan.bit_length() - 1
        runs = torch.sort(x.reshape(-1, run_len), dim=1,
                          descending=True).values.reshape(-1)
        kb = torch.cat([runs, runs.new_full((slack,), float("-inf"))])
        rb = torch.arange(kb.shape[0], dtype=torch.int32, device="cuda")
        groups, bpg = n // run_len // fan, fan * run_len // C
        for kv in (False, True):
            out = torch.empty(n, device="cuda")
            out_r = torch.empty(n, dtype=torch.int32, device="cuda")
            for v, lib in libs.items():
                ctas = lib.flims_stream_merge_occupancy(1, int(kv), 1, L, w) * sms
                spg = k8.stream_spans(groups, bpg, ctas)
                grid = min(ctas, groups * spg, MAX_CTAS)
                # the check's flags, the wide form's scratch (idle here:
                # sorted NaN-free runs flag no group)
                check = torch.empty(groups + 1 + 2 * n // run_len,
                                    dtype=torch.int32, device="cuda")
                wctas = 2 * sms
                wmeta = torch.empty(n // run_len + 1 + 3 * (groups + 1),
                                    dtype=torch.int32, device="cuda")
                tables = torch.empty((L - 1) * n * (2 if kv else 1),
                                     dtype=torch.int32, device="cuda")
                wscratch = torch.empty(
                    wctas * lib.flims_wide_tree_scratch(int(kv), L, w, C),
                    dtype=torch.uint8, device="cuda")
                call_args = (1, int(kv), 1, L, kb.data_ptr(),
                             rb.data_ptr() if kv else None, out.data_ptr(),
                             out_r.data_ptr() if kv else None, n, n, run_len,
                             C, w, groups, spg, grid, check.data_ptr(),
                             (fan // 2 * run_len).bit_length(),
                             wmeta.data_ptr(), tables.data_ptr(),
                             wscratch.data_ptr(), wctas,
                             torch.cuda.current_stream().cuda_stream)
                ms = time_ms(lambda: lib.flims_stream_merge(*call_args))
                lib.k8_prof_zero()
                lib.flims_stream_merge(*call_args)
                torch.cuda.synchronize()
                raw = (ctypes.c_ulonglong * (MAX_CTAS * 32 * 8))()
                lib.k8_prof_read(ctypes.addressof(raw))
                P = np.frombuffer(raw, dtype=np.uint64).reshape(
                    MAX_CTAS, 32, 8)[:grid, :1 << L].astype(np.float64)
                roles = {}
                for wp in range(1 << L):
                    role = "prod" if wp == (1 << L) - 1 else \
                        str((wp + 1).bit_length() - 1)
                    roles.setdefault(role, []).append(P[:, wp].mean(0))
                print(json.dumps({
                    "variant": v, "fan_in": fan, "kv": kv, "ms": ms,
                    "ctas": grid, "spans_per_group": spg,
                    "clocks_per_warp": {r: dict(zip(COUNTERS, (
                        round(float(c), 1) for c in np.mean(vs, 0))))
                        for r, vs in roles.items()}}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
