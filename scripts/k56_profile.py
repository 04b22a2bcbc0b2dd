"""Where K5 / K6's time goes on the card: the kernel's clock counters,
compiled in under ``-DK56_PROFILE``.

    python3 scripts/k56_profile.py [--source PATH] [--label NAME]
                                   [--shapes seg,short]
    python3 scripts/k56_profile.py --split [--shapes wide65536,rows32768]

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit. It builds one K5 / K6 source (``--source``, by default
``src/repro_torch/csrc/segment_sort.cu``; another version of the file, such
as an earlier commit's, can be given to compare the two on one card) twice
with the port's nvcc flags, as is and with ``-DK56_PROFILE``, which compiles
in the kernel's ``clock64`` counters (the ``PROF*`` macros of
``csrc/bitonic_net.cuh``: summed per warp, written out at the warp's end for
the first ``NET_PROF_CTAS`` CTAs), into ``build/k56_profile/<label>/``. It
puts each library in turn under the wrapper
(``kernels/segmented_merge.py``) and runs ``segment_sort`` (K5) and
``segment_sort_kv`` (K6, descending) on float32 keys 0..999 (ties, no NaN),
from a seeded generator, at each shape:

- ``seg``: 2^22 keys in ragged segments of [0, 16384] keys, every 17th
  empty, cap 16384 (``chip_smoke.py``'s segmented-ops shape);
- ``short``: 2^20 keys in 4096 segments of [0, 512] keys, cap 512 (the
  (group x expert) buckets of a grouped Moonlight-16B-A3B dispatch).

Each line printed is one JSON object: the call's median time with the plain
build and with the instrumented one (CUDA events), the CTAs that ran, the
kernel's span on the card and the most CTAs an SM ran at once (from per-CTA
globaltimer stamps), the mean SM clocks per counter of a warp that did
work, and, by the segment's width ``next_pow2(len)``, the segments, their
CTAs' mean time on the card and their warps' mean clocks. Before them,
ptxas's registers, spills and shared memory per kernel; last, the card's
name, power limit and SM clock.

``--split`` builds nothing of its own: it runs the port's library (its
normal build) and, for each shape, prints the call's time (CUDA events)
and the device time of every kernel it launched, by name, from
``torch.profiler`` (the torch gathers of the bank included). Its shapes:
``wide<cap>``, 2^22 keys in ragged segments of [0, cap] keys at that cap
(``chip_smoke.phase_wide``'s K5 / K6 shapes; K5 and K6 descending), and
``rows<c>``, 2^24 keys in rows of c (K1 and K1kv, ``phase_wide``'s rows).
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
from k1_profile import build, residency, time_ms  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import segmented_merge as k56  # noqa: E402

SHAPES = {"seg": (1 << 22, 16384, 16384), "short": (1 << 20, 512, 512)}
SPLIT_SEG_KEYS, SPLIT_ROW_KEYS = 1 << 22, 1 << 24


def kernel_split(fn) -> dict:
    """(ms by CUDA events, {kernel name: device ms}) of one call, the
    device times from ``torch.profiler`` over one warm call."""
    from torch.profiler import ProfilerActivity, profile
    ms = time_ms(fn)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0)
        if t and ev.device_type == torch.autograd.DeviceType.CUDA:
            dev[ev.key[:90]] = round(t / 1e3, 4)
    return {"ms": ms, "device_ms_by_kernel": dev,
            "device_ms": round(sum(dev.values()), 4)}


def split_main(shapes) -> int:
    """``--split``: per shape, each call's time and its kernels'."""
    from repro_torch.kernels import bitonic_sort as k1
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in shapes:
        if shape.startswith("wide"):
            cap = int(shape[4:])
            lens = ragged(SPLIT_SEG_KEYS, cap, gen)
            offs = torch.tensor([0] + lens, dtype=torch.int64).cumsum(0).to(
                device="cuda", dtype=torch.int32)
            x = torch.randint(0, 1000, (SPLIT_SEG_KEYS,), generator=gen,
                              device="cuda").float()
            calls = {"K5": lambda: k56.segment_sort(x, offs, cap=cap),
                     "K6": lambda: k56.segment_sort_kv(x, offs, cap=cap)}
            info = {"keys": SPLIT_SEG_KEYS, "segments": len(lens),
                    "cap": cap}
        else:
            c = int(shape[4:])
            x = torch.randn(SPLIT_ROW_KEYS, generator=gen,
                            device="cuda").view(-1, c)
            r = torch.arange(SPLIT_ROW_KEYS, dtype=torch.int32,
                             device="cuda").view(-1, c)
            calls = {"K1": lambda: k1.sort_chunks(x),
                     "K1kv": lambda: k1.sort_chunks_kv(x, r)}
            info = {"keys": SPLIT_ROW_KEYS, "rows": x.shape[0], "c": c}
        for name, fn in calls.items():
            print(json.dumps({"shape": shape, "kernel": name, **info,
                              **kernel_split(fn)}), flush=True)
    return 0


def ragged(total: int, longest: int, gen) -> list:
    """Segment lengths in [0, longest] summing to ``total``, every 17th
    empty (as ``chip_smoke.seg_offsets``)."""
    draws = torch.randint(0, longest + 1, (4 * total // longest + 64,),
                          generator=gen, device="cuda").tolist()
    lens, rem = [], total
    for i, n in enumerate(draws):
        if not rem:
            break
        n = 0 if i % 17 == 5 else min(n, rem)
        lens.append(n)
        rem -= n
    while rem:
        lens.append(min(rem, longest))
        rem -= lens[-1]
    return lens


def by_width(lens, W, P, counters):
    """Per segment width next_pow2(len): segments, their CTAs' mean time on
    the card (µs) and their warps' mean clocks (CTA b = segment b)."""
    out = {}
    width = np.array([0 if n == 0 else 1 << (n - 1).bit_length()
                      for n in lens])
    for c in np.unique(width):
        sel = np.nonzero(width == c)[0]
        sel = sel[sel < len(W)]
        if not len(sel):
            continue
        warps = P[sel].reshape(-1, counters)
        warps = warps[warps.any(1)]
        out[int(c)] = {
            "segments": int((width == c).sum()),
            "cta_us_mean": float((W[sel, 1] - W[sel, 0]).mean()) / 1e3,
            "warp_clocks_mean": [round(float(v), 1) for v in
                                 (warps.mean(0) if len(warps) else
                                  np.zeros(counters))]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", default=str(
        ROOT / "src" / "repro_torch" / "csrc" / "segment_sort.cu"))
    ap.add_argument("--label", default="current")
    ap.add_argument("--shapes", default=None)
    ap.add_argument("--split", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k56_profile: no CUDA device", file=sys.stderr)
        return 1
    if args.split:
        rc = split_main((args.shapes or "wide65536,wide131072,wide32768,"
                         "rows32768,rows65536").split(","))
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip())
        return rc
    args.shapes = args.shapes or "seg,short"
    plain_lib, prof, ptxas = build(Path(args.source), args.label, "k56")
    print(json.dumps({"label": args.label, "ptxas": ptxas}), flush=True)
    names = prof.k56_prof_names().decode().split(",")
    ctas, warps, counters = (ctypes.c_int() for _ in range(3))
    prof.k56_prof_layout(ctypes.byref(ctas), ctypes.byref(warps),
                         ctypes.byref(counters))
    ctas, warps, counters = ctas.value, warps.value, counters.value
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in args.shapes.split(","):
        total, longest, cap = SHAPES[shape]
        lens = ragged(total, longest, gen)
        offs = torch.tensor([0] + lens, dtype=torch.int64).cumsum(0).to(
            device="cuda", dtype=torch.int32)
        x = torch.randint(0, 1000, (total,), generator=gen,
                          device="cuda").float()
        for kv in (False, True):
            fn = (lambda: k56.segment_sort_kv(x, offs, cap=cap)) if kv else \
                (lambda: k56.segment_sort(x, offs, cap=cap))
            _build._lib = plain_lib
            ms = time_ms(fn)
            expect = fn()
            _build._lib = prof
            ms_prof = time_ms(fn)
            prof.k56_prof_zero()
            got = fn()
            torch.cuda.synchronize()
            same = all(torch.equal(g.view(torch.int32), e.view(torch.int32))
                       for g, e in zip(got if kv else (got,),
                                       expect if kv else (expect,)))
            raw = (ctypes.c_ulonglong * (ctas * warps * counters))()
            prof.k56_prof_read(ctypes.addressof(raw))
            P = np.frombuffer(raw, dtype=np.uint64).reshape(
                ctas, warps, counters).astype(np.float64)
            wraw = (ctypes.c_ulonglong * (ctas * 3))()
            prof.k56_when_read(ctypes.addressof(wraw))
            W = np.frombuffer(wraw, dtype=np.uint64).reshape(ctas, 3).astype(
                np.float64)
            ran = W[:, 1] > 0
            busy = P[ran].reshape(-1, counters)
            busy = busy[busy.any(1)]
            line = {
                "label": args.label, "shape": shape, "keys": total,
                "segments": len(lens), "cap": cap, "kv": kv, "ms": ms,
                "ms_instrumented": ms_prof, "same_as_plain_build": same,
                "ctas_sampled": int(ran.sum()), "warps_sampled": len(busy),
                **residency(W[ran]),
                "clocks_per_warp": dict(zip(names, (
                    round(float(v), 1) for v in busy.mean(0))))}
            if int(ran.sum()) == min(len(lens), ctas):
                line["by_width"] = by_width(lens, W[:len(lens)],
                                            P[:len(lens)], counters)
            print(json.dumps(line), flush=True)
    _build._lib = None
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
