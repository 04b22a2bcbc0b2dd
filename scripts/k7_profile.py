"""Where K7's time goes on the card: the kernel's clock counters, compiled
in under ``-DK7_PROFILE``.

    python3 scripts/k7_profile.py [--source PATH] [--label NAME]
                                  [--shapes mixtral,sorted,moonlight]
                                  [--shapes moon4096,moon65536,group2m]

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit. It builds one K7 source (``--source``, by default
``src/repro_torch/csrc/route_fuse.cu``; another version of the file with
the same C interface, such as an earlier commit's, can be given to compare
the two on one card) twice
with the port's nvcc flags, as is and with ``-DK7_PROFILE``, which compiles
in the kernel's ``clock64`` counters (summed per phase over the warps, with
each of its launches' span from globaltimer stamps), into
``build/k7_profile/<label>/``. It puts each library in turn under the
wrapper (``kernels/route_fuse.py``) and runs ``moe_route`` on float32
router logits from a seeded generator at the smoke's three route shapes:

- ``mixtral``: a grouped Mixtral-8x22B chunk, (1, 2048, 8), k 2;
- ``sorted``: the sorted Mixtral-8x22B layer, (1, 4096, 8), k 2;
- ``moonlight``: a grouped Moonlight-16B-A3B chunk, (1, 2048, 64), k 6;

or, with ``--shapes``, at the groups past the kernel's old 16384-pair
limit that ``chip_smoke.py``'s ``phase_wide`` drives: ``moon4096`` (1,
4096, 64) k 6, ``moon65536`` (1, 65536, 64) k 6 and ``group2m`` (1, 2^21,
8) k 1 (131072 tiles: the scan's one CTA a group walks E x tiles counts);

each at the layer's capacity (``models.moe.expert_capacity(1.25, ...)``).
Each line printed is one JSON object: the call's median time with the plain
build and with the instrumented one (CUDA events), whether both builds
gave the same lanes, the warps of each launch of the call, the SM clocks
per phase summed over the warps (the phases' names come from the source,
``k7_prof_names``; divide by the warps of the launch that runs the phase
for a warp's mean) and the span on the card of each launch. Before them, ptxas's
registers, spills and shared memory per kernel; last, the card's name,
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
sys.path.insert(0, str(ROOT / "scripts"))
sys.path.insert(0, str(ROOT / "src"))
from k1_profile import build, time_ms  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import route_fuse as k7  # noqa: E402
from repro_torch.models.moe import expert_capacity  # noqa: E402

SHAPES = {"mixtral": (2048, 8, 2), "sorted": (4096, 8, 2),
          "moonlight": (2048, 64, 6), "moon4096": (4096, 64, 6),
          "moon65536": (65536, 64, 6), "group2m": (1 << 21, 8, 1)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", default=str(
        ROOT / "src" / "repro_torch" / "csrc" / "route_fuse.cu"))
    ap.add_argument("--label", default="current")
    ap.add_argument("--shapes", default="mixtral,sorted,moonlight")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k7_profile: no CUDA device", file=sys.stderr)
        return 1
    plain_lib, prof, ptxas = build(Path(args.source), args.label, "k7")
    print(json.dumps({"label": args.label, "ptxas": ptxas}), flush=True)
    names = prof.k7_prof_names().decode().split(",")
    counters, kernels = ctypes.c_int(), ctypes.c_int()
    prof.k7_prof_layout(ctypes.byref(counters), ctypes.byref(kernels))
    counters, kernels = counters.value, kernels.value
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in args.shapes.split(","):
        T, E, k = SHAPES[shape]
        cap = expert_capacity(1.25, T, k, E)
        lg = torch.randn((1, T, E), generator=gen, device="cuda")

        def fn():
            return k7.moe_route(lg, k, cap)

        _build._lib = plain_lib
        ms = time_ms(fn)
        expect = fn()
        _build._lib = prof
        ms_prof = time_ms(fn)
        prof.k7_prof_zero()
        got = fn()
        torch.cuda.synchronize()
        same = all(torch.equal(g.view(torch.int32), e.view(torch.int32))
                   for g, e in zip(got, expect))
        raw = (ctypes.c_ulonglong * (counters + kernels))()
        prof.k7_prof_read(ctypes.addressof(raw))
        P = np.frombuffer(raw, dtype=np.uint64).astype(np.float64)
        wraw = (ctypes.c_ulonglong * (2 * kernels))()
        prof.k7_when_read(ctypes.addressof(wraw))
        W = np.frombuffer(wraw, dtype=np.uint64).reshape(kernels, 2)
        warps = [int(x) for x in P[counters:counters + kernels]]
        spans = [float(e - s) / 1e3 for s, e in W if e >= s > 0]
        print(json.dumps({
            "label": args.label, "shape": shape, "T": T, "E": E, "k": k,
            "cap": cap, "ms": ms, "ms_instrumented": ms_prof,
            "same_as_plain_build": same, "warps_per_launch": warps,
            "clocks_summed_over_warps": dict(zip(names, (
                int(v) for v in P[:counters]))),
            "launch_span_us": spans}), flush=True)
    _build._lib = None
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
