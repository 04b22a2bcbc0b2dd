"""The streaming merge trees' ring hand-off under load: one fan-2 pass,
repeated, against a fixed reference.

    python3 scripts/fan2_race.py [--passes 2000]

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit. It builds ``csrc/stream_merge.cu`` (K8) and
``csrc/merge_tree.cu`` (K4) with the port's nvcc flags twice each, as
they are and with ``-DFLIMS_NO_PROXY_FENCE`` (no ``fence.proxy.async``
before a consumer frees a ring slot that a bulk copy refills), under
``build/fan2_race/``, puts each library under the wrappers in turn and
runs the stable KV merge of two sorted runs of 2^26 int32 keys in [0, 2^16)
(``external_sort``'s last pass at 2^27 keys: K8 at fan 2, K4 at group 2),
alternating descending and ascending inputs so that stale shared memory
differs from the row expected. Each line printed is one JSON object: the
build, the passes run and how many came back different from
``torch.argsort(stable=True)``. The last line is the card's name and
power limit.
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
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import merge_tree as k4  # noqa: E402
from repro_torch.kernels import stream_merge as k8  # noqa: E402

N, RUN = 1 << 27, 1 << 26
#: (source, extra nvcc flags) per build
BUILDS = {"k8": ("stream_merge.cu", ()),
          "k8_no_fence": ("stream_merge.cu", ("-DFLIMS_NO_PROXY_FENCE",)),
          "k4": ("merge_tree.cu", ()),
          "k4_no_fence": ("merge_tree.cu", ("-DFLIMS_NO_PROXY_FENCE",))}


def build():
    csrc = ROOT / "src" / "repro_torch" / "csrc"
    procs = []
    for name, (src, flags) in BUILDS.items():
        d = ROOT / "build" / "fan2_race" / name
        d.mkdir(parents=True, exist_ok=True)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-I", str(csrc),
               "-shared", "-o", str(d / "lib.so"), str(csrc / src),
               str(csrc / "wide_merge.cu")]
        procs.append((name, d, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for name, d, p in procs:
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"fan2_race: nvcc failed on {name}:\n{out}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        for fn_name, (res, args) in _build._SIGNATURES.items():
            if hasattr(lib, fn_name):
                fn = getattr(lib, fn_name)
                fn.restype, fn.argtypes = res, args
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--passes", type=int, default=2000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fan2_race: no CUDA device", file=sys.stderr)
        return 1
    libs = build()
    gen = torch.Generator(device="cuda").manual_seed(5)
    keys = torch.randint(0, 1 << 16, (N,), generator=gen, device="cuda",
                         dtype=torch.int32)
    ranks = torch.arange(N, dtype=torch.int32, device="cuda")
    slack = k8.stream_slack(2, 128, 4096)
    starts = torch.tensor([0, RUN], dtype=torch.int32, device="cuda")
    lens = torch.full_like(starts, RUN)
    inputs, refs = {}, {}
    for d in (True, False):
        p = torch.argsort(keys.reshape(2, RUN), dim=1, stable=True,
                          descending=d)
        k = torch.gather(keys.reshape(2, RUN), 1, p).reshape(-1)
        r = torch.gather(ranks.reshape(2, RUN), 1, p).reshape(-1)
        last = -2 ** 31 if d else 2 ** 31 - 1
        inputs[d] = (torch.cat([k, k.new_full((slack,), last)]),
                     torch.cat([r, r.new_full((slack,), 2 ** 31 - 1)]))
        perm = torch.argsort(keys, descending=d, stable=True)
        refs[d] = (keys[perm], perm.to(torch.int32))
    for name, lib in libs.items():
        _build._lib = lib
        k8._per_sm.clear()
        k4._per_sm.clear()
        wrong = 0
        for i in range(args.passes):
            d = i % 2 == 0
            k, r = inputs[d]
            if name.startswith("k8"):
                ok, orr = k8.stream_merge_runs_kv(
                    k, r, runs=2, run_len=RUN, fan_in=2, w=128,
                    block_out=4096, descending=d)
            else:
                ok, orr = k4.merge_tree_runs_kv(
                    k[:N], r[:N], starts, lens, group=2, n_out=N, w=128,
                    block_out=4096, descending=d)
            wrong += not (torch.equal(ok[:N], refs[d][0])
                          and torch.equal(orr[:N], refs[d][1]))
        print(json.dumps({"build": name, "passes": args.passes,
                          "wrong": wrong}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
