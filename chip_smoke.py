"""Smoke run of the PyTorch / CUDA port on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit. It

1. builds the kernels of ``src/repro_torch/csrc`` with nvcc (``sm_90a``);
2. drives the main path once at 2^24 keys through the engine
   (``sort`` / ``argsort`` / ``merge`` / ``merge_runs``) with every kernel
   launch count set to 0 just before and read just after, checks every
   result bit-for-bit against ``torch.sort`` / ``torch.argsort(stable=True)``
   and fails if a kernel of the path was not launched;
3. holds every kernel bit-for-bit (floats compared as int32 bit patterns)
   against its plain PyTorch version on the card, on inputs with heavy
   duplicates, +0.0/-0.0 and -inf;
4. times each kernel at the main path's shapes with CUDA events (warm-up,
   then the median of at least 5 runs) beside its plain version, one
   ``torch.sort`` call and its bound (bytes over the memory rate, or
   compare-exchanges over the float32 rate, whichever is larger).

Any mismatch or error exits non-zero. The last three lines are the kernel
table (JSON), the card's name and power limit from nvidia-smi, and
``{"ok": true, "device": {...}}``. Inputs come from seeded generators.
"""
from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

import torch

SEED = 0
N_MAIN = 1 << 24
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3, NVIDIA data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM, float32 outside the tensor cores


def _import_port():
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    sys.path.insert(0, src)
    from repro_torch import engine, kernels
    from repro_torch.kernels import _build, bitonic_sort as k1, \
        flims_merge as k2, merge_tree as k4, segmented_merge as k3
    return engine, kernels, _build, k1, k2, k3, k4


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def max_abs_err(g: torch.Tensor, e: torch.Tensor) -> float:
    """Largest |g - e| over the elements, in float64 (equal infinities
    count as 0)."""
    if not g.numel():
        return 0.0
    d = (g.double() - e.double()).abs()
    return float(torch.where(g == e, 0.0, d).max())


def check_same(what: str, got, exp) -> float:
    """Bit-for-bit equality of tensors (or tuples of tensors); raises on any
    mismatch and returns the max absolute difference it measured."""
    got = got if isinstance(got, tuple) else (got,)
    exp = exp if isinstance(exp, tuple) else (exp,)
    err = 0.0
    for g, e in zip(got, exp):
        if g.shape != e.shape or g.dtype != e.dtype:
            raise AssertionError(f"{what}: {g.shape}/{g.dtype} vs "
                                 f"{e.shape}/{e.dtype}")
        bad = bits(g) != bits(e)
        if bool(bad.any()):
            i = int(bad.nonzero()[0])
            raise AssertionError(f"{what}: {int(bad.sum())} elements differ, "
                                 f"first at {i}: {g[i].item()} vs "
                                 f"{e[i].item()}")
        err = max(err, max_abs_err(g, e))
    return err


def plain_of(fn):
    """The plain PyTorch twin of a kernel wrapper (``<name>_plain``)."""
    return getattr(sys.modules[fn.__module__], fn.__name__ + "_plain")


def time_ms(fn, warmup: int = 2, reps: int = 7) -> float:
    """Median of ``reps`` CUDA-event timings after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    ts.sort()
    return ts[len(ts) // 2]


def dup_keys(n: int, gen) -> torch.Tensor:
    """float32 keys with heavy duplicates, +0.0, -0.0 and -inf among them."""
    pool = torch.tensor([float("-inf"), -3.0, -1.0, -0.0, 0.0, 0.5, 2.0,
                         7.0, 11.0, 12.5], device="cuda")
    return pool[torch.randint(0, pool.numel(), (n,), generator=gen,
                              device="cuda")]


def tie_keys(n: int, gen) -> torch.Tensor:
    """float32 keys 0..999: heavy ties and no signed zeros, so a key-only
    FLiMS merge equals ``torch.sort`` bit for bit (with both zeros present
    the reference's max/min rule moves sign bits; ROADMAP queue 3)."""
    return torch.randint(0, 1000, (n,), generator=gen, device="cuda").float()


def sorted_runs(lens, gen, descending=True, keys=dup_keys):
    """Flat buffer of runs of ``lens`` (each sorted in the direction) and
    int32 starts / lens."""
    dev = "cuda"
    lens_t = torch.tensor(lens, dtype=torch.int64, device=dev)
    n = int(lens_t.sum())
    keys = keys(n, gen)
    seg = torch.repeat_interleave(torch.arange(len(lens), device=dev), lens_t)
    p1 = torch.argsort(keys, descending=descending, stable=True)
    p2 = torch.argsort(seg[p1], stable=True)
    buf = keys[p1][p2].contiguous()
    starts = torch.cumsum(lens_t, 0) - lens_t
    return buf, starts.to(torch.int32), lens_t.to(torch.int32)


def ragged_lens(R: int, total: int, gen):
    """R ragged run lengths summing to ``total``, every 17th one empty."""
    cuts = torch.sort(torch.randint(0, total + 1, (R - 1,), generator=gen,
                                    device="cuda")).values.tolist()
    for j in range(0, R - 1, 17):
        cuts[j] = cuts[j - 1] if j else 0
    return [b - a for a, b in zip([0] + cuts, cuts + [total])]


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_build(_build):
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    log = (lib.parent / "build.log").read_text()
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill", log))
    print(f"build: {lib} in {time.perf_counter() - t0:.1f} s; ptxas: "
          f"{len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
          f"{spills} bytes of spills", flush=True)


def phase_main_path(engine, kernels, gen):
    """One pass over the main path at 2^24 keys, counted and checked."""
    dev = "cuda"
    n = N_MAIN
    xi = torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=gen,
                       device=dev, dtype=torch.int32)
    xf = torch.randn(n, generator=gen, device=dev)
    kt = tie_keys(n, gen)
    half = n // 2
    ma = torch.sort(torch.randn(half, generator=gen, device=dev),
                    descending=True).values
    mb = torch.sort(torch.randn(half, generator=gen, device=dev),
                    descending=True).values
    sa = torch.sort(kt[:half], descending=True).values
    sb = torch.sort(kt[half:], descending=True).values
    va = torch.arange(half, device=dev)
    vb = half + torch.arange(half, device=dev)
    rbuf, rstarts, _ = sorted_runs(ragged_lens(128, n, gen), gen,
                                   keys=tie_keys)
    roffs = torch.cat([rstarts, rstarts.new_tensor([n])])
    torch.cuda.synchronize()

    kernels.reset_launches()
    out, per_call = {}, {}

    def run(name, fn):
        before = kernels.launch_counts()
        out[name] = fn()
        after = kernels.launch_counts()
        per_call[name] = {k: v - before.get(k, 0) for k, v in after.items()
                          if v - before.get(k, 0)}

    for d in (True, False):
        run(f"sort_i32_{d}", lambda: engine.sort(xi, descending=d))
        run(f"sort_f32_{d}", lambda: engine.sort(xf, descending=d))
        run(f"argsort_{d}", lambda: engine.argsort(kt, descending=d))
    run("merge", lambda: engine.merge(ma, mb))
    run("merge_kv", lambda: engine.merge(sa, sb, values=(va, vb),
                                         stable=True))
    run("merge_runs", lambda: engine.merge_runs(rbuf, roffs))
    rvals = torch.arange(n, device=dev)
    run("merge_runs_kv", lambda: engine.merge_runs(rbuf, roffs,
                                                   values=rvals))
    torch.cuda.synchronize()
    launches = kernels.launch_counts()

    for d in (True, False):
        check_same(f"sort int32 desc={d}", out[f"sort_i32_{d}"],
                   torch.sort(xi, descending=d).values)
        check_same(f"sort f32 desc={d}", out[f"sort_f32_{d}"],
                   torch.sort(xf, descending=d).values)
        check_same(f"argsort desc={d}", out[f"argsort_{d}"].long(),
                   torch.argsort(kt, descending=d, stable=True))
    check_same("merge", out["merge"],
               torch.sort(torch.cat([ma, mb]), descending=True).values)
    ref = torch.sort(torch.cat([sa, sb]), descending=True, stable=True)
    check_same("merge values", out["merge_kv"],
               (ref.values, torch.cat([va, vb])[ref.indices]))
    check_same("merge_runs", out["merge_runs"],
               torch.sort(rbuf, descending=True).values)
    perm = torch.argsort(rbuf, descending=True, stable=True)
    check_same("merge_runs values", out["merge_runs_kv"], (rbuf[perm], perm))
    need = ("sort_chunks", "sort_chunks_kv", "flims_merge", "flims_merge_kv",
            "segmented_merge_runs", "segmented_merge_runs_kv",
            "merge_tree_runs", "merge_tree_runs_kv")
    missing = [k for k in need if not launches.get(k)]
    if missing:
        raise AssertionError(f"main path never launched {missing}: "
                             f"{launches}")
    print("main path: 2^24 keys, every result bit-for-bit equal to torch; "
          "launches " + json.dumps(launches), flush=True)
    print("launches per call: " + json.dumps(
        {k: per_call[k] for k in ("sort_f32_True", "argsort_True", "merge",
                                  "merge_kv", "merge_runs",
                                  "merge_runs_kv")}), flush=True)
    return launches, dict(xf=xf, kt=kt, ma=ma, mb=mb, sa=sa, sb=sb, va=va,
                          vb=vb, rbuf=rbuf, roffs=roffs)


def phase_kernels_vs_plain(mods, gen):
    """Every kernel bit-for-bit against its plain version on the card."""
    k1, k2, k3, k4 = mods
    errs = {}
    dev = "cuda"

    def both(fn, *args, **kw):
        name = fn.__name__
        err = check_same(f"{name} {kw}", fn(*args, **kw),
                         plain_of(fn)(*args, **kw))
        errs[name] = max(errs.get(name, 0.0), err)

    xi = torch.randint(-2 ** 31, 2 ** 31 - 1, (8192, 512), generator=gen,
                       device=dev, dtype=torch.int32)
    both(k1.sort_chunks, xi)
    both(k1.sort_chunks, dup_keys(8192 * 512, gen).reshape(8192, 512))
    kf = dup_keys(8192 * 256, gen).reshape(8192, 256)
    r = torch.arange(kf.numel(), dtype=torch.int32,
                     device=dev).reshape(8192, 256)
    for d in (True, False):
        both(k1.sort_chunks_kv, kf, r, descending=d)

    na, nb = (1 << 20) + 12345, (1 << 20) - 777
    ra = torch.arange(na, dtype=torch.int32, device=dev)
    rb = na + torch.arange(nb, dtype=torch.int32, device=dev)
    for w, bo in ((128, 4096), (8, 1024)):
        a = torch.sort(dup_keys(na, gen), descending=True).values
        b = torch.sort(dup_keys(nb, gen), descending=True).values
        both(k2.flims_merge, a, b, w=w, block_out=bo)
        for d in (True, False):
            aa, bb = (a, b) if d else (torch.flip(a, [0]), torch.flip(b, [0]))
            both(k2.flims_merge_kv, aa, ra, bb, rb, w=w, block_out=bo,
                 descending=d)

    lens = ragged_lens(514, 1 << 20, gen)
    lens[2] = lens[3] = 0              # one pair empty on both sides
    lens[5] = 0                        # and one with only an A run
    for d in (True, False):
        buf, st, ln = sorted_runs(lens, gen, descending=d)
        rk = torch.arange(buf.shape[0], dtype=torch.int32, device=dev)
        pairs = (st[0::2].contiguous(), ln[0::2].contiguous(),
                 st[1::2].contiguous(), ln[1::2].contiguous())
        if d:
            both(k3.segmented_merge_runs, buf, buf, *pairs,
                 n_out=buf.shape[0], w=128, block_out=4096)
        both(k3.segmented_merge_runs_kv, buf, rk, buf, rk, *pairs,
             n_out=buf.shape[0], w=128, block_out=4096, descending=d)

    for group, total in ((4, 1 << 20), (8, 1 << 18)):
        lens = ragged_lens(group * 32, total, gen)
        for d in (True, False):
            buf, st, ln = sorted_runs(lens, gen, descending=d)
            rk = torch.arange(buf.shape[0], dtype=torch.int32, device=dev)
            if d:
                both(k4.merge_tree_runs, buf, st, ln, group=group,
                     n_out=buf.shape[0], w=128, block_out=4096)
            both(k4.merge_tree_runs_kv, buf, rk, st, ln, group=group,
                 n_out=buf.shape[0], w=128, block_out=4096, descending=d)
    torch.cuda.synchronize()
    print("kernels vs plain: all bit-for-bit " + json.dumps(errs),
          flush=True)
    return errs


def _bound(nbytes: float, ops: float):
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def phase_times(mods, launches, errs, data):
    """Each kernel at the main path's shapes beside its plain version, one
    torch.sort call and its bound. Bytes: each input read once, each output
    written once. Operations: compare-exchanges of the network (K1) or one
    selector compare plus log2(w) butterfly stages per element and level
    (K2-K4)."""
    k1, k2, k3, k4 = mods
    dev = "cuda"
    n = N_MAIN
    half = n // 2
    rows = data["xf"].reshape(-1, 256)
    rr = torch.arange(n, dtype=torch.int32, device=dev).reshape(-1, 256)
    ma, mb = data["ma"], data["mb"]
    ra = torch.arange(half, dtype=torch.int32, device=dev)
    rb = half + ra
    cat = torch.cat([ma, mb])
    rcat = torch.arange(n, dtype=torch.int32, device=dev)
    # K3 as in merge_runs' one-level pass: one pair, the two halves
    pair = [torch.tensor([v], dtype=torch.int32, device=dev)
            for v in (0, half, half, half)]
    # K4 as in a pass of engine.sort: runs of 4096 keys, groups of 4
    runs4 = torch.sort(data["xf"].reshape(-1, 4096), dim=-1,
                       descending=True).values.reshape(-1)
    st4 = torch.arange(0, n, 4096, dtype=torch.int32, device=dev)
    ln4 = torch.full_like(st4, 4096)
    lg = math.log2(256)
    sort_ops = n / 2 * lg * (lg + 1) / 2
    merge_ops = n * (1 + math.log2(128) / 2)
    M = dict(w=128, block_out=4096)
    cases = [
        (k1.sort_chunks, "bitonic_sort.cu", "bitonic_sort.py:93", (rows,),
         {}, lambda: torch.sort(rows, dim=-1, descending=True),
         2 * n * 4, sort_ops),
        (k1.sort_chunks_kv, "bitonic_sort.cu", "bitonic_sort.py:123",
         (rows, rr), {},
         lambda: torch.sort(rows, dim=-1, descending=True, stable=True),
         2 * n * 8, sort_ops),
        (k2.flims_merge, "flims_merge.cu", "flims_merge.py:202", (ma, mb), M,
         lambda: torch.sort(cat, descending=True), 2 * n * 4, merge_ops),
        (k2.flims_merge_kv, "flims_merge.cu", "flims_merge.py:391",
         (ma, ra, mb, rb), M,
         lambda: torch.sort(cat, descending=True, stable=True),
         2 * n * 8, merge_ops),
        (k3.segmented_merge_runs, "flims_merge.cu", "segmented_merge.py:208",
         (cat, cat, *pair), dict(M, n_out=n),
         lambda: torch.sort(cat, descending=True), 2 * n * 4, merge_ops),
        (k3.segmented_merge_runs_kv, "flims_merge.cu",
         "segmented_merge.py:375", (cat, rcat, cat, rcat, *pair),
         dict(M, n_out=n),
         lambda: torch.sort(cat, descending=True, stable=True),
         2 * n * 8, merge_ops),
        (k4.merge_tree_runs, "merge_tree.cu", "merge_tree.py:393",
         (runs4, st4, ln4), dict(M, group=4, n_out=n),
         lambda: torch.sort(runs4, descending=True), 2 * n * 4,
         2 * merge_ops),
        (k4.merge_tree_runs_kv, "merge_tree.cu", "merge_tree.py:393",
         (runs4, rcat, st4, ln4), dict(M, group=4, n_out=n),
         lambda: torch.sort(runs4, descending=True, stable=True),
         2 * n * 8, 2 * merge_ops),
    ]
    table = []
    for fn, source, replaces, args, kw, lib, nbytes, ops in cases:
        name = fn.__name__
        plain = plain_of(fn)
        err = check_same(f"{name} at the main path's shape", fn(*args, **kw),
                         plain(*args, **kw))
        bound_ms, bound_by = _bound(nbytes, ops)
        table.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/" + source,
            "replaces": "src/repro/kernels/" + replaces,
            "launches": int(launches.get(name, 0)),
            "max_abs_err": max(errs[name], err),
            "ms": time_ms(lambda: fn(*args, **kw)),
            "plain_ms": time_ms(lambda: plain(*args, **kw), warmup=1,
                                reps=5),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": time_ms(lib)})
        print(f"time {name}: " + json.dumps(table[-1]), flush=True)
    return table


def phase_e2e_times(engine, data):
    xf, kt = data["xf"], data["kt"]
    rows = []
    for name, fn, lib in (
            ("engine.sort f32 desc", lambda: engine.sort(xf),
             lambda: torch.sort(xf, descending=True)),
            ("engine.argsort f32 desc", lambda: engine.argsort(kt),
             lambda: torch.argsort(kt, descending=True, stable=True)),
            ("engine.merge", lambda: engine.merge(data["ma"], data["mb"]),
             lambda: torch.sort(torch.cat([data["ma"], data["mb"]]),
                                descending=True)),
            ("engine.merge_runs", lambda: engine.merge_runs(
                data["rbuf"], data["roffs"]),
             lambda: torch.sort(data["rbuf"], descending=True))):
        rows.append({"call": name, "n": N_MAIN, "ms": time_ms(fn),
                     "library_ms": time_ms(lib)})
    print(json.dumps({"e2e": rows}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    engine, kernels, _build, k1, k2, k3, k4 = _import_port()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    driver = subprocess.run(["nvidia-smi", "--query-gpu=driver_version",
                             "--format=csv,noheader"], capture_output=True,
                            text=True, check=True).stdout.strip()
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"(cuda {torch.version.cuda}) nvcc '{nvcc[-1]}' driver {driver} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    phase_build(_build)
    launches, data = phase_main_path(engine, kernels, gen)
    mods = (k1, k2, k3, k4)
    errs = phase_kernels_vs_plain(mods, gen)
    table = phase_times(mods, launches, errs, data)
    phase_e2e_times(engine, data)
    print(json.dumps({"kernels": table}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
