"""Smoke run of the PyTorch / CUDA port on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit. It

1. builds the kernels of ``src/repro_torch/csrc`` with nvcc (``sm_90a``);
2. drives each path of the port once, every kernel launch count set to 0
   just before it and read just after, and fails if a kernel of the path
   was not launched:
   - the sorter at 2^24 keys through the engine (``sort`` / ``argsort`` /
     ``merge`` / ``merge_runs``), every result bit-for-bit ``torch.sort`` /
     ``torch.argsort(stable=True)`` (K1-K4);
   - one MoE layer of Mixtral-8x22B at full width (d 6144, expert d_ff
     16384, 8 experts, top-2, bf16, random weights from the seed) through
     ``models.moe.moe_apply``, grouped at (4, 2048) and sorted at
     (1, 4096), and the same layer of Moonlight-16B-A3B (d 2048, d_ff 1408,
     64 experts, top-6) at (4, 2048) (K7, four launches a grouped layer,
     one a sorted one). Every chunk's routing lanes are
     held against the ``torch`` variant, the layer output of the fused route
     against the ``torch`` route's, and, with a capacity that drops
     nothing, the grouped output against ``moe_apply_dense``;
   - the segmented ops over 2^22 keys in ragged segments (``segment_sort``
     / ``segment_argsort`` fused and two-phase, both directions, float32 and
     int32; ``segment_merge``), bit-for-bit the ``torch`` variants (K5, K6,
     and K1/K3/K4 in the two-phase path);
   - the out-of-core sort at 2^27 keys (``external_sort``: float32 both
     directions, int32 descending, stable with ``values=arange`` on int32
     keys in [0, 2^16) both directions; tiles of 2^20, fan-in 8, so K1 x1,
     K4 x6 and K8 x3 per call and three ``external.pass`` events), and
     ``merge_runs(variant="stream_cuda")`` on the main path's 128 ragged
     runs, every result bit-for-bit ``torch.sort`` /
     ``torch.argsort(stable=True)``;
   - the reference sorters and the samplers (K9, one launch a
     ``tree_vmapped`` level): ``serve.RaggedSampler(k=64, "flims")`` over
     64 decode slots of Moonlight-16B-A3B's vocabulary (163840; exactly one
     ``engine.topk`` call), ``engine.sample_topp(p=0.9)`` /
     ``sample_minp(min_p=0.05)`` (``flims``, 10 K9 launches each) over 8
     rows of it, token ids equal to the ``torch`` variants' under the same
     generator seed; ``engine.merge_runs(variant="tree_vmapped")`` over 2^22
     keys in 64 ragged runs (tie b and skew as values against the ``torch``
     executor, stable with ``values=`` bit for bit), ``sort(variant="ref")``
     against ``torch.sort`` as values and ``argsort(variant="flims")``
     bit-for-bit ``torch.argsort(stable=True)``, all at 2^22 keys, each
     call's ms, K9 launches and its ``torch`` variant's ms; and, in a second
     run of those calls, every K9 level they launch held bit for bit to the
     whole chain (``chain=True``) on the same inputs, and to the plain
     version where its cycle chain is at most ``CHECK_CHAIN`` (and at
     ``merge_runs``' first skew level), each level's block form and chain
     timed;
   - serving (K7, four launches a decode step and a prefill token):
     the repo's ``moonshot_v1_16b_a3b`` config (d 2048, 16 heads of 128,
     64 experts top-6 with d_ff 1408, vocab 163840, bf16, random weights
     from the seed) with its depth cut from 48 to 4 layers, serving 12
     requests (prompts of 3-32 tokens, 8-24 new tokens, half greedy, two
     with an EOS id) through ``serve.serve_batch`` at 8 slots, max_seq 256,
     prefill_len 32 and k 64: every completion checked, ``traces == 2``,
     one ``engine.topk`` a step, no fallback demotion; one decode step held
     to the same step routed by the ``torch`` variant (relative Frobenius
     within 2^-6) and its sampled ids to the ``torch`` sampler's under the
     same noise; K7 at the step's route shapes against its plain version;
     the step split by part; then ``engine.autotune("topk", ...)`` at the
     served (8, 163840) and the same requests again under the tuned plan,
     greedy tokens equal. The config approximates the published
     Moonlight-16B-A3B: it has plain multi-head attention where that model
     has MLA, 48 layers where it has 27, no shared experts beside the 64
     routed where it has 2, no dense first layer, softmax routing where it
     scores by sigmoid, and a tied head where its head is untied;
   - the mesh (``phase_mesh``; K9, K4, K3 and K7 in every rank): 4 ranks
     spawned on the one card under gloo, so every collective crosses the
     host. (a) ``engine.sharded_sort`` at 2^24 integral float32 keys a
     rank, key-only and with the global int32 indices, under
     ``tree_cuda`` at 2 levels (K4) and 1 (K3) and ``tree_vmapped`` (K9),
     hist and regular splitters, each rank's run bit for bit its slice of
     ``torch.sort(descending=True, stable=True)`` of the gathered keys,
     the payload its stable permutation, one run split per stage; a zipf
     input at ``cap_factor`` 1 overflowing with ``retries=0`` and recovered
     by the default ladder; (b) ``sharded_topk`` k 2048 with the payload,
     bit for bit ``engine.topk(variant="torch")`` of the gathered keys;
     (c) ``moe_route_ep`` of Moonlight's router (E 64, k 6) at 2048
     tokens a rank, each owner's kept pairs those of ``engine.moe_route``
     of the gathered logits; (d) one bf16 decode step of Moonlight's
     attention at batch 4 over 131072 positions split 4 ways, within
     2^-6 of one process; (e) ``moonshot_v1_16b_a3b`` (4 of 48 layers,
     bf16) on a ``model`` axis of 4 (16 experts a rank, ``moe_apply_ep``)
     serving the 12 requests, the token streams equal on every rank, K7
     4 a step, and 8 steps each fed the same tokens and cache within 2^-6
     of the one-process ``grouped`` step;
   - the rest of the model zoo (no kernel; plain torch as the JAX package
     computes these modules outside any Pallas kernel), each config at its
     published widths and the least depth that holds its structure, in
     float32, one model at a time: Zamba2-2.7B (6 of 54 layers, one group
     of Mamba2 layers and the shared attention block), xLSTM-1.3B (8 of
     48, 7 mLSTM and 1 sLSTM), Gemma-2-9B and -27B (2 of 42 / 46, a local
     and a global layer), Qwen1.5-110B and InternVL2-76B (2 of 80),
     Whisper-large-v3 (2 + 2 of 32 + 32, 1500 frames): 16 seeded tokens at
     batch 2 decoded one at a time within ``FAMILY_REL_FROB`` relative
     Frobenius of the teacher-forced forward (Whisper's ``decode_train``
     over the encoded frames), and InternVL2's forward with its 256-patch
     vision prefix finite at (2, 256 + 16, vocab);
   - Zamba2-2.7B at its widths and all 54 layers (bf16, 2.34B parameters)
     serving the same 12 requests through the scheduler, at its vocabulary
     (32000): the first and the last slot's state after admission (``S``
     and ``conv`` of every layer, the shared block's 9 KV caches) bit for
     bit the same request admitted alone; the bf16 drift of forward
     against decode on one 32-token prompt (a figure); then a checked and
     a timed pass under the heuristic and the autotuned ``topk`` plan,
     every completion checked, ``traces == 2``, one ``engine.topk`` a
     step, no kernel launched, no fallback, greedy tokens equal; one
     ``serve`` line with the step's byte bound;
   - training (K7, now with its gradient): the ``moonshot_v1_16b_a3b``
     config at its widths, 4 of 48 layers, bf16, remat on, batch 4 x
     1024, checkpoints in a private temporary directory: ``TrainLoop.run``
     takes steps 1-3 and writes the state at step 3 (36.6 GB: bf16
     parameters, float32 m, v and master), the loop's ``step_fn`` takes
     steps 4-6 (``train_loss``, its backward and AdamW; the synthetic
     stream): finite losses, step p50, tokens/s, peak memory, K7 launched
     16 times a step (8 in the forward, 8 in remat's recompute); on the
     final state one step split into forward, backward and optimizer by
     CUDA events, the route Function's backward called once a routed
     chunk, and the router's gradient through K7 within
     ``ROUTER_GRAD_REL_FROB`` of the same gradient through the ``torch``
     route and non-zero; then a fresh loop restores the step-3 checkpoint
     (``TrainLoop.resume_state``) and takes steps 4-6, its losses within
     ``RESUME_RTOL`` of the straight run's (one checkpoint is written: a
     second would take the run past the machine's 45 GiB of disk writes
     a call). The ``qwen3_1p7b`` config at its
     widths and all 28 layers, bf16, remat, batch 4 x 2048: four steps of
     ``make_train_step``, finite losses and non-zero gradient norms, step
     p50, tokens/s, peak memory and the model's FLOP rate;
   - training on the mesh (``phase_train_mesh``; K7 in every rank): the
     parent takes 3 one-process steps of the training phase's Moonlight
     config (4 of 48 layers, bf16, remat, batch 4 x 1024) and frees the
     card; then 4 ranks spawned on it under gloo run (a) the same 3 steps
     on a (2, 2) ``("data", "model")`` mesh (FSDP, data parallelism,
     expert parallelism with 32 experts a rank and the ZeRO layout at
     once; ``launch.steps.make_train_step(mesh=)``), the blocks drawn from
     the same generator: each loss within 2^-6 relative of the one
     process's, the loss bits the same on every rank, every leaf's norm
     and 64 seeded elements within 2^-6, K7 4 times a step in the forward
     and 4 in remat's recompute; step times, tokens/s, peak and state GB
     a rank, staged bytes a step by collective; (b) ``gpipe`` over a
     ``stage`` axis of 4 (M 8 microbatches of (256, 2048) float32 through
     ``tanh(x @ W)``) within 1e-5 of each microbatch through the stages in
     sequence; (c) ``compressed_psum_int8`` over a ``pod`` axis of 4 on one
     Qwen3-1.7B layer's gradient shapes, within 1.5 quantisation steps of
     the float32 mean, its bytes on the wire against float32's;
   - past one CTA's shared memory (``phase_wide``), the shapes the port
     refused before: ``engine.moe_route`` (fused, K7) at (4096, 64) and
     (65536, 64) k 6 and at one group of 2^21 tokens (E 8, k 1: 131072
     tiles, past a grid's y), equal to the ``torch`` variant;
     ``kernel_sort`` / ``kernel_argsort`` with K1's chunk at 32768 and
     65536 (tiles of 16384 in shared memory, the wider stages over device
     memory) equal to ``torch.sort`` / ``torch.argsort(stable=True)``;
     ``segment_sort`` at caps 65536 and 131072 (K5) and
     ``segment_argsort`` at caps 32768 and 65536 (K6) under
     ``cuda_fused`` bit for bit the ``torch`` variant; then each kernel
     against its plain version there on NaN / +-0 keys, and timed;
   - the dry run (``phase_dryrun``): ``launch.dryrun.run_cell`` of
     ``qwen3_1p7b`` ``train_4k`` on rank 0 of the (16, 16) mesh, counted
     on ``meta`` tensors, an ``OK`` record with every count above 0;
   - the examples (``phase_examples``): ``python -m
     repro_torch.examples.<name> --device cuda`` for the five, together,
     each exiting 0 with its self-check lines true;
   - the guard on the card: with ``guard.enable_verify()``, ``sort``,
     ``argsort``, ``merge``, ``segment_sort``, ``merge_runs(tree_cuda)``
     and ``external_sort`` on their kernels at 2^20-2^22 keys with no
     failed check, a bit-flipped sort output failing
     ``check_permutation``; a ``failing_variant("sort")`` stub at the head
     of the plan demoted to ``cuda``, bit for bit its output (the one
     demotion the run allows); ``poison_model`` under the scheduler
     retiring the poisoned request alone, the others' greedy tokens those
     of the same requests served without it;
3. holds every kernel against its plain PyTorch version on the card (floats
   compared as int32 bit patterns; K7's weights lane within
   ``ROUTE_WEIGHT_ULPS``), on inputs with heavy duplicates, +0.0/-0.0 and
   -inf; K2 / K3 also at w 8, 32, 128 and 1024 on runs holding NaNs of
   several payloads and +0.0/-0.0, ragged pairs with empty runs at starts
   off 16 bytes, the output whole and cut below the total, KV both ways,
   under forced CTA counts (1, 7 and the card's own); K7 also at its three
   route shapes, on tied logits and on logits whose monotone key is INT32_MIN
   (the top-k repair); K1 also on rows holding NaNs of several payloads
   and at a width of 4096 (stages through shared memory); K5 / K6 also at
   the many-short-segments shape and on segments holding NaNs or dense in
   +0.0/-0.0 at caps 16384 and 32768 (K5), counted by route (warp, wide,
   K5's shared-memory network at c = 32768, exact lanes); K8's plain
   version runs on the card
   at the main path's shapes (one fan-8 group of 2^20-key runs, the fan-2
   pass over two 2^26-key runs) and on host copies of the inputs at small
   shapes up to fan 16 (there it is millions of small tensor operations,
   launch-bound on the card), and K8 is held to one plain result under
   several CTA counts (``_ctas=``): spans of many blocks starting mid-group,
   one block a span, and one CTA taking two groups of a fan-16 KV pass in
   turn; K4 likewise on ragged runs at unaligned starts under forced CTA
   counts (1, 2, 7 and the card's own), the output whole and cut below the
   group total; K9 against its plain version at w 1, 8, 32 and 128, tie b,
   skew and KV, on float32 runs holding NaNs of several payloads and
   +0.0/-0.0 and on int32 duplicate runs, ragged pairs of lengths 0, 1,
   w - 1, w, w + 1 and random, the output whole and cut;
4. times each kernel at its path's shapes with CUDA events (warm-up, then
   the median of at least 5 runs) beside its plain version, one library
   call and its bound (bytes over the memory rate, or the operations over
   the float32 rate, whichever is larger), splits the MoE layer's time
   between the router, K7, the slab scatter, the expert products and the
   combine (Mixtral-8x22B and Moonlight-16B-A3B), times K7 at its three
   route shapes, splits the out-of-core sort's between run formation and
   each merge pass; records one K8 pass and the whole out-of-core sort at fan-in
   2, 4, 8 and 16, K4 at engine.sort's first and last pass, engine.sort /
   engine.argsort split per launch, and both at 2 and 3 fused levels a pass;
   times K1 / K1kv at run formation's (524288, 256) and records the chunk
   sweep: K1 / K1kv alone, engine.sort, engine.argsort and the out-of-core
   run formation with the plan's chunk at 256, 512, 1024, 2048 and 4096;
   times K5 / K6 also at 2^20 keys in 4096 segments of [0, 512] (cap 512,
   the buckets of a grouped Moonlight-16B-A3B dispatch), and
   engine.segment_sort / segment_argsort end to end at both shapes for the
   ``cuda_fused``, ``cuda_two_phase`` and ``torch`` variants; and K9 at
   every level of ``sort(variant="ref")`` / ``argsort(variant="flims")`` of
   2^22 keys (pairs, cycle chain, blocks a pair, the block form's and the
   whole chain's time, byte bound, ``torch.sort`` of the same pair groups);
   the table's row is the level of a ``CHECK_CHAIN``-cycle chain, where K9
   and its plain version are timed at one shape.

Each phase prints its seconds. Any mismatch or error, or any demotion by
the fallback ladder but the chaos phase's injected one, exits non-zero. The
last three lines are the kernel table (JSON), the card's name and power
limit from nvidia-smi, and ``{"ok": true, "device": {...}}``. Inputs and
weights come from seeded generators.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import torch

SEED = 0
N_MAIN = 1 << 24
N_SEG = 1 << 22                # keys of the segmented-ops phase
N_EXT = 1 << 27                # keys of the out-of-core phase (README's)
SEG_MAX = 16384                # longest segment there (K6's largest cap)
# many short segments: the (group x expert) buckets of a grouped
# Moonlight-16B-A3B dispatch (64 experts, 2048 x 6 pairs a group, ~192 a
# bucket), 4096 segments of [0, 512] keys, cap 512
N_SHORT = 1 << 20
SHORT_MAX = 512
FP32_OPS_PER_S = 67e12         # H100 SXM, float32 outside the tensor cores
# K7's weights against torch.softmax: exp(v - max) / sum on both sides,
# CUDA's expf (within 2 ulps of exp) against torch's exp and its own order
# of the k-term sum; a few ulps of float32 either way
ROUTE_WEIGHT_ULPS = 8
# grouped (nothing dropped) against dense, both bf16: the same products in
# another order with bf16 roundings between them (per expert output, per
# weighted contribution); measured on the CPU at reduced widths: relative
# Frobenius 3.7e-3, largest element difference 6.8e-3 of the largest output
BF16_REL_FROB = 2.0 ** -6
BF16_REL_MAX = 2.0 ** -5


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


def nan_keys(n: int, gen) -> torch.Tensor:
    """float32 keys with NaNs of several payloads (quiet, negative,
    another mantissa) among +0.0, -0.0, -inf and duplicates: K1's exact
    path, where a NaN operand of XLA's max / min wins both outputs."""
    pool = torch.tensor([0x7fc00000, -0x00400000, 0x7fc00001, 0, -2 ** 31,
                         -0x00800000, 0x3f800000, -0x40800000, 0x40200000],
                        dtype=torch.int32, device="cuda").view(torch.float32)
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


# CTA counts K4 and K2 / K3 are forced to against their plain versions (0:
# the card's own)
K4_CTAS = (1, 2, 7, 0)
K23_CTAS = (1, 7, 0)


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
    # K1 on rows holding NaNs (the exact path), and at a width past one
    # warp's 256 keys (4096: stages at d >= 256 in shared memory)
    for rows, c in ((8192, 256), (256, 4096)):
        rk = torch.arange(rows * c, dtype=torch.int32,
                          device=dev).reshape(rows, c)
        for keys in (nan_keys, dup_keys):
            x = keys(rows * c, gen).reshape(rows, c)
            both(k1.sort_chunks, x)
            for d in (True, False):
                both(k1.sort_chunks_kv, x, rk, descending=d)

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

    # K2 / K3 at w 8 / 32 / 128 / 1024 (w / 32 lanes a thread up to 32, a
    # CTA of one warp at 1024) on runs holding NaNs of several payloads
    # and +-0, ragged pairs with empty runs at starts off 16 bytes, the
    # output whole and cut below the total, KV both ways, each against one
    # plain result under forced CTA counts (one CTA taking every block in
    # turn, 7, the card's own count)
    def forced(fn, *args, **kw):
        exp = plain_of(fn)(*args, **kw)
        for ctas in K23_CTAS:
            err = check_same(f"{fn.__name__} {kw} ctas={ctas}",
                             fn(*args, _ctas=ctas, **kw), exp)
            errs[fn.__name__] = max(errs.get(fn.__name__, 0.0), err)

    for w in (8, 32, 128, 1024):
        bo = 32 * w
        for d in (True, False):
            a, b = (sorted_runs([n], gen, descending=d, keys=nan_keys)[0]
                    for n in ((1 << 18) + 123, (1 << 18) - 77))
            ra = torch.arange(a.numel(), dtype=torch.int32, device=dev)
            rb = a.numel() + torch.arange(b.numel(), dtype=torch.int32,
                                          device=dev)
            if d:
                forced(k2.flims_merge, a, b, w=w, block_out=bo)
            forced(k2.flims_merge_kv, a, ra, b, rb, w=w, block_out=bo,
                   descending=d)
            lens = ragged_lens(258, 1 << 19, gen)
            lens[2] = lens[3] = lens[5] = 0
            buf, st, ln = sorted_runs(lens, gen, descending=d, keys=nan_keys)
            n = buf.shape[0]
            rk = torch.arange(n, dtype=torch.int32, device=dev)
            pairs = (st[0::2].contiguous(), ln[0::2].contiguous(),
                     st[1::2].contiguous(), ln[1::2].contiguous())
            for n_out in (n, 3 * n // 4):
                if d:
                    forced(k3.segmented_merge_runs, buf, buf, *pairs,
                           n_out=n_out, w=w, block_out=bo)
                forced(k3.segmented_merge_runs_kv, buf, rk, buf, rk, *pairs,
                       n_out=n_out, w=w, block_out=bo, descending=d)

    # K4 on ragged runs at unaligned starts with empty runs, each against one
    # plain result under forced CTA counts (one CTA taking every group in
    # turn, 2, 7, the card's own count), the output whole and cut at 3/4
    for group, total in ((4, 1 << 20), (8, 1 << 18)):
        lens = ragged_lens(group * 32, total, gen)
        for d in (True, False):
            buf, st, ln = sorted_runs(lens, gen, descending=d)
            n = buf.shape[0]
            rk = torch.arange(n, dtype=torch.int32, device=dev)
            cases = [(k4.merge_tree_runs_kv, (buf, rk), dict(descending=d))]
            if d:
                cases.append((k4.merge_tree_runs, (buf,), {}))
            for fn, args, kw in cases:
                for n_out in (n, 3 * n // 4):
                    ckw = dict(kw, group=group, n_out=n_out, w=128,
                               block_out=4096)
                    exp = plain_of(fn)(*args, st, ln, **ckw)
                    for ctas in K4_CTAS:
                        err = check_same(f"{fn.__name__} {ckw} ctas={ctas}",
                                         fn(*args, st, ln, _ctas=ctas, **ckw),
                                         exp)
                        errs[fn.__name__] = max(errs.get(fn.__name__, 0.0),
                                                err)
    torch.cuda.synchronize()
    print("kernels vs plain: all bit-for-bit " + json.dumps(errs),
          flush=True)
    return errs


def hbm_bytes_per_s() -> float:
    """The H100 SXM's HBM3 rate from NVIDIA's data sheet, as the port's
    traffic models price it (the table entry, not an override)."""
    from repro_torch.launch.roofline import MEM_BW_BY_BACKEND
    return MEM_BW_BY_BACKEND["cuda"]


def _bound(nbytes: float, ops: float):
    tb = nbytes / hbm_bytes_per_s() * 1e3
    to = ops / FP32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def phase_times(mods, launches, errs, data):
    """Each kernel at the main path's shapes beside its plain version, one
    torch.sort call and its bound. Bytes: each input read once, each output
    written once. Operations: compare-exchanges of the network (K1) or one
    selector compare plus log2(w) butterfly stages per element and level
    (K2-K4)."""
    from repro_torch.launch.roofline import stream_bytes
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
         stream_bytes(n, 4), sort_ops),
        (k1.sort_chunks_kv, "bitonic_sort.cu", "bitonic_sort.py:123",
         (rows, rr), {},
         lambda: torch.sort(rows, dim=-1, descending=True, stable=True),
         stream_bytes(n, 8), sort_ops),
        (k2.flims_merge, "flims_merge.cu", "flims_merge.py:202", (ma, mb), M,
         lambda: torch.sort(cat, descending=True), stream_bytes(n, 4), merge_ops),
        (k2.flims_merge_kv, "flims_merge.cu", "flims_merge.py:391",
         (ma, ra, mb, rb), M,
         lambda: torch.sort(cat, descending=True, stable=True),
         stream_bytes(n, 8), merge_ops),
        (k3.segmented_merge_runs, "flims_merge.cu", "segmented_merge.py:208",
         (cat, cat, *pair), dict(M, n_out=n),
         lambda: torch.sort(cat, descending=True), stream_bytes(n, 4), merge_ops),
        (k3.segmented_merge_runs_kv, "flims_merge.cu",
         "segmented_merge.py:375", (cat, rcat, cat, rcat, *pair),
         dict(M, n_out=n),
         lambda: torch.sort(cat, descending=True, stable=True),
         stream_bytes(n, 8), merge_ops),
        (k4.merge_tree_runs, "merge_tree.cu", "merge_tree.py:393",
         (runs4, st4, ln4), dict(M, group=4, n_out=n),
         lambda: torch.sort(runs4, descending=True), stream_bytes(n, 4),
         2 * merge_ops),
        (k4.merge_tree_runs_kv, "merge_tree.cu", "merge_tree.py:393",
         (runs4, rcat, st4, ln4), dict(M, group=4, n_out=n),
         lambda: torch.sort(runs4, descending=True, stable=True),
         stream_bytes(n, 8), 2 * merge_ops),
    ]
    table = []
    for fn, source, replaces, args, kw, lib, nbytes, ops in cases:
        name = fn.__name__
        plain = plain_of(fn)
        err = check_same(f"{name} at the main path's shape", fn(*args, **kw),
                         plain(*args, **kw))
        bound_ms, bound_by = _bound(nbytes, ops)
        extra = {}
        if fn in (k1.sort_chunks, k1.sort_chunks_kv):
            kv = name.endswith("_kv")
            extra = {"smem_bytes": k1.rows_smem(torch.float32, kv, True, 256),
                     "ctas": k1.resident_ctas(torch.float32, kv, True, 256,
                                              dev)}
        if fn in (k2.flims_merge, k2.flims_merge_kv, k3.segmented_merge_runs,
                  k3.segmented_merge_runs_kv):
            extra = {"ctas": k2.resident_ctas(
                k2._build.DTYPE_CODES[torch.float32], name.endswith("_kv"),
                True, 128, dev)}
        if fn in (k4.merge_tree_runs, k4.merge_tree_runs_kv):
            kv = name.endswith("_kv")
            extra = {"smem_bytes": k4.tree_smem(torch.float32, kv, True, 2,
                                                128),
                     "ctas": k4._resident_ctas(
                         k4._build.DTYPE_CODES[torch.float32], kv, True, 2,
                         128, dev)}
        table.append({**extra,
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/" + source,
            "replaces": "src/repro/kernels/" + replaces,
            "launches": int(launches.get(name, 0)),
            "max_abs_err": max(errs[name], err),
            "ms": time_ms(lambda: fn(*args, **kw)),
            "plain_ms": time_ms(lambda: plain(*args, **kw), warmup=1,
                                reps=5),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": time_ms(lib),
            "library_call": "torch.sort(stable=True)" if name.endswith("_kv")
            else "torch.sort"})
        print(f"time {name}: " + json.dumps(table[-1]), flush=True)
    # recorded only: K4 at engine.sort's first pass (runs of 256, block
    # 1024) and last (4 runs of 2^22, block 4096)
    passes = []
    for run_len, bo in ((256, 1024), (1 << 22, 4096)):
        runs = torch.sort(data["xf"].reshape(-1, run_len), dim=-1,
                          descending=True).values.reshape(-1)
        st = torch.arange(0, n, run_len, dtype=torch.int32, device=dev)
        ln = torch.full_like(st, run_len)
        kw = dict(group=4, n_out=n, w=128, block_out=bo)
        for fn, args in ((k4.merge_tree_runs, (runs,)),
                         (k4.merge_tree_runs_kv, (runs, rcat))):
            check_same(f"{fn.__name__} runs of {run_len}", fn(*args, st, ln,
                                                              **kw),
                       plain_of(fn)(*args, st, ln, **kw))
            passes.append({"name": fn.__name__, "run_len": run_len,
                           "block_out": bo,
                           "ms": time_ms(lambda: fn(*args, st, ln, **kw))})
    print(json.dumps({"k4_passes": passes}), flush=True)
    return table


SWEEP_CHUNKS = (256, 512, 1024, 2048, 4096)


def phase_k1_sweep(engine, kernels, k1, slice3, data, ext):
    """K1 and K1kv at run formation's (524288, 256) beside their plain
    versions, torch.sort and the bound; then the chunk sweep (recorded; the
    planner keeps 256): at each width, K1 / K1kv alone over 2^24 keys, and
    ``engine.sort`` / ``engine.argsort`` of 2^24 keys and the out-of-core
    sort's run formation of 2^27 with the plan's chunk forced to it, each
    result bit-for-bit torch, with its launches."""
    from repro_torch.engine import planner
    external = slice3[1]
    dev = "cuda"
    xf, kt = data["xf"], data["kt"]
    n = xf.shape[0]
    # run formation's rows: float32 key-only, and the stable sort's int32
    # keys with their ranks
    rows = ext["xf"].reshape(-1, 256)
    krows, rrows = ext["xk"].reshape(-1, 256), ext["rank"].reshape(-1, 256)
    big = []
    for fn, args, nbytes, lib in (
            (k1.sort_chunks, (rows,), 2 * N_EXT * 4,
             lambda: torch.sort(rows, dim=-1, descending=True)),
            (k1.sort_chunks_kv, (krows, rrows), 2 * N_EXT * 8,
             lambda: torch.sort(krows, dim=-1, descending=True,
                                stable=True))):
        plain = plain_of(fn)
        check_same(f"{fn.__name__} at (524288, 256)", fn(*args),
                   plain(*args))
        lg = math.log2(256)
        bound_ms, bound_by = _bound(nbytes, N_EXT / 2 * lg * (lg + 1) / 2)
        big.append({"name": fn.__name__, "rows": rows.shape[0], "c": 256,
                    "keys": str(args[0].dtype), "ms": time_ms(lambda: fn(
                        *args)),
                    "plain_ms": time_ms(lambda: plain(*args), warmup=1,
                                        reps=3),
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": time_ms(lib)})
    print(json.dumps({"k1_run_formation": big}), flush=True)
    rank = torch.arange(n, dtype=torch.int32, device=dev)
    R, T = N_EXT >> 20, 1 << 20
    ext_plan = external.resolve_dofs(planner.heuristic_plan(
        "external_sort", planner.plan_key("external_sort", n=N_EXT,
                                          dtype=ext["xf"].dtype,
                                          backend="cuda")), N_EXT)
    form_ref = torch.sort(ext["xf"].reshape(R, T), dim=1,
                          descending=True).values.reshape(-1)
    kv_ref = torch.sort(ext["xk"].reshape(R, T), dim=1, descending=True,
                        stable=True)
    kv_ref = (kv_ref.values.reshape(-1), ext["rank"].reshape(R, T).gather(
        1, kv_ref.indices).reshape(-1))
    s_ref = torch.sort(xf, descending=True).values
    a_ref = torch.argsort(kt, descending=True, stable=True)
    sweep = []
    for c in SWEEP_CHUNKS:
        row = {"chunk": c}
        rk = rank.reshape(-1, c)
        for name, fn in (("k1_ms", lambda: k1.sort_chunks(xf.reshape(-1, c))),
                         ("k1kv_ms", lambda: k1.sort_chunks_kv(
                             xf.reshape(-1, c), rk))):
            row[name] = time_ms(fn)
        plans = {op: planner.heuristic_plan(op, planner.plan_key(
            op, n=n, dtype=x.dtype, backend="cuda")).replace(chunk=c)
            for op, x in (("sort", xf), ("argsort", kt))}
        form = lambda kv: external._form_runs_cuda(
            ext["xk"] if kv else ext["xf"], ext["rank"] if kv else None, R,
            T, w=ext_plan.w, chunk=c, levels=ext_plan.levels,
            block_out=ext_plan.block_out, descending=True)
        calls = (("sort", lambda: engine.sort(xf, plan=plans["sort"]),
                  s_ref),
                 ("argsort", lambda: engine.argsort(kt, plan=plans["argsort"]),
                  a_ref.to(torch.int32)),
                 ("run_form", lambda: form(False)[0], form_ref),
                 ("run_form_kv", lambda: form(True), kv_ref))
        for name, fn, ref in calls:
            out, launches = counted(kernels, fn)
            check_same(f"{name} at chunk {c}", out, ref)
            row[name + "_ms"] = time_ms(fn)
            row[name + "_launches"] = launches
        sweep.append(row)
        print(json.dumps({"chunk_sweep_row": row}), flush=True)
    print(json.dumps({"chunk_sweep": sweep}), flush=True)


def sorter_split(engine, x, kv: bool):
    """CUDA-event medians of ``engine.sort`` (``engine.argsort`` with
    ``kv``) of ``x`` split into its launches: the K1 chunk sort, then each
    merge pass at the shapes the schedule's ``schedule.pass`` events give
    (runs of uniform length, sorted here)."""
    from repro_torch import obs
    from repro_torch.kernels import bitonic_sort as k1
    from repro_torch.kernels import merge_tree as k4
    n, chunk = x.shape[0], 256
    obs.reset()
    obs.enable()
    (engine.argsort if kv else engine.sort)(x)
    events = [e["data"] for e in obs.snapshot()["events"]
              if e["kind"] == "schedule.pass"]
    obs.disable()
    obs.reset()
    rows = x.reshape(-1, chunk)
    ranks = torch.arange(n, dtype=torch.int32, device="cuda")
    out = [{"pass": "K1", "ms": time_ms(
        (lambda: k1.sort_chunks_kv(rows, ranks.reshape(-1, chunk)))
        if kv else (lambda: k1.sort_chunks(rows)))}]
    for ev in events:
        runs = ev["runs"]
        run_len = n // runs
        srt = torch.sort(x.reshape(runs, run_len), dim=-1, descending=True,
                         stable=True)
        buf = srt.values.reshape(-1)
        st = torch.arange(0, n, run_len, dtype=torch.int32, device="cuda")
        ln = torch.full_like(st, run_len)
        kw = dict(group=1 << ev["levels"], n_out=n, w=128,
                  block_out=ev["block_out"])
        if ev["levels"] < 2:
            raise AssertionError(f"sorter pass at one level: {ev}")
        if kv:
            rk = ranks.reshape(runs, run_len).gather(1, srt.indices) \
                .reshape(-1)
            fn = lambda: k4.merge_tree_runs_kv(buf, rk, st, ln, **kw)
        else:
            fn = lambda: k4.merge_tree_runs(buf, st, ln, **kw)
        out.append({"pass": len(out), "runs": runs, "run_len": run_len,
                    "levels": ev["levels"], "block_out": ev["block_out"],
                    "ms": time_ms(fn)})
    return out


def phase_sorter_split(engine, data):
    """engine.sort / engine.argsort of 2^24 keys split per launch, and the
    sorter at 2 and 3 fused levels a pass (``kernel_sort`` /
    ``kernel_argsort``, the functions engine.sort / argsort call; recorded,
    the planner keeps 2), each result bit-for-bit torch."""
    from repro_torch.kernels import ops
    xf, kt = data["xf"], data["kt"]
    split = {"engine.sort f32 desc": sorter_split(engine, xf, False),
             "engine.argsort f32 desc": sorter_split(engine, kt, True)}
    print(json.dumps({"sorter_split": split}), flush=True)
    levels = []
    for L in (2, 3):
        s_fn = lambda: ops.kernel_sort(xf, chunk=256, w=128, levels=L)
        a_fn = lambda: ops.kernel_argsort(kt, chunk=256, w=128, levels=L)
        check_same(f"kernel_sort levels={L}", s_fn(),
                   torch.sort(xf, descending=True).values)
        check_same(f"kernel_argsort levels={L}", a_fn().long(),
                   torch.argsort(kt, descending=True, stable=True))
        levels.append({"levels": L, "sort_ms": time_ms(s_fn),
                       "argsort_ms": time_ms(a_fn)})
    print(json.dumps({"sorter_levels": levels}), flush=True)


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


# --------------------------------------------------------------------------
# slice 2: the segmented ops (K5, K6) and the MoE layer (K7)
# --------------------------------------------------------------------------

def _import_slice2():
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.engine import planner
    from repro_torch.kernels import route_fuse as k7
    from repro_torch.kernels import segmented_merge as k56
    from repro_torch.models import moe
    return obs, get_config, planner, k7, k56, moe


def ulps(g: torch.Tensor, e: torch.Tensor) -> int:
    """Largest distance in float32 units in the last place (the weights are
    positive, so their int32 bit patterns are ordered)."""
    if not g.numel():
        return 0
    return int((g.view(torch.int32).long() - e.view(torch.int32).long()
                ).abs().max())


def check_route(what: str, got, ref):
    """Routing lanes: experts, tokens, perm, slabs and keep bit for bit, the
    weights within ROUTE_WEIGHT_ULPS (a NaN weight, which logits whose
    monotone key is INT32_MIN give, at the same places on both sides).
    Returns (max_abs_err, ulps) of the weights."""
    names = ("experts", "tokens", "perm", "weights", "slabs", "keep")
    for name, g, e in zip(names, got, ref):
        if name != "weights":
            check_same(f"{what} {name}", g, e)
    nan = torch.isnan(got[3])
    if not torch.equal(nan, torch.isnan(ref[3])):
        raise AssertionError(f"{what} weights: NaN at other places")
    g, e = got[3][~nan], ref[3][~nan]
    u = ulps(g, e)
    if u > ROUTE_WEIGHT_ULPS:
        raise AssertionError(f"{what} weights: {u} ulps > "
                             f"{ROUTE_WEIGHT_ULPS}")
    return max_abs_err(g, e), u


def int_min_logits(G, T, E, per_row, gen):
    """(G, T, E) router logits with ``per_row`` entries of each row (at
    random experts) set to the bits 0xFFFFFFFF, whose monotone key is
    INT32_MIN."""
    lg = torch.randn((G, T, E), generator=gen, device="cuda")
    pick = torch.argsort(torch.rand((G, T, E), generator=gen, device="cuda"),
                         dim=-1)[..., :per_row]
    lg.view(torch.int32).scatter_(-1, pick, -1)
    return lg


def counted(kernels, fn):
    """Run ``fn`` with every launch count set to 0 just before and read just
    after (the device synchronised on both sides)."""
    torch.cuda.synchronize()
    kernels.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, kernels.launch_counts()


def seg_offsets(total: int, gen, longest: int = SEG_MAX):
    """Ragged segment lengths in [0, longest] summing to ``total``, every
    17th segment empty; returns the lengths and int32 offsets on the card."""
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
    offs = torch.tensor([0] + lens, dtype=torch.int64).cumsum(0)
    return lens, offs.to(device="cuda", dtype=torch.int32)


def phase_segments(engine, kernels, gen):
    """The segmented ops over 2^22 keys in ragged segments, counted, each
    cuda variant bit-for-bit its torch variant."""
    lens, offs = seg_offsets(N_SEG, gen)
    kf = tie_keys(N_SEG, gen)
    ki = torch.randint(-2 ** 31, 2 ** 31 - 1, (N_SEG,), generator=gen,
                       device="cuda", dtype=torch.int32)
    lens_b = lens[::-1]
    offs_b = torch.tensor([0] + lens_b, dtype=torch.int64).cumsum(0).to(
        device="cuda", dtype=torch.int32)
    a = engine.segment_sort(kf, offs, variant="torch")
    b = engine.segment_sort(tie_keys(N_SEG, gen), offs_b, variant="torch")
    cases = [(nm, x, v, d) for nm, x in (("f32", kf), ("i32", ki))
             for v in ("cuda_fused", "cuda_two_phase") for d in (True, False)]

    def drive():
        out = {}
        for nm, x, v, d in cases:
            out[(nm, v, d, "sort")] = engine.segment_sort(
                x, offs, descending=d, variant=v)
            out[(nm, v, d, "argsort")] = engine.segment_argsort(
                x, offs, descending=d, variant=v)
        out["merge"] = engine.segment_merge(a, offs, b, offs_b)
        return out

    out, launches = counted(kernels, drive)
    for nm, x, v, d in cases:
        check_same(f"segment_sort {nm} {v} desc={d}", out[(nm, v, d, "sort")],
                   engine.segment_sort(x, offs, descending=d,
                                       variant="torch"))
        check_same(f"segment_argsort {nm} {v} desc={d}",
                   out[(nm, v, d, "argsort")],
                   engine.segment_argsort(x, offs, descending=d,
                                          variant="torch"))
    check_same("segment_merge", out["merge"],
               engine.segment_merge(a, offs, b, offs_b, variant="torch"))
    need = ("segment_sort", "segment_sort_kv", "sort_chunks",
            "sort_chunks_kv", "segmented_merge_runs",
            "segmented_merge_runs_kv")
    missing = [k for k in need if not launches.get(k)]
    if missing:
        raise AssertionError(f"segment path never launched {missing}: "
                             f"{launches}")
    print(f"segments: {N_SEG} keys in {len(lens)} segments "
          f"({sum(1 for n in lens if not n)} empty, longest {max(lens)}), "
          "every cuda variant bit-for-bit torch; launches "
          + json.dumps(launches), flush=True)
    short_lens, short_offs = seg_offsets(N_SHORT, gen, SHORT_MAX)
    short = dict(kf=tie_keys(N_SHORT, gen), offs=short_offs, lens=short_lens)
    return launches, dict(kf=kf, ki=ki, offs=offs, lens=lens, short=short)


def _chunk_logits(moe, p, x, mode: str):
    """The router logits of every chunk the layer routes, (1, T, E)
    each."""
    B, S, d = x.shape
    Sc = S if mode == "sorted" else moe._seq_chunk(S, (512, 256, 128))
    return [x[:, i * Sc:(i + 1) * Sc].reshape(1, B * Sc, d).float()
            @ p["router"] for i in range(S // Sc)]


def phase_moe(engine, kernels, slice2, gen, cfg_name, runs, split=False):
    """One MoE layer at full width: each (mode, B, S) of ``runs`` driven
    once through ``moe_apply`` with the counts set to 0 before and read
    after, then the route, fused-vs-torch and no-drop checks."""
    obs, get_config, planner, k7, _, moe = slice2
    cfg = get_config(cfg_name)
    E, k, dev = cfg.n_experts, cfg.n_experts_active, "cuda"
    t0 = time.perf_counter()
    p = moe.moe_init(gen, cfg, device=dev)
    xs = {(B, S): torch.randn((B, S, cfg.d_model), generator=gen,
                              device=dev).to(torch.bfloat16)
          for _, B, S in runs}
    torch.cuda.synchronize()
    gb = sum(v.numel() * v.element_size() for v in p.values()) / 1e9
    print(f"{cfg_name}: d {cfg.d_model}, expert d_ff {cfg.moe_d_ff}, "
          f"{E} experts top-{k}, {cfg.param_dtype}; {gb:.3f} GB of weights "
          f"made in {time.perf_counter() - t0:.1f} s", flush=True)
    launches_all, errs, routes = {}, [0.0, 0], []
    for mode, B, S in runs:
        x = xs[(B, S)]
        obs.reset()
        obs.enable()
        y, launches = counted(kernels, lambda: moe.moe_apply(p, x, cfg,
                                                             mode=mode))
        dropped = obs.snapshot()["counters"].get("moe.dropped_tokens", 0)
        obs.disable()
        label = f"{cfg_name} {mode or cfg.moe_path} ({B}, {S})"
        if not launches.get("moe_route"):
            raise AssertionError(f"{label}: K7 never launched: {launches}")
        if y.shape != x.shape or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"{label}: output {tuple(y.shape)} not "
                                 "finite or misshapen")
        for kname, n in launches.items():
            launches_all[kname] = launches_all.get(kname, 0) + n
        # every chunk's routing lanes against the torch variant
        lgs = _chunk_logits(moe, p, x, mode or cfg.moe_path)
        T = lgs[0].shape[1]
        cap = moe.expert_capacity(1.25, T, k, E)
        w_same = True
        for i, lg in enumerate(lgs):
            rf = engine.moe_route(lg, k, cap, variant="fused")
            rt = engine.moe_route(lg, k, cap, variant="torch")
            err, u = check_route(f"{label} chunk {i}", rf, rt)
            errs = [max(errs[0], err), max(errs[1], u)]
            w_same &= torch.equal(rf.weights.to(torch.bfloat16),
                                  rt.weights.to(torch.bfloat16))
        # the run's first chunk and the K7 launches of the run
        routes.append((lgs[0], k, cap, launches["moe_route"]))
        # the layer on the torch route: equal where the bf16 weights are
        key = planner.plan_key("moe_route", n=T * k, dtype=torch.float32,
                               backend="cuda", segments=1)
        engine.default_planner.put(key, engine.Plan("torch"))
        yt = moe.moe_apply(p, x, cfg, mode=mode)
        engine.clear_plans()
        d_route = max_abs_err(y.float(), yt.float())
        if w_same and not torch.equal(y, yt):
            raise AssertionError(f"{label}: fused and torch routes gave "
                                 f"equal weights but outputs differ by "
                                 f"{d_route}")
        if d_route > 2.0 ** -7 * float(yt.float().abs().max()):
            raise AssertionError(f"{label}: fused vs torch route output "
                                 f"differs by {d_route}")
        line = {"run": label, "tokens_per_route": T, "capacity": cap,
                "routes": len(lgs), "launches": launches,
                "moe.dropped_tokens": dropped,
                "route_weight_ulps": errs[1],
                "bf16_weights_equal": bool(w_same),
                "fused_vs_torch_route_max_abs": d_route}
        if mode != "sorted":
            ynd = moe.moe_apply_grouped(p, x, cfg, capacity_factor=E / k)
            yd = moe.moe_apply_dense(p, x, cfg)
            diff = (ynd.float() - yd.float())
            rel_f = float(diff.norm() / yd.float().norm())
            rel_m = float(diff.abs().max() / yd.float().abs().max())
            if rel_f > BF16_REL_FROB or rel_m > BF16_REL_MAX:
                raise AssertionError(
                    f"{label}: grouped (nothing dropped) vs dense: relative "
                    f"Frobenius {rel_f}, largest {rel_m}")
            line.update(nodrop_vs_dense_rel_frob=rel_f,
                        nodrop_vs_dense_rel_max=rel_m)
        print("moe: " + json.dumps(line), flush=True)
    split_line = moe_split(engine, k7, moe, p, xs[runs[0][1:]], cfg) \
        if split else None
    del p, xs
    torch.cuda.empty_cache()
    return launches_all, errs, routes, split_line


def moe_split(engine, k7, moe, p, x, cfg):
    """Where the grouped layer's time goes, per chunk: router logits, the
    routing op (K7 inside), the slab scatter, the expert products and the
    combine; CUDA-event medians against the whole layer's."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.n_experts_active
    Sc = moe._seq_chunk(S, (512, 256, 128))
    T = B * Sc
    cap = moe.expert_capacity(1.25, T, k, E)
    xc = x[:, :Sc].reshape(1, T, d)
    lg = xc.float() @ p["router"]
    r = engine.moe_route(lg, k, cap)
    xin = moe._scatter_slabs(xc, r, E, cap)
    y = moe._experts(p, xin)
    parts = {"router_logits": time_ms(lambda: xc.float() @ p["router"]),
             "moe_route": time_ms(lambda: engine.moe_route(lg, k, cap)),
             "k7_kernel": time_ms(lambda: k7.moe_route(lg, k, cap)),
             "slab_scatter": time_ms(lambda: moe._scatter_slabs(xc, r, E,
                                                                cap)),
             "expert_products": time_ms(lambda: moe._experts(p, xin)),
             "combine": time_ms(lambda: moe._combine(y, r, T, k))}
    layer = time_ms(lambda: moe.moe_apply(p, x, cfg, mode="grouped"),
                    warmup=1, reps=5)
    chunks = S // Sc
    per_chunk = sum(v for n, v in parts.items() if n != "k7_kernel")
    flops = 3 * 2 * E * cap * d * (cfg.moe_d_ff or cfg.d_ff)
    line = {"layer": f"{cfg.name} grouped ({B}, {S})", "layer_ms": layer,
            "chunks": chunks, "per_chunk_ms": parts,
            "parts_ms": chunks * per_chunk,
            "unaccounted_ms": layer - chunks * per_chunk,
            "expert_tflops": flops / parts["expert_products"] / 1e9}
    print("moe split: " + json.dumps(line), flush=True)
    return line


def phase_slice2_vs_plain(slice2, seg, route_logits, gen):
    """K5, K6 and K7 against their plain versions on the card: the segment
    phase's batch, a small batch dense with +0.0/-0.0, and the layers' first
    routed chunks plus tied shapes with signed zeros."""
    _, _, _, k7, k56, _ = slice2
    errs = {"segment_sort": 0.0, "segment_sort_kv": 0.0, "moe_route": 0.0}

    def both(fn, *args, **kw):
        err = check_same(f"{fn.__name__} {kw}", fn(*args, **kw),
                         plain_of(fn)(*args, **kw))
        errs[fn.__name__] = max(errs[fn.__name__], err)

    lens = [5, 0, 33, 7, 0, 0, 90, 4, 17, 1, 1024, 600]
    small_offs = torch.tensor([0] + lens, dtype=torch.int64).cumsum(0).to(
        device="cuda", dtype=torch.int32)
    small = dup_keys(sum(lens), gen)
    short = seg["short"]
    wide = [(nan_segments(WIDE_LENS[cap], gen), cap) for cap in WIDE_LENS]
    for x, offs, cap in ((seg["kf"], seg["offs"], SEG_MAX),
                         (seg["ki"], seg["offs"], SEG_MAX),
                         (short["kf"], short["offs"], SHORT_MAX),
                         (small, small_offs, 1024),
                         (small, small_offs, 4096),
                         *((x, o, cap) for (x, o), cap in wide)):
        both(k56.segment_sort, x, offs, cap=cap)
        if cap > k56.MAX_CAP_KV:
            continue
        for d in (True, False):
            both(k56.segment_sort_kv, x, offs, cap=cap, descending=d)
    routes = {f"cap {cap}": seg_routes(WIDE_LENS[cap], x, offs, cap,
                                       k56.MAX_CAP_KV)
              for (x, offs), cap in wide}
    ulp_max = 0
    tied = []
    for G, T, E, k in ((1, 64, 8, 2), (3, 33, 5, 2), (2, 128, 16, 6),
                       (1, 2048, 64, 6)):
        lg = torch.round(torch.randn((G, T, E), generator=gen,
                                     device="cuda") * 2) / 2
        sign = torch.randint(0, 2, lg.shape, generator=gen, device="cuda")
        tied.append((torch.where((lg == 0) & (sign == 1), -0.0, lg), k,
                     max(1, T * k // (2 * E))))
    # the top-k repair: once every expert not yet picked reads INT32_MIN
    # the mask rule picks expert 0 again ([1.0, 0xFFFFFFFF, 2.0,
    # 0xFFFFFFFF] at k = 4 routes to [0, 0, 0, 2])
    row = torch.tensor([[[1.0, 0.0, 2.0, 0.0]]], device="cuda")
    row.view(torch.int32)[0, 0, 1::2] = -1
    repair = [(row, 4, 8), (int_min_logits(1, 2048, 64, 60, gen), 6, 241),
              (int_min_logits(1, 4096, 8, 7, gen), 2, 1281),
              (int_min_logits(2, 512, 8, 5, gen), 8, 600)]
    first = k7.moe_route(row, 4, 8)[0][0].tolist()
    if first != [0, 0, 0, 2]:
        raise AssertionError(f"moe_route repair row: experts {first}")
    for lg, k, cap in [r[:3] for r in route_logits] + tied + repair:
        got = k7.moe_route(lg, k, cap)
        err, u = check_route(f"moe_route {tuple(lg.shape)} k={k}", got,
                             k7.moe_route_plain(lg, k, cap))
        errs["moe_route"] = max(errs["moe_route"], err)
        ulp_max = max(ulp_max, u)
    torch.cuda.synchronize()
    print("slice 2 kernels vs plain: K5/K6 bit-for-bit (NaN and +-0 "
          "segments by route, K5 then K6: " + json.dumps(routes) + "), K7 "
          "integer lanes bit-for-bit at the three route shapes, tied logits "
          f"and INT32_MIN keys, weights within {ulp_max} ulps "
          + json.dumps(errs), flush=True)
    return errs


# NaN and +-0 segments at the largest caps: every width class, starts off
# 16 bytes (the 3-key segment first)
WIDE_LENS = {16384: [3, 16384, 16383, 9000, 0, 1, 257, 8193, 4096, 33,
                     16384, 12000],
             32768: [3, 32768, 20000, 16385, 16384, 100, 0, 5, 32767,
                     30000]}


def nan_segments(lens, gen):
    """Keys for ``lens``: even segments from ``nan_keys`` (NaNs of several
    payloads among +-0), odd ones from ``dup_keys`` (+-0, no NaN)."""
    parts = [(nan_keys if i % 2 == 0 else dup_keys)(n, gen)
             for i, n in enumerate(lens)]
    offs = torch.tensor([0] + lens, dtype=torch.int64).cumsum(0).to(
        device="cuda", dtype=torch.int32)
    return torch.cat(parts), offs


def seg_routes(lens, x, offs, cap, kv_cap):
    """Segments of a batch by K5 / K6's route: empty; warp (c <= 256 or
    512); wide (WideNet); smem (K5 at c = 32768); a NaN sends a segment to
    the cap's route; "exact" marks the float lanes (a NaN, or on K6 a
    -0.0). K6 is counted only up to ``kv_cap``."""
    nan = [bool(torch.isnan(x[a:b]).any()) for a, b in
           zip(offs[:-1].tolist(), offs[1:].tolist())]
    negz = [bool((x[a:b].view(torch.int32) == -2 ** 31).any()) for a, b in
            zip(offs[:-1].tolist(), offs[1:].tolist())]
    tile = 256 if cap <= 8192 else 512
    out = {}
    for kv in (False, True)[:1 + (cap <= kv_cap)]:
        cnt = {}
        for n, h, z in zip(lens, nan, negz):
            c = cap if h else 1 << max(n - 1, 0).bit_length()
            r = ("empty" if not n else "warp" if c <= tile else
                 "smem" if c == 32768 and not kv else "wide")
            if h or (kv and z):
                r += " exact"
            cnt[r] = cnt.get(r, 0) + 1
        out["K6" if kv else "K5"] = cnt
    return out


def _network_ops(lens) -> float:
    """Compare-exchanges of a bitonic network over next_pow2(len) lanes per
    segment: what this data needs of the algorithm."""
    ops = 0.0
    for n in lens:
        if n > 1:
            lg = math.ceil(math.log2(n))
            ops += (1 << lg) / 2 * lg * (lg + 1) / 2
    return ops


def phase_slice2_times(slice2, launches, errs, seg, route_logits):
    """K5, K6 and K7 at their paths' shapes beside the plain versions, a
    library call and the bound; K5 / K6 also at the many-short-segments
    shape (printed, not in the table)."""
    from repro_torch.launch import roofline as rl
    _, _, _, k7, k56, _ = slice2

    def route_case(lg, k, cap):
        """K7 at one route shape: bytes of the logits and the six lanes;
        operations the k sweeps' compares and the counting sort's pairs."""
        G, T, E = lg.shape
        return (k7.moe_route, "route_fuse.cu", "route_fuse.py:181",
                (lg, k, cap), {}, lambda: k7.moe_route_torch(lg, k, cap),
                "moe_route_torch, the torch variant: no single torch call "
                "routes", G * rl.moe_route_bytes(T, E, k),
                G * T * k * (E + 2))

    def seg_cases(sh, cap):
        kf, offs, lens = sh["kf"], sh["offs"], sh["lens"]
        n, S = kf.numel(), len(lens)
        bank = k56.padded_bank(kf, offs, cap)
        net = _network_ops(lens)
        return [
            (k56.segment_sort, "segment_sort.cu", "segmented_merge.py:422",
             (kf, offs), dict(cap=cap), lambda: torch.sort(bank, dim=-1),
             "torch.sort over the padded (S, cap) bank",
             rl.stream_bytes(n, 4) + (S + 1) * 4, net),
            (k56.segment_sort_kv, "segment_sort.cu",
             "segmented_merge.py:521", (kf, offs), dict(cap=cap),
             lambda: torch.sort(bank, dim=-1, stable=True),
             "torch.sort(stable=True) over the padded (S, cap) bank",
             3 * n * 4 + (S + 1) * 4, net)]

    cases = seg_cases(seg, SEG_MAX) + [route_case(*route_logits[0][:3])]
    short = seg_cases(seg["short"], SHORT_MAX)
    # K7 at each route shape, with that run's launches: Mixtral's grouped
    # chunk (the table's row), its sorted layer, Moonlight's grouped chunk
    shapes = [route_case(*r[:3]) for r in route_logits]
    table = []
    for i, (fn, source, replaces, args, kw, lib, lib_call, nbytes,
            ops) in enumerate(cases + short + shapes):
        name = fn.__name__
        bound_ms, bound_by = _bound(nbytes, ops)
        row = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/" + source,
            "replaces": "src/repro/kernels/" + replaces,
            "launches": int(launches.get(name, 0)),
            "max_abs_err": errs[name],
            "ms": time_ms(lambda: fn(*args, **kw)),
            "plain_ms": time_ms(lambda: plain_of(fn)(*args, **kw), warmup=1,
                                reps=5),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": time_ms(lib), "library_call": lib_call}
        if i < len(cases):
            table.append(row)
            print(f"time {name}: " + json.dumps(row), flush=True)
        elif i < len(cases) + len(short):
            row.update(keys=N_SHORT, segments=len(seg["short"]["lens"]),
                       cap=SHORT_MAX)
            print(f"time {name} short: " + json.dumps(row), flush=True)
        else:
            lg, k = args[:2]
            row.update(launches=route_logits[i - len(cases) - len(short)][3],
                       shape=list(lg.shape), k=k)
            print(f"time moe_route {tuple(lg.shape)} k={k}: "
                  + json.dumps(row), flush=True)
    return table


SEG_VARIANTS = ("cuda_fused", "cuda_two_phase", "torch")


def phase_slice2_e2e(engine, seg):
    """``engine.segment_sort`` / ``segment_argsort`` end to end at the
    segmented-ops shape and the many-short-segments shape: ``cuda_fused``
    (K5 / K6), ``cuda_two_phase`` (the planner's default on the card: K1,
    then K3 / K4 passes) and ``torch``, each result bit-for-bit ``torch``'s
    (float32 keys 0..999: ties, no signed zeros)."""
    rows = []
    for shape, sh in (("seg", seg), ("short", seg["short"])):
        kf, offs = sh["kf"], sh["offs"]
        for op in ("segment_sort", "segment_argsort"):
            fn = getattr(engine, op)
            ref = fn(kf, offs, variant="torch")
            row = {"call": f"engine.{op}", "shape": shape, "n": kf.numel(),
                   "segments": len(sh["lens"])}
            for v in SEG_VARIANTS:
                check_same(f"engine.{op} {v} {shape}",
                           fn(kf, offs, variant=v), ref)
                row[f"{v}_ms"] = time_ms(lambda: fn(kf, offs, variant=v))
            rows.append(row)
    print(json.dumps({"e2e_segments": rows}), flush=True)


# --------------------------------------------------------------------------
# slice 3: the out-of-core sort (K8)
# --------------------------------------------------------------------------

def _import_slice3():
    from repro_torch import obs
    from repro_torch.engine import external, schedule
    from repro_torch.kernels import stream_merge as k8
    from repro_torch.launch import roofline
    return obs, external, schedule, k8, roofline


def phase_external(engine, kernels, slice3, data, gen):
    """``external_sort`` at 2^27 keys and ``merge_runs(variant=
    "stream_cuda")`` on the main path's runs, counted per call, every
    result bit-for-bit torch."""
    obs, _, _, _, roofline = slice3
    n, dev = N_EXT, "cuda"
    xf = torch.randn(n, generator=gen, device=dev)
    xi = torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=gen,
                       device=dev, dtype=torch.int32)
    xk = torch.randint(0, 1 << 16, (n,), generator=gen, device=dev,
                       dtype=torch.int32)
    rank = torch.arange(n, dtype=torch.int32, device=dev)
    rbuf, roffs = data["rbuf"], data["roffs"]
    rvals = torch.arange(rbuf.shape[0], device=dev)
    calls = {
        "f32_desc": lambda: engine.external_sort(xf),
        "f32_asc": lambda: engine.external_sort(xf, descending=False),
        "i32_desc": lambda: engine.external_sort(xi),
        "kv_desc": lambda: engine.external_sort(xk, stable=True,
                                                values=rank),
        "kv_asc": lambda: engine.external_sort(xk, descending=False,
                                               stable=True, values=rank),
        "merge_runs": lambda: engine.merge_runs(rbuf, roffs,
                                                variant="stream_cuda"),
        "merge_runs_kv": lambda: engine.merge_runs(
            rbuf, roffs, values=rvals, variant="stream_cuda"),
    }
    out, per_call, passes = {}, {}, {}

    def drive():
        for name, fn in calls.items():
            before = kernels.launch_counts()
            obs.reset()
            obs.enable()
            out[name] = fn()
            passes[name] = [e["data"] for e in obs.snapshot()["events"]
                            if e["kind"] == "external.pass"]
            obs.disable()
            after = kernels.launch_counts()
            per_call[name] = {k: v - before.get(k, 0) for k, v in
                              after.items() if v - before.get(k, 0)}

    _, launches = counted(kernels, drive)
    obs.reset()
    for name, x, d in (("f32_desc", xf, True), ("f32_asc", xf, False),
                       ("i32_desc", xi, True)):
        check_same(f"external_sort {name}", out[name],
                   torch.sort(x, descending=d).values)
    for name, d in (("kv_desc", True), ("kv_asc", False)):
        perm = torch.argsort(xk, descending=d, stable=True)
        check_same(f"external_sort {name}", out[name],
                   (xk[perm], perm.to(torch.int32)))
    check_same("merge_runs stream_cuda", out["merge_runs"],
               torch.sort(rbuf, descending=True).values)
    perm = torch.argsort(rbuf, descending=True, stable=True)
    check_same("merge_runs stream_cuda values", out["merge_runs_kv"],
               (rbuf[perm], perm))
    n_pass = roofline.external_passes(n // (1 << 20), 8)
    for name in ("f32_desc", "f32_asc", "i32_desc", "kv_desc", "kv_asc"):
        sfx = "_kv" if name.startswith("kv") else ""
        want = {"sort_chunks" + sfx: 1, "merge_tree_runs" + sfx: 6,
                "stream_merge_runs" + sfx: n_pass}
        if per_call[name] != want:
            raise AssertionError(f"external_sort {name}: launches "
                                 f"{per_call[name]}, expected {want}")
        bytes_each = 2 * n * (8 if sfx else 4)
        got = [p["bytes_streamed"] for p in passes[name]]
        if got != [bytes_each] * n_pass:
            raise AssertionError(f"external_sort {name}: external.pass "
                                 f"bytes {got}, expected {n_pass} x "
                                 f"{bytes_each}")
    for name in ("merge_runs", "merge_runs_kv"):
        k8 = "stream_merge_runs" + ("_kv" if name.endswith("kv") else "")
        if not per_call[name].get(k8):
            raise AssertionError(f"{name} stream_cuda never launched K8: "
                                 f"{per_call[name]}")
    print(f"external: 2^27 keys, {n_pass} external.pass events per call; "
          "every result bit-for-bit torch; launches "
          + json.dumps(launches), flush=True)
    print("external launches per call: " + json.dumps(per_call), flush=True)
    return launches, dict(xf=xf, xk=xk, rank=rank)


# (runs, run_len, fan_in, w, block_out) of K8 against its plain version:
# small shapes at fan 2, 8 and 16, w 32 and 128, run_len above and equal to
# the output block (plain version on host copies) ...
K8_SMALL = ((8, 1024, 2, 32, 256), (16, 4096, 8, 128, 4096),
            (16, 256, 16, 32, 256))
# ... and the main path's at its plan: one fan-8 group of pass 0 (runs of
# 2^20) and the last pass, fan 2 over two runs of 2^26 (plain on the card)
K8_PATH = ((8, 1 << 20, 8, 128, 4096), (2, 1 << 26, 2, 128, 4096))
# span geometries, each (shape, CTA counts forced through ``_ctas``, plain
# on host copies, KV only): two groups of 512 blocks under 6 CTAs (three
# spans of 170-171 blocks a group, two starting mid-group) and under the
# card's own count; 16 blocks under 64 CTAs (a span is a block); fan 16 on
# KV lanes under 5 CTAs (two spans a group) and 1 (one CTA takes both
# groups in turn)
K8_SPANS = (((16, 1 << 16, 8, 128, 1024), (6, 0), False, False),
            ((16, 4096, 8, 128, 4096), (64,), True, False),
            ((32, 256, 16, 32, 256), (5, 1), True, True))


def _k8_cases(gen, geoms):
    """(kwargs, key-only runs, {descending: KV runs}) at each geometry."""
    dev = "cuda"
    cases = []
    for runs, run_len, fan, w, bo in geoms:
        x = dup_keys(runs * run_len, gen).reshape(runs, run_len)
        r = torch.randperm(runs * run_len, generator=gen, device=dev).to(
            torch.int32).reshape(runs, run_len)
        kw = dict(runs=runs, run_len=run_len, fan_in=fan, w=w, block_out=bo)
        key_only = torch.sort(x, dim=1, descending=True).values.reshape(-1)
        kv = {}
        for d in (True, False):
            p1 = torch.argsort(r, dim=1)
            xs, rs = torch.gather(x, 1, p1), torch.gather(r, 1, p1)
            p2 = torch.argsort(xs, dim=1, descending=d, stable=True)
            kv[d] = (torch.gather(xs, 1, p2).reshape(-1).contiguous(),
                     torch.gather(rs, 1, p2).reshape(-1).contiguous())
        cases.append((kw, key_only.contiguous(), kv))
    return cases


def phase_slice3_vs_plain(slice3, gen):
    """K8 and K8kv against their plain versions, on keys with +0.0/-0.0,
    -inf and heavy duplicates: at the main path's shapes with the plain
    version on the card, at small shapes on host copies of the inputs, and
    a two-pass chain reading the first pass's output and slack as is."""
    _, _, _, k8, _ = slice3
    errs = {"stream_merge_runs": 0.0, "stream_merge_runs_kv": 0.0}

    def both(fn, *args, host=True, **kw):
        got = fn(*args, **kw)
        if host:
            exp = plain_of(fn)(*(a.cpu() for a in args), **kw)
            exp = tuple(e.cuda() for e in exp) if isinstance(exp, tuple) \
                else exp.cuda()
        else:
            exp = plain_of(fn)(*args, **kw)
        err = check_same(f"{fn.__name__} {kw}", got, exp)
        errs[fn.__name__] = max(errs[fn.__name__], err)
        return got

    for geoms, host in ((K8_PATH, False), (K8_SMALL, True)):
        for kw, key_only, kv in _k8_cases(gen, geoms):
            both(k8.stream_merge_runs, key_only, out_slack=100, host=host,
                 **kw)
            for d, (k, r) in kv.items():
                if kw["fan_in"] < 16 or d:
                    both(k8.stream_merge_runs_kv, k, r, descending=d,
                         host=host, **kw)
        torch.cuda.synchronize()
        print(f"slice 3 kernels vs plain: {geoms} bit-for-bit", flush=True)
    # span geometries: one plain result, the kernel under each CTA count
    for geom, ctas_list, host, kv_only in K8_SPANS:
        (kw, key_only, kv), = _k8_cases(gen, (geom,))
        cases = [(k8.stream_merge_runs_kv, kv[True], dict(kw, descending=True))]
        if not kv_only:
            cases += [(k8.stream_merge_runs, (key_only,), kw),
                      (k8.stream_merge_runs_kv, kv[False],
                       dict(kw, descending=False))]
        for fn, args, ckw in cases:
            exp = plain_of(fn)(*((a.cpu() for a in args) if host else args),
                               **ckw)
            exp = tuple(e.cuda() for e in exp) if isinstance(exp, tuple) \
                else exp.cuda()
            for ctas in ctas_list:
                err = check_same(f"{fn.__name__} {ckw} ctas={ctas}",
                                 fn(*args, _ctas=ctas, **ckw), exp)
                errs[fn.__name__] = max(errs[fn.__name__], err)
        torch.cuda.synchronize()
        print(f"slice 3 kernels vs plain: spans {geom} under ctas "
              f"{ctas_list} bit-for-bit", flush=True)
    # a chain: pass 1 leaves the slack pass 2 needs, pass 2 reads it as is
    w, bo, runs, run_len, fan = 32, 512, 16, 512, 4
    x = torch.sort(dup_keys(runs * run_len, gen).reshape(runs, run_len),
                   dim=1, descending=True).values.reshape(-1)
    slack = k8.stream_slack(fan, w, bo)
    b1 = both(k8.stream_merge_runs, x, runs=runs, run_len=run_len,
              fan_in=fan, w=w, block_out=bo, out_slack=slack)
    both(k8.stream_merge_runs, b1, runs=runs // fan, run_len=run_len * fan,
         fan_in=fan, w=w, block_out=bo)
    torch.cuda.synchronize()
    print("slice 3 kernels vs plain: K8/K8kv bit-for-bit at the path's "
          "shapes, fan 2, 8, 16, the span geometries and a two-pass chain "
          + json.dumps(errs), flush=True)
    return errs


def phase_slice3_times(slice3, launches, errs, ext):
    """K8 and K8kv at the path's shape (one fan-8 pass over 2^27 keys in
    runs of 2^20) beside the plain version (at 8 runs of 2^12: the plain
    version is launch-bound, seconds a call), one torch.sort of the
    concatenation and the bound."""
    _, _, _, k8, roofline = slice3
    n, run_len, fan = N_EXT, 1 << 20, 8
    M = dict(runs=n // run_len, run_len=run_len, fan_in=fan, w=128,
             block_out=4096)
    slack = k8.stream_slack(16, 128, 4096)   # enough for every fan-in
    runs = torch.sort(ext["xf"].reshape(-1, run_len), dim=1,
                      descending=True).values.reshape(-1)
    kvs = torch.sort(ext["xk"].reshape(-1, run_len), dim=1,
                     descending=True, stable=True)
    rk = (ext["rank"].reshape(-1, run_len).gather(1, kvs.indices)
          .reshape(-1))
    kvk = kvs.values.reshape(-1)
    pad = lambda t, f: torch.cat([t, t.new_full((slack,), f)])
    kbuf, kvbuf, rbuf = pad(runs, float("-inf")), pad(kvk, -2 ** 31), \
        pad(rk, 2 ** 31 - 1)
    # the plain version's shape: the first 8 x 4096 keys of the first run
    # are 8 sorted runs of 4096
    P = dict(M, runs=8, run_len=1 << 12)
    small_kv = (kvk[:8 << 12], torch.arange(8 << 12, dtype=torch.int32,
                                             device="cuda"))
    ops = n * (1 + math.log2(128) / 2) * 3
    cases = [
        (k8.stream_merge_runs, (kbuf,), M, (runs[:8 << 12],),
         lambda: torch.sort(runs, descending=True),
         roofline.stream_bytes(n, 4), ops),
        (k8.stream_merge_runs_kv, (kvbuf, rbuf), M, small_kv,
         lambda: torch.sort(kvk, descending=True, stable=True),
         roofline.stream_bytes(n, 8), ops),
    ]
    table = []
    for fn, args, kw, pargs, lib, nbytes, ops_ in cases:
        name = fn.__name__
        plain = plain_of(fn)
        bound_ms, bound_by = _bound(nbytes, ops_)
        kv = name.endswith("_kv")
        L = kw["fan_in"].bit_length() - 1
        table.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/stream_merge.cu",
            "replaces": "src/repro/kernels/stream_merge.py:225",
            "smem_bytes": k8.stream_smem(args[0].dtype, kv, True, L,
                                         kw["w"]),
            "ctas": k8._resident_ctas(k8._build.DTYPE_CODES[args[0].dtype], kv,
                                      True, L, kw["w"], args[0].device),
            "launches": int(launches.get(name, 0)),
            "max_abs_err": errs[name],
            "ms": time_ms(lambda: fn(*args, **kw)),
            "plain_ms": time_ms(lambda: plain(*pargs, **P), warmup=1,
                                reps=3),
            "plain_shape": "8 runs of 4096, fan 8, w 128, block 4096",
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": time_ms(lib),
            "library_call": "torch.sort(stable=True)" if name.endswith("_kv")
            else "torch.sort"})
        print(f"time {name}: " + json.dumps(table[-1]), flush=True)
    # recorded only: one pass of each fan-in over the same 2^27 keys
    fans = []
    for f in (2, 4, 8, 16):
        Mf = dict(M, fan_in=f)
        fans.append({"fan_in": f, "run_len": run_len,
                     "ms": time_ms(lambda: k8.stream_merge_runs(kbuf, **Mf)),
                     "kv_ms": time_ms(lambda: k8.stream_merge_runs_kv(
                         kvbuf, rbuf, **Mf))})
    print(json.dumps({"k8_fans": fans}), flush=True)
    return table


def external_split(slice3, x, ranks):
    """CUDA-event medians of the out-of-core sort's parts at its plan:
    run formation (K1 + K4 passes), the copy that appends K8's input slack
    to the formed runs, then each merge pass (K8)."""
    _, external, schedule, k8, _ = slice3
    from repro_torch.engine import planner
    n, kv = x.shape[0], ranks is not None
    plan = planner.heuristic_plan("external_sort", planner.plan_key(
        "external_sort", n=n, dtype=x.dtype, backend="cuda"))
    plan = external.resolve_dofs(plan, n)
    T, fan = plan.tile_elems, plan.fan_in
    R = n // T
    form = lambda: external._form_runs_cuda(
        x, ranks, R, T, w=plan.w, chunk=plan.chunk, levels=plan.levels,
        block_out=plan.block_out, descending=True)
    parts = {"run_form": time_ms(form)}
    buf, rbuf = form()
    slack = k8.stream_slack(fan, plan.w, plan.block_out)
    fill = float("-inf") if x.is_floating_point() else -2 ** 31

    def add_slack(b=buf, rb=rbuf):
        return (external._pad(b, R * T + slack, fill),
                external._pad(rb, R * T + slack, 2 ** 31 - 1) if kv else None)
    parts["slack_copy"] = time_ms(add_slack)
    buf, rbuf = add_slack()
    runs, run_len, i = R, T, 0
    while runs > 1:
        f = min(fan, runs)

        def step(b=buf, rb=rbuf, r=runs, rl=run_len, f=f):
            return schedule.stream_pass(
                b, rb, runs=r, run_len=rl, fan_in=f, executor="stream_cuda",
                w=plan.w, block_out=plan.block_out, descending=True,
                out_slack=slack)
        parts[f"pass{i}_fan{f}"] = time_ms(step)
        buf, rbuf = step()
        runs, run_len, i = runs // f, run_len * f, i + 1
    return parts


def phase_slice3_e2e(engine, slice3, ext):
    """``external_sort`` at 2^27 keys beside torch.sort on the same input,
    its bound (``external_sort_bytes`` over the memory rate) and its split
    per phase."""
    roofline = slice3[4]
    xf, xk, rank = ext["xf"], ext["xk"], ext["rank"]
    rows = []
    for name, fn, lib, x, r in (
            ("engine.external_sort f32 desc", lambda: engine.external_sort(xf),
             lambda: torch.sort(xf, descending=True), xf, None),
            ("engine.external_sort stable values int32 desc",
             lambda: engine.external_sort(xk, stable=True, values=rank),
             lambda: torch.sort(xk, descending=True, stable=True), xk,
             rank)):
        nbytes = roofline.external_sort_bytes(
            N_EXT, 4 if r is None else 8, 1 << 20, 8)
        rows.append({"call": name, "n": N_EXT, "ms": time_ms(fn),
                     "library_ms": time_ms(lib),
                     "bound_ms": nbytes / hbm_bytes_per_s() * 1e3,
                     "split_ms": external_split(slice3, x, r)})
    print(json.dumps({"e2e_external": rows}), flush=True)
    # recorded only: the whole sort at each fan-in (the planner's is 8)
    fans = [{"fan_in": f, "passes": roofline.external_passes(N_EXT >> 20, f),
             "ms": time_ms(lambda: engine.external_sort(xf, fan_in=f)),
             "kv_ms": time_ms(lambda: engine.external_sort(
                 xk, stable=True, values=rank, fan_in=f))}
            for f in (2, 4, 8, 16)]
    print(json.dumps({"e2e_external_fans": fans}), flush=True)


# --------------------------------------------------------------------------
# slice 4: the reference sorters, tree_vmapped on K9, topk and the samplers
# --------------------------------------------------------------------------

N_REF = 1 << 22                # keys of the reference sorters' calls
SLOTS = 64                     # decode slots of the ragged sampler
SAMPLE_ROWS = 8                # rows of the full-vocabulary samplers
K9_WIDTHS = (1, 8, 32, 128)
#: longest cycle chain at which the main path's K9 levels meet the plain
#: version (about a millisecond a cycle there, a Python loop)
CHECK_CHAIN = 2048


def _import_slice4():
    from repro_torch.configs.moonshot_v1_16b_a3b import CONFIG
    from repro_torch.kernels import lane_merge as k9
    from repro_torch.serve import sampler
    return k9, sampler, CONFIG.vocab_size


def int_dup_keys(n: int, gen) -> torch.Tensor:
    """int32 keys with heavy duplicates and both extremes."""
    pool = torch.tensor([-2 ** 31, -7, 0, 3, 3, 9, 2 ** 31 - 1],
                        dtype=torch.int32, device="cuda")
    return pool[torch.randint(0, pool.numel(), (n,), generator=gen,
                              device="cuda")]


def phase_k9_vs_plain(k9, gen):
    """K9 against its plain version on the card, bit for bit: tie b, tie
    skew and KV; w 1, 8, 32 and 128; float32 runs holding NaNs of several
    payloads, +0.0/-0.0 and duplicates, and int32 duplicate runs; ragged
    pairs of lengths 0, 1, w - 1, w, w + 1 and random, the output whole
    and cut below the total."""
    errs = {"lane_merge": 0.0, "lane_merge_kv": 0.0}
    for w in K9_WIDTHS:
        for keys in (nan_keys, int_dup_keys):
            edge = [0, 1, max(w - 1, 0), w, w + 1, 2 * w + 3]
            rand = torch.randint(0, 6 * w + 40, (26,), generator=gen,
                                 device="cuda").tolist()
            la = edge + rand
            a, sa, na = sorted_runs(la, gen, keys=keys)
            b, sb, nb = sorted_runs(la[::-1], gen, keys=keys)
            ra = torch.randperm(a.numel(), generator=gen, device="cuda").to(
                torch.int32)
            rb = torch.randperm(b.numel(), generator=gen, device="cuda").to(
                torch.int32)
            n = a.numel() + b.numel()
            for n_out in (n, n - n // 3):
                for tie in ("b", "skew"):
                    kw = dict(n_out=n_out, w=w, tie=tie)
                    err = check_same(f"lane_merge {keys.__name__} {kw}",
                                     k9.lane_merge(a, b, sa, na, sb, nb, **kw),
                                     k9.lane_merge_plain(a, b, sa, na, sb, nb,
                                                         **kw))
                    errs["lane_merge"] = max(errs["lane_merge"], err)
                kw = dict(n_out=n_out, w=w)
                err = check_same(
                    f"lane_merge_kv {keys.__name__} {kw}",
                    k9.lane_merge_kv(a, ra, b, rb, sa, na, sb, nb, **kw),
                    k9.lane_merge_kv_plain(a, ra, b, rb, sa, na, sb, nb, **kw))
                errs["lane_merge_kv"] = max(errs["lane_merge_kv"], err)
    torch.cuda.synchronize()
    print(f"K9 vs plain: w {K9_WIDTHS}, tie b / skew / KV, float32 NaN and "
          "int32 duplicate runs, ragged pairs: bit-for-bit "
          + json.dumps(errs), flush=True)
    return errs


def check_k9_on_path(k9, calls, variants, first_level=("merge_runs_skew",)):
    """Run ``calls`` once more with every K9 level held bit for bit to the
    whole chain (``chain=True``) on the same inputs, and to the plain
    version too where its chain is at most ``CHECK_CHAIN`` cycles and at the
    first level of the calls in ``first_level``; each level's block form
    and chain timed on its inputs. Outside the counted drive."""
    real = k9.lane_merge_level
    errs = {"lane_merge": 0.0, "lane_merge_kv": 0.0}
    seen, name = [], None

    def checked(buf, ranks, run_len, *, w, tie):
        got = real(buf, ranks, run_len, w=w, tie=tie)
        cycles, blocks = k9.level_blocks(buf, ranks, run_len, w=w, tie=tie)
        lv = {"call": name, "level": sum(x["call"] == name for x in seen),
              "pairs": buf.numel() // (2 * run_len), "run_len": run_len,
              "w": w, "tie": tie, "chain_cycles": -(-2 * run_len // w),
              "blocks": blocks, "block_cycles": cycles}
        kind = "lane_merge" if ranks is None else "lane_merge_kv"
        keep = lambda t: tuple(x for x in t if x is not None)
        whole = real(buf, ranks, run_len, w=w, tie=tie, chain=True)
        errs[kind] = max(errs[kind], check_same(
            f"K9 on the path against its chain: {lv}", keep(got),
            keep(whole)))
        lv["plain"] = lv["chain_cycles"] <= CHECK_CHAIN or (
            lv["level"] == 0 and name in first_level)
        if lv["plain"]:
            exp = k9.lane_merge_level_plain(buf, ranks, run_len, w=w,
                                            tie=tie)
            errs[kind] = max(errs[kind], check_same(
                f"K9 on the path against plain: {lv}", keep(got), keep(exp)))
        lv["ms"] = time_ms(lambda: real(buf, ranks, run_len, w=w, tie=tie),
                           warmup=1, reps=3)
        lv["chain_ms"] = time_ms(lambda: real(buf, ranks, run_len, w=w,
                                              tie=tie, chain=True),
                                 warmup=0, reps=1)
        seen.append(lv)
        return got

    k9.lane_merge_level = checked
    try:
        for name, fn in calls.items():
            if name in variants:
                fn(variants[name])
    finally:
        k9.lane_merge_level = real
    plain = [lv for lv in seen if lv["plain"]]
    print(f"K9 on the path: {len(seen)} of {len(seen)} levels bit-for-bit "
          f"against the chain form; {len(plain)} of {len(seen)} against the "
          f"plain version (chains up to {CHECK_CHAIN} cycles and the first "
          f"skew level): " + json.dumps(errs), flush=True)
    per_call = {}
    for lv in seen:
        per_call.setdefault(lv["call"], []).append(
            [lv["pairs"], lv["run_len"], lv["w"], lv["chain_cycles"],
             lv["blocks"], lv["plain"], lv["ms"], lv["chain_ms"]])
    print("K9 levels on the path, [pairs, run_len, w, chain, blocks a pair, "
          "plain checked, ms, chain ms]: " + json.dumps(per_call), flush=True)
    if not plain or not {lv["tie"] for lv in plain} >= {"b", "skew"}:
        raise AssertionError("the path's K9 levels were not all kinds checked")
    return errs


def phase_sampling(engine, kernels, slice4, gen):
    """The slice at full width: ``RaggedSampler(k=64, "flims")`` over 64
    decode slots at Moonlight-16B-A3B's vocabulary, ``sample_topp`` /
    ``sample_minp`` (``flims``) over 8 rows of it, ``merge_runs(variant=
    "tree_vmapped")`` over 2^22 keys in 64 ragged runs (tie b, skew, stable
    with values), ``sort(variant="ref")`` and ``argsort(variant="flims")`` at
    2^22; counted per call, every result held to its torch variant."""
    _, sampler, vocab = slice4
    dev = "cuda"
    logits = torch.randn(SLOTS, vocab, generator=gen, device=dev) * 4
    rows = logits[:SAMPLE_ROWS].contiguous()
    lens = ragged_lens(64, N_REF, gen)
    rbuf, rst, _ = sorted_runs(lens, gen)
    roffs = torch.cat([rst, rst.new_tensor([N_REF])])
    rvals = torch.arange(N_REF, device=dev)
    x = torch.randn(N_REF, generator=gen, device=dev)
    state = sampler.SamplingState.full(SLOTS, device=dev)
    seeded = lambda: torch.Generator(device=dev).manual_seed(SEED + 7)
    topk_calls = []
    topk = engine.topk

    def counting_topk(*a, **k):
        topk_calls.append(k.get("variant"))
        return topk(*a, **k)

    calls = {
        "ragged_sampler": lambda v: sampler.RaggedSampler(64, v).sample(
            seeded(), logits, state),
        "sample_topp": lambda v: engine.sample_topp(seeded(), rows, 0.9,
                                                    variant=v),
        "sample_minp": lambda v: engine.sample_minp(seeded(), rows, 0.05,
                                                    variant=v),
        "merge_runs_b": lambda v: engine.merge_runs(rbuf, roffs, variant=v),
        "merge_runs_skew": lambda v: engine.merge_runs(rbuf, roffs,
                                                       tie="skew", variant=v),
        "merge_runs_values": lambda v: engine.merge_runs(
            rbuf, roffs, values=rvals, variant=v),
        "sort": lambda v: engine.sort(x, variant=v),
        "argsort": lambda v: engine.argsort(x, variant=v),
    }
    flims = {"ragged_sampler": "flims", "sample_topp": "flims",
             "sample_minp": "flims", "merge_runs_b": "tree_vmapped",
             "merge_runs_skew": "tree_vmapped",
             "merge_runs_values": "tree_vmapped", "sort": "ref",
             "argsort": "flims"}
    # K9 launches a call: 10 levels over a row's 1024 chunks of 256, 6 over
    # 64 runs, 14 over 2^22 / 256 chunks
    want = {"ragged_sampler": {}, "sample_topp": {"lane_merge_kv": 10},
            "sample_minp": {"lane_merge_kv": 10},
            "merge_runs_b": {"lane_merge": 6},
            "merge_runs_skew": {"lane_merge": 6},
            "merge_runs_values": {"lane_merge_kv": 6},
            "sort": {"lane_merge": 14}, "argsort": {"lane_merge_kv": 14}}
    out, per_call = {}, {}

    def drive():
        engine.topk = counting_topk
        try:
            for name, fn in calls.items():
                before = kernels.launch_counts()
                topk_calls.clear()
                out[name] = fn(flims[name])
                if name == "ragged_sampler" and topk_calls != ["flims"]:
                    raise AssertionError(f"RaggedSampler made the engine "
                                         f"calls {topk_calls}, not one topk")
                after = kernels.launch_counts()
                per_call[name] = {k: v - before.get(k, 0) for k, v in
                                  after.items() if v - before.get(k, 0)}
        finally:
            engine.topk = topk

    _, launches = counted(kernels, drive)
    key_only = ("merge_runs_b", "merge_runs_skew", "sort")
    for name, fn in calls.items():
        if per_call[name] != want[name]:
            raise AssertionError(f"{name}: launches {per_call[name]}, "
                                 f"expected {want[name]}")
        ref = fn("torch")
        if name in key_only:
            # key-only lanes compare as values: +0.0 / -0.0 may trade
            # places between executors (the keys hold no NaN; K9's bits are
            # held to its plain version in phase_k9_vs_plain)
            if not torch.equal(out[name], ref):
                raise AssertionError(f"{name}: differs from torch as values")
        else:
            check_same(f"{name} against torch", out[name], ref)
    if not torch.equal(out["sort"], torch.sort(x, descending=True).values):
        raise AssertionError("sort ref differs from torch.sort as values")
    check_same("argsort flims against torch.argsort(stable=True)",
               out["argsort"], torch.argsort(x, descending=True,
                                             stable=True).to(torch.int32))
    rows_ids = [out[n] for n in ("sample_topp", "sample_minp")]
    for t in [out["ragged_sampler"]] + rows_ids:
        if t.dtype != torch.int32 or int(t.min()) < 0 or \
                int(t.max()) >= vocab:
            raise AssertionError(f"token ids outside [0, {vocab}): {t}")
    if not launches.get("lane_merge") or not launches.get("lane_merge_kv"):
        raise AssertionError(f"the slice never launched K9: {launches}")
    print(f"sampling: vocab {vocab}, {SLOTS} slots, merge_runs over "
          f"{N_REF} keys in 64 runs (longest {max(lens)}), sort / argsort "
          f"at {N_REF}; ids and results equal the torch variants'; launches "
          + json.dumps(launches), flush=True)
    print("sampling launches per call: " + json.dumps(per_call), flush=True)
    k9_calls = {n: v for n, v in flims.items() if want[n]}
    path_errs = check_k9_on_path(slice4[0], calls, k9_calls)
    e2e = []
    for name, fn in calls.items():
        reps = dict(warmup=1, reps=5)
        e2e.append({"call": name, "variant": flims[name],
                    "k9_launches": per_call[name],
                    "ms": time_ms(lambda: fn(flims[name]), **reps),
                    "torch_ms": time_ms(lambda: fn("torch"), **reps)})
        print("e2e sampling: " + json.dumps(e2e[-1]), flush=True)
    return launches, path_errs, dict(x=x, rows=rows, rbuf=rbuf, roffs=roffs)


def k9_levels(k9, keys, ranks, L: int, w: int):
    """Each K9 level of a tree_vmapped reduction of uniform runs of ``L``
    (one group): its CUDA-event time, the whole chain's (``chain=True``),
    pairs, cycle chain, blocks a pair and cycles a block, byte bound, and
    one torch.sort of the same pair groups; at the level of a
    ``CHECK_CHAIN``-cycle chain the plain version too (one run: a Python
    loop of that many cycles)."""
    buf, rbuf, n = keys, ranks, keys.numel()
    levels = []
    while L < n:
        P = n // (2 * L)
        fn = lambda b=buf, r=rbuf, L=L: k9.lane_merge_level(b, r, L, w=w)
        chain = lambda b, r, L: k9.lane_merge_level(b, r, L, w=w, chain=True)
        plain = lambda b=buf, r=rbuf, L=L: k9.lane_merge_level_plain(b, r, L,
                                                                     w=w)
        grp = buf.reshape(P, 2 * L)
        lib = (lambda: torch.sort(grp, dim=1, descending=True)) if \
            rbuf is None else \
            (lambda: torch.sort(grp, dim=1, descending=True, stable=True))
        nbytes = 2 * n * (4 if rbuf is None else 8)
        cycles, blocks = k9.level_blocks(buf, rbuf, L, w=w)
        levels.append({"run_len": L, "pairs": P, "chain_cycles": 2 * L // w,
                       "blocks": blocks, "block_cycles": cycles,
                       "ms": time_ms(fn, warmup=1, reps=3),
                       "chain_ms": time_ms(lambda: chain(b=buf, r=rbuf, L=L),
                                           warmup=1, reps=3),
                       "bound_ms": nbytes / hbm_bytes_per_s() * 1e3,
                       "library_ms": time_ms(lib, warmup=1, reps=3)})
        if 2 * L // w == CHECK_CHAIN:
            levels[-1]["plain_ms"] = time_ms(plain, warmup=0, reps=1)
        buf, rbuf = fn()
        L *= 2
    return levels


def phase_slice4_times(slice4, launches, errs, data):
    """K9 at the reference sorters' shapes: every level of ``sort(variant=
    "ref")`` (key-only) and ``argsort(variant="flims")`` (KV) at 2^22 keys,
    chunks of 256, w 128. The table row is the level of a ``CHECK_CHAIN``-
    cycle chain (16 pairs of two 2^17-key runs): K9, its plain version,
    torch.sort of the same pair groups and the byte bound at that one
    shape; ``levels`` holds every level and ``levels_ms`` their sum."""
    k9 = slice4[0]
    from repro_torch.core.butterfly import bitonic_sort
    from repro_torch.core.lanes import stable_compare
    x = data["x"]
    chunk, w = 256, 128
    rows = bitonic_sort(x.reshape(-1, chunk)).reshape(-1).contiguous()
    r0 = torch.arange(N_REF, dtype=torch.int32, device="cuda")
    kv = bitonic_sort({"key": x.reshape(-1, chunk),
                       "rank": r0.reshape(-1, chunk)},
                      compare=stable_compare)
    kk, kr = kv["key"].reshape(-1).contiguous(), \
        kv["rank"].reshape(-1).contiguous()
    table = []
    for name, keys, ranks in (("lane_merge", rows, None),
                              ("lane_merge_kv", kk, kr)):
        levels = k9_levels(k9, keys, ranks, chunk, w)
        row = next(lv for lv in levels if "plain_ms" in lv)
        table.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/lane_merge.cu",
            "replaces": "src/repro/core/lanes.py:165 (merge_lanes under "
                        "jax.vmap) + src/repro/engine/schedule.py:211; no "
                        "pallas_call",
            "launches": int(launches.get(name, 0)),
            "max_abs_err": errs[name],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "shape": f"{row['pairs']} pairs of two {row['run_len']}-key "
                     f"runs, w {w}, a chain of {row['chain_cycles']} cycles",
            "chain_cycles": row["chain_cycles"], "blocks": row["blocks"],
            "chain_ms": row["chain_ms"],
            "last_level_ms": levels[-1]["ms"],
            "last_level_chain_ms": levels[-1]["chain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": "bytes",
            "library_ms": row["library_ms"],
            "library_call": "torch.sort" + ("" if ranks is None else
                                            "(stable=True)"),
            "levels": levels,
            "levels_ms": sum(lv["ms"] for lv in levels)})
        print(f"time {name}: " + json.dumps(table[-1]), flush=True)
    return table


# --------------------------------------------------------------------------
# serving: the moonshot_v1_16b_a3b config through the continuous-batching
# scheduler
# --------------------------------------------------------------------------

SERVE_ARCH = "moonshot_v1_16b_a3b"
SERVE_LAYERS = 4               # the depth, cut from the config's 48
SERVE_SLOTS = 8
SERVE_SEQ = 256
SERVE_PREFILL = 32
SERVE_K = 64                   # the sampler's prefix width
N_SERVE = 12


def _import_slice5():
    from repro_torch import obs, serve
    from repro_torch.configs import get_config
    from repro_torch.engine import planner
    from repro_torch.guard import fallback
    from repro_torch.models import transformer
    from repro_torch.models.model import build_model
    return obs, serve, get_config, planner, fallback, transformer, build_model


def serve_specs(vocab: int):
    """(prompt, max_new_tokens, params) of the 12 requests, from the seed:
    prompts of 3-32 tokens, 8-24 new tokens; requests 0-5 greedy, 6-8
    top-p 0.9 and 9-11 min-p 0.05 at temperature 1."""
    g = torch.Generator().manual_seed(SEED + 11)
    draw = lambda lo, hi: int(torch.randint(lo, hi + 1, (1,), generator=g))
    specs = []
    for i in range(N_SERVE):
        prompt = torch.randint(1, vocab, (draw(3, SERVE_PREFILL),),
                               generator=g).tolist()
        knobs = (dict(temperature=0.0) if i < 6 else
                 dict(top_p=0.9) if i < 9 else dict(min_p=0.05))
        specs.append((prompt, draw(8, 24), knobs))
    return specs


def serve_requests(serve, specs, eos):
    return [serve.Request(prompt=p, max_new_tokens=n, eos_id=eos.get(i),
                          params=serve.SamplingParams(**kn), uid=i)
            for i, (p, n, kn) in enumerate(specs)]


def check_completions(what: str, done, reqs, vocab: int):
    by_uid = {c.uid: c for c in done}
    if sorted(by_uid) != sorted(r.uid for r in reqs):
        raise AssertionError(f"{what}: completions {sorted(by_uid)}")
    hits = 0
    for r in reqs:
        c = by_uid[r.uid]
        toks = c.tokens
        if c.status != "OK" or not 1 <= len(toks) <= r.max_new_tokens:
            raise AssertionError(f"{what}: request {r.uid} {c.status} "
                                 f"{c.finish_reason} {len(toks)} tokens")
        hit = r.eos_id is not None and r.eos_id in toks
        if hit and (toks.index(r.eos_id) != len(toks) - 1
                    or c.finish_reason != "eos"):
            raise AssertionError(f"{what}: request {r.uid} ran past EOS")
        if not hit and (len(toks) != r.max_new_tokens
                        or c.finish_reason != "length"):
            raise AssertionError(f"{what}: request {r.uid} stopped at "
                                 f"{len(toks)} of {r.max_new_tokens}")
        if min(toks) < 0 or max(toks) >= vocab:
            raise AssertionError(f"{what}: token ids outside the vocab")
        hits += hit
    return by_uid, hits


def _pct(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def serve_run(kernels, obs, serve, model, params, specs, eos, label,
              k7_layers: int):
    """The requests served twice, the launch counts set to 0 just before
    each pass. The checked pass is one ``serve_batch`` with obs recording:
    completions, traces, one ``engine.topk`` a step, K7 launches (one a
    MoE layer, ``k7_layers``, per decode step and per prefill token; with
    none, no kernel launch at all) and no fallback. The timed pass runs the
    scheduler's own loop with obs off (recording makes ``engine.moe_route``
    read every keep mask back): the host clock around each step, which
    waits on its sampled tokens, and around each admission round, closed by
    a synchronize. Both passes give the greedy requests the same tokens."""
    want_k7 = lambda steps, admits: k7_layers * (steps + SERVE_PREFILL
                                                 * admits)
    wrong = lambda launches, steps, admits: (
        launches.get("moe_route", 0) != want_k7(steps, admits)
        or (not k7_layers and launches))
    reqs = serve_requests(serve, specs, eos)
    obs.reset()
    obs.enable()
    try:
        (done, _, sched), launches = counted(
            kernels, lambda: serve.serve_batch(
                model, params, reqs, n_slots=SERVE_SLOTS, max_seq=SERVE_SEQ,
                prefill_len=SERVE_PREFILL, top_k_width=SERVE_K, seed=SEED))
        snap = obs.snapshot()
    finally:
        obs.disable()
    by_uid, hits = check_completions(label, done, reqs,
                                     model.cfg.vocab_size)
    step_t, pre_t = snap["timers"]["serve.step"], \
        snap["timers"]["serve.prefill"]
    steps, admits = step_t["count"], pre_t["count"]
    topk = {k: v["count"] for k, v in snap["timers"].items()
            if k.startswith("engine.topk.")}
    c = snap["counters"]
    if sched.traces != 2 or c.get("serve.trace") != 2:
        raise AssertionError(f"{label}: traces {sched.traces}")
    if sum(topk.values()) != steps or len(topk) != 1:
        raise AssertionError(f"{label}: engine.topk calls {topk} over "
                             f"{steps} steps")
    if wrong(launches, steps, admits) or admits != N_SERVE:
        raise AssertionError(f"{label}: K7 launches {launches} over {steps} "
                             f"steps and {admits} admissions, expected "
                             f"{want_k7(steps, admits)}")
    if c.get("guard.fallback", 0) or c.get("guard.oom_retry", 0):
        raise AssertionError(f"{label}: guard.fallback "
                             f"{c.get('guard.fallback', 0)}, oom retries "
                             f"{c.get('guard.oom_retry', 0)}")
    # the timed pass
    reqs = serve_requests(serve, specs, eos)
    sched = serve.Scheduler(model, params, n_slots=SERVE_SLOTS,
                            max_seq=SERVE_SEQ, prefill_len=SERVE_PREFILL,
                            top_k_width=SERVE_K, seed=SEED)
    step_s, admit_s, n_admit = [], 0.0, 0

    def loop():
        nonlocal admit_s, n_admit
        for r in reqs:
            sched.submit(r)
        while sched.waiting or sched.live:
            t0 = time.perf_counter()
            n = sched.admit()
            if n:
                torch.cuda.synchronize()
                admit_s += time.perf_counter() - t0
                n_admit += n
            if sched.live:
                t0 = time.perf_counter()
                sched.step()
                step_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    _, t_launches = counted(kernels, loop)
    wall = time.perf_counter() - t0
    t_by_uid, _ = check_completions(f"{label} (timed)", sched.completed,
                                    reqs, model.cfg.vocab_size)
    if wrong(t_launches, len(step_s), n_admit) or sched.traces != 2:
        raise AssertionError(f"{label} (timed): K7 launches {t_launches} "
                             f"over {len(step_s)} steps, traces "
                             f"{sched.traces}")
    for uid in range(6):
        if by_uid[uid].tokens != t_by_uid[uid].tokens:
            raise AssertionError(f"{label}: greedy request {uid} differs "
                                 "between the checked and the timed pass")
    tokens = sum(len(x.tokens) for x in sched.completed)
    line = {"run": label, "requests": len(done), "eos_hits": hits,
            "steps": len(step_s), "admissions": n_admit,
            "topk_variant": next(iter(topk)).split(".")[-1],
            "step_p50_ms": _pct(step_s, 0.5) * 1e3,
            "step_p99_ms": _pct(step_s, 0.99) * 1e3,
            "prefill_ms": admit_s * 1e3 / n_admit,
            "wall_s": wall, "tokens": tokens, "tok_s": tokens / wall,
            "decode_tok_s": tokens / sum(step_s),
            "obs_step_p50_ms": step_t["p50_us"] / 1e3,
            "obs_prefill_ms": pre_t["total_us"] / 1e3 / admits,
            "launches": t_launches, "checked_launches": launches,
            "k7_per_step": k7_layers, "k7_per_prefill_token": k7_layers,
            "guard.fallback": c.get("guard.fallback", 0)}
    print("serve run: " + json.dumps(line), flush=True)
    return by_uid, line


def _nbytes(*trees) -> int:
    from repro_torch.core.butterfly import tree_leaves
    return sum(t.numel() * t.element_size() for tree in trees
               for t in tree_leaves(tree))


def step_bytes(params, cache, vocab: int) -> int:
    """The least bytes one decode step moves: every weight once (grouped
    dispatch runs all 64 experts' slabs; the tied head reads the whole
    embedding), the cache read once, one key and value row a slot and
    layer written to each KV cache, every recurrent state (Zamba2's
    ``cache["mamba"]``) written whole, and the float32 logits."""
    kv, states = (cache["attn"], cache["mamba"]) if isinstance(cache, dict) \
        else (cache, ())
    L, B, W, K, hd = kv[0].shape
    return (_nbytes(params, cache, states)
            + 2 * L * B * K * hd * kv[0].element_size() + B * vocab * 4)


def serve_split(obs, serve, tf, model, params, cfg, cache, last_tok, pos,
                logits, sampling, u):
    """Where a decode step's time goes, on the captured state: the whole
    ``decode_step`` with obs off and on (on, ``engine.moe_route`` reads
    each keep mask back to count drops), one layer's attention and MoE
    halves, the tied head, and the sampler per ``topk`` variant;
    CUDA-event medians."""
    from repro_torch.models import attention
    from repro_torch.models.config import torch_dtype
    from repro_torch.models.layers import embed_lookup, rmsnorm
    p0 = tf.layer(params, 0)
    x = embed_lookup(params["embed"], last_tok[:, None]).to(
        torch_dtype(cfg.compute_dtype))
    h = rmsnorm(x, p0["attn_norm"], cfg.norm_eps)
    c0 = (cache[0][0], cache[1][0])
    step = lambda: model.decode_step(params, last_tok, pos, cache)
    parts = {
        "decode_step_ms": time_ms(step, warmup=1, reps=5),
        "attention_layer_ms": time_ms(lambda: attention.attn_decode(
            p0["attn"], h, c0, pos, cfg)),
        "moe_layer_ms": time_ms(lambda: tf.moe_mod.moe_apply(
            p0["moe"], h, cfg)),
        "lm_head_ms": time_ms(lambda: tf.lm_logits(params, x, cfg)),
        "sampler_flims_ms": time_ms(lambda: serve.RaggedSampler(
            SERVE_K, "flims").sample(None, logits, sampling, u=u)),
        "sampler_torch_ms": time_ms(lambda: serve.RaggedSampler(
            SERVE_K, "torch").sample(None, logits, sampling, u=u))}
    obs.enable()
    try:
        parts["decode_step_obs_ms"] = time_ms(step, warmup=1, reps=5)
    finally:
        obs.disable()
        obs.reset()
    print("serve split: " + json.dumps(parts), flush=True)
    return parts


def serve_two_plans(engine, kernels, obs, serve, model, params, specs, eos,
                    logits, prefix: str, k7_layers: int):
    """Run 1 under the card's heuristic ``topk`` plan, then
    ``engine.autotune("topk", logits, k)`` at the served step's logits and
    run 2 under the tuned plan (each a ``serve_run``); the greedy requests'
    tokens must agree. Returns ``(run1, run2, tuned plan, candidates)``."""
    greedy1, run1 = serve_run(kernels, obs, serve, model, params, specs,
                              eos, prefix + "heuristic", k7_layers)
    obs.reset()
    obs.enable()
    try:
        tuned = engine.autotune("topk", logits, SERVE_K)
        cands = [{"variant": e["data"]["variant"],
                  "ms": e["data"].get("us", float("nan")) / 1e3,
                  "status": e["data"]["status"]}
                 for e in obs.snapshot()["events"]
                 if e["kind"] == "autotune.candidate"]
    finally:
        obs.disable()
    print(f"{prefix}autotune topk {tuple(logits.shape)} k={SERVE_K}: "
          + json.dumps({"candidates": cands, "winner": tuned.variant}),
          flush=True)
    greedy2, run2 = serve_run(kernels, obs, serve, model, params, specs,
                              eos, prefix + "autotuned", k7_layers)
    engine.clear_plans()
    if run2["topk_variant"] != tuned.variant:
        raise AssertionError(f"the tuned run sampled through "
                             f"{run2['topk_variant']}, not {tuned.variant}")
    for uid in range(6):
        if greedy1[uid].tokens != greedy2[uid].tokens:
            raise AssertionError(f"{prefix}greedy request {uid}: the tuned "
                                 "run's tokens differ")
    return run1, run2, tuned, cands


def phase_serve(engine, kernels, slice5, slice2):
    """The ``moonshot_v1_16b_a3b`` config at its widths, depth cut to 4,
    serving 12 requests through ``serve.serve_batch``; checks, the decode step held
    to its torch-routed twin, K7 at the step's shapes, times, and the same
    requests again under the autotuned ``topk`` plan."""
    obs, serve, get_config, planner, fallback, tf, build_model = slice5
    k7 = slice2[3]
    cfg = get_config(SERVE_ARCH)
    print(f"reduced: n_layers {cfg.n_layers} -> {SERVE_LAYERS}", flush=True)
    cfg = dataclasses.replace(cfg, n_layers=SERVE_LAYERS)
    t0 = time.perf_counter()
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    from repro_torch.core.butterfly import tree_leaves
    n_par = sum(t.numel() for t in tree_leaves(params))
    gb = sum(t.numel() * t.element_size() for t in tree_leaves(params)) / 1e9
    print(f"{cfg.name}: d {cfg.d_model}, {cfg.n_heads} heads (kv "
          f"{cfg.n_kv_heads}) x {cfg.hd}, {cfg.n_experts} experts top-"
          f"{cfg.n_experts_active} d_ff {cfg.moe_d_ff}, vocab "
          f"{cfg.vocab_size}, {cfg.param_dtype}, {SERVE_LAYERS} layers: "
          f"{n_par / 1e9:.3f}B parameters, {gb:.3f} GB, made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    specs = serve_specs(cfg.vocab_size)
    # run 0 (warm-up, no EOS): a decode state to hold against its twin, and
    # the greedy tokens that give requests 0 and 3 their EOS ids
    sched = serve.Scheduler(model, params, n_slots=SERVE_SLOTS,
                            max_seq=SERVE_SEQ, prefill_len=SERVE_PREFILL,
                            top_k_width=SERVE_K, seed=SEED)
    for r in serve_requests(serve, specs, {}):
        sched.submit(r)
    captured, n_steps = None, 0
    while sched.waiting or sched.live:
        sched.admit()
        if n_steps == 4:
            if len(sched.live) != SERVE_SLOTS:
                raise AssertionError(f"{len(sched.live)} live slots at step 4")
            st = sched.state
            captured = (tuple(t.clone() for t in sched.kv.cache),
                        st.last_tok.clone(), st.pos.clone(), st.sampling)
        sched.step()
        n_steps += 1
    warm = {c.uid: c.tokens for c in sched.completed}
    eos = {0: warm[0][3], 3: warm[3][5]}
    del sched
    # the step with K7 against the same step routed by the torch variant
    cache, last_tok, pos, sampling = captured
    route_lg = []
    real_route = engine.moe_route

    def recording(lg, *a, **kw):
        route_lg.append(lg)
        return real_route(lg, *a, **kw)

    engine.moe_route = recording
    try:
        logits, launches = counted(kernels, lambda: model.decode_step(
            params, last_tok, pos, cache)[0])
    finally:
        engine.moe_route = real_route
    key = planner.plan_key("moe_route", n=SERVE_SLOTS *
                           cfg.n_experts_active, dtype=torch.float32,
                           backend="cuda", segments=1)
    engine.default_planner.put(key, engine.Plan("torch"))
    try:
        ref, ref_launches = counted(kernels, lambda: model.decode_step(
            params, last_tok, pos, cache)[0])
    finally:
        engine.clear_plans()
    if launches != {"moe_route": SERVE_LAYERS} or ref_launches:
        raise AssertionError(f"decode step launches {launches}, torch-routed "
                             f"{ref_launches}")
    rel = float((logits - ref).norm() / ref.norm())
    if not bool(torch.isfinite(logits).all()) or rel > BF16_REL_FROB:
        raise AssertionError(f"decode step vs torch-routed: relative "
                             f"Frobenius {rel}")
    u = serve.sampler.uniform_noise((SERVE_SLOTS, SERVE_K), torch.Generator(
        device="cuda").manual_seed(SEED + 13), "cuda")
    ids = {v: serve.RaggedSampler(SERVE_K, v).sample(None, logits, sampling,
                                                     u=u)
           for v in ("flims", "torch")}
    check_same("served step's ids, flims sampler against torch",
               ids["flims"], ids["torch"])
    # K7 at the step's and a prefill token's route shapes, on the step's
    # router logits, against its plain version and the torch variant
    from repro_torch.launch.roofline import moe_route_bytes
    E, k = cfg.n_experts, cfg.n_experts_active
    k7_rows, errs = [], [0.0, 0]
    for lg in (route_lg[0], route_lg[0][:, :1].contiguous()):
        T = lg.shape[1]
        cap = tf.moe_mod.expert_capacity(1.25, T, k, E)
        got = k7.moe_route(lg, k, cap)
        for ref_fn in (k7.moe_route_plain, k7.moe_route_torch):
            e, ul = check_route(f"K7 {tuple(lg.shape)} k={k}", got,
                                ref_fn(lg, k, cap))
            errs = [max(errs[0], e), max(errs[1], ul)]
        b_ms, b_by = _bound(moe_route_bytes(T, E, k), T * k * (E + 2))
        k7_rows.append({
            "shape": list(lg.shape), "k": k, "capacity": cap,
            "ms": time_ms(lambda: k7.moe_route(lg, k, cap)),
            "plain_ms": time_ms(lambda: k7.moe_route_plain(lg, k, cap),
                                warmup=1, reps=5),
            "library_ms": time_ms(lambda: k7.moe_route_torch(lg, k, cap)),
            "bound_ms": b_ms, "bound_by": b_by,
            "max_abs_err": errs[0], "weight_ulps": errs[1]})
        print(f"time moe_route {tuple(lg.shape)} k={k} (serve): "
              + json.dumps(k7_rows[-1]), flush=True)
    nbytes = step_bytes(params, cache, cfg.vocab_size)
    print("serve step check: " + json.dumps({
        "logits_rel_frob_vs_torch_route": rel, "bound": BF16_REL_FROB,
        "ids_equal": True, "k7_launches": launches["moe_route"]}),
        flush=True)
    split = serve_split(obs, serve, tf, model, params, cfg, cache, last_tok,
                        pos, logits, sampling, u)
    del captured, cache, route_lg
    run1, run2, tuned, cands = serve_two_plans(
        engine, kernels, obs, serve, model, params, specs, eos, logits, "",
        SERVE_LAYERS)
    if fallback.demotions():
        raise AssertionError(f"{fallback.demotions()} fallback demotions")
    line = {"serve": f"{cfg.name} {SERVE_LAYERS} of {get_config(SERVE_ARCH).n_layers} "
                     f"layers, {SERVE_SLOTS} slots, max_seq {SERVE_SEQ}, "
                     f"prefill_len {SERVE_PREFILL}, k {SERVE_K}",
            "requests": N_SERVE, "parameters": n_par, "weight_gb": gb,
            "step_p50_ms": run1["step_p50_ms"],
            "step_p99_ms": run1["step_p99_ms"],
            "prefill_ms": run1["prefill_ms"], "tok_s": run1["tok_s"],
            "decode_tok_s": run1["decode_tok_s"],
            "step_bytes": nbytes,
            "step_bound_ms": nbytes / hbm_bytes_per_s() * 1e3,
            "k7_launches": sum(r[w]["moe_route"] for r in (run1, run2)
                               for w in ("launches", "checked_launches"))
            + launches["moe_route"],
            "topk_heuristic": run1["topk_variant"],
            "autotune_candidates": cands, "autotune_winner": tuned.variant,
            "tuned_step_p50_ms": run2["step_p50_ms"],
            "tuned_step_p99_ms": run2["step_p99_ms"],
            "tuned_tok_s": run2["tok_s"], "eos_hits": run1["eos_hits"],
            "obs_step_p50_ms": run1["obs_step_p50_ms"],
            "tuned_obs_step_p50_ms": run2["obs_step_p50_ms"],
            "split_ms": split,
            "guard.fallback": fallback.demotions()}
    print("serve: " + json.dumps(line), flush=True)
    del params, model
    torch.cuda.empty_cache()
    return line["k7_launches"], k7_rows


# --------------------------------------------------------------------------
# the rest of the model zoo at published widths, and Zamba2-2.7B served at
# full depth
# --------------------------------------------------------------------------

# config: the depth that still holds its structure (a Zamba2 group of 6
# Mamba2 layers and the shared block; an xLSTM group of 7 mLSTM and 1
# sLSTM; a Gemma-2 local / global pair; 2 decoder layers; Whisper's 2
# encoder and 2 decoder layers)
# --------------------------------------------------------------------------
# the mesh: 4 ranks on the one card (gloo, the collectives through the host)
# --------------------------------------------------------------------------

MESH_RANKS = 4
MESH_N = 1 << 24               # keys a rank (2^26 in all)
MESH_KEY_RANGE = 1 << 20       # integral float32 keys in [-2^20, 2^20)
MESH_TOPK = 2048
# router rows a rank, as the JAX package routes them (one group of 4096
# tokens at k 6: 24576 pairs, padded to 32768)
MESH_TOKENS = 4096
MESH_CACHE = 131072            # decode positions, split 4 ways
MESH_BATCH = 4
MESH_STEPS = 8                 # decode steps held to the one-process step
MESH_LIMIT_S = 175             # the phase's whole time, spawns included
# the sort plans: (variant, levels, splitter); tree_cuda at 2 levels is K4,
# at 1 level K3, tree_vmapped K9
MESH_PLANS = (("tree_cuda", 2, "hist"), ("tree_cuda", 1, "regular"),
              ("tree_vmapped", 1, "hist"), ("tree_vmapped", 1, "regular"))
MESH_KERNELS = ("lane_merge", "lane_merge_kv", "merge_tree_runs",
                "merge_tree_runs_kv", "segmented_merge_runs",
                "segmented_merge_runs_kv", "moe_route")


def _mesh_keys(rank: int, n: int) -> torch.Tensor:
    g = torch.Generator(device="cuda").manual_seed(SEED + 300 + rank)
    return torch.randint(-MESH_KEY_RANGE, MESH_KEY_RANGE, (n,), generator=g,
                         device="cuda").float()


def _mesh_sort_split(mesh, sharded, comm, x, pay, plan):
    """One sharded sort split per stage with CUDA events (this rank's
    timeline; the stages end in collectives, so every rank waits for the
    slowest): local sort, splitters (with the bucket bounds and the
    ``pmax``'d need), exchange (host-staged under gloo), reduction."""
    from repro_torch.engine.schedule import MergeSchedule
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    torch.cuda.synchronize()
    ev[0].record()
    loc, ploc = sharded._local_sort(x, pay, plan.w)
    ev[1].record()
    split = sharded._splitters_hist if plan.splitter == "hist" else \
        lambda loc, a, m, n: sharded._splitters_regular(loc, a, m, n,
                                                        plan.w)
    spl = split(loc, "data", mesh, MESH_RANKS)
    bounds, sizes = sharded._bucket_bounds(loc, spl)
    need = int(comm.pmax(sizes.max().reshape(1), "data", mesh)[0])
    caps = sharded.cap_ladder(x.shape[0], MESH_RANKS, plan.cap_factor,
                              plan.retries)
    cap = caps[sharded._rung(need, caps)]
    ev[2].record()
    recv, cnt, precv = sharded._exchange(loc, ploc, bounds, sizes, cap=cap,
                                         axis="data", mesh=mesh)
    ev[3].record()
    sched = MergeSchedule.from_plan(plan)
    if pay is not None:
        sched = sched.replace(tie="b")
    sharded._reduce_received(recv, cnt, precv, cap=cap, out_cap=caps[-1],
                             sched=sched, dtype=x.dtype)
    ev[4].record()
    torch.cuda.synchronize()
    return {k: ev[i].elapsed_time(ev[i + 1]) for i, k in enumerate(
        ("local_sort", "splitters", "exchange", "reduction"))}


def _mesh_sort(engine, kernels, mesh, rank):
    """(a): sharded_sort at 2^24 float32 keys a rank, key-only and with the
    global indices as payload, under four plans; the skewed input through
    the cap ladder. Each rank checks its run against its slice of
    ``torch.sort(descending=True, stable=True)`` of the gathered input."""
    from repro_torch.engine import sharded
    from repro_torch.parallel import comm
    n = MESH_N
    x = _mesh_keys(rank, n)
    gidx = rank * n + torch.arange(n, dtype=torch.int32, device="cuda")
    gathered = comm.all_gather(x, "data", mesh).reshape(-1)
    ref_k, ref_p = torch.sort(gathered, descending=True, stable=True)
    ref_p = ref_p.to(torch.int32)
    del gathered

    def check(what, res, pay, rk, rp):
        counts = comm.all_gather(res.count, "data", mesh).reshape(-1)
        c = int(counts[rank])
        lo = int(counts[:rank].sum())
        if bool(res.overflow.any()) or int(counts.sum()) != rk.numel():
            raise AssertionError(f"{what}: overflow {res.overflow.tolist()}"
                                 f", counts {counts.tolist()}")
        check_same(f"{what} keys", res.values[:c], rk[lo:lo + c])
        if pay is not None:
            check_same(f"{what} payload", pay[:c], rp[lo:lo + c])
        return c

    runs, launches, ms, split = [], {}, {}, {}
    for variant, levels, splitter in MESH_PLANS:
        plan = engine.Plan(variant, w=32, levels=levels, splitter=splitter)
        label = f"{variant} L{levels} {splitter}"
        for kv in (False, True):
            call = (lambda: engine.sharded_sort(x, mesh, payload=gidx,
                                                plan=plan)) if kv else \
                (lambda: engine.sharded_sort(x, mesh, plan=plan))
            out, got = counted(kernels, call)
            for k_, v in got.items():
                launches[k_] = launches.get(k_, 0) + v
            res, pay = out if kv else (out, None)
            c = check(f"sharded_sort {label} kv={kv}", res, pay, ref_k,
                      ref_p)
            del out, res, pay
            # the timed run: CUDA events on this rank (all ranks run it)
            s, e = torch.cuda.Event(enable_timing=True), \
                torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            s.record()
            call()
            e.record()
            e.synchronize()
            ms[f"{label} kv={kv}"] = s.elapsed_time(e)
            runs.append({"plan": label, "kv": kv, "count": c})
    for kv in (False, True):
        split[f"tree_cuda L2 hist kv={kv}"] = _mesh_sort_split(
            mesh, sharded, comm, x, gidx if kv else None,
            engine.Plan("tree_cuda", w=32, levels=2, splitter="hist"))
    del ref_k, ref_p
    # the skewed input (tests/test_distributed.py's zipf construction): at
    # P = 4 the default cap_factor 4 makes the base cap n_local, so
    # cap_factor 1 puts the duplicate mass past the base rung
    import numpy as np
    z = np.minimum(np.random.default_rng(SEED + 3 + rank).zipf(2.0, n),
                   10**6).astype(np.int32)
    z = torch.from_numpy(z).to("cuda")
    zg = comm.all_gather(z, "data", mesh).reshape(-1)
    zref = torch.sort(zg, descending=True, stable=True).values
    del zg
    r0 = engine.sharded_sort(z, mesh, plan=engine.Plan(
        "tree_cuda", w=32, levels=2, cap_factor=1, retries=0))
    total0 = int(comm.psum(r0.count, "data", mesh)[0])
    if not bool(r0.overflow.any()) or total0 >= zref.numel():
        raise AssertionError(f"skewed input: retries=0 gave overflow "
                             f"{r0.overflow.tolist()}, {total0} keys")
    del r0
    r1, got = counted(kernels, lambda: engine.sharded_sort(
        z, mesh, plan=engine.Plan("tree_cuda", w=32, levels=2,
                                  cap_factor=1)))
    for k_, v in got.items():
        launches[k_] = launches.get(k_, 0) + v
    check("sharded_sort skewed, cap_factor 1", r1, None, zref, None)
    torch.cuda.synchronize()
    return {"runs": runs, "ms": ms, "split_ms": split, "launches": launches,
            "skew": {"retries0_keys": total0, "n": zref.numel()}}, x, gidx


def _mesh_topk(engine, kernels, mesh, x, gidx):
    """(b): sharded_topk k 2048 over (a)'s keys with the payload, bit for
    bit the one-process ``engine.topk(variant="torch")`` of the gathered
    array (ties to the lower global index) on every rank."""
    from repro_torch.parallel import comm
    (v, i, p), launches = counted(kernels, lambda: engine.sharded_topk(
        x, MESH_TOPK, mesh, payload=gidx))
    gathered = comm.all_gather(x, "data", mesh).reshape(-1)
    ev, ei = engine.topk(gathered, MESH_TOPK, variant="torch")
    check_same("sharded_topk values", v, ev)
    check_same("sharded_topk indices", i, ei.to(torch.int32))
    check_same("sharded_topk payload", p, ei.to(torch.int32))
    del gathered
    ms = time_ms(lambda: engine.sharded_topk(x, MESH_TOPK, mesh,
                                             payload=gidx), warmup=1, reps=3)
    return {"k": MESH_TOPK, "ms": ms, "launches": launches}


def _mesh_route(engine, kernels, mesh, rank):
    """(c): moe_route_ep of Moonlight's router (E 64, k 6) at
    ``MESH_TOKENS`` rows a rank; each owner's kept pairs, weights, slabs
    and tokens equal ``engine.moe_route`` of the gathered logits restricted
    to its experts."""
    from repro_torch.models.moe import expert_capacity
    from repro_torch.parallel import comm
    E, k = 64, 6
    T = MESH_TOKENS * MESH_RANKS
    cap = expert_capacity(1.25, T, k, E)
    g = torch.Generator(device="cuda").manual_seed(SEED + 500 + rank)
    lg = torch.randn(MESH_TOKENS, E, generator=g, device="cuda")
    shard, launches = counted(kernels, lambda: engine.moe_route_ep(
        lg, k, cap, mesh, "data"))
    glob = engine.moe_route(comm.all_gather(lg, "data", mesh).reshape(T, E),
                            k, cap, variant="torch")
    E_loc = E // MESH_RANKS
    c = int(shard.count[0])
    keep = shard.keep[:c]
    mine = (torch.div(glob.experts, E_loc, rounding_mode="floor") == rank) \
        & glob.keep
    order_g = torch.argsort(glob.perm[mine])
    order_s = torch.argsort(shard.perm[:c][keep])
    check_same("moe_route_ep perm", shard.perm[:c][keep][order_s],
               glob.perm[mine][order_g])
    check_same("moe_route_ep tokens", shard.tokens[:c][keep][order_s],
               glob.tokens[mine][order_g])
    check_same("moe_route_ep slabs", shard.slabs[:c][keep][order_s],
               glob.slabs[mine][order_g] - rank * E_loc * cap)
    u = ulps(shard.weights[:c][keep][order_s], glob.weights[mine][order_g])
    if u > ROUTE_WEIGHT_ULPS:
        raise AssertionError(f"moe_route_ep weights: {u} ulps")
    ms = time_ms(lambda: engine.moe_route_ep(lg, k, cap, mesh, "data"),
                 warmup=1, reps=5)
    return {"tokens_a_rank": MESH_TOKENS, "E": E, "k": k, "capacity": cap,
            "arrived": c, "kept": int(keep.sum()), "weight_ulps": u,
            "ms": ms, "launches": launches}


def _mesh_decode(mesh, rank, slice5):
    """(d): one bf16 decode step of Moonlight's attention (d 2048, 16 heads
    of 128) at batch 4 over a 131072-position cache split 4 ways, within
    2^-6 relative Frobenius of the one-process decode (rank 0 builds the
    whole cache from the same seeds)."""
    from repro_torch.models.attention import attn_decode, attn_init
    cfg = slice5[2](SERVE_ARCH)
    dt = torch.bfloat16
    cfg = dataclasses.replace(cfg, param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    p = attn_init(torch.Generator(device="cuda").manual_seed(SEED + 600),
                  cfg, device="cuda")
    W_loc = MESH_CACHE // MESH_RANKS
    shape = (MESH_BATCH, W_loc, cfg.n_kv_heads, cfg.hd)

    def block(r):
        g = torch.Generator(device="cuda").manual_seed(SEED + 700 + r)
        return (torch.randn(shape, generator=g, device="cuda").to(dt),
                torch.randn(shape, generator=g, device="cuda").to(dt))
    g = torch.Generator(device="cuda").manual_seed(SEED + 601)
    x = torch.randn(MESH_BATCH, 1, cfg.d_model, generator=g,
                    device="cuda").to(dt)
    pos = torch.tensor([MESH_CACHE - 1, 3 * W_loc + 17, 2 * W_loc - 1, 1000],
                       device="cuda")
    kc, vc = block(rank)
    call = lambda: attn_decode(p, x, (kc, vc), pos, cfg, mesh=mesh,
                               kv_shard_axis="data")
    y, _ = call()
    ms = time_ms(call, warmup=1, reps=5)
    out = {"cache_gb_a_rank": 2 * kc.numel() * kc.element_size() / 1e9,
           "ms": ms}
    if rank == 0:
        blocks = [block(r) for r in range(MESH_RANKS)]
        fk = torch.cat([b[0] for b in blocks], dim=1)
        fv = torch.cat([b[1] for b in blocks], dim=1)
        del blocks
        one = lambda: attn_decode(p, x, (fk, fv), pos, cfg)
        y1, _ = one()
        err = rel_frob(y, y1)
        if not err <= BF16_REL_FROB:
            raise AssertionError(f"sequence-sharded decode: {err} from the "
                                 f"one-process decode")
        out.update(rel_frob=err, one_process_ms=time_ms(one, warmup=1,
                                                        reps=3))
        del fk, fv
    torch.cuda.synchronize()
    return out


def _mesh_serve(engine, kernels, slice5, mesh, rank):
    """(e): ``moonshot_v1_16b_a3b`` at full width, 4 of 48 layers, bf16,
    on a ``model`` axis of 4 (16 experts a rank, ``moe_path="ep"``): the
    12 seeded requests of ``phase_serve`` through the scheduler on every
    rank under ``set_context(mesh)``, the token streams equal on every
    rank; then 8 decode steps, each fed the same tokens and cache on both
    sides, the mesh step's logits within 2^-6 relative Frobenius of the
    one-process ``grouped`` step's (rank 0 holds the whole weights)."""
    from repro_torch.models.convert import shard_params_for_rank
    from repro_torch.parallel import act, comm
    obs, serve, get_config, _, fallback, _, build_model = slice5
    cfg = dataclasses.replace(get_config(SERVE_ARCH), n_layers=SERVE_LAYERS)
    model = build_model(cfg)
    full = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    params = shard_params_for_rank(full, mesh)
    if rank:
        del full
        full = None
    torch.cuda.synchronize()
    specs = serve_specs(cfg.vocab_size)
    reqs = serve_requests(serve, specs, {})
    sched = serve.Scheduler(model, params, n_slots=SERVE_SLOTS,
                            max_seq=SERVE_SEQ, prefill_len=SERVE_PREFILL,
                            top_k_width=SERVE_K, seed=SEED, variant="torch")
    step_s, admit_s, n_admit = [], 0.0, 0
    staged0 = comm.host_staged_bytes()

    def loop():
        nonlocal admit_s, n_admit
        for r in reqs:
            sched.submit(r)
        while sched.waiting or sched.live:
            t0 = time.perf_counter()
            n = sched.admit()
            if n:
                torch.cuda.synchronize()
                admit_s += time.perf_counter() - t0
                n_admit += n
            if sched.live:
                t0 = time.perf_counter()
                sched.step()
                step_s.append(time.perf_counter() - t0)
    act.set_context(mesh)
    try:
        t0 = time.perf_counter()
        _, launches = counted(kernels, loop)
        wall = time.perf_counter() - t0
    finally:
        act.clear_context()
    staged = comm.host_staged_bytes() - staged0
    by_uid, _ = check_completions("mesh serve", sched.completed, reqs,
                                  cfg.vocab_size)
    want = SERVE_LAYERS * (len(step_s) + SERVE_PREFILL * n_admit)
    if launches.get("moe_route", 0) != want:
        raise AssertionError(f"mesh serve: K7 launches {launches} over "
                             f"{len(step_s)} steps and {n_admit} "
                             f"admissions, expected {want}")
    # every rank's token streams, gathered and compared
    flat = torch.full((N_SERVE, 24), -1, dtype=torch.int32, device="cuda")
    for uid, c in by_uid.items():
        flat[uid, :len(c.tokens)] = torch.tensor(c.tokens, dtype=torch.int32)
    every = comm.all_gather(flat, "model", mesh)
    if not bool((every == every[0:1]).all()):
        raise AssertionError("mesh serve: token streams differ between "
                             "ranks")
    tokens = sum(len(c.tokens) for c in sched.completed)
    del sched
    # 8 steps, each fed the same tokens and the same cache on both sides:
    # the mesh step against the one-process grouped step (rank 0)
    g = torch.Generator().manual_seed(SEED + 800)
    toks = torch.randint(1, cfg.vocab_size, (MESH_STEPS, SERVE_SLOTS),
                         generator=g, dtype=torch.int32).to("cuda")
    cache = model.init_cache(SERVE_SLOTS, SERVE_SEQ)
    errs = []
    for t in range(MESH_STEPS):
        pos = torch.full((SERVE_SLOTS,), t, device="cuda")
        act.set_context(mesh)
        try:
            lg, new_cache = model.decode_step(params, toks[t], pos, cache)
        finally:
            act.clear_context()
        if rank == 0:
            # outside the context moe_path "ep" runs grouped
            lg1, _ = model.decode_step(full, toks[t], pos, cache)
            errs.append(rel_frob(lg.float(), lg1.float()))
        cache = new_cache
    if rank == 0 and not max(errs) <= BF16_REL_FROB:
        raise AssertionError(f"mesh decode step: {errs} from the "
                             f"one-process grouped step")
    return {"steps": len(step_s), "admissions": n_admit,
            "step_p50_ms": _pct(step_s, 0.5) * 1e3,
            "step_p99_ms": _pct(step_s, 0.99) * 1e3,
            "prefill_ms": admit_s * 1e3 / max(n_admit, 1),
            "wall_s": wall, "tokens": tokens, "tok_s": tokens / wall,
            "k7_per_step": SERVE_LAYERS, "launches": launches,
            "host_staged_bytes": staged, "step_rel_frob": errs,
            "topk_variant": "torch",
            "guard.fallback": fallback.demotions()}


def _mesh_progress(rank: int, part: str, t: dict) -> None:
    if rank == 0:
        print(f"mesh part ({part}): {t[part]:.1f} s on rank 0", flush=True)


def _mesh_rank(rank: int, store: str, out_dir: str) -> None:
    """One rank of ``phase_mesh``: every part on this rank's shard; the
    results to ``rank<r>.json``. Exits 1 on any failure."""
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    # 4 ranks share the host's cores: 2 intra-op threads each
    torch.set_num_threads(2)
    try:
        engine, kernels, _build, *_ = _import_port()
        _build.library()             # the parent's build, loaded
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.parallel import comm
        slice5 = _import_slice5()
        mesh = make_mesh((MESH_RANKS,), ("data",), backend="gloo",
                         rank=rank, world_size=MESH_RANKS, store_dir=store,
                         timeout_s=120.0)
        out, t = {"rank": rank, "device": str(mesh.device)}, {}
        t0 = time.perf_counter()
        out["sort"], x, gidx = _mesh_sort(engine, kernels, mesh, rank)
        t["a"] = time.perf_counter() - t0
        _mesh_progress(rank, "a", t)
        t0 = time.perf_counter()
        out["topk"] = _mesh_topk(engine, kernels, mesh, x, gidx)
        del x, gidx
        t["b"] = time.perf_counter() - t0
        _mesh_progress(rank, "b", t)
        t0 = time.perf_counter()
        out["route"] = _mesh_route(engine, kernels, mesh, rank)
        t["c"] = time.perf_counter() - t0
        _mesh_progress(rank, "c", t)
        t0 = time.perf_counter()
        out["decode"] = _mesh_decode(mesh, rank, slice5)
        t["d"] = time.perf_counter() - t0
        _mesh_progress(rank, "d", t)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        mmesh = make_mesh((MESH_RANKS,), ("model",))
        out["serve"] = _mesh_serve(engine, kernels, slice5, mmesh, rank)
        t["e"] = time.perf_counter() - t0
        _mesh_progress(rank, "e", t)
        out["seconds"] = t
        out["host_staged_bytes"] = comm.host_staged_bytes()
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    except Exception:
        import traceback
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    sys.stdout.flush()
    # skip the process groups' teardown: every rank is done with them
    os._exit(0)


def phase_mesh(kernels):
    """4 ranks on the one card (``torch.multiprocessing``, spawn, gloo: the
    kernels run on ``cuda:0`` in every rank and the collectives cross the
    host). The parent has built the kernels, so the ranks load the built
    library; it empties its cache allocator first. Parts (a)-(e) run in
    every rank (their docstrings above); any rank's failure, or a rank
    still running at ``MESH_LIMIT_S``, fails the phase. Returns the
    kernels' launches summed over the ranks."""
    import torch.multiprocessing as mp
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    store = tempfile.mkdtemp(prefix="mesh_store_")
    out_dir = tempfile.mkdtemp(prefix="mesh_out_")
    ctx = mp.get_context("spawn")
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_mesh_rank, args=(r, store, out_dir))
             for r in range(MESH_RANKS)]
    try:
        for p in procs:
            p.start()
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break               # a rank failed: stop the others now
            if time.perf_counter() - t0 > MESH_LIMIT_S:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
    codes = [p.exitcode for p in procs]
    if codes != [0] * MESH_RANKS:
        raise AssertionError(f"phase_mesh: rank exit codes {codes} after "
                             f"{time.perf_counter() - t0:.1f} s")
    ranks = []
    for r in range(MESH_RANKS):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    shutil.rmtree(store, ignore_errors=True)
    shutil.rmtree(out_dir, ignore_errors=True)
    launches = {}
    for rk in ranks:
        for part in ("sort", "topk", "route", "serve"):
            for k_, v in rk[part]["launches"].items():
                launches[k_] = launches.get(k_, 0) + v
    missing = [k_ for k_ in MESH_KERNELS if not launches.get(k_)]
    if missing:
        raise AssertionError(f"phase_mesh: kernels not launched: {missing}")
    note = ("4 ranks on one card, gloo: the collectives crossed the host")
    r0 = ranks[0]
    print("mesh: " + json.dumps({
        "note": note, "seconds": time.perf_counter() - t0,
        "rank_seconds": [rk["seconds"] for rk in ranks],
        "sort_ms": r0["sort"]["ms"], "sort_split_ms": r0["sort"]["split_ms"],
        "skew": r0["sort"]["skew"], "topk": r0["topk"],
        "route": r0["route"], "decode": r0["decode"],
        "serve": r0["serve"],
        "serve_token_streams_equal": True,
        "host_staged_bytes": [rk["host_staged_bytes"] for rk in ranks],
        "peak_gb": [rk["peak_gb"] for rk in ranks],
        "launches": launches}), flush=True)
    return launches


FAMILY_DEPTHS = {"zamba2_2p7b": 6, "xlstm_1p3b": 8, "gemma2_9b": 2,
                 "gemma2_27b": 2, "qwen1p5_110b": 2, "internvl2_76b": 2,
                 "whisper_large_v3": 2}
FAMILY_BATCH = 2
FAMILY_TOKENS = 16
# float32 decode against the teacher-forced forward: the same arithmetic in
# another order (a recurrence against its chunked form, a KV cache against
# the whole sequence); float32 rounding, far below this bound
FAMILY_REL_FROB = 1e-3
ZAMBA_ARCH = "zamba2_2p7b"
DRIFT_TOKENS = 32


def rel_frob(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got.double() - ref.double()).norm() / ref.double().norm())


def phase_families(slice5):
    """Each family the serving phases do not drive, at its published widths
    and the least depth that holds its structure, in float32: seeded tokens
    decoded one at a time against the teacher-forced forward (Whisper's
    ``decode_train`` over 1500 encoded frames), and InternVL2's forward
    with its 256-patch vision prefix. One model at a time."""
    _, _, get_config, _, _, tf, build_model = slice5
    B, S = FAMILY_BATCH, FAMILY_TOKENS
    rows = []
    for arch, depth in FAMILY_DEPTHS.items():
        t0 = time.perf_counter()
        base = get_config(arch)
        cut = dict(n_layers=depth, param_dtype="float32",
                   compute_dtype="float32")
        what = f"n_layers {base.n_layers} -> {depth}"
        if base.n_encoder_layers:
            cut["n_encoder_layers"] = depth
            what += f", n_encoder_layers {base.n_encoder_layers} -> {depth}"
        print(f"reduced: {arch} {what}, {base.param_dtype} -> float32",
              flush=True)
        cfg = dataclasses.replace(base, **cut)
        model = build_model(cfg)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
        params = model.init(gen)
        toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                             device="cuda", dtype=torch.int32)
        batch = {"tokens": toks}
        if cfg.arch_kind == "encdec":
            batch["frames"] = 0.5 * torch.randn(
                (B, cfg.encoder_seq, cfg.d_model), generator=gen,
                device="cuda")
            _, filled = model.prefill(params, batch, S)
            cache = dict(model.init_cache(B, S, enc_len=cfg.encoder_seq),
                         cross=filled["cross"])
            del filled
        else:
            cache = model.init_cache(B, S)
        full = tf.lm_logits(params, model.forward(params, batch), cfg)
        steps = []
        for t in range(S):
            logits, cache = model.decode_step(
                params, toks[:, t], torch.full((B,), t, dtype=torch.int32,
                                               device="cuda"), cache)
            steps.append(logits)
        got = torch.stack(steps, dim=1)
        want = (B, S, cfg.vocab_size)
        if got.shape != want or full.shape != want or not bool(
                torch.isfinite(got).all() & torch.isfinite(full).all()):
            raise AssertionError(f"{arch}: logits {tuple(got.shape)} / "
                                 f"{tuple(full.shape)}, or not finite")
        row = {"family": arch, "layers": depth, "dtype": "float32",
               "d_model": cfg.d_model, "vocab": cfg.vocab_size,
               "parameters": sum(t.numel() for t in _leaves(params)),
               "tokens": S, "batch": B,
               "decode_vs_forward_rel_frob": rel_frob(got, full),
               "last_rel_frob": rel_frob(got[:, -1], full[:, -1]),
               "bound": FAMILY_REL_FROB}
        if cfg.arch_kind == "encdec":
            row["frames"] = cfg.encoder_seq
        if max(row["decode_vs_forward_rel_frob"],
               row["last_rel_frob"]) > FAMILY_REL_FROB:
            raise AssertionError(f"{arch}: decode against forward "
                                 + json.dumps(row))
        if cfg.n_vision_tokens:
            P = cfg.n_vision_tokens
            batch["vision"] = 0.5 * torch.randn((B, P, cfg.d_model),
                                                generator=gen, device="cuda")
            lv = tf.lm_logits(params, model.forward(params, batch), cfg)
            if lv.shape != (B, P + S, cfg.vocab_size) or not bool(
                    torch.isfinite(lv).all()):
                raise AssertionError(f"{arch}: vision-prefixed logits "
                                     f"{tuple(lv.shape)}, or not finite")
            row["vision_logits_shape"] = list(lv.shape)
            del lv
        torch.cuda.synchronize()
        row["seconds"] = time.perf_counter() - t0
        print("family: " + json.dumps(row), flush=True)
        rows.append(row)
        del params, model, cache, full, got, steps, batch
        torch.cuda.empty_cache()
    return rows


def _leaves(tree):
    from repro_torch.core.butterfly import tree_leaves
    return tree_leaves(tree)


def bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def check_slot_isolation(serve, model, params, specs):
    """Admit the first ``SERVE_SLOTS`` requests into one scheduler, and hold
    the first and the last slot's state (every cache leaf's slice on its
    own slot axis: Zamba2's ``S`` and ``conv`` of all layers and its KV
    caches) bit for bit to the same request admitted alone into a one-slot
    scheduler. Returns the check's summary, the decode state just after
    the admissions (cache, last tokens, positions, sampling rows, every
    slot live), and EOS ids for requests 0 and 3 (their greedy tokens 4
    and 6, from 6 steps of the same batch, as ``serve_run``'s first
    steps run it)."""
    from repro_torch.core.butterfly import tree_map
    kw = dict(max_seq=SERVE_SEQ, prefill_len=SERVE_PREFILL,
              top_k_width=SERVE_K, seed=SEED)
    sched = serve.Scheduler(model, params, n_slots=SERVE_SLOTS, **kw)
    for r in serve_requests(serve, specs, {}):
        sched.submit(r)
    if sched.admit() != SERVE_SLOTS:
        raise AssertionError("slot isolation: not every slot admitted")
    checked, leaves = [0, SERVE_SLOTS - 1], 0
    for slot in checked:
        alone = serve.Scheduler(model, params, n_slots=1, **kw)
        alone.submit(sched.live[slot].req)
        alone.admit()
        got = _leaves(tree_map(lambda leaf, ax: leaf.narrow(ax, slot, 1),
                               sched.kv.cache, sched.kv.axes))
        exp = _leaves(alone.kv.cache)
        bad = [i for i, (g, e) in enumerate(zip(got, exp))
               if not bit_equal(g, e)]
        if bad or len(got) != len(exp):
            raise AssertionError(f"slot {slot}: cache leaves {bad} differ "
                                 "from the same request admitted alone")
        leaves = len(got)
        del alone
    st = sched.state
    state = (tree_map(lambda t: t.clone(), sched.kv.cache),
             st.last_tok.clone(), st.pos.clone(), st.sampling)
    for _ in range(6):
        sched.step()
    toks = {ls.req.uid: ls.tokens for ls in sched.live.values()}
    iso = {"slots": checked, "leaves_per_slot": leaves,
           "slot_axes": sorted(set(_leaves(sched.kv.axes))),
           "bit_for_bit": True}
    return iso, state, {0: toks[0][3], 3: toks[3][5]}


def phase_serve_zamba2(engine, kernels, slice5):
    """The ``zamba2_2p7b`` config at its widths and all 54 layers, bf16,
    serving the 12 requests through the scheduler: slot isolation bit for
    bit, the bf16 drift of forward against decode at full depth, the
    heuristic and autotuned ``topk`` plans (checked and timed, greedy
    tokens equal, no kernel launched, no fallback) and one ``serve``
    line. The tuned plan and the step's byte bound come from the decode
    state just after the first admissions."""
    obs, serve, get_config, planner, fallback, tf, build_model = slice5
    cfg = get_config(ZAMBA_ARCH)
    t0 = time.perf_counter()
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in _leaves(params))
    gb = _nbytes(params) / 1e9
    print(f"{cfg.name}: d {cfg.d_model}, {cfg.n_layers} Mamba2 layers "
          f"(state {cfg.ssm_state}, heads of {cfg.ssm_head_dim}), a shared "
          f"block of {cfg.n_heads} heads x {cfg.hd} every "
          f"{cfg.hybrid_attn_every}, vocab {cfg.vocab_size}, "
          f"{cfg.param_dtype}: {n_par / 1e9:.3f}B parameters, {gb:.3f} GB, "
          f"made in {time.perf_counter() - t0:.1f} s", flush=True)
    specs = serve_specs(cfg.vocab_size)
    iso, captured, eos = check_slot_isolation(serve, model, params, specs)
    cache, last_tok, pos, sampling = captured
    print("zamba2 slot isolation: " + json.dumps(iso), flush=True)
    # the bf16 drift at full depth: forward against the decode steps on
    # one 32-token prompt (a figure; the float32 check is phase_families')
    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
    toks = torch.randint(0, cfg.vocab_size, (1, DRIFT_TOKENS), generator=gen,
                         device="cuda", dtype=torch.int32)
    full = tf.lm_logits(params, model.forward(params, {"tokens": toks}), cfg)
    c1, steps = model.init_cache(1, SERVE_SEQ), []
    for t in range(DRIFT_TOKENS):
        lg, c1 = model.decode_step(params, toks[:, t], torch.full(
            (1,), t, dtype=torch.int32, device="cuda"), c1)
        steps.append(lg)
    drift = rel_frob(torch.stack(steps, dim=1), full)
    print("zamba2 bf16 drift: " + json.dumps({
        "tokens": DRIFT_TOKENS, "layers": cfg.n_layers,
        "forward_vs_decode_rel_frob": drift}), flush=True)
    del full, c1, steps
    logits, launches = counted(kernels, lambda: model.decode_step(
        params, last_tok, pos, cache)[0])
    if launches or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"zamba2 decode step: launches {launches}")
    nbytes = step_bytes(params, cache, cfg.vocab_size)
    run1, run2, tuned, cands = serve_two_plans(
        engine, kernels, obs, serve, model, params, specs, eos, logits,
        "zamba2 ", 0)
    if fallback.demotions():
        raise AssertionError(f"{fallback.demotions()} fallback demotions")
    line = {"serve": f"{cfg.name} {cfg.n_layers} of {cfg.n_layers} layers, "
                     f"{SERVE_SLOTS} slots, max_seq {SERVE_SEQ}, "
                     f"prefill_len {SERVE_PREFILL}, k {SERVE_K}",
            "requests": N_SERVE, "parameters": n_par, "weight_gb": gb,
            "step_p50_ms": run1["step_p50_ms"],
            "step_p99_ms": run1["step_p99_ms"],
            "prefill_ms": run1["prefill_ms"], "tok_s": run1["tok_s"],
            "decode_tok_s": run1["decode_tok_s"],
            "step_bytes": nbytes,
            "step_bound_ms": nbytes / hbm_bytes_per_s() * 1e3,
            "kernel_launches": {**run1["launches"], **run2["launches"]},
            "topk_heuristic": run1["topk_variant"],
            "autotune_candidates": cands, "autotune_winner": tuned.variant,
            "tuned_step_p50_ms": run2["step_p50_ms"],
            "tuned_step_p99_ms": run2["step_p99_ms"],
            "tuned_tok_s": run2["tok_s"], "eos_hits": run1["eos_hits"],
            "obs_step_p50_ms": run1["obs_step_p50_ms"],
            "slot_isolation": iso, "bf16_drift_rel_frob": drift,
            "guard.fallback": fallback.demotions()}
    print("serve: " + json.dumps(line), flush=True)
    del params, model, captured, cache, logits
    torch.cuda.empty_cache()
    return line


# --------------------------------------------------------------------------
# training: the trainer on one card, and the guard's chaos checks
# --------------------------------------------------------------------------

TRAIN_MOE_ARCH = "moonshot_v1_16b_a3b"
TRAIN_MOE_LAYERS = 4
TRAIN_MOE_BATCH, TRAIN_MOE_SEQ = 4, 1024
TRAIN_MOE_STEPS, TRAIN_MOE_CKPT = 6, 3
TRAIN_ARCH = "qwen3_1p7b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 4
TRAIN_LR, TRAIN_WARMUP = 3e-4, 2
# a resumed run's losses against the straight run's, relative: the restored
# state is bit for bit the saved one and the data is replayed per step, so
# only a run-to-run order of float additions on the card moves them (the
# embedding's backward accumulates with atomics); bf16 activations carry
# such a difference at ~2^-8 of an element, much less of the mean loss
RESUME_RTOL = 1e-3
# the router's gradient through K7's Function against the same gradient
# through the torch route, relative Frobenius: the lanes are bit for bit
# the same and the weights within 8 float32 ulps, which the bf16 rounding
# of the weights and activations between the products can carry through
# four layers' backward (the serving step's bound, BF16_REL_FROB)
ROUTER_GRAD_REL_FROB = 2.0 ** -6
BF16_OPS_PER_S = 989e12        # H100 SXM, dense bf16 tensor-core rate


def _import_train():
    from types import SimpleNamespace
    from repro_torch.core.butterfly import tree_leaves
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.guard import inject, verify
    from repro_torch.kernels import route_fuse
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.launch.train import TrainLoop
    from repro_torch.models.config import TrainConfig
    from repro_torch.optim import adamw_init, adamw_update, lr_schedule
    return SimpleNamespace(**{k: v for k, v in locals().items()
                              if k != "SimpleNamespace"})


def _events(n: int):
    return [torch.cuda.Event(enable_timing=True) for _ in range(n)]


def _p50(xs) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _train_split(kernels, tr, model, params, opt, batch, tcfg):
    """One training step on the loop's final state, split with CUDA events
    into forward (``train_loss``, its end marked by a hook on the model's
    ``train_loss``), backward (the rest of ``loss_and_grads``) and the
    AdamW update: K7's launches in the forward and in the backward (remat
    recomputes each MoE layer's forward), and the calls of the route
    Function's backward. Returns the split, the counts and the gradient
    list (``tree_leaves`` order) taken before the update."""
    rf = tr.route_fuse
    real_bwd, real_loss = rf.route_backward, model.train_loss
    calls, fwd, ev = [0], {}, _events(5)

    def counting(*args):
        calls[0] += 1
        return real_bwd(*args)

    def loss_then_mark(p, b):
        out = real_loss(p, b)
        ev[1].record()
        fwd.update(kernels.launch_counts())
        kernels.reset_launches()
        return out

    rf.route_backward, model.train_loss = counting, loss_then_mark
    try:
        torch.cuda.synchronize()
        kernels.reset_launches()
        ev[0].record()
        loss, _, grads = tr.loss_and_grads(model, params, batch)
        ev[2].record()
        bwd = kernels.launch_counts()
    finally:
        rf.route_backward, model.train_loss = real_bwd, real_loss
    lr = tr.lr_schedule(opt.step, tcfg.lr, tcfg.warmup_steps,
                        tcfg.total_steps)
    ev[3].record()
    tr.adamw_update(grads, opt, params, lr=lr, b1=tcfg.b1, b2=tcfg.b2,
                    weight_decay=tcfg.weight_decay, grad_clip=tcfg.grad_clip)
    ev[4].record()
    torch.cuda.synchronize()
    split = {"forward_ms": ev[0].elapsed_time(ev[1]),
             "backward_ms": ev[1].elapsed_time(ev[2]),
             "optimizer_ms": ev[3].elapsed_time(ev[4]),
             "loss": float(loss)}
    counts = {"k7_forward": fwd.get("moe_route", 0),
              "k7_backward_recompute": bwd.get("moe_route", 0),
              "route_backward_calls": calls[0],
              "other_kernels": sorted((set(fwd) | set(bwd)) - {"moe_route"})}
    return split, counts, grads


def _steps(loop, params, opt, steps):
    """The loop's steps ``steps`` through its own parts (``step_fn``,
    ``data``), with no checkpoint, timed on the host clock. Returns the
    state, the losses and the seconds."""
    losses, step_s = [], []
    for s in steps:
        t0 = time.perf_counter()
        params, opt, met = loop.step_fn(params, opt, loop.data.batch(s))
        losses.append(float(met["loss"]))
        step_s.append(time.perf_counter() - t0)
    return params, opt, losses, step_s


def _dir_gb(path: str) -> float:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs) / 1e9


def _resume(tr, cfg, tcfg, straight):
    """A fresh ``TrainLoop`` on the checkpoint directory: its
    ``resume_state`` (what ``run`` starts from) restores the newest
    checkpoint, then its ``step_fn`` on its ``data`` takes the steps from
    there to the last. ``run`` itself would write a second checkpoint at
    its last step, which would take the smoke past the card machine's
    disk writes a call (45 GiB; a checkpoint is 36.6 GB). Returns the
    summary, held to the straight run's losses within ``RESUME_RTOL``."""
    t0 = time.perf_counter()
    loop = tr.TrainLoop(cfg, tcfg)
    params, opt, start = loop.resume_state()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    _, _, resumed, _ = _steps(loop, params, opt,
                              range(start, TRAIN_MOE_STEPS))
    gap = max((abs(a - b) / abs(a) for a, b in
               zip(straight[TRAIN_MOE_CKPT:], resumed)), default=math.inf)
    if start != TRAIN_MOE_CKPT \
            or len(resumed) != TRAIN_MOE_STEPS - TRAIN_MOE_CKPT \
            or not all(math.isfinite(v) for v in resumed) \
            or gap > RESUME_RTOL:
        raise AssertionError(f"train resume: from step {start}, straight "
                             f"{straight}, resumed {resumed}")
    return {"resumed_at_step": start,
            "straight_steps_4_to_6": straight[TRAIN_MOE_CKPT:],
            "resumed_steps_4_to_6": resumed,
            "steps_4_to_6_max_rel_gap": gap, "bound": RESUME_RTOL,
            "restore_s": restore_s}


def phase_train_moe(engine, kernels, slice5, tr):
    """The ``moonshot_v1_16b_a3b`` config at its widths, 4 of 48 layers,
    bf16, remat on, batch 4 x 1024, checkpoints in a directory of its own
    (removed at the end). ``TrainLoop.run`` takes steps 1-3 and saves its
    state at step 3, the loop's ``step_fn`` steps 4-6 (step p50, tokens/s,
    peak memory, K7's launches); on the final state and one fixed batch,
    the router's gradient through the ``torch`` route, then one step split
    by part with K7 counted in its forward, the route Function's backward
    counted, and the router's gradient through K7 held to the torch
    route's. A fresh loop then resumes from the checkpoint to step 6
    against the straight run. Returns the summary line and K7's launches
    in the phase's training steps."""
    obs, serve, get_config, planner, fallback, tf, build_model = slice5
    base = get_config(TRAIN_MOE_ARCH)
    cfg = dataclasses.replace(base, n_layers=TRAIN_MOE_LAYERS)
    print(f"reduced: {TRAIN_MOE_ARCH} n_layers {base.n_layers} -> "
          f"{TRAIN_MOE_LAYERS} (training)", flush=True)
    if not cfg.remat or cfg.param_dtype != "bfloat16":
        raise AssertionError("train moe: expected remat and bf16")
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        tcfg = tr.TrainConfig(
            global_batch=TRAIN_MOE_BATCH, seq_len=TRAIN_MOE_SEQ, lr=TRAIN_LR,
            warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_MOE_STEPS,
            checkpoint_every=TRAIN_MOE_CKPT, checkpoint_dir=ckdir, seed=SEED)
        line, train_k7, straight = _train_moe(engine, kernels, planner, tr,
                                              base, cfg, tcfg, ckdir)
        resume = _resume(tr, cfg, tcfg, straight)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.empty_cache()
    print("train resume: " + json.dumps(resume), flush=True)
    line["resume_max_rel_gap"] = resume["steps_4_to_6_max_rel_gap"]
    print("train: " + json.dumps(line), flush=True)
    return line, train_k7


def _train_moe(engine, kernels, planner, tr, base, cfg, tcfg, ckdir):
    """The straight run and the checks on its final state (see
    :func:`phase_train_moe`); returns the line, K7's launches and the six
    losses. The run's state is freed on return."""
    loop = tr.TrainLoop(cfg, tcfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    params, opt, losses = loop.run(resume="no", max_steps=TRAIN_MOE_CKPT)
    run_s = time.perf_counter() - t0
    saved = sorted(os.listdir(ckdir))
    ck_gb = _dir_gb(ckdir)
    params, opt, more, more_s = _steps(
        loop, params, opt, range(TRAIN_MOE_CKPT, TRAIN_MOE_STEPS))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    train_k7 = kernels.launch_counts().get("moe_route", 0)
    losses += more
    step_s = loop.step_times + more_s
    if saved != [f"step_{TRAIN_MOE_CKPT}"] \
            or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"train moe: checkpoints {saved}, losses "
                             f"{losses}")
    leaves = tr.tree_leaves(params)
    router = params["blocks"]["moe"]["router"]
    ri = next(i for i, t in enumerate(leaves) if t is router)
    batch = loop.data.batch(TRAIN_MOE_STEPS)
    # the grouped path routes B * 512 tokens of a (1, T, E) group a call
    T = TRAIN_MOE_BATCH * min(512, TRAIN_MOE_SEQ)
    key = planner.plan_key("moe_route", n=T * cfg.n_experts_active,
                           dtype=torch.float32, backend="cuda", segments=1)
    engine.default_planner.put(key, engine.Plan("torch"))
    try:
        (_, _, grads), torch_launches = counted(
            kernels, lambda: tr.loss_and_grads(loop.model, params, batch))
    finally:
        engine.default_planner.put(key, planner.heuristic_plan("moe_route",
                                                               key))
    g_torch = grads[ri].clone()
    del grads
    split, counts, grads = _train_split(kernels, tr, loop.model, params, opt,
                                        batch, tcfg)
    g_k7 = grads[ri].clone()
    del grads
    rel = rel_frob(g_k7, g_torch)
    per_step = TRAIN_MOE_LAYERS * (TRAIN_MOE_SEQ // min(512, TRAIN_MOE_SEQ))
    if torch_launches or train_k7 != 2 * per_step * TRAIN_MOE_STEPS \
            or counts["k7_forward"] != per_step \
            or counts["k7_backward_recompute"] != per_step \
            or counts["route_backward_calls"] != per_step:
        raise AssertionError(f"train moe: K7 launches {counts}, in the "
                             f"steps {train_k7}, torch-routed step "
                             f"{torch_launches}")
    if not (float(g_k7.norm()) > 0 and math.isfinite(rel)
            and rel <= ROUTER_GRAD_REL_FROB):
        raise AssertionError(f"train moe: router gradient through K7 "
                             f"|g| {float(g_k7.norm())}, rel {rel}")
    n_par = sum(t.numel() for t in leaves)
    state_gb = _nbytes(params, [opt.step, opt.m, opt.v, opt.master]) / 1e9
    del params, opt, leaves, router, g_k7, g_torch, loop
    torch.cuda.empty_cache()
    tokens = TRAIN_MOE_BATCH * TRAIN_MOE_SEQ
    p50 = _p50(step_s[1:])
    line = {"train": f"{cfg.name} {TRAIN_MOE_LAYERS} of {base.n_layers} "
                     f"layers, {cfg.param_dtype}, remat, batch "
                     f"{TRAIN_MOE_BATCH} x {TRAIN_MOE_SEQ}",
            "parameters": n_par, "state_gb": state_gb, "losses": losses,
            "step_s": step_s, "step_p50_ms": p50 * 1e3,
            "tokens_per_s": tokens / p50,
            "max_memory_allocated_gb": peak / 1e9, "split": split,
            "k7": dict(counts, train_launches=train_k7),
            "router_grad_rel_frob": rel,
            "router_grad_bound": ROUTER_GRAD_REL_FROB,
            "checkpoint_gb": ck_gb,
            "run_to_checkpoint_s": run_s,
            "init_and_checkpoint_s": run_s - sum(step_s[:TRAIN_MOE_CKPT])}
    return line, train_k7 + 2 * counts["k7_forward"], losses


# --------------------------------------------------------------------------
# the training half of the mesh: 4 ranks on the one card
# --------------------------------------------------------------------------

TMESH_SHAPE = (2, 2)           # ("data", "model"): FSDP, DP, EP and ZeRO
TMESH_RANKS = 4
TMESH_STEPS = 3
TMESH_LIMIT_S = 240            # the phase's whole time, spawns included
TMESH_REL = 2.0 ** -6          # losses, leaf norms and samples
TMESH_SAMPLE = 64              # seeded elements of each leaf
GPIPE_S, GPIPE_M, GPIPE_D, GPIPE_BM = 4, 8, 2048, 256
GPIPE_TOL = 1e-5
COMPRESS_ARCH = "qwen3_1p7b"   # one layer's gradient shapes
COMPRESS_STEPS = 1.5           # bound, in quantisation steps of the mean
# the leaves whose gradient depends on which pairs the capacity cut keeps
CAPACITY_LEAVES = tuple(f"blocks/moe/{n}" for n in ("router", "wi", "wg",
                                                    "wo"))


def _tmesh_cfg(tr, get_config):
    base = get_config(TRAIN_MOE_ARCH)
    cfg = dataclasses.replace(base, n_layers=TRAIN_MOE_LAYERS)
    tcfg = tr.TrainConfig(
        global_batch=TRAIN_MOE_BATCH, seq_len=TRAIN_MOE_SEQ, lr=TRAIN_LR,
        warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_MOE_STEPS, seed=SEED)
    return base, cfg, tcfg


def _tmesh_sample_index(i: int, numel: int):
    import numpy as np
    rng = np.random.default_rng([SEED, 910, i])
    return rng.integers(0, numel, TMESH_SAMPLE)


def _tmesh_reference(kernels, tr, cfg, tcfg, per_shard: bool):
    """The one-process steps on the same seeded weights and batches: the
    losses, gradient norms, step times, K7's launches a step, and each
    leaf's Frobenius norm and seeded sample after the last step; the
    state is freed. ``per_shard``: under an ``AbstractMesh`` of the mesh's
    shape, where ``moe_apply_ep`` routes each data shard's rows as one
    group a 1024-position chunk, as the mesh cuts capacity, so the one
    process computes the mesh's function; otherwise the plain step, whose
    ``grouped`` MoE layer routes the whole batch as one group a
    512-position chunk, and whose capacity cut drops other pairs."""
    import contextlib
    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.parallel import act
    with (act.context(AbstractMesh(TMESH_SHAPE, ("data", "model")))
          if per_shard else contextlib.nullcontext()):
        return _tmesh_steps(kernels, tr, cfg, tcfg, _flatten)


def _tmesh_steps(kernels, tr, cfg, tcfg, _flatten):
    model, step = tr.make_train_step(cfg, tcfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    opt = tr.adamw_init(params)
    state_gb = _nbytes(params, [opt.step, opt.m, opt.v, opt.master]) / 1e9
    data = tr.SyntheticLM(cfg.vocab_size, tcfg.seq_len, tcfg.global_batch,
                          SEED)
    losses, norms, step_s, k7 = [], [], [], []
    for s in range(TMESH_STEPS):
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, data.batch(s))
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        k7.append(kernels.launch_counts().get("moe_route", 0))
    leaves = {}
    for i, (name, t) in enumerate(_flatten(params)):
        idx = _tmesh_sample_index(i, t.numel())
        leaves[name] = {
            "i": i, "shape": list(t.shape),
            "norm": float(t.double().norm()),
            "sample": t.reshape(-1)[torch.from_numpy(idx).to("cuda")]
            .float().cpu().tolist()}
    del params, opt, model, step, met
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {"losses": losses, "grad_norms": norms, "leaves": leaves,
            "step_s": step_s, "k7_a_step": k7, "state_gb": state_gb}


def _tmesh_check_leaves(mesh, comm, lay, params, ref, no_sample=()):
    """Each leaf's norm and seeded sample from this rank's blocks (square
    sums and owned elements summed over the axes the spec names; an
    element has one owner along them) against the one-process leaf's:
    the worst relative errors, the leaves past ``TMESH_REL``, and the
    sample errors of the leaves named in ``no_sample``, read, not held."""
    import numpy as np
    from repro_torch.core.butterfly import tree_leaves
    from repro_torch.parallel.sharding import block_slices, spec_axes
    worst_norm, worst_sample, bad, unheld = 0.0, 0.0, [], {}
    for lf, b in zip(lay.plans(params), tree_leaves(params)):
        name = "/".join(lf.path)
        r = ref[name]
        axes = [a for e in lf.pspec for a in spec_axes(e)]
        sq = b.double().square().sum().reshape(1)
        shape = tuple(r["shape"])
        idx = _tmesh_sample_index(r["i"], int(np.prod(shape)))
        coords = np.unravel_index(idx, shape)
        sl = block_slices(shape, lf.pspec, mesh)
        own = np.ones(len(idx), bool)
        for c, s_ in zip(coords, sl):
            own &= (c >= s_.start) & (c < s_.stop)
        local = [c - s_.start for c, s_ in zip(coords, sl)]
        vals = torch.zeros(len(idx), dtype=torch.float32, device="cuda")
        if own.any():
            pick = tuple(torch.from_numpy(l_[own]).to("cuda") for l_ in local)
            vals[torch.from_numpy(np.nonzero(own)[0]).to("cuda")] = \
                b[pick].float()
        for a in axes:
            sq = comm.psum(sq, a, mesh)
            vals = comm.psum(vals, a, mesh)
        norm = float(sq.sqrt())
        rel_n = abs(norm - r["norm"]) / max(r["norm"], 1e-30)
        want = torch.tensor(r["sample"], dtype=torch.float64)
        rel_s = float((vals.double().cpu() - want).norm() /
                      max(float(want.norm()), 1e-30))
        worst_norm = max(worst_norm, rel_n)
        if name in no_sample:
            unheld[name], rel_s = rel_s, 0.0
        worst_sample = max(worst_sample, rel_s)
        if not (rel_n <= TMESH_REL and rel_s <= TMESH_REL):
            bad.append(f"leaf {name}: norm {norm} vs {r['norm']}, sample "
                       f"{rel_s}")
    return worst_norm, worst_sample, bad, unheld


def _tmesh_train(kernels, tr, slice5, mesh, rank, refs):
    """(a): Moonlight, 4 of 48 layers, bf16, remat, batch 4 x 1024 on the
    (2, 2) mesh: the blocks drawn from the one-process init's generator,
    3 steps. Within ``TMESH_REL``: losses, gradient norms, leaf norms and
    samples against the one-process steps that compute the mesh's
    function (``refs["per_shard"]``); losses, leaf norms and the dense
    leaves' samples against the plain one-process steps
    (``refs["one_group"]``, ``CAPACITY_LEAVES``). The loss and norm bits
    the same on every rank. Step times, staged bytes by collective and
    K7's launches a step (forward and remat's recompute apart)."""
    import torch.distributed as dist
    from repro_torch.parallel import comm
    get_config = slice5[2]
    base, cfg, tcfg = _tmesh_cfg(tr, get_config)
    _, step = tr.make_train_step(cfg, tcfg, mesh)
    lay = step.layout
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lay.init(torch.Generator(device="cuda").manual_seed(SEED))
    opt = lay.opt_init(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_gb = _nbytes(params, [opt.step, opt.m, opt.v, opt.master]) / 1e9
    data = tr.SyntheticLM(cfg.vocab_size, tcfg.seq_len, tcfg.global_batch,
                          SEED)
    # marks on the host clock, the card synchronised: the forward's end
    # (K7's forward launches read there) and the gradients' (reduced)
    real, real_grads, fwd = lay.model.train_loss, lay.loss_and_grads, {}

    def loss_then_mark(p, b):
        out = real(p, b)
        torch.cuda.synchronize()
        fwd["t"] = time.perf_counter()
        fwd["k7"] = kernels.launch_counts().get("moe_route", 0)
        return out

    def grads_then_mark(p, b):
        out = real_grads(p, b)
        torch.cuda.synchronize()
        fwd["t_grads"] = time.perf_counter()
        return out
    lay.model.train_loss = loss_then_mark
    lay.loss_and_grads = grads_then_mark
    ref, plain = refs["per_shard"], refs["one_group"]
    losses, norms, step_s, k7_fwd, k7_bwd, staged = [], [], [], [], [], []
    split = []
    try:
        for s in range(TMESH_STEPS):
            batch = lay.batch_block(data.batch(s))
            before = comm.host_staged_bytes_by_kind()
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            params, opt, met = step(params, opt, batch)
            losses.append(met["loss"].reshape(1).float().cpu())
            norms.append(met["grad_norm"].reshape(1).float().cpu())
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            step_s.append(t1 - t0)
            split.append({"forward_s": fwd["t"] - t0,
                          "backward_and_reductions_s": fwd["t_grads"]
                          - fwd["t"],
                          "norm_and_adamw_s": t1 - fwd["t_grads"]})
            total = kernels.launch_counts().get("moe_route", 0)
            k7_fwd.append(fwd["k7"])
            k7_bwd.append(total - fwd["k7"])
            after = comm.host_staged_bytes_by_kind()
            staged.append({k: v - before.get(k, 0) for k, v in after.items()
                           if v - before.get(k, 0)})
    finally:
        lay.model.train_loss = real
        lay.loss_and_grads = real_grads
    peak = torch.cuda.max_memory_allocated()
    mine = torch.cat(losses + norms)
    every = [torch.empty_like(mine) for _ in range(TMESH_RANKS)]
    dist.all_gather(every, mine)
    bad = []
    if not all(torch.equal(e.view(torch.int32), mine.view(torch.int32))
               for e in every):
        bad.append(f"loss or norm bits differ between ranks: "
                   f"{[e.tolist() for e in every]}")
    got, got_norms = mine[:TMESH_STEPS].tolist(), mine[TMESH_STEPS:].tolist()
    rel = {}
    for what, vals, want in (
            ("losses", got, ref["losses"]),
            ("gradient norms", got_norms, ref["grad_norms"]),
            ("losses (plain step)", got, plain["losses"])):
        rel[what] = [abs(x - y) / abs(y) for x, y in zip(vals, want)]
        if not (all(map(math.isfinite, vals)) and
                max(rel[what]) <= TMESH_REL):
            bad.append(f"{what} {vals} against the one process's {want}")
    per_step = TRAIN_MOE_LAYERS * max(TRAIN_MOE_SEQ // 1024, 1)
    if k7_fwd != [per_step] * TMESH_STEPS or \
            k7_bwd != [per_step] * TMESH_STEPS:
        bad.append(f"K7 forward {k7_fwd}, recompute {k7_bwd}, expected "
                   f"{per_step} each a step")
    worst_norm, worst_sample, bad_leaves, _ = _tmesh_check_leaves(
        mesh, comm, lay, params, ref["leaves"])
    bad += bad_leaves
    # the plain step's capacity cut keeps other pairs, so some MoE
    # elements get gradients of another sign or none, and Adam moves an
    # element by up to lr a step whatever its gradient's size: the MoE
    # leaves' samples are read, not held (their norms are)
    plain_norm, plain_sample, bad_leaves, unheld = _tmesh_check_leaves(
        mesh, comm, lay, params, plain["leaves"],
        no_sample=CAPACITY_LEAVES)
    bad += [f"(plain step) {b}" for b in bad_leaves]
    tokens = TRAIN_MOE_BATCH * TRAIN_MOE_SEQ
    p50 = _p50(step_s)
    kinds = sorted({k for d in staged for k in d})
    del params, opt
    torch.cuda.synchronize()
    out = {"losses": got, "loss_rel": rel["losses"],
            "grad_norms": got_norms, "grad_norm_rel": rel["gradient norms"],
            "leaf_norm_rel": worst_norm, "leaf_sample_rel_frob": worst_sample,
            "plain_step": {"loss_rel": rel["losses (plain step)"],
                           "leaf_norm_rel": plain_norm,
                           "leaf_sample_rel_frob_dense": plain_sample,
                           "moe_sample_rel_frob_not_held": unheld},
            "bound": TMESH_REL,
            "step_s": step_s, "step_p50_ms": p50 * 1e3, "split": split,
            "tokens_per_s": tokens / p50, "init_s": init_s,
            "state_gb": state_gb, "peak_gb": peak / 1e9,
            "staged_bytes_a_step": {k: sum(d.get(k, 0) for d in staged)
                                    / len(staged) for k in kinds},
            "k7_forward_a_step": k7_fwd, "k7_recompute_a_step": k7_bwd,
            "launches": {"moe_route": sum(k7_fwd) + sum(k7_bwd)}}
    if bad:
        if rank == 0:
            print("train mesh (a), failed: " + json.dumps(out), flush=True)
        raise AssertionError("train mesh: " + "; ".join(bad))
    return out


def _tmesh_gpipe(make_mesh, rank):
    """(b): ``gpipe`` over a ``stage`` axis of 4, M 8 microbatches of (256,
    2048) float32 through ``tanh(x @ W_s)``, against each microbatch put
    through the 4 stages in sequence on the card."""
    from repro_torch.parallel.pipeline import gpipe
    smesh = make_mesh((GPIPE_S,), ("stage",))
    g = torch.Generator(device="cuda").manual_seed(SEED + 950)
    W = torch.randn(GPIPE_S, GPIPE_D, GPIPE_D, generator=g,
                    device="cuda") / math.sqrt(GPIPE_D)
    x = torch.randn(GPIPE_M, GPIPE_BM, GPIPE_D, generator=g, device="cuda")
    stage = lambda w, x_: torch.tanh(x_ @ w)
    from repro_torch.parallel import comm
    before = comm.host_staged_bytes()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = gpipe(stage, W, x, smesh)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    staged = comm.host_staged_bytes() - before
    t0 = time.perf_counter()
    seq = []
    for m in range(GPIPE_M):
        h = x[m]
        for s in range(GPIPE_S):
            h = stage(W[s], h)
        seq.append(h)
    seq = torch.stack(seq)
    torch.cuda.synchronize()
    seq_ms = (time.perf_counter() - t0) * 1e3
    err = max_abs_err(y, seq)
    if not err <= GPIPE_TOL:
        raise AssertionError(f"gpipe: {err} from the stages in sequence")
    return {"S": GPIPE_S, "M": GPIPE_M, "ticks": GPIPE_M + GPIPE_S - 1,
            "d": GPIPE_D, "Bm": GPIPE_BM, "max_abs_err": err, "ms": ms,
            "sequential_ms": seq_ms, "host_staged_bytes": staged}


def _tmesh_compress(make_mesh, rank, slice5):
    """(c): ``compressed_psum_int8`` over a ``pod`` axis of 4 on one
    Qwen3-1.7B layer's gradient shapes (float32, seeded per rank): the
    mean within 1.5 quantisation steps of the float32 mean (the JAX test's
    bound); the bytes on the wire against a float32 psum's."""
    from repro_torch.core.butterfly import tree_leaves, tree_map
    from repro_torch.models.transformer import layer
    from repro_torch.optim.compress import compressed_psum_int8, \
        ef_state_init
    from repro_torch.parallel import comm
    pmesh = make_mesh((TMESH_RANKS,), ("pod",))
    build_model, get_config = slice5[6], slice5[2]
    meta = build_model(get_config(COMPRESS_ARCH)).init(
        torch.Generator(), device="meta")
    g = torch.Generator(device="cuda").manual_seed(SEED + 960 + rank)
    grads = tree_map(lambda t: torch.randn(t.shape, generator=g,
                                           device="cuda") * 1e-3,
                     layer(meta, 0))
    ef = ef_state_init(grads)
    before = comm.host_staged_bytes()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mean, ef = compressed_psum_int8(grads, ef, "pod", pmesh)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    staged = comm.host_staged_bytes() - before
    t0 = time.perf_counter()
    exact = tree_map(lambda t: comm.psum(t, "pod", pmesh) / TMESH_RANKS,
                     grads)
    torch.cuda.synchronize()
    f32_ms = (time.perf_counter() - t0) * 1e3
    worst = 0.0
    for gl, m, e in zip(tree_leaves(grads), tree_leaves(mean),
                        tree_leaves(exact)):
        every = comm.all_gather(gl.abs().max().reshape(1), "pod", pmesh)
        tol = float(every.mean()) / 127
        err = max_abs_err(m, e)
        worst = max(worst, err / tol)
        if not err <= COMPRESS_STEPS * tol:
            raise AssertionError(f"compressed psum: {err} from the float32 "
                                 f"mean, bound {COMPRESS_STEPS * tol}")
    n = sum(t.numel() for t in tree_leaves(grads))
    leaves = len(tree_leaves(grads))
    return {"leaves": leaves, "elements": n,
            "worst_err_in_quant_steps": worst, "bound": COMPRESS_STEPS,
            "wire_bytes_a_member": n + 4 * leaves,
            "float32_bytes_a_member": 4 * n, "ms": ms, "float32_psum_ms":
            f32_ms, "host_staged_bytes": staged}


def _tmesh_rank(rank: int, store: str, out_dir: str, ref_path: str) -> None:
    """One rank of ``phase_train_mesh``: (a)-(c); the results to
    ``rank<r>.json``. Exits 1 on any failure."""
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    torch.set_num_threads(2)
    try:
        engine, kernels, _build, *_ = _import_port()
        _build.library()             # the parent's build, loaded
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.parallel import comm
        slice5 = _import_slice5()
        tr = _import_train()
        refs = torch.load(ref_path)
        mesh = make_mesh(TMESH_SHAPE, ("data", "model"), backend="gloo",
                         rank=rank, world_size=TMESH_RANKS, store_dir=store,
                         timeout_s=120.0)
        out, t = {"rank": rank}, {}
        for part, fn in (
                ("a", lambda: _tmesh_train(kernels, tr, slice5, mesh, rank,
                                           refs)),
                ("b", lambda: _tmesh_gpipe(make_mesh, rank)),
                ("c", lambda: _tmesh_compress(make_mesh, rank, slice5))):
            t0 = time.perf_counter()
            out[part] = fn()
            torch.cuda.empty_cache()
            t[part] = time.perf_counter() - t0
            if rank == 0:
                print(f"train mesh part ({part}): {t[part]:.1f} s on rank 0",
                      flush=True)
        out["seconds"] = t
        out["host_staged_bytes"] = comm.host_staged_bytes()
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    except Exception:
        import traceback
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    sys.stdout.flush()
    os._exit(0)


def phase_train_mesh(kernels, slice5, tr):
    """The training half of the mesh, 4 ranks on the one card (spawn,
    gloo: the collectives cross the host). The parent runs the one-process
    Moonlight steps (``_tmesh_reference``) and frees the card; then every
    rank runs (a) ``_tmesh_train`` on a (2, 2) ``("data", "model")`` mesh,
    (b) ``_tmesh_gpipe``, (c) ``_tmesh_compress``. Any rank's failure, or
    a rank still running at ``TMESH_LIMIT_S`` from the phase's start,
    fails the phase. Returns the line and K7's launches over the ranks."""
    import torch.multiprocessing as mp
    t_start = time.perf_counter()
    base, cfg, tcfg = _tmesh_cfg(tr, slice5[2])
    print(f"reduced: {TRAIN_MOE_ARCH} n_layers {base.n_layers} -> "
          f"{TRAIN_MOE_LAYERS} (training on the mesh)", flush=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ref = _tmesh_reference(kernels, tr, cfg, tcfg, per_shard=True)
    one_group = _tmesh_reference(kernels, tr, cfg, tcfg, per_shard=False)
    ref_s = time.perf_counter() - t_start
    store = tempfile.mkdtemp(prefix="tmesh_store_")
    out_dir = tempfile.mkdtemp(prefix="tmesh_out_")
    ref_path = os.path.join(out_dir, "ref.pt")
    torch.save({"per_shard": ref, "one_group": one_group}, ref_path)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_tmesh_rank,
                         args=(r, store, out_dir, ref_path))
             for r in range(TMESH_RANKS)]
    try:
        for p in procs:
            p.start()
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break               # a rank failed: stop the others now
            if time.perf_counter() - t_start > TMESH_LIMIT_S:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
    codes = [p.exitcode for p in procs]
    if codes != [0] * TMESH_RANKS:
        raise AssertionError(f"phase_train_mesh: rank exit codes {codes} "
                             f"after {time.perf_counter() - t_start:.1f} s")
    ranks = []
    for r in range(TMESH_RANKS):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    shutil.rmtree(store, ignore_errors=True)
    shutil.rmtree(out_dir, ignore_errors=True)
    k7 = sum(rk["a"]["launches"]["moe_route"] for rk in ranks)
    r0 = ranks[0]
    line = {
        "note": "4 ranks on one card, gloo: the collectives crossed the "
                "host",
        "train": f"{cfg.name} {TRAIN_MOE_LAYERS} of {base.n_layers} "
                 f"layers, {cfg.param_dtype}, remat, batch "
                 f"{TRAIN_MOE_BATCH} x {TRAIN_MOE_SEQ}, mesh (data 2, "
                 f"model 2), {cfg.n_experts // 2} experts a rank",
        "seconds": time.perf_counter() - t_start, "reference_s": ref_s,
        "rank_seconds": [rk["seconds"] for rk in ranks],
        "one_process": {k: ref[k] for k in (
            "losses", "grad_norms", "step_s", "k7_a_step", "state_gb")},
        "one_process_one_group": {k: one_group[k] for k in (
            "losses", "grad_norms", "step_s", "k7_a_step")},
        "a": r0["a"], "b": r0["b"], "c": r0["c"],
        "state_gb": [rk["a"]["state_gb"] for rk in ranks],
        "peak_gb": [rk["peak_gb"] for rk in ranks],
        "host_staged_bytes": [rk["host_staged_bytes"] for rk in ranks],
        "k7_launches": k7}
    print("train mesh: " + json.dumps(line), flush=True)
    return line, k7


def phase_train(kernels, slice5, tr):
    """``make_train_step`` on the ``qwen3_1p7b`` config at its widths and
    all 28 layers, bf16, remat on, batch 4 x 2048: finite losses and
    finite, non-zero gradient norms over 4 steps; step p50, tokens/s, peak
    memory and the model's FLOP rate (6 * parameters * tokens plus the
    attention's 12 * layers * heads * head_dim * seq_len a token); then
    one more step split into forward, backward and optimizer."""
    get_config = slice5[2]
    cfg = get_config(TRAIN_ARCH)
    if not cfg.remat or cfg.param_dtype != "bfloat16":
        raise AssertionError("train: expected remat and bf16")
    tcfg = tr.TrainConfig(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                          lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                          total_steps=TRAIN_STEPS, seed=SEED)
    model, step = tr.make_train_step(cfg, tcfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    opt = tr.adamw_init(params)
    data = tr.SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, SEED)
    n_par = sum(t.numel() for t in _leaves(params))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, step_s = [], [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, data.batch(i))
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(v) for v in losses + norms) or min(norms) <= 0:
        raise AssertionError(f"train: losses {losses}, grad norms {norms}")
    split, _, grads = _train_split(kernels, tr, model, params, opt,
                                   data.batch(TRAIN_STEPS), tcfg)
    del grads
    tokens = TRAIN_BATCH * TRAIN_SEQ
    p50 = _p50(step_s[1:])
    flops = (6 * n_par + 12 * cfg.n_layers * cfg.n_heads * cfg.hd
             * TRAIN_SEQ) * tokens
    line = {"train": f"{cfg.name} {cfg.n_layers} of {cfg.n_layers} layers, "
                     f"{cfg.param_dtype}, remat, batch {TRAIN_BATCH} x "
                     f"{TRAIN_SEQ}",
            "parameters": n_par, "losses": losses, "grad_norms": norms,
            "step_s": step_s, "step_p50_ms": p50 * 1e3,
            "tokens_per_s": tokens / p50,
            "max_memory_allocated_gb": peak / 1e9,
            "model_flops_per_step": flops,
            "model_tflop_s": flops / p50 / 1e12,
            "model_flops_share_of_bf16_peak": flops / p50 / BF16_OPS_PER_S,
            "split": split}
    print("train: " + json.dumps(line), flush=True)
    del params, opt, model, step
    torch.cuda.empty_cache()
    return line


def phase_chaos(engine, kernels, slice5, tr, gen):
    """The guard layer on the card. With ``enable_verify()``: ``sort``,
    ``argsort``, ``merge``, ``segment_sort``, ``merge_runs(tree_cuda)``
    and ``external_sort`` on their kernels, no failed check; a bit-flipped
    output fails ``check_permutation``; a ``failing_variant("sort")`` stub
    at the head of the plan demotes to the next rung (``cuda``), bit for
    bit that rung's output; ``poison_model`` under the scheduler retires
    the poisoned slot alone. Returns the summary line and the demotions
    it caused (the stub's one)."""
    obs, serve, get_config, planner, fallback, tf, build_model = slice5
    verify, inject = tr.verify, tr.inject
    n = 1 << 20
    x = torch.randn(n, generator=gen, device="cuda")
    a = torch.sort(torch.randn(n // 2, generator=gen, device="cuda"),
                   descending=True).values
    b = torch.sort(torch.randn(n // 2, generator=gen, device="cuda"),
                   descending=True).values
    _, offs = seg_offsets(n, gen, longest=SHORT_MAX)
    # no signed zeros: the key-only merges' max / min rule moves the sign
    # bit of a zero (ROADMAP queue 3), which the bit checksum would see
    runs, starts, lens = sorted_runs(ragged_lens(64, n, gen), gen,
                                     keys=tie_keys)
    roffs = torch.cat([starts, (starts[-1:] + lens[-1:])])
    xe = torch.randn(1 << 22, generator=gen, device="cuda")
    verify.reset_failures()
    verify.enable_verify()
    try:
        def ops():
            engine.sort(x)
            engine.argsort(x)
            engine.merge(a, b)
            engine.segment_sort(x, offs)
            engine.merge_runs(runs, roffs, variant="tree_cuda")
            return engine.external_sort(xe, tile_elems=1 << 20, fan_in=8)
        _, launches = counted(kernels, ops)
        checks, fails = verify.checked(), verify.failures()
        out = engine.sort(x)
        verify.check_permutation(x, inject.bitflip(out, 1e-3, seed=SEED),
                                 op="sort")
        flip_fails = verify.failures() - fails
    finally:
        verify.disable_verify()
        verify.reset_failures()
    need = ("sort_chunks", "sort_chunks_kv", "merge_tree_runs",
            "merge_tree_runs_kv", "flims_merge", "stream_merge_runs")
    missing = [k for k in need if not launches.get(k)]
    if fails or checks != 11 or flip_fails != 1 or missing:
        raise AssertionError(f"chaos verify: {checks} checks, {fails} "
                             f"failed, bit flip -> {flip_fails}, kernels "
                             f"never launched {missing}: {launches}")
    want = {"sort", "argsort", "merge", "segment_sort", "merge_runs",
            "external_sort"}
    before = fallback.demotions()
    with inject.failing_variant("sort") as name:
        got, stub_launches = counted(kernels,
                                     lambda: engine.sort(x, variant=name))
    demoted = fallback.demotions() - before
    ref = engine.sort(x, variant="cuda")
    if demoted != 1 or not bit_equal(got, ref) or not stub_launches:
        raise AssertionError(f"chaos stub: {demoted} demotions, launches "
                             f"{stub_launches}, equal {bit_equal(got, ref)}")
    # poison: a reduced float32 decoder on the card, one poisoned request
    # among three greedy ones, against the three served alone
    cfg = get_config("qwen3_1p7b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    greedy = serve.SamplingParams(temperature=0.0)
    prompts = [[1, 2, 10 * (i + 1)] for i in range(3)]
    kw = dict(n_slots=4, max_seq=64, prefill_len=8, top_k_width=8)
    good = [serve.Request(prompt=p, max_new_tokens=6, params=greedy, uid=i)
            for i, p in enumerate(prompts)]
    bad = serve.Request(prompt=[5, inject.POISON_TOKEN], max_new_tokens=6,
                        params=greedy, uid=3)
    done = {c.uid: c for c in serve.Scheduler(
        inject.poison_model(model), params, **kw).run(good + [bad])}
    alone = {c.uid: c for c in serve.Scheduler(model, params, **kw).run(
        [serve.Request(prompt=p, max_new_tokens=6, params=greedy, uid=i)
         for i, p in enumerate(prompts)])}
    if done[3].status != "ERROR" or done[3].tokens or any(
            done[i].status != "OK" or done[i].tokens != alone[i].tokens
            for i in range(3)):
        raise AssertionError("chaos poison: " + repr(done))
    line = {"chaos": "verify, bit flip, failing variant, poison",
            "verify_checks": checks, "verify_failures": fails,
            "ops": sorted(want), "kernel_launches": launches,
            "bitflip_failures": flip_fails,
            "stub_demotions": demoted, "stub_rung": "cuda",
            "stub_launches": stub_launches,
            "poisoned_status": done[3].status,
            "others_tokens_equal_alone": True}
    print("chaos: " + json.dumps(line), flush=True)
    return line, demoted


# --------------------------------------------------------------------------
# past one CTA's shared memory: K7 at any group, K1 / K5 / K6 at wide rows
# --------------------------------------------------------------------------
N_WIDE = 1 << 24               # K1's keys at rows past its 16384-key tile
N_WIDE_SEG = 1 << 22           # K5 / K6's keys at caps past one CTA
WIDE_ROWS = (32768, 65536)
WIDE_CAPS = {"segment_sort": (65536, 131072),
             "segment_sort_kv": (32768, 65536)}
# (G, T, E, k): Moonlight's router at 4096 and 65536 tokens (Np 32768 and
# 524288), and one group of 2^21 tokens, 131072 tiles of 16 (past a grid's
# y of 65535)
WIDE_ROUTES = ((1, 4096, 64, 6), (1, 65536, 64, 6), (1, 1 << 21, 8, 1))


def _wide_route_cap(T: int, E: int, k: int) -> int:
    return max(1, int(1.25 * T * k / E))


def phase_wide(engine, kernels, k1, slice2, gen):
    """K7, K1, K5 and K6 at shapes past one CTA's shared memory, which the
    port refused before: (a) the paths, counted: ``engine.moe_route``
    (default plan, fused) at ``WIDE_ROUTES`` against the ``torch`` variant;
    ``kernel_sort`` / ``kernel_argsort`` with K1's chunk at ``WIDE_ROWS``
    against ``torch.sort`` / ``torch.argsort(stable=True)``;
    ``engine.segment_sort`` / ``segment_argsort`` (``cuda_fused``) at
    ``WIDE_CAPS`` against the ``torch`` variant; (b) each kernel against
    its plain version on the card at those shapes, on NaN / +-0 keys; (c)
    each timed beside its plain version, a library call and its bound from
    ``launch.roofline``. Returns the launches of (a) and the rows of (c) by
    kernel name."""
    from repro_torch.kernels.ops import kernel_argsort, kernel_sort
    from repro_torch.launch import roofline as rl
    k7, k56 = slice2[3], slice2[4]
    xs = dup_keys(N_WIDE, gen)
    segs = {cap: seg_offsets(N_WIDE_SEG, gen, cap)
            for cap in sorted({c for cs in WIDE_CAPS.values() for c in cs})}
    tk = tie_keys(N_WIDE_SEG, gen)
    logits = {r: torch.randn(r[:3], generator=gen, device="cuda")
              for r in WIDE_ROUTES}

    def drive():
        out = {}
        for c in WIDE_ROWS:
            out["sort", c] = kernel_sort(xs, chunk=c)
            out["argsort", c] = kernel_argsort(xs, chunk=c)
        for name, caps in WIDE_CAPS.items():
            for cap in caps:
                offs = segs[cap][1]
                out[name, cap] = (
                    engine.segment_sort(tk, offs, cap=cap,
                                        variant="cuda_fused")
                    if name == "segment_sort" else
                    engine.segment_argsort(tk, offs, cap=cap,
                                           variant="cuda_fused"))
        for r, lg in logits.items():
            out["route", r] = engine.moe_route(lg, r[3],
                                               _wide_route_cap(*r[1:]))
        return out

    out, launches = counted(kernels, drive)
    ref_v = torch.sort(xs, descending=True).values
    ref_p = torch.argsort(xs, descending=True, stable=True).to(torch.int32)
    for c in WIDE_ROWS:
        if not torch.equal(out["sort", c], ref_v):
            raise AssertionError(f"kernel_sort chunk={c}: not torch.sort")
        check_same(f"kernel_argsort chunk={c}", out["argsort", c], ref_p)
    for name, caps in WIDE_CAPS.items():
        for cap in caps:
            offs = segs[cap][1]
            ref = (engine.segment_sort(tk, offs, cap=cap, variant="torch")
                   if name == "segment_sort" else
                   engine.segment_argsort(tk, offs, cap=cap, variant="torch"))
            check_same(f"{name} cap={cap} cuda_fused", out[name, cap], ref)
    for r, lg in logits.items():
        check_route(f"engine.moe_route {r[:3]} k={r[3]}", out["route", r],
                    engine.moe_route(lg, r[3], _wide_route_cap(*r[1:]),
                                     variant="torch"))
    need = ("sort_chunks", "sort_chunks_kv", "segment_sort",
            "segment_sort_kv", "moe_route")
    missing = [k for k in need if not launches.get(k)]
    if missing:
        raise AssertionError(f"wide path never launched {missing}: "
                             f"{launches}")
    print("wide: engine.moe_route (fused) at " + ", ".join(
        f"{r[:3]} k={r[3]}" for r in WIDE_ROUTES) + " equal to the torch "
        f"variant; kernel_sort / kernel_argsort at chunks {WIDE_ROWS} equal "
        "to torch.sort / torch.argsort(stable=True); segment_sort at caps "
        f"{WIDE_CAPS['segment_sort']} and segment_argsort at caps "
        f"{WIDE_CAPS['segment_sort_kv']} (cuda_fused) bit for bit the torch "
        "variant; launches " + json.dumps(launches), flush=True)

    # (b) and (c): kernel against plain on NaN / +-0 keys, then times
    rows = {}

    def row(fn, args, kw, lib, lib_call, nbytes, ops, **shape):
        bound_ms, bound_by = _bound(nbytes, ops)
        r = dict(shape, ms=time_ms(lambda: fn(*args, **kw)),
                 plain_ms=time_ms(lambda: plain_of(fn)(*args, **kw),
                                  warmup=1, reps=3),
                 bound_ms=bound_ms, bound_by=bound_by,
                 library_ms=time_ms(lib), library_call=lib_call)
        rows.setdefault(fn.__name__, []).append(r)
        print(f"time {fn.__name__} wide: " + json.dumps(r), flush=True)

    xn = nan_keys(N_WIDE, gen)
    rk = torch.arange(N_WIDE, dtype=torch.int32, device="cuda")
    for c in WIDE_ROWS:
        m = N_WIDE // c
        x, r = xn.view(m, c), rk.view(m, c)
        err = check_same(f"sort_chunks ({m}, {c})", k1.sort_chunks(x),
                         k1.sort_chunks_plain(x))
        for d in (True, False):
            err = max(err, check_same(
                f"sort_chunks_kv ({m}, {c}) desc={d}",
                k1.sort_chunks_kv(x, r, descending=d),
                k1.sort_chunks_kv_plain(x, r, descending=d)))
        net = m * c / 2 * math.log2(c) * (math.log2(c) + 1) / 2
        row(k1.sort_chunks, (x,), {}, lambda: torch.sort(x, dim=-1,
                                                         descending=True),
            "torch.sort(dim=-1)", rl.stream_bytes(N_WIDE, 4), net, rows=m,
            width=c, max_abs_err=err)
        row(k1.sort_chunks_kv, (x, r), {},
            lambda: torch.sort(x, dim=-1, descending=True, stable=True),
            "torch.sort(dim=-1, stable=True)", rl.stream_bytes(N_WIDE, 8),
            net, rows=m, width=c, max_abs_err=err)
    for name, caps in WIDE_CAPS.items():
        fn = getattr(k56, name)
        for cap in caps:
            lens, offs = segs[cap]
            x, _ = nan_segments(lens, gen)
            kws = [dict(cap=cap)] if name == "segment_sort" else \
                [dict(cap=cap, descending=d) for d in (True, False)]
            err = max(check_same(f"{name} cap={cap} {kw}", fn(x, offs, **kw),
                                 plain_of(fn)(x, offs, **kw)) for kw in kws)
            bank = k56.padded_bank(x, offs, cap)
            lanes = 2 if name == "segment_sort" else 3
            row(fn, (x, offs), dict(cap=cap),
                lambda: torch.sort(bank, dim=-1, stable=lanes == 3),
                "torch.sort over the padded (S, cap) bank",
                lanes * N_WIDE_SEG * 4 + (len(lens) + 1) * 4,
                _network_ops(lens), keys=N_WIDE_SEG, segments=len(lens),
                cap=cap, max_abs_err=err)
    for (G, T, E, k), lg in logits.items():
        cap = _wide_route_cap(T, E, k)
        err, u = check_route(f"moe_route {(G, T, E)} k={k}",
                             k7.moe_route(lg, k, cap),
                             k7.moe_route_plain(lg, k, cap))
        check_route(f"moe_route {(G, T, E)} k={k} vs torch",
                    k7.moe_route(lg, k, cap), k7.moe_route_torch(lg, k, cap))
        row(k7.moe_route, (lg, k, cap), {},
            lambda: k7.moe_route_torch(lg, k, cap),
            "moe_route_torch, the torch variant: no single torch call "
            "routes", G * rl.moe_route_bytes(T, E, k), G * T * k * (E + 2),
            shape=[G, T, E], k=k, max_abs_err=err, ulps=u)
    return launches, rows


DRYRUN_CELL = ("qwen3_1p7b", "train_4k")
DRYRUN_LIMIT_S = 60


def phase_dryrun():
    """The dry run at production shape: ``DRYRUN_CELL`` on rank 0 of the
    (data 16, model 16) mesh, counted on ``meta`` tensors (no card): an
    ``OK`` record with FLOPs, bytes, collective bytes by kind, memory and
    roofline terms, each above 0, within ``DRYRUN_LIMIT_S``."""
    from repro_torch.launch.dryrun import run_cell
    t0 = time.perf_counter()
    rec = run_cell(*DRYRUN_CELL, False, verbose=False)
    dt = time.perf_counter() - t0
    print("dryrun: " + json.dumps(rec), flush=True)
    roof = rec.get("roofline", {})
    if rec["status"] != "OK" or not (
            roof["flops"] > 0 and roof["hbm_bytes"] > 0
            and roof["coll_bytes"] > 0 and rec["memory"]["temp_gb"] > 0):
        raise AssertionError(f"dryrun {DRYRUN_CELL}: {rec}")
    if dt > DRYRUN_LIMIT_S:
        raise AssertionError(f"dryrun took {dt:.1f} s > {DRYRUN_LIMIT_S}")
    return rec


# (example, its arguments, its self-check lines); all five run at once
EXAMPLES = (("quickstart", [], 6), ("moe_routing", [], 2),
            ("serve_lm", [], 1), ("train_lm", ["--steps", "40"], 1),
            ("distributed_sort", ["--ranks", "4"], 3))
EXAMPLES_LIMIT_S = 240


def phase_examples():
    """The port's five examples (``python -m repro_torch.examples.<name>``)
    as subprocesses on the card, all started together: each exits 0 with
    every self-check line (``...: True``) true, as many as it prints."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    env = dict(os.environ, PYTHONPATH=src, GLOO_SOCKET_IFNAME="lo")
    check = re.compile(r":\s*(True|False)\s*$")
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for name, extra, n in EXAMPLES:
            if name == "train_lm":
                extra = extra + ["--ckpt", os.path.join(tmp, "ckpt")]
            procs.append((name, n, time.perf_counter(), subprocess.Popen(
                [sys.executable, "-m", f"repro_torch.examples.{name}",
                 "--device", "cuda", *extra], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True, env=env, cwd=tmp)))
        out = {}
        for name, n, t0, p in procs:
            try:
                so, se = p.communicate(timeout=EXAMPLES_LIMIT_S)
            except subprocess.TimeoutExpired:
                for *_, q in procs:
                    q.kill()
                raise AssertionError(f"example {name}: past "
                                     f"{EXAMPLES_LIMIT_S} s")
            checks = [m.group(1) for line in so.splitlines()
                      for m in [check.search(line)] if m]
            if p.returncode or checks != ["True"] * n:
                raise AssertionError(f"example {name}: exit {p.returncode}, "
                                     f"checks {checks}\n{so[-2000:]}"
                                     f"\n{se[-2000:]}")
            out[name] = {"seconds": round(time.perf_counter() - t0, 1),
                         "checks": len(checks)}
    print("examples: " + json.dumps(out), flush=True)
    return out


def timed(name: str, fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


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
    timed("build", phase_build, _build)
    launches, data = timed("main path", phase_main_path, engine, kernels,
                           gen)
    slice2 = _import_slice2()
    seg_launches, seg = timed("segments", phase_segments, engine, kernels,
                              gen)
    mix_launches, mix_errs, mix_routes, split = timed(
        "moe mixtral_8x22b", phase_moe, engine, kernels, slice2, gen,
        "mixtral_8x22b", [("grouped", 4, 2048), ("sorted", 1, 4096)],
        split=True)
    moon_launches, moon_errs, moon_routes, _ = timed(
        "moe moonshot_v1_16b_a3b", phase_moe, engine, kernels, slice2, gen,
        "moonshot_v1_16b_a3b", [(None, 4, 2048)], split=True)
    slice3 = _import_slice3()
    ext_launches, ext = timed("external", phase_external, engine, kernels,
                              slice3, data, gen)
    moe_k7 = mix_launches.get("moe_route", 0) + \
        moon_launches.get("moe_route", 0)
    print(f"K7 launches on the MoE path: {moe_k7} (mixtral "
          f"{mix_launches.get('moe_route', 0)}, moonlight "
          f"{moon_launches.get('moe_route', 0)})", flush=True)
    mods = (k1, k2, k3, k4)
    errs = timed("kernels vs plain", phase_kernels_vs_plain, mods, gen)
    # (logits, k, cap, K7 launches) of Mixtral's grouped and sorted runs
    # and Moonlight's grouped run
    route_logits = mix_routes + moon_routes
    errs2 = timed("slice 2 kernels vs plain", phase_slice2_vs_plain, slice2,
                  seg, route_logits, gen)
    errs2["moe_route"] = max(errs2["moe_route"], mix_errs[0], moon_errs[0])
    errs3 = timed("slice 3 kernels vs plain", phase_slice3_vs_plain, slice3,
                  gen)
    table = timed("times", phase_times, mods, launches, errs, data)
    launches2 = dict(seg_launches, moe_route=moe_k7)
    table += timed("slice 2 times", phase_slice2_times, slice2, launches2,
                   errs2, seg, route_logits)
    table += timed("slice 3 times", phase_slice3_times, slice3,
                   ext_launches, errs3, ext)
    timed("e2e times", phase_e2e_times, engine, data)
    timed("slice 2 e2e times", phase_slice2_e2e, engine, seg)
    timed("sorter split", phase_sorter_split, engine, data)
    timed("slice 3 e2e times", phase_slice3_e2e, engine, slice3, ext)
    timed("K1 shapes and chunk sweep", phase_k1_sweep, engine, kernels, k1,
          slice3, data, ext)
    wide_launches, wide_rows = timed("wide", phase_wide, engine, kernels, k1,
                                     slice2, gen)
    slice4 = _import_slice4()
    k9_launches, path_errs, ref = timed("sampling", phase_sampling, engine,
                                        kernels, slice4, gen)
    slice5 = _import_slice5()
    serve_k7, serve_k7_rows = timed("serve", phase_serve, engine, kernels,
                                    slice5, slice2)
    mesh_launches = timed("mesh", phase_mesh, kernels)
    timed("families", phase_families, slice5)
    timed("serve zamba2", phase_serve_zamba2, engine, kernels, slice5)
    tr = _import_train()
    train_moe, train_k7 = timed("train moe", phase_train_moe, engine,
                                kernels, slice5, tr)
    _, tmesh_k7 = timed("train mesh", phase_train_mesh, kernels, slice5,
                        tr)
    timed("train", phase_train, kernels, slice5, tr)
    timed("dryrun", phase_dryrun)
    timed("examples", phase_examples)
    _, chaos_demotions = timed("chaos", phase_chaos, engine, kernels, slice5,
                               tr, gen)
    errs4 = timed("K9 vs plain", phase_k9_vs_plain, slice4[0], gen)
    errs4 = {k: max(v, path_errs[k]) for k, v in errs4.items()}
    table += timed("slice 4 times", phase_slice4_times, slice4, k9_launches,
                   errs4, ref)
    for row in table:
        # the mesh phase's launches, summed over its 4 ranks; the wide
        # shapes' path, and the kernels' times there
        row["launches"] += mesh_launches.get(row["name"], 0) + \
            wide_launches.get(row["name"], 0)
        if row["name"] in wide_rows:
            row["wide"] = wide_rows.pop(row["name"])
        if row["name"] == "moe_route":
            # the serving and training paths' K7 launches, and K7 at its
            # route shapes
            row["launches"] += serve_k7 + train_k7 + tmesh_k7
            row["serve_shapes"] = serve_k7_rows
            row["train"] = dict(train_moe["k7"], launches=train_k7,
                                backward="plain torch (route_backward)")
            row["train_mesh"] = tmesh_k7
    if slice5[4].demotions() != chaos_demotions:
        raise AssertionError(f"{slice5[4].demotions()} fallback demotions, "
                             f"{chaos_demotions} of them injected")
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
