"""Variant registry: which implementations serve each engine op.

Counterpart of ``repro/engine/registry.py`` for ``sort``, ``argsort``,
``merge``, ``merge_runs``, ``topk``, ``sample_topp``, ``sample_minp``,
``segment_sort``, ``segment_argsort``, ``segment_merge``, ``moe_route`` and
``external_sort``. Variant names map from the JAX package's:

    pallas            -> cuda            the hand-written CUDA kernels
    tree_pallas       -> tree_cuda       the fused merge-tree schedule (K3/K4)
    pallas_fused      -> cuda_fused      one-launch segment sorts (K5/K6)
    pallas_two_phase  -> cuda_two_phase  K1 rows, then the tree_cuda schedule
    fused             -> fused           the routing megakernel (K7)
    stream_pallas     -> stream_cuda     streamed run-merge passes (K8)
    stream_xla        -> stream_torch    the same passes in plain torch
    xla               -> torch           torch built-ins, the reference
    ref, banked                          the FLiMS reference merges
    ref (sort), flims                    the reference sorters of core/
                                         (mergesort, topk) over tree_vmapped
    tree_vmapped                         the per-level lane-merge tree (K9)

Every variant takes ``fn(*op_args, plan=Plan, ...)``. The engine api
dispatches through ``guard.fallback.guarded_call``, which moves a call to
the next variant only when it runs out of device memory: a CUDA kernel that
fails to build or launch, or a shape the fused kernels cannot take, raises;
it is never replaced by another variant behind the caller's back.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

_REGISTRY: Dict[str, Dict[str, Callable]] = {}


def register(op: str, name: str):
    def deco(fn):
        _REGISTRY.setdefault(op, {})[name] = fn
        return fn
    return deco


def unregister(op: str, name: str) -> None:
    """Remove a registered variant (``guard.inject.failing_variant``'s stubs
    leave through this; an unknown name is a no-op)."""
    _REGISTRY.get(op, {}).pop(name, None)


def get(op: str, name: str) -> Callable:
    try:
        return _REGISTRY[op][name]
    except KeyError:
        raise KeyError(f"no variant {name!r} for op {op!r}; known: "
                       f"{sorted(_REGISTRY.get(op, {}))}") from None


def call(op: str, name: str, *args, **kw):
    """Dispatch ``op`` to variant ``name`` inside a profiler range
    ``repro.engine.<op>.<name>`` and, while ``obs`` is enabled, an
    ``engine.<op>.<name>`` span (which waits for the device when
    ``obs.configure(block=True)``)."""
    from repro_torch import obs
    fn = get(op, name)
    if not obs.enabled():
        with obs.kernel_scope(f"engine.{op}.{name}"):
            return fn(*args, **kw)
    with obs.span(f"engine.{op}.{name}"):
        out = fn(*args, **kw)
        if obs.blocking() and torch.cuda.is_available():
            torch.cuda.synchronize()
        return out


def variants(op: str):
    return tuple(sorted(_REGISTRY.get(op, {})))


# --- merge: two descending 1-D tensors -> one ------------------------------
# ``ranks=(ra, rb)`` makes the merge stable through int32 rank lanes (A
# first on ties, then by position) and returns ``(keys, ranks)``.

def _merge_kv_lanes(a, b, ranks, plan):
    from repro_torch.core.flims import flims_merge_kv_stable
    keys, vals = flims_merge_kv_stable(a, {"r": ranks[0]}, b,
                                       {"r": ranks[1]}, w=plan.w)
    return keys, vals["r"]


@register("merge", "ref")
def _merge_ref(a, b, *, plan, ranks=None):
    if ranks is not None:
        return _merge_kv_lanes(a, b, ranks, plan)
    from repro_torch.core.flims import flims_merge_ref
    return flims_merge_ref(a, b, plan.w, tie=plan.tie)


@register("merge", "banked")
def _merge_banked(a, b, *, plan, ranks=None):
    if ranks is not None:
        return _merge_kv_lanes(a, b, ranks, plan)
    from repro_torch.core.flims import flims_merge_banked
    return flims_merge_banked(a, b, plan.w, tie=plan.tie)


@register("merge", "cuda")
def _merge_cuda(a, b, *, plan, ranks=None):
    from repro_torch.kernels.flims_merge import flims_merge, flims_merge_kv
    if ranks is not None:
        return flims_merge_kv(a, ranks[0], b, ranks[1], w=plan.w,
                              block_out=plan.block_out)
    return flims_merge(a, b, w=plan.w, block_out=plan.block_out)


# --- sort: full descending sort of a 1-D tensor -----------------------------

@register("sort", "ref")
def _sort_ref(x, *, plan):
    from repro_torch.core.mergesort import flims_sort
    return flims_sort(x, chunk=plan.chunk, w=plan.w)


@register("sort", "cuda")
def _sort_cuda(x, *, plan):
    from repro_torch.kernels.ops import kernel_sort
    return kernel_sort(x, chunk=plan.chunk, w=plan.w)


@register("sort", "torch")
def _sort_torch(x, *, plan):
    from repro_torch.kernels.ref import stable_sort_values
    return stable_sort_values(x, descending=True)


# --- argsort: stable permutation (1-D, or 2-D row-wise) ---------------------

@register("argsort", "cuda")
def _argsort_cuda(keys, *, plan, descending):
    from repro_torch.kernels.ops import kernel_argsort
    return kernel_argsort(keys, chunk=plan.chunk, w=plan.w,
                          descending=descending)


@register("argsort", "flims")
def _argsort_flims(keys, *, plan, descending):
    # a (B, n) batch is one grouped reduction of every row's chunks
    from repro_torch.core.mergesort import flims_argsort
    return flims_argsort(keys, chunk=plan.chunk, w=plan.w,
                         descending=descending)


@register("argsort", "torch")
def _argsort_torch(keys, *, plan, descending):
    return torch.argsort(keys, dim=-1, stable=True,
                         descending=descending).to(torch.int32)


# --- topk: (values, indices) of the k largest along the trailing axis -------

@register("topk", "flims")
def _topk_flims(x, k, *, plan, values=None):
    from repro_torch.core.topk import flims_topk
    return flims_topk(x, k, values=values)


def _monotone_bits(x):
    """Integer keys whose order is the float total order of ``x`` (+0.0
    above -0.0, a NaN above +inf or, with its sign bit set, below -inf);
    bf16 / f16 go through float32, integer keys stay as they are."""
    if not x.dtype.is_floating_point:
        return x
    if x.dtype == torch.float64:
        b = x.contiguous().view(torch.int64)
        return b ^ ((b >> 63) & 0x7FFFFFFFFFFFFFFF)
    from repro_torch.kernels.route_fuse import untwist
    return untwist(x.float().contiguous().view(torch.int32))


_SAME_SIZE_INT = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def _gather_bits(x, idx):
    """``torch.gather`` along the last axis that keeps every bit of float
    elements (the CPU gather rewrites bf16 NaNs as 0xFFFF)."""
    if not x.dtype.is_floating_point:
        return torch.gather(x, -1, idx)
    as_int = _SAME_SIZE_INT[x.element_size()]
    return torch.gather(x.contiguous().view(as_int), -1, idx).view(x.dtype)


@register("topk", "torch")
def _topk_torch(x, k, *, plan, values=None):
    # lax.top_k's order: a stable descending sort of the monotone bits and a
    # slice, so floats rank by their total order and ties go to the lower
    # index (a stable sort of the floats would tie -0.0 with +0.0 and put
    # every NaN first; torch.topk promises no tie order at all)
    from repro_torch.core.butterfly import tree_map
    idx = torch.sort(_monotone_bits(x), dim=-1, descending=True,
                     stable=True).indices[..., :k]
    vals = _gather_bits(x, idx)
    if values is None:
        return vals, idx.to(torch.int32)
    pay = tree_map(lambda v: torch.gather(v, -1, idx), values)
    return vals, idx.to(torch.int32), pay


# --- sample_topp / sample_minp: a mask over the sorted prefix ----------------
# The variant names the stable descending argsort of the whole row; the
# nucleus / min-p cut and the Gumbel-max draw are shared elementwise math,
# so the variants agree bit for bit.

def _sample_sorted_prefix(generator, logits, perm, *, temperature, top_p,
                          min_p, u):
    from repro_torch.serve.sampler import SamplingState, sorted_prefix_sample
    state = SamplingState.full(logits.shape[0], temperature=temperature,
                               top_p=top_p, min_p=min_p,
                               device=logits.device)
    svals = torch.gather(logits, -1, perm.long())
    return sorted_prefix_sample(generator, svals, perm, state, u=u)


def _full_sort_perm(variant, logits, plan):
    if variant == "flims":
        from repro_torch.core.mergesort import flims_argsort
        return flims_argsort(logits, chunk=plan.chunk, w=plan.w)
    return torch.argsort(logits, dim=-1, stable=True,
                         descending=True).to(torch.int32)


def _sample_with(variant, nucleus: bool):
    def fn(generator, logits, knob, *, plan, temperature=1.0, u=None):
        perm = _full_sort_perm(variant, logits, plan)
        return _sample_sorted_prefix(
            generator, logits, perm, temperature=temperature,
            top_p=knob if nucleus else 1.0, min_p=0.0 if nucleus else knob,
            u=u)
    return fn


for _v in ("flims", "torch"):
    register("sample_topp", _v)(_sample_with(_v, True))
    register("sample_minp", _v)(_sample_with(_v, False))


# --- merge_runs: K sorted runs -> one, through a MergeSchedule ---------------

def _merge_runs_with(variant):
    def fn(keys, offsets, *, plan, descending, ranks=None):
        from repro_torch.engine.schedule import MergeSchedule, merge_runs
        sched = MergeSchedule.from_plan(plan, variant=variant)
        return merge_runs(keys, offsets, ranks=ranks, schedule=sched,
                          descending=descending)
    return fn


for _v in ("torch", "tree_vmapped", "tree_cuda", "stream_cuda",
           "stream_torch"):
    register("merge_runs", _v)(_merge_runs_with(_v))


# --- external_sort: the two-phase out-of-core sort --------------------------

def _external_sort(keys, *, plan, descending, ranks=None):
    from repro_torch.engine.external import run_external_sort
    return run_external_sort(keys, plan=plan, descending=descending,
                             ranks=ranks)


for _v in ("torch", "stream_cuda"):
    register("external_sort", _v)(_external_sort)


# --- segment_merge: ragged batch of 2-way merges ----------------------------

@register("segment_merge", "cuda")
def _segment_merge_cuda(a, ao, b, bo, *, plan):
    from repro_torch.kernels.segmented_merge import segmented_merge
    return segmented_merge(a, ao, b, bo, w=plan.w, block_out=plan.block_out)


@register("segment_merge", "torch")
def _segment_merge_torch(a, ao, b, bo, *, plan):
    from repro_torch.engine.segments import segment_merge_ref
    return segment_merge_ref(a, ao, b, bo)


# --- segment_sort: ragged batch of descending sorts --------------------------

@register("segment_sort", "cuda_fused")
def _segment_sort_fused(values, offsets, *, plan):
    from repro_torch.kernels.segmented_merge import segment_sort
    return segment_sort(values, offsets, cap=plan.cap)


@register("segment_sort", "cuda_two_phase")
def _segment_sort_two_phase(values, offsets, *, plan):
    from repro_torch.kernels.segmented_merge import segment_sort_two_phase
    return segment_sort_two_phase(values, offsets, cap=plan.cap,
                                  chunk=min(plan.chunk, plan.cap), w=plan.w,
                                  levels=plan.levels)


@register("segment_sort", "torch")
def _segment_sort_torch(values, offsets, *, plan):
    from repro_torch.engine.segments import segment_sort_ref
    return segment_sort_ref(values, offsets, cap=plan.cap)


# --- segment_argsort: ragged batch of stable local argsorts ------------------

@register("segment_argsort", "cuda_fused")
def _segment_argsort_fused(keys, offsets, *, plan, descending):
    from repro_torch.kernels.segmented_merge import segment_argsort
    return segment_argsort(keys, offsets, cap=plan.cap,
                           descending=descending)


@register("segment_argsort", "cuda_two_phase")
def _segment_argsort_two_phase(keys, offsets, *, plan, descending):
    from repro_torch.kernels.segmented_merge import segment_argsort_two_phase
    return segment_argsort_two_phase(keys, offsets, cap=plan.cap,
                                     chunk=min(plan.chunk, plan.cap),
                                     w=plan.w, descending=descending,
                                     levels=plan.levels)


@register("segment_argsort", "torch")
def _segment_argsort_torch(keys, offsets, *, plan, descending):
    from repro_torch.engine.segments import segment_argsort_ref
    return segment_argsort_ref(keys, offsets, cap=plan.cap,
                               descending=descending)


# --- moe_route: router logits -> permuted capacity slabs ---------------------

@register("moe_route", "fused")
def _moe_route_fused(logits, k, capacity, *, plan):
    from repro_torch.kernels.route_fuse import moe_route
    return moe_route(logits, k, capacity)


@register("moe_route", "torch")
def _moe_route_torch(logits, k, capacity, *, plan):
    from repro_torch.kernels.route_fuse import moe_route_torch
    return moe_route_torch(logits, k, capacity)
