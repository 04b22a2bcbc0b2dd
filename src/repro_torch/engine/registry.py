"""Variant registry: which implementations serve each engine op.

Counterpart of ``repro/engine/registry.py`` for ``sort``, ``argsort``,
``merge`` and ``merge_runs``. Variant names map from the JAX package's:

    pallas       -> cuda        the hand-written CUDA kernels (K1-K4)
    tree_pallas  -> tree_cuda   the fused merge-tree schedule (K3/K4)
    xla          -> torch       torch built-ins, the reference
    ref, banked                 the FLiMS reference merges of core/flims.py

Every variant takes ``fn(*op_args, plan=Plan, ...)``. Dispatch goes straight
to the variant: a CUDA kernel that fails to build or launch raises, it is
never replaced by another variant behind the caller's back.
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

@register("merge", "ref")
def _merge_ref(a, b, *, plan):
    from repro_torch.core.flims import flims_merge_ref
    return flims_merge_ref(a, b, plan.w, tie=plan.tie)


@register("merge", "banked")
def _merge_banked(a, b, *, plan):
    from repro_torch.core.flims import flims_merge_banked
    return flims_merge_banked(a, b, plan.w, tie=plan.tie)


@register("merge", "cuda")
def _merge_cuda(a, b, *, plan):
    from repro_torch.kernels.flims_merge import flims_merge
    return flims_merge(a, b, w=plan.w, block_out=plan.block_out)


# --- sort: full descending sort of a 1-D tensor -----------------------------

@register("sort", "cuda")
def _sort_cuda(x, *, plan):
    from repro_torch.kernels.ops import kernel_sort
    return kernel_sort(x, chunk=plan.chunk, w=plan.w)


@register("sort", "torch")
def _sort_torch(x, *, plan):
    return torch.sort(x, descending=True, stable=True).values


# --- argsort: stable permutation (1-D, or 2-D row-wise) ---------------------

@register("argsort", "cuda")
def _argsort_cuda(keys, *, plan, descending):
    from repro_torch.kernels.ops import kernel_argsort
    return kernel_argsort(keys, chunk=plan.chunk, w=plan.w,
                          descending=descending)


@register("argsort", "torch")
def _argsort_torch(keys, *, plan, descending):
    return torch.argsort(keys, dim=-1, stable=True,
                         descending=descending).to(torch.int32)


# --- merge_runs: K sorted runs -> one, through a MergeSchedule ---------------

def _merge_runs_with(variant):
    def fn(keys, offsets, *, plan, descending, ranks=None):
        from repro_torch.engine.schedule import MergeSchedule, merge_runs
        sched = MergeSchedule.from_plan(plan, variant=variant)
        return merge_runs(keys, offsets, ranks=ranks, schedule=sched,
                          descending=descending)
    return fn


for _v in ("torch", "tree_cuda"):
    register("merge_runs", _v)(_merge_runs_with(_v))
