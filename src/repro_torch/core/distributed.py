"""Distributed sorting across a mesh axis (paper §8.2, scaled out):
counterpart of ``repro/core/distributed.py``.

The paper parallelises FLiMS mergesort across CPU threads: sort in chunks
on every core, then parallel merge passes. Across ranks the same
structure is a sample sort:

  1. every rank FLiMS-sorts its local shard              (compute-bound)
  2. splitter selection -> (P-1,) global splitters
  3. bucket partition by searchsorted + one all_to_all    (collective-bound)
  4. every rank PMT-merges the P sorted runs it received  (paper fig. 1)

Rank p ends with the p-th descending value range, so the concatenation in
axis order is globally sorted. Buckets are sentinel-padded to a fixed cap;
``count`` gives the true sizes and ``overflow`` flags a cap overrun. The
machinery is ``engine.sharded`` (the cap-doubling ladder of ``retries``
rungs, decided before the exchange); :func:`sample_sort` is the
paper-facing wrapper with regular splitter sampling, and
``engine.sharded_sort`` / ``engine.sharded_topk`` add plan caching,
autotuning and histogram-refined splitters. With ``payload=`` the local
sort is the stable KV sort and the payload rows travel beside the keys: a
distributed argsort is ``payload=global_indices``.
"""
from __future__ import annotations

from repro_torch.engine.sharded import ShardedSort, run_sharded_sort

__all__ = ["ShardedSort", "sample_sort"]


def sample_sort(x, mesh, axis: str = "data", w: int = 32,
                cap_factor: int = 4, payload=None, merge_schedule=None,
                retries: int = 2, splitter: str = "regular"):
    """Sort this rank's shard ``x`` of a 1-D array split over ``axis``.
    Descending.

    Returns this rank's padded run (a ``ShardedSort``); the runs in axis
    order concatenate to the global descending order. With ``payload=`` (a
    tensor or tree of tensors shaped like ``x``) returns ``(ShardedSort,
    payload)``, each leaf permuted identically to the keys, ties in input
    order (algorithm 3). ``cap_factor`` sets the base bucket cap; up to
    ``retries`` cap doublings recover an overflow before the exchange
    (``retries=0`` leaves the flag meaningful). ``merge_schedule`` (an
    ``engine.schedule.MergeSchedule``) selects step 4's executor, default
    the per-level lane-merge tree at ``w``.
    """
    from repro_torch.engine.schedule import schedule_or
    # the caller's w drives the local sort and splitters; an explicit
    # merge_schedule keeps its own tiles for the step-4 reduction
    plan = schedule_or(merge_schedule, w).to_plan(
        cap_factor=cap_factor, retries=retries, splitter=splitter).replace(
        w=w)
    return run_sharded_sort(x, mesh, axis, payload=payload, plan=plan,
                            schedule=merge_schedule)
