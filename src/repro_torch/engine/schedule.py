"""Merge schedules: one description of how K sorted runs reduce to one.

Counterpart of ``repro/engine/schedule.py`` for the executors of this
slice:

- ``torch``      one shot per group: a stable ``torch.sort`` of each group
                 (counterpart of the ``xla`` executor, the reference);
- ``tree_cuda``  fused passes (counterpart of ``tree_pallas``): each pass
                 collapses ``levels_per_pass`` tree levels per group in one
                 launch, the merge-tree kernel K4 at two or more levels and
                 the segmented pair kernel K3 at one, so a reduction takes
                 ``ceil(log2 K / levels_per_pass)`` passes.

The calling convention is grouped contiguous runs: a flat buffer of ``R``
sorted runs with ``(R+1,)`` offsets, consecutive ``runs_per_group`` runs
forming one reduction. With ``ranks=`` every executor orders ties by the
compound ``(key, rank asc)`` order. ``tree_cuda`` sorts KV lanes ascending
natively; key-only ascending calls are mirrored (runs reversed per segment).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import obs
from repro_torch.core.flims import next_pow2
from repro_torch.core.lanes import INVALID_RANK
from repro_torch.engine import segments
from repro_torch.kernels.flims_merge import _exclusive_cumsum, bound_keys

#: mirror pivot for the ascending rank trick (INVALID_RANK stays padding)
_RANK_MIRROR = INVALID_RANK - 1

_VARIANTS = ("torch", "tree_cuda")


@dataclasses.dataclass(frozen=True)
class MergeSchedule:
    """How K sorted runs become one: executor, fused-pass depth, tiles."""
    variant: str = "torch"
    levels_per_pass: int = 1
    w: int = 32
    block_out: int = 1024

    def __post_init__(self):
        if self.variant not in _VARIANTS:
            raise ValueError(f"executor {self.variant!r} not in {_VARIANTS}")
        if self.levels_per_pass < 1:
            raise ValueError(f"bad schedule {self}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_plan(cls, plan, variant: Optional[str] = None) -> "MergeSchedule":
        """Lift an engine ``Plan`` into a schedule; ``variant`` overrides."""
        v = variant or plan.variant
        if v not in _VARIANTS:
            v = "torch"
        return cls(variant=v, levels_per_pass=plan.levels, w=plan.w,
                   block_out=plan.block_out)


def _mirror(keys, offsets, ranks):
    """Reverse every run (and flip rank priorities): the descending merge of
    the mirror, un-mirrored per group, is the ascending merge."""
    n = keys.shape[0]
    rev_k = segments.reverse_segments(keys, offsets, n)
    if ranks is None:
        return rev_k, None
    return rev_k, segments.reverse_segments(_RANK_MIRROR - ranks, offsets, n)


def _unmirror(keys, ranks, group_offsets):
    """Undo ``_mirror`` on the merged output, group by group."""
    n = keys.shape[0]
    k = segments.reverse_segments(keys, group_offsets, n)
    if ranks is None:
        return k
    return k, segments.reverse_segments(_RANK_MIRROR - ranks, group_offsets,
                                        n)


def _pad_group_runs(offsets, m: int, m2: int):
    """Extend each group's ``m`` runs with ``m2 - m`` empty runs (start =
    group end). Returns flat (R2,) int32 starts and lens."""
    starts = offsets[:-1].reshape(-1, m)
    lens = torch.diff(offsets).reshape(-1, m)
    gend = offsets[m::m].reshape(-1, 1)
    pad_s = gend.expand(starts.shape[0], m2 - m)
    starts = torch.cat([starts, pad_s], dim=1).reshape(-1)
    lens = torch.cat([lens, lens.new_zeros(lens.shape[0], m2 - m)],
                     dim=1).reshape(-1)
    return starts.to(torch.int32), lens.to(torch.int32)


def _torch_reduce(keys, offsets, ranks, m: int, descending: bool):
    """One-shot per-group sort. Key-only: XLA's directional sort. KV:
    order rows by rank, then stably by key, so ties land in rank order."""
    from repro_torch.kernels.ref import stable_sort_values
    from repro_torch.kernels.segmented_merge import padded_bank, unpad_bank
    n = keys.shape[0]
    goff = offsets[::m]
    cap = segments.static_cap(goff, n)
    _, last_k = bound_keys(keys.dtype, descending)
    kb = padded_bank(keys, goff, cap, fill=last_k)
    if ranks is None:
        return unpad_bank(stable_sort_values(kb, descending=descending), goff,
                          n)
    rb = padded_bank(ranks, goff, cap, fill=INVALID_RANK)
    p1 = torch.argsort(rb, dim=-1, stable=True)
    kb1 = torch.gather(kb, -1, p1)
    p2 = torch.argsort(kb1, dim=-1, stable=True, descending=descending)
    perm = torch.gather(p1, -1, p2)
    return (unpad_bank(torch.gather(kb, -1, perm), goff, n),
            unpad_bank(torch.gather(rb, -1, perm), goff, n))


def _cuda_reduce(keys, offsets, ranks, m: int, sched: MergeSchedule,
                 descending: bool):
    """Fused passes: each collapses ``2^levels_per_pass`` runs per group in
    one launch (K3 at one level, K4 at two or more). No host sync: every
    shape is known from ``n`` and the run count."""
    from repro_torch.kernels.merge_tree import (merge_tree_runs,
                                                merge_tree_runs_kv)
    from repro_torch.kernels.segmented_merge import (segmented_merge_runs,
                                                     segmented_merge_runs_kv)
    n = keys.shape[0]
    m2 = next_pow2(m)
    levels_total = m2.bit_length() - 1
    passes = 0
    starts, lens = _pad_group_runs(offsets, m, m2)
    buf, rbuf = keys, ranks
    while m2 > 1:
        Lp = min(sched.levels_per_pass, m2.bit_length() - 1)
        groups = max(starts.shape[0] >> Lp, 1)
        bo = max(sched.w, min(sched.block_out, next_pow2(-(-n // groups))))
        passes += 1
        obs.event("schedule.pass", executor="tree_cuda", levels=int(Lp),
                  runs=int(starts.shape[0]), n=int(n), block_out=int(bo),
                  kv=rbuf is not None)
        with obs.kernel_scope(f"schedule.pass_L{Lp}"):
            if Lp == 1:
                if rbuf is None:
                    buf = segmented_merge_runs(
                        buf, buf, starts[0::2], lens[0::2], starts[1::2],
                        lens[1::2], n_out=n, w=sched.w, block_out=bo)
                else:
                    buf, rbuf = segmented_merge_runs_kv(
                        buf, rbuf, buf, rbuf, starts[0::2], lens[0::2],
                        starts[1::2], lens[1::2], n_out=n, w=sched.w,
                        block_out=bo, descending=descending)
            elif rbuf is None:
                buf = merge_tree_runs(buf, starts, lens, group=1 << Lp,
                                      n_out=n, w=sched.w, block_out=bo)
            else:
                buf, rbuf = merge_tree_runs_kv(
                    buf, rbuf, starts, lens, group=1 << Lp, n_out=n,
                    w=sched.w, block_out=bo, descending=descending)
        lens = lens.reshape(-1, 1 << Lp).sum(1, dtype=torch.int32)
        starts = _exclusive_cumsum(lens)[:-1]
        m2 >>= Lp
    obs.event("schedule.reduce", executor="tree_cuda", passes=passes,
              levels_total=levels_total,
              hbm_trips_saved=levels_total - passes, n=int(n),
              kv=ranks is not None)
    return buf if rbuf is None else (buf, rbuf)


def merge_runs(keys, offsets, *, ranks=None, schedule: MergeSchedule,
               runs_per_group: Optional[int] = None, descending: bool = True):
    """Reduce grouped contiguous sorted runs to one sorted run per group.

    ``keys`` is the flat concatenation of ``R`` runs with boundaries
    ``offsets`` ((R+1,)), each sorted in the call's direction; consecutive
    ``runs_per_group`` runs (default: all) reduce independently. With
    ``ranks=`` (int32) the reduction is the stable compound-order merge and
    returns ``(keys, ranks)``.
    """
    offsets = offsets.to(device=keys.device, dtype=torch.int32)
    K = offsets.shape[0] - 1
    m = runs_per_group or max(K, 1)
    if K % max(m, 1):
        raise ValueError("run count must divide into equal groups")
    n = keys.shape[0]
    if ranks is not None:
        ranks = ranks.to(torch.int32)
    if K <= 1 or m == 1 or n == 0:
        return keys if ranks is None else (keys, ranks)

    sched = schedule
    if not descending and sched.variant == "tree_cuda" and ranks is None:
        keys, ranks = _mirror(keys, offsets, ranks)
        out = merge_runs(keys, offsets, ranks=ranks, schedule=sched,
                         runs_per_group=m, descending=True)
        return _unmirror(out, None, offsets[::m])

    levels_total = next_pow2(m).bit_length() - 1
    if sched.variant == "torch":
        obs.event("schedule.reduce", executor="torch", passes=1,
                  levels_total=levels_total, hbm_trips_saved=levels_total - 1,
                  n=int(n), kv=ranks is not None)
        with obs.kernel_scope("schedule.torch_reduce"):
            return _torch_reduce(keys, offsets, ranks, m, descending)
    return _cuda_reduce(keys, offsets, ranks, m, sched, descending)


def reduce_rows(rows, *, schedule: MergeSchedule, ranks=None,
                runs_per_group: Optional[int] = None,
                descending: bool = True):
    """Merge the K rows of a ``(K, n)`` bank (each a sorted run) per group
    of ``runs_per_group`` rows. Returns the flat merged groups (and ranks)."""
    K, n = rows.shape
    offsets = torch.arange(K + 1, dtype=torch.int32, device=rows.device) * n
    return merge_runs(rows.reshape(-1), offsets,
                      ranks=None if ranks is None else ranks.reshape(-1),
                      schedule=schedule, runs_per_group=runs_per_group,
                      descending=descending)
