"""Merge schedules: one description of how K sorted runs reduce to one.

Counterpart of ``repro/engine/schedule.py`` for the executors of this
slice:

- ``torch``      one shot per group: a stable ``torch.sort`` of each group
                 (counterpart of the ``xla`` executor, the reference);
- ``tree_vmapped`` the classic per-level tree (counterpart of the JAX
                 package's ``tree_vmapped``): every run pair of a level merges
                 by the FLiMS lane merge, one launch of K9 a level on the card
                 (``kernels/lane_merge.py``), so a reduction takes ``log2 K``
                 launches; the default of the reference sorters
                 (``schedule_or``) and the only executor that reads ``tie``;
- ``tree_cuda``  fused passes (counterpart of ``tree_pallas``): each pass
                 collapses ``levels_per_pass`` tree levels per group in one
                 launch, the merge-tree kernel K4 at two or more levels and
                 the segmented pair kernel K3 at one, so a reduction takes
                 ``ceil(log2 K / levels_per_pass)`` passes;
- ``stream_cuda`` the device-resident level kind (counterpart of
                 ``stream_pallas``): runs are made uniform once, then each
                 pass is one launch of the streaming kernel K8 merging
                 ``fan_in = 2^levels_per_pass`` runs per group, its output
                 carrying the slack the next pass reads;
- ``stream_torch`` the same pass structure in plain torch (counterpart of
                 ``stream_xla``): each pass is ``log2(fan_in)`` rounds of
                 vectorised binary-search pair merges.

The calling convention is grouped contiguous runs: a flat buffer of ``R``
sorted runs with ``(R+1,)`` offsets, consecutive ``runs_per_group`` runs
forming one reduction. With ``ranks=`` every executor orders ties by the
compound ``(key, rank asc)`` order. ``tree_cuda`` and the stream executors
sort KV lanes ascending natively; their key-only ascending calls are
mirrored (runs reversed per segment), and so are all of ``tree_vmapped``'s,
whose lane merge is descending only (ranks mirrored around
``INVALID_RANK - 1``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import obs
from repro_torch.core.flims import next_pow2
from repro_torch.core.lanes import INVALID_RANK, sentinel_for
from repro_torch.engine import segments
from repro_torch.kernels.flims_merge import (_exclusive_cumsum, bound_keys,
                                             lane_first)

#: mirror pivot for the ascending rank trick (INVALID_RANK stays padding)
_RANK_MIRROR = INVALID_RANK - 1

_VARIANTS = ("torch", "tree_vmapped", "tree_cuda", "stream_cuda",
             "stream_torch")

#: executors whose passes read device-resident uniform runs
STREAM_VARIANTS = ("stream_cuda", "stream_torch")


@dataclasses.dataclass(frozen=True)
class MergeSchedule:
    """How K sorted runs become one: executor, fused-pass depth, tiles and
    the selector's tie policy (``'b'``: algorithm 1; ``'skew'``: algorithm
    2, read by ``tree_vmapped`` on key-only lanes)."""
    variant: str = "torch"
    levels_per_pass: int = 1
    w: int = 32
    block_out: int = 1024
    tie: str = "b"

    def __post_init__(self):
        if self.variant not in _VARIANTS:
            raise ValueError(f"executor {self.variant!r} not in {_VARIANTS}")
        if self.levels_per_pass < 1 or self.tie not in ("b", "skew"):
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
                   block_out=plan.block_out, tie=plan.tie)


def schedule_or(schedule: Optional[MergeSchedule], w: int,
                tie: str = "b") -> MergeSchedule:
    """The reference sorters' default: the per-level lane-merge tree at
    ``w``."""
    if schedule is not None:
        return schedule
    return MergeSchedule("tree_vmapped", w=w, tie=tie)


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


def _vmapped_reduce(keys, offsets, ranks, m: int, sched: MergeSchedule,
                    uniform_len: Optional[int] = None):
    """The per-level tree, descending only: rows of uniform length (the
    runs as they are when uniform, else a padded bank), each group
    completed to a power of two with sentinel runs, then one lane merge of
    every row pair a level (K9 on the card)."""
    from repro_torch.kernels.lane_merge import lane_merge_level
    from repro_torch.kernels.segmented_merge import padded_bank, unpad_bank
    n = keys.shape[0]
    K = offsets.shape[0] - 1
    n_groups = K // m
    ulen = uniform_len if uniform_len is not None else _uniform_len(offsets)
    if ulen is not None:
        krows = keys.reshape(K, ulen)
        rrows = None if ranks is None else ranks.reshape(K, ulen)
    else:
        cap = segments.static_cap(offsets, n)
        krows = padded_bank(keys, offsets, cap)
        rrows = None if ranks is None else padded_bank(ranks, offsets, cap,
                                                       fill=INVALID_RANK)
    m2 = next_pow2(m)
    cap = krows.shape[1]
    if m2 != m:                          # sentinel runs complete each group
        pad = krows.new_full((n_groups, m2 - m, cap), sentinel_for(keys.dtype))
        krows = torch.cat([krows.reshape(n_groups, m, cap), pad],
                          dim=1).reshape(n_groups * m2, cap)
        if rrows is not None:
            rpad = rrows.new_full((n_groups, m2 - m, cap), INVALID_RANK)
            rrows = torch.cat([rrows.reshape(n_groups, m, cap), rpad],
                              dim=1).reshape(n_groups * m2, cap)
    buf = krows.reshape(-1)
    rbuf = None if rrows is None else rrows.reshape(-1)
    rows, L = n_groups * m2, cap
    while rows > n_groups:
        buf, rbuf = lane_merge_level(buf, rbuf, L, w=sched.w,
                                     tie=sched.tie if rbuf is None else "b")
        rows, L = rows // 2, 2 * L
    # each group's valid prefix back to the flat layout
    glen = torch.diff(offsets).reshape(n_groups, m).sum(1)
    goff = _exclusive_cumsum(glen)
    kb = buf.reshape(n_groups, -1)
    if rbuf is None:
        return unpad_bank(kb, goff, n)
    return unpad_bank(kb, goff, n), unpad_bank(rbuf.reshape(n_groups, -1),
                                               goff, n)


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


def _bcount(xk, xr, vk, vr, pred, length: int):
    """Per-element monotone-prefix count: for each query ``v[i, j]`` the
    number of elements of sorted row ``x[i]`` satisfying ``pred`` (true on
    a prefix of the row), by a vectorised binary search."""
    lo = torch.zeros(vk.shape, dtype=torch.int64, device=vk.device)
    hi = torch.full(vk.shape, length, dtype=torch.int64, device=vk.device)
    for _ in range(max(length, 2).bit_length() + 1):
        mid = (lo + hi) // 2
        idx = mid.clamp(max=length - 1)
        take = lambda a: torch.gather(a, -1, idx)
        ok = pred(take(xk), None if xr is None else take(xr), vk, vr)
        ok = ok & (mid < hi)
        lo, hi = torch.where(ok, mid + 1, lo), torch.where(ok, hi, mid)
    return lo


def _pair_merge_rows(k, r, descending: bool):
    """Merge adjacent row pairs of an ``(R, L)`` bank of sorted rows into
    ``(R/2, 2L)`` by each element's merged position (a scatter by rank
    count). Key-only ties take the even (A) row first; with ranks the
    compound ``(key, rank)`` order decides, and equal compound lanes
    (sentinel padding) land A-first too."""
    R2, L = k.shape[0] // 2, k.shape[1]
    a, b = k[0::2], k[1::2]
    if r is not None:
        ra, rb = r[0::2], r[1::2]
        first = lane_first(descending)
        prec = lambda xk, xr, vk, vr: first(xk, xr, vk, vr)
        prec_or_tie = lambda xk, xr, vk, vr: ~first(vk, vr, xk, xr)
        ca = _bcount(b, rb, a, ra, prec, L)           # b strictly before a_i
        cb = _bcount(a, ra, b, rb, prec_or_tie, L)    # a before-or-tying b_j
    else:
        ra = rb = None
        if descending:
            prec = lambda xk, _, vk, __: xk > vk
            prec_or_tie = lambda xk, _, vk, __: xk >= vk
        else:
            prec = lambda xk, _, vk, __: xk < vk
            prec_or_tie = lambda xk, _, vk, __: xk <= vk
        ca = _bcount(b, None, a, None, prec, L)
        cb = _bcount(a, None, b, None, prec_or_tie, L)
    idx = torch.arange(L, device=k.device)[None, :]
    ko = k.new_empty((R2, 2 * L))
    ko.scatter_(1, idx + ca, a)
    ko.scatter_(1, idx + cb, b)
    if r is None:
        return ko, None
    ro = r.new_empty((R2, 2 * L))
    ro.scatter_(1, idx + ca, ra)
    ro.scatter_(1, idx + cb, rb)
    return ko, ro


def stream_pass(buf, rbuf, *, runs: int, run_len: int, fan_in: int,
                executor: str, w: int, block_out: int, descending: bool,
                out_slack: int = 0):
    """One out-of-core pass: consecutive groups of ``fan_in`` uniform
    sorted runs (``runs`` of ``run_len`` elements, a power of two ``>=
    w``) each merge into one run of ``fan_in * run_len``. On
    ``stream_cuda`` the buffers may carry trailing slack and the returned
    ones carry ``out_slack`` (K8's contract), so a chain of passes reads
    and writes the data once per pass; ``stream_torch`` returns exactly
    ``runs * run_len`` elements."""
    if executor == "stream_cuda":
        from repro_torch.kernels.stream_merge import (stream_merge_runs,
                                                      stream_merge_runs_kv)
        kw = dict(runs=runs, run_len=run_len, fan_in=fan_in, w=w,
                  block_out=block_out, out_slack=out_slack)
        if rbuf is None:
            return stream_merge_runs(buf, **kw), None
        return stream_merge_runs_kv(buf, rbuf, descending=descending, **kw)
    n_val = runs * run_len
    k = buf[:n_val].reshape(runs, run_len)
    r = None if rbuf is None else rbuf[:n_val].reshape(runs, run_len)
    f = fan_in
    while f > 1:
        k, r = _pair_merge_rows(k, r, descending)
        f >>= 1
    return k.reshape(-1), None if r is None else r.reshape(-1)


def _uniform_len(offsets) -> Optional[int]:
    """The common run length when every run has the same positive one."""
    lens = torch.diff(offsets)
    if lens.numel() and bool((lens == lens[0]).all()) and int(lens[0]) > 0:
        return int(lens[0])
    return None


def _stream_reduce(keys, offsets, ranks, m: int, sched: MergeSchedule,
                   descending: bool):
    """Device-resident level kind: make the ragged runs uniform once (no
    copy when they already are, at a power of two), then reduce each group
    with ``ceil(log_fan_in(m))`` streamed passes instead of ``log2(m)``
    levels."""
    from repro_torch.kernels.segmented_merge import padded_bank, unpad_bank
    from repro_torch.kernels.stream_merge import stream_slack
    n = keys.shape[0]
    K = offsets.shape[0] - 1
    n_groups = K // m
    fan = 1 << max(sched.levels_per_pass, 1)
    _, last_k = bound_keys(keys.dtype, descending)

    ulen = _uniform_len(offsets)
    if (ulen is not None and ulen >= sched.w and ulen & (ulen - 1) == 0
            and ulen * K == n):
        run_len = ulen
        krows = keys.reshape(K, run_len)
        rrows = None if ranks is None else ranks.reshape(K, run_len)
    else:
        run_len = max(segments.static_cap(offsets, n), sched.w)
        krows = padded_bank(keys, offsets, run_len, fill=last_k)
        rrows = (None if ranks is None else
                 padded_bank(ranks, offsets, run_len, fill=INVALID_RANK))
    m2 = next_pow2(m)
    if m2 != m:                          # sentinel runs complete each group
        pad = krows.new_full((n_groups, m2 - m, run_len), last_k)
        krows = torch.cat([krows.reshape(n_groups, m, run_len), pad],
                          dim=1).reshape(n_groups * m2, run_len)
        if rrows is not None:
            rpad = rrows.new_full((n_groups, m2 - m, run_len), INVALID_RANK)
            rrows = torch.cat([rrows.reshape(n_groups, m, run_len), rpad],
                              dim=1).reshape(n_groups * m2, run_len)

    levels_total = m2.bit_length() - 1
    buf = krows.reshape(-1)
    rbuf = None if rrows is None else rrows.reshape(-1)
    n_runs, mleft, passes = n_groups * m2, m2, 0
    slack = (stream_slack(fan, sched.w, sched.block_out)
             if sched.variant == "stream_cuda" else 0)
    while mleft > 1:
        f = min(fan, mleft)
        passes += 1
        obs.event("schedule.pass", executor=sched.variant,
                  levels=f.bit_length() - 1, runs=int(n_runs),
                  n=int(n_runs * run_len), kv=rbuf is not None,
                  level_kind="hbm_run")
        with obs.kernel_scope(f"schedule.stream_pass_f{f}"):
            buf, rbuf = stream_pass(
                buf, rbuf, runs=n_runs, run_len=run_len, fan_in=f,
                executor=sched.variant, w=sched.w,
                block_out=sched.block_out, descending=descending,
                out_slack=slack)
        n_runs //= f
        run_len *= f
        mleft //= f
    obs.event("schedule.reduce", executor=sched.variant, passes=passes,
              levels_total=levels_total,
              hbm_trips_saved=levels_total - passes, n=int(n),
              kv=ranks is not None)

    # each group's valid prefix back to the flat ragged layout
    glen = torch.diff(offsets).reshape(n_groups, m).sum(1)
    goff = _exclusive_cumsum(glen)
    kb = buf[:n_groups * run_len].reshape(n_groups, run_len)
    if rbuf is None:
        return unpad_bank(kb, goff, n)
    return (unpad_bank(kb, goff, n),
            unpad_bank(rbuf[:n_groups * run_len].reshape(n_groups, run_len),
                       goff, n))


def merge_runs(keys, offsets, *, ranks=None, schedule: MergeSchedule,
               runs_per_group: Optional[int] = None, descending: bool = True,
               uniform_len: Optional[int] = None):
    """Reduce grouped contiguous sorted runs to one sorted run per group.

    ``keys`` is the flat concatenation of ``R`` runs with boundaries
    ``offsets`` ((R+1,)), each sorted in the call's direction; consecutive
    ``runs_per_group`` runs (default: all) reduce independently. With
    ``ranks=`` (int32) the reduction is the stable compound-order merge and
    returns ``(keys, ranks)``. ``uniform_len`` declares every run that long
    (``reduce_rows``), which spares ``tree_vmapped`` reading the offsets
    back.
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
    if not descending and sched.variant != "torch" and (
            ranks is None or sched.variant == "tree_vmapped"):
        kv = ranks is not None
        keys, ranks = _mirror(keys, offsets, ranks)
        out = merge_runs(keys, offsets, ranks=ranks, schedule=sched,
                         runs_per_group=m, descending=True,
                         uniform_len=uniform_len)
        goff = offsets[::m]
        return _unmirror(out[0], out[1], goff) if kv else \
            _unmirror(out, None, goff)

    levels_total = next_pow2(m).bit_length() - 1
    if sched.variant == "torch":
        obs.event("schedule.reduce", executor="torch", passes=1,
                  levels_total=levels_total, hbm_trips_saved=levels_total - 1,
                  n=int(n), kv=ranks is not None)
        with obs.kernel_scope("schedule.torch_reduce"):
            return _torch_reduce(keys, offsets, ranks, m, descending)
    if sched.variant == "tree_vmapped":
        obs.event("schedule.reduce", executor="tree_vmapped",
                  passes=levels_total, levels_total=levels_total,
                  hbm_trips_saved=0, n=int(n), kv=ranks is not None)
        with obs.kernel_scope("schedule.vmapped_reduce"):
            return _vmapped_reduce(keys, offsets, ranks, m, sched,
                                   uniform_len=uniform_len)
    if sched.variant in STREAM_VARIANTS:
        with obs.kernel_scope("schedule.stream_reduce"):
            return _stream_reduce(keys, offsets, ranks, m, sched, descending)
    return _cuda_reduce(keys, offsets, ranks, m, sched, descending)


def reduce_rows(rows, *, schedule: MergeSchedule, ranks=None,
                runs_per_group: Optional[int] = None,
                descending: bool = True):
    """Merge the K rows of a ``(K, n)`` bank (each a sorted run) per group
    of ``runs_per_group`` rows. Returns the flat merged groups (and ranks).
    The rows' length is known, so no executor reads the offsets back."""
    K, n = rows.shape
    offsets = torch.arange(K + 1, dtype=torch.int32, device=rows.device) * n
    return merge_runs(rows.reshape(-1), offsets,
                      ranks=None if ranks is None else ranks.reshape(-1),
                      schedule=schedule, runs_per_group=runs_per_group,
                      descending=descending, uniform_len=n)
