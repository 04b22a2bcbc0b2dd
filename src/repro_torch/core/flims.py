"""FLiMS: Fast Lightweight 2-way Merge Sorter (paper §3-§5), in PyTorch.

Counterpart of ``repro/core/flims.py``. Both formulations merge descending:

1. ``flims_merge_ref``: sorted-space, scalar pointers into each list.
2. ``flims_merge_banked``: inputs in round-robin banks of width ``w``, heads
   kept in rotated positions by two-row windows and rotations ``lA, lB``
   with the FLiMS invariant ``(lA + lB) mod w == 0``.

``tie='b'`` is algorithm 1 (ties from B), ``tie='skew'`` algorithm 2, and
``flims_merge_kv_stable`` algorithm 3 with an explicit rank lane. These back
the ``ref``/``banked`` merge variants and run eagerly, one cycle per loop
iteration.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.lanes import (KEY, VAL, flims_cycle, key_compare,
                                    make_lanes, merge_lanes, sentinel_for,
                                    skew_compare, stable_compare)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def next_pow2(n: int) -> int:
    """Smallest power of two >= max(n, 1)."""
    p = 1
    while p < n:
        p *= 2
    return p


def flims_merge_ref(a: torch.Tensor, b: torch.Tensor, w: int = 128,
                    tie: str = "b") -> torch.Tensor:
    """Merge two descending 1-D tensors through ``merge_lanes``."""
    out = merge_lanes(make_lanes(a), make_lanes(b), w=w, compare=key_compare,
                      tie=tie)
    return out[KEY]


class MergeStats(NamedTuple):
    merged: torch.Tensor
    k_per_cycle: torch.Tensor   # elements dequeued from A on each cycle


def flims_merge_banked(a: torch.Tensor, b: torch.Tensor, w: int = 128,
                       tie: str = "b", with_stats: bool = False):
    """Banked FLiMS merge (descending), FLiMSj-style whole-row dequeues."""
    if a.ndim != 1 or b.ndim != 1:
        raise ValueError("flims_merge_banked takes 1-D tensors")
    if w & (w - 1) or tie not in ("b", "skew"):
        raise ValueError(f"bad w={w} or tie={tie!r}")
    n_out = a.shape[0] + b.shape[0]
    dev = a.device
    if n_out == 0:
        out = a.new_zeros((0,))
        empty = torch.zeros((0,), dtype=torch.int32, device=dev)
        return MergeStats(out, empty) if with_stats else out
    cycles = _cdiv(n_out, w)

    def rows_of(x):
        r = _cdiv(x.shape[0], w) + 2          # +2 sentinel rows: the window
        pad = x.new_full((r * w - x.shape[0],), sentinel_for(x.dtype))
        return torch.cat([x, pad]).reshape(r, w)

    ra, rb = rows_of(a), rows_of(b)
    iota = torch.arange(w, device=dev)

    def heads(W, l):
        return torch.where(iota < l, W[1], W[0])

    def advance(W, rows, l, r, consumed):
        l2 = l + consumed
        shift = l2 >= w
        nxt = rows[torch.clamp(r, max=rows.shape[0] - 1)]
        W = torch.where(shift, torch.stack([W[1], nxt]), W)
        return W, torch.where(shift, l2 - w, l2), r + shift.to(torch.int64)

    zero = torch.zeros((), dtype=torch.int64, device=dev)
    WA, WB, lA, lB, rA, rB = ra[:2], rb[:2], zero, zero, zero + 2, zero + 2
    dirb = torch.zeros((w,), dtype=torch.bool, device=dev)
    chunks, ks = [], []
    for _ in range(cycles):
        cA = heads(WA, lA)
        cBr = torch.flip(heads(WB, lB), [0])  # MAX_i pairs a_i, b_{w-1-i}
        sel_cmp = key_compare if tie == "b" else skew_compare(dirb)
        chunk, take_a = flims_cycle(cA, cBr, key_compare,
                                    select_compare=sel_cmp)
        k = take_a.sum()
        dirb = ~take_a
        WA, lA, rA = advance(WA, ra, lA, rA, k)
        WB, lB, rB = advance(WB, rb, lB, rB, w - k)
        chunks.append(chunk)
        ks.append(k)
    merged = torch.cat(chunks)[:n_out]
    if with_stats:
        return MergeStats(merged, torch.stack(ks).to(torch.int32))
    return merged


def flims_merge_kv_stable(keys_a, vals_a, keys_b, vals_b, w: int = 128):
    """Stable descending merge of (key, value) lists; A's duplicates first.

    A gets ranks ``0..nA-1`` and B ``nA..nA+nB-1``, so ``stable_compare``
    orders ties A-first, then by input position. ``vals_*`` is a tensor or a
    dict/list/tuple of tensors. Returns ``(merged_keys, merged_vals)``.
    """
    nA, nB = keys_a.shape[0], keys_b.shape[0]
    if nA + nB == 0:
        return keys_a, vals_a
    dev = keys_a.device
    a = make_lanes(keys_a, rank=torch.arange(nA, device=dev), val=vals_a)
    b = make_lanes(keys_b, rank=nA + torch.arange(nB, device=dev),
                   val=vals_b)
    out = merge_lanes(a, b, w=w, compare=stable_compare)
    return out[KEY], out.get(VAL)


def flims_merge(a, b, *, w: int = 128, descending: bool = True,
                variant: str = "banked", tie: str = "b"):
    """Merge two sorted 1-D tensors with FLiMS; ``descending=False`` merges
    ascending inputs by mirroring."""
    if not descending:
        out = flims_merge(torch.flip(a, [0]), torch.flip(b, [0]), w=w,
                          descending=True, variant=variant, tie=tie)
        return torch.flip(out, [0])
    if variant == "ref":
        return flims_merge_ref(a, b, w, tie=tie)
    return flims_merge_banked(a, b, w, tie=tie)
