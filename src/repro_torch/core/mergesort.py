"""FLiMS complete sorting (paper §8.2), the reference sorters.

Counterpart of ``repro/core/mergesort.py``: a bitonic sort of fixed-width
chunks, vectorised over rows, then the chunk tree reduced by a
``MergeSchedule``, by default ``tree_vmapped`` (``schedule_or``): one FLiMS
lane merge of every run pair a level, K9 on the card. ``flims_argsort`` runs
the same pipeline over (key, rank) lanes under the compound order (key
descending, rank ascending); the rank lane of the merged result is the
stable permutation. A ``(B, n)`` batch of rows is one grouped reduction.
"""
from __future__ import annotations

import torch

from repro_torch.core.butterfly import bitonic_sort
from repro_torch.core.flims import next_pow2
from repro_torch.core.lanes import (INVALID_RANK, KEY, RANK, sentinel_for,
                                    stable_compare)


def _pad_to(x: torch.Tensor, n: int) -> torch.Tensor:
    """Right-pad the trailing axis to ``n`` with the sentinel key."""
    pad = x.new_full(x.shape[:-1] + (n - x.shape[-1],),
                     sentinel_for(x.dtype))
    return torch.cat([x, pad], dim=-1)


def sort_chunks(x: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """Bitonic-sort each row of ``x.reshape(-1, chunk)``, descending."""
    return bitonic_sort(x.reshape(-1, chunk))


def flims_sort(x: torch.Tensor, *, chunk: int = 512, w: int = 32,
               descending: bool = True, schedule=None) -> torch.Tensor:
    """Full sort of a 1-D tensor by FLiMS merge sort."""
    from repro_torch.engine.schedule import reduce_rows, schedule_or
    n = x.shape[0]
    if n <= 1:
        return x
    chunk = min(chunk, next_pow2(n))
    w = min(w, chunk)
    rows = sort_chunks(_pad_to(x, next_pow2(max(n, chunk))), chunk)
    out = reduce_rows(rows, schedule=schedule_or(schedule, w))[:n]
    return out if descending else torch.flip(out, [0])


def flims_argsort(keys: torch.Tensor, *, chunk: int = 256, w: int = 32,
                  descending: bool = True, schedule=None) -> torch.Tensor:
    """Stable argsort (int32) of 1-D keys, or of each row of a (B, n)
    batch, through key / rank FLiMS merge sort (algorithm 3)."""
    n = keys.shape[-1]
    if n <= 1:
        return torch.zeros(keys.shape, dtype=torch.int32, device=keys.device)
    if not descending:
        # the stable ascending order mirrors the stable descending order of
        # the reversed row
        perm_rev = _argsort_desc(torch.flip(keys, [-1]), chunk, w, schedule)
        return torch.flip(n - 1 - perm_rev, [-1]).to(torch.int32)
    return _argsort_desc(keys, chunk, w, schedule)


def _argsort_desc(keys, chunk: int, w: int, schedule):
    from repro_torch.engine.schedule import reduce_rows, schedule_or
    n = keys.shape[-1]
    rows = keys.reshape(-1, n)
    B = rows.shape[0]
    chunk = min(chunk, next_pow2(n))
    w = min(w, chunk)
    n_pad = next_pow2(max(n, chunk))
    idx = torch.arange(n_pad, dtype=torch.int32, device=keys.device)
    idx = torch.where(idx < n, idx, INVALID_RANK)
    lanes = {KEY: _pad_to(rows, n_pad).reshape(-1, chunk),
             RANK: idx.expand(B, n_pad).reshape(-1, chunk)}
    # chunk-local stable sort, then the chunk tree: ranks rise with input
    # position, so the compound order is algorithm 3's at every node
    lanes = bitonic_sort(lanes, compare=stable_compare)
    _, perm = reduce_rows(lanes[KEY], ranks=lanes[RANK],
                          schedule=schedule_or(schedule, w),
                          runs_per_group=n_pad // chunk)
    return perm.reshape(B, n_pad)[:, :n].reshape(keys.shape)


def flims_sort_kv(keys: torch.Tensor, values: torch.Tensor, *,
                  chunk: int = 256, w: int = 32, descending: bool = True):
    """Stable key / value sort: values gathered by the argsort
    permutation."""
    perm = flims_argsort(keys, chunk=chunk, w=w, descending=descending)
    return keys[perm], values[perm]
