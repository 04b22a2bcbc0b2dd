"""Parallel merge trees (paper §2.1, figs. 1-2): PMT and HPMT.

Counterpart of ``repro/core/merge_tree.py``. A PMT merges K sorted lists
through a binary tree of FLiMS 2-way mergers; every function here is a
``MergeSchedule`` reduction (default ``tree_vmapped``: one lane merge of
every pair a level), for any K >= 1 (a group short of a power of two is
completed with sentinel runs). ``schedule=`` swaps the executor.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.butterfly import tree_map
from repro_torch.core.lanes import sentinel_for


def pmt_merge(lists: torch.Tensor, w: int = 32, tie: str = "b",
              schedule=None) -> torch.Tensor:
    """Merge the K descending rows of ``lists`` (K, n) into one (K*n,)
    descending tensor; ``tie='skew'`` applies algorithm 2's selector at every
    node of the default schedule."""
    from repro_torch.engine.schedule import reduce_rows, schedule_or
    if lists.shape[0] == 1:
        return lists[0]
    return reduce_rows(lists, schedule=schedule_or(schedule, w, tie))


def _rowmajor_ranks(K: int, n: int, device):
    return (torch.arange(K, dtype=torch.int32, device=device)[:, None] * n
            + torch.arange(n, dtype=torch.int32, device=device)[None, :])


def _gather_payload(payload, ranks, modulo: int):
    """The merged rank permutation applied to a payload of row banks; ranks
    at or past ``modulo`` mark padding and gather the padded slot's own
    payload. An index past the bank (a sentinel run's rank, surfacing only
    where NaN keys break the order) reads the last slot, as JAX's clamped
    gather does."""
    idx = torch.where(ranks < modulo, ranks, ranks - modulo).long()
    idx = idx.clamp(max=modulo - 1)
    return tree_map(lambda v: v.reshape((-1,) + tuple(v.shape[2:]))[idx],
                    payload)


def pmt_merge_kv(keys: torch.Tensor, payload, w: int = 32, schedule=None):
    """Stable KV PMT: K descending (K, n) key rows carrying a payload of
    (K, n) rows. Ties order lower row first, then by position (algorithm
    3). Returns ``(merged_keys, merged_payload)`` of length K*n."""
    from repro_torch.engine.schedule import reduce_rows, schedule_or
    K, n = keys.shape
    mk, mr = reduce_rows(keys, ranks=_rowmajor_ranks(K, n, keys.device),
                         schedule=schedule_or(schedule, w))
    return mk, _gather_payload(payload, mr, K * n)


def pmt_merge_kv_padded(keys: torch.Tensor, counts: torch.Tensor, payload,
                        w: int = 32, schedule=None):
    """KV PMT over padded rows with per-row valid counts: positions past a
    row's count get the sentinel key and a rank after every real element,
    so the merged prefix of length ``sum(counts)`` is exact even where real
    keys equal the sentinel."""
    from repro_torch.engine.schedule import reduce_rows, schedule_or
    K, n = keys.shape
    pos = torch.arange(n, dtype=torch.int32, device=keys.device)
    valid = pos[None, :] < counts.to(keys.device).reshape(-1, 1)
    base = _rowmajor_ranks(K, n, keys.device)
    rank = torch.where(valid, base, K * n + base)
    masked = torch.where(valid, keys, keys.new_full((), sentinel_for(
        keys.dtype)))
    mk, mr = reduce_rows(masked, ranks=rank,
                         schedule=schedule_or(schedule, w))
    return mk, _gather_payload(payload, mr, K * n)


def merge_k(arrays: Sequence[torch.Tensor], w: int = 32,
            dtype=None) -> torch.Tensor:
    """Merge K descending tensors of any lengths (HPMT style): they
    concatenate into one run list reduced by ``tree_vmapped``. ``dtype``
    fixes the empty result's type when no input gives one (default
    float32)."""
    from repro_torch.engine.schedule import MergeSchedule, merge_runs
    inputs = [torch.as_tensor(a) for a in arrays]
    if dtype is None and inputs:
        dtype = inputs[0].dtype
    arrays = [a for a in inputs if a.shape[0] > 0]
    if not arrays:
        dev = inputs[0].device if inputs else None
        return torch.zeros((0,), dtype=dtype or torch.float32, device=dev)
    flat = torch.cat(arrays)
    lens = torch.tensor([a.shape[0] for a in arrays], dtype=torch.int32)
    offsets = torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0,
                                                         dtype=torch.int32)])
    return merge_runs(flat, offsets.to(flat.device),
                      schedule=MergeSchedule("tree_vmapped", w=w))


def pmt_merge_padded(lists: torch.Tensor, counts: torch.Tensor, w: int = 32,
                     valid_is_count: bool = True,
                     schedule=None) -> torch.Tensor:
    """Merge K padded descending rows with per-row validity, enforced:
    positions past the valid region become the sentinel, so the merged
    prefix of length ``sum(counts)`` is the true merge. ``counts`` is (K,)
    valid lengths, or with ``valid_is_count=False`` a (K, n) mask."""
    if valid_is_count:
        valid = torch.arange(lists.shape[1], device=lists.device)[None, :] \
            < counts.to(lists.device).reshape(-1, 1)
    else:
        valid = counts.to(device=lists.device, dtype=torch.bool)
    masked = torch.where(valid, lists, lists.new_full((), sentinel_for(
        lists.dtype)))
    return pmt_merge(masked, w, schedule=schedule)
