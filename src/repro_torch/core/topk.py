"""FLiMS top-k selection.

Counterpart of ``repro/core/topk.py``. One FLiMS cycle (the MAX selector and
the butterfly, paper fig. 9) maps two descending k-lists to the sorted top-k
of their union, so the top-k of a row is a bitonic sort of its k-wide
chunks and then a binary tree of single cycles (``topk_node``). Every stage
is over key and rank lanes in the compound order: the rank breaks ties to
the lower index (``lax.top_k``'s order) and is the returned index; a
``values`` payload rides extra lanes. The stages are vectorised over every
row and chunk at once, so this is plain torch on the card too.
"""
from __future__ import annotations

import torch

from repro_torch.core.butterfly import bitonic_sort, tree_map
from repro_torch.core.flims import next_pow2
from repro_torch.core.lanes import (KEY, RANK, VAL, sentinel_for,
                                    stable_compare, topk_node)


def flims_topk(x: torch.Tensor, k: int, values=None):
    """Top-k of the trailing axis: ``(vals, inds)``, or with a ``values``
    payload (a tensor or a dict/list/tuple of ``x``-shaped tensors)
    ``(vals, inds, payload_topk)``. Values descend, ties to the lower index.
    When fewer than ``k`` elements exist the tail is masked by rank
    validity: index 0, the sentinel value, zero payload."""
    kk = next_pow2(k)
    n = x.shape[-1]
    n_pad = max(next_pow2(n), kk)
    sent = sentinel_for(x.dtype)
    lead = tuple(x.shape[:-1])
    shape = lead + (n_pad // kk, kk)

    def pad(v, fill):
        return torch.cat([v, v.new_full(lead + (n_pad - n,), fill)], dim=-1)

    idx = torch.arange(n_pad, dtype=torch.int32, device=x.device)
    rows = {KEY: pad(x, sent).reshape(shape),
            RANK: idx.expand(lead + (n_pad,)).reshape(shape)}
    if values is not None:
        rows[VAL] = tree_map(lambda v: pad(v, 0).reshape(shape), values)
    rows = bitonic_sort(rows, compare=stable_compare)
    # reduce the rows pairwise along axis -2
    while rows[KEY].shape[-2] > 1:
        carry = None
        if rows[KEY].shape[-2] % 2:            # carry an odd row through
            carry = tree_map(lambda r: r[..., -1:, :], rows)
            rows = tree_map(lambda r: r[..., :-1, :], rows)
        rows = topk_node(tree_map(lambda r: r[..., 0::2, :], rows),
                         tree_map(lambda r: r[..., 1::2, :], rows),
                         stable_compare)
        if carry is not None:
            rows = tree_map(lambda r, c: torch.cat([r, c], dim=-2), rows,
                            carry)
    vals = rows[KEY][..., 0, :k]
    inds = rows[RANK][..., 0, :k]
    # padding carries ranks >= n: it surfaces only when k exceeds n
    valid = inds < n
    vals = torch.where(valid, vals, vals.new_full((), sent))
    inds = torch.where(valid, inds, 0)
    if values is None:
        return vals, inds
    pay = tree_map(lambda r: torch.where(valid, r[..., 0, :k],
                                         r.new_zeros(())), rows[VAL])
    return vals, inds, pay
