"""Payload lanes: the selector/compare core every FLiMS formulation shares.

PyTorch counterpart of ``repro/core/lanes.py``. A lane set is a dict
``{"key": tensor[, "rank": int32 tensor][, "val": payload]}`` whose lanes
share the trailing axis; ``val`` is a tensor or a dict/list/tuple of tensors.
Comparators: ``key_compare`` (descending, ties unresolved: paper algorithm 1)
and ``stable_compare`` (key descending, rank ascending: algorithm 3).
``flims_cycle`` is one FLiMS cycle (MAX selector over ``(A, reverse(B))``
plus the butterfly), and ``merge_lanes`` the sorted-space FLiMS merge built
from it.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.core.butterfly import butterfly_sort, tree_map

KEY, RANK, VAL = "key", "rank", "val"

#: rank given to padding: sorts after every real rank under ``rank asc``.
INVALID_RANK = 2 ** 31 - 1

Compare = Callable[[Any, Any], Any]


def sentinel_for(dtype: torch.dtype):
    """Key that sorts last in descending order (never strictly wins)."""
    if dtype.is_floating_point:
        return float("-inf")
    return torch.iinfo(dtype).min


def plus_inf_for(dtype: torch.dtype):
    """Key that sorts first in descending order (never strictly loses)."""
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def make_lanes(keys, rank=None, val=None) -> Dict[str, Any]:
    """Assemble a lane set; ``rank`` is cast to int32."""
    lanes: Dict[str, Any] = {KEY: keys}
    if rank is not None:
        lanes[RANK] = rank.to(torch.int32)
    if val is not None:
        lanes[VAL] = val
    return lanes


def _key(x):
    return x[KEY] if isinstance(x, dict) else x


def key_compare(x, y):
    """Descending key order, ties unresolved (the selector then prefers the
    second operand: algorithm 1's ties-to-B)."""
    return _key(x) > _key(y)


def key_eq(x, y):
    return _key(x) == _key(y)


def skew_compare(dirb, compare: Optional[Compare] = None):
    """Algorithm 2's selector ``{cA, dir} > {cB, !dir}`` (key-only)."""
    compare = compare or key_compare
    return lambda x, y: compare(x, y) | (key_eq(x, y) & dirb)


def stable_compare(x, y):
    """Key descending, then rank ascending (algorithm 3's compound order)."""
    kx, ky = x[KEY], y[KEY]
    first = kx > ky
    if isinstance(x, dict) and RANK in x:
        first = first | ((kx == ky) & (x[RANK] < y[RANK]))
    return first


def compare_for(lanes) -> Compare:
    """stable_compare when a rank lane is present, else key_compare."""
    return stable_compare if (isinstance(lanes, dict) and RANK in lanes) \
        else key_compare


def _pad(x, npad: int, value):
    n = x.shape[0]
    return torch.cat([x, x.new_full((npad - n,) + tuple(x.shape[1:]), value)])


def pad_lanes(lanes, npad: int):
    """Right-pad every lane to ``npad`` with elements that sort last:
    sentinel keys, INVALID_RANK ranks, zero payloads."""
    out = {KEY: _pad(lanes[KEY], npad, sentinel_for(lanes[KEY].dtype))}
    if RANK in lanes:
        out[RANK] = _pad(lanes[RANK], npad, INVALID_RANK)
    if VAL in lanes:
        out[VAL] = tree_map(lambda v: _pad(v, npad, 0), lanes[VAL])
    return out


def flims_cycle(a, b_rev, compare: Optional[Compare] = None,
                select_compare: Optional[Compare] = None):
    """One FLiMS cycle on lane sets (or plain tensors): MAX selector over
    ``(a, b_rev)`` and a butterfly sort of the rotated-bitonic result.
    Returns ``(chunk, take_a)``."""
    compare = compare or compare_for(a)
    take_a = (select_compare or compare)(a, b_rev)
    sel = tree_map(lambda x, y: torch.where(take_a, x, y), a, b_rev)
    return butterfly_sort(sel, compare=compare), take_a


def merge_lanes(a, b, *, w: int = 128, compare: Optional[Compare] = None,
                tie: str = "b"):
    """Sorted-space FLiMS merge of two descending 1-D lane sets.

    Per cycle: the next ``w`` candidates of each side, ``flims_cycle`` on
    ``(A, reverse(B))``, pointers advanced by the selector counts.
    ``tie='skew'`` is algorithm 2 (key-only lanes). Returns the merged lane
    set of length ``len(a) + len(b)``.
    """
    if a[KEY].ndim != 1 or b[KEY].ndim != 1:
        raise ValueError("merge_lanes takes 1-D lanes")
    if w & (w - 1):
        raise ValueError(f"w must be a power of two, got {w}")
    if tie not in ("b", "skew"):
        raise ValueError(f"tie must be 'b' or 'skew', got {tie!r}")
    if tie == "skew" and RANK in a:
        raise ValueError("tie='skew' is key-only (rank lanes leave no ties)")
    compare = compare or compare_for(a)
    n_out = a[KEY].shape[0] + b[KEY].shape[0]
    if n_out == 0:
        return tree_map(lambda x, y: torch.cat([x, y]), a, b)
    cycles = -(-n_out // w)
    npad = cycles * w + w               # pointers never pass cycles * w
    ap, bp = pad_lanes(a, npad), pad_lanes(b, npad)
    dev = a[KEY].device
    iota = torch.arange(w, device=dev)

    def slice_at(lanes, p, rev):
        out = tree_map(lambda x: x[p + iota], lanes)
        return tree_map(lambda x: torch.flip(x, [0]), out) if rev else out

    pA = torch.zeros((), dtype=torch.int64, device=dev)
    pB = torch.zeros((), dtype=torch.int64, device=dev)
    dirb = torch.zeros((w,), dtype=torch.bool, device=dev)
    chunks = []
    for _ in range(cycles):
        sel_cmp = skew_compare(dirb, compare) if tie == "skew" else None
        chunk, take_a = flims_cycle(slice_at(ap, pA, False),
                                    slice_at(bp, pB, True), compare,
                                    select_compare=sel_cmp)
        k = take_a.sum()
        pA, pB, dirb = pA + k, pB + (w - k), ~take_a
        chunks.append(chunk)
    return tree_map(lambda *xs: torch.cat(xs)[:n_out], *chunks)
