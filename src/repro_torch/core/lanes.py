"""Payload lanes: the selector/compare core every FLiMS formulation shares.

PyTorch counterpart of ``repro/core/lanes.py``. A lane set is a dict
``{"key": tensor[, "rank": int32 tensor][, "val": payload]}`` whose lanes
share the trailing axis; ``val`` is a tensor or a dict/list/tuple of tensors.
Comparators: ``key_compare`` (descending, ties unresolved: paper algorithm 1)
and ``stable_compare`` (key descending, rank ascending: algorithm 3).
``flims_cycle`` is one FLiMS cycle (MAX selector over ``(A, reverse(B))``
plus the butterfly), ``topk_node`` one cycle mapping two descending k-lists
to the top k of their union, and ``merge_lanes`` the sorted-space FLiMS
merge built from it, over one pair of 1-D lane sets or a leading axis of
row pairs (the plain version of K9, ``kernels/lane_merge.py``).
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


def flims_cycle(a, b_rev, compare: Optional[Compare] = None,
                select_compare: Optional[Compare] = None):
    """One FLiMS cycle on lane sets (or plain tensors): MAX selector over
    ``(a, b_rev)`` and a butterfly sort of the rotated-bitonic result.
    Returns ``(chunk, take_a)``."""
    compare = compare or compare_for(a)
    take_a = (select_compare or compare)(a, b_rev)
    sel = tree_map(lambda x, y: torch.where(take_a, x, y), a, b_rev)
    return butterfly_sort(sel, compare=compare), take_a


def topk_node(a, b, compare: Optional[Compare] = None):
    """Top-k (sorted) of two descending k-lane lists: one selector and
    butterfly cycle over the trailing axis (the merge-tree node of
    ``core/topk.py``)."""
    compare = compare or compare_for(a)
    b_rev = tree_map(lambda x: torch.flip(x, [-1]), b)
    take_a = compare(a, b_rev)
    sel = tree_map(lambda x, y: torch.where(take_a, x, y), a, b_rev)
    return butterfly_sort(sel, compare=compare)


def pad_lanes(lanes, npad: int, lens=None):
    """Right-pad every lane of a (P, n) lane set to ``npad`` columns with
    elements that sort last (sentinel keys, INVALID_RANK ranks, zero
    payloads); with ``lens`` ((P,)) the columns at or past a row's length
    read as padding too."""
    n = lanes[KEY].shape[1]
    dev = lanes[KEY].device
    valid = None
    if lens is not None:
        valid = torch.arange(npad, device=dev)[None, :] < \
            torch.as_tensor(lens, device=dev).reshape(-1, 1)

    def pad(x, fill):
        x = torch.cat([x, x.new_full((x.shape[0], npad - n), fill)], dim=1)
        return x if valid is None else torch.where(valid, x,
                                                   x.new_full((), fill))
    out = {KEY: pad(lanes[KEY], sentinel_for(lanes[KEY].dtype))}
    if RANK in lanes:
        out[RANK] = pad(lanes[RANK], INVALID_RANK)
    if VAL in lanes:
        out[VAL] = tree_map(lambda v: pad(v, 0), lanes[VAL])
    return out


def merge_lanes(a, b, *, w: int = 128, compare: Optional[Compare] = None,
                tie: str = "b", a_lens=None, b_lens=None):
    """Sorted-space FLiMS merge of two descending lane sets.

    Per cycle: the next ``w`` candidates of each side, ``flims_cycle`` on
    ``(A, reverse(B))``, pointers advanced by the selector counts.
    ``tie='skew'`` is algorithm 2 (key-only lanes): the dir bit ``~take_a``
    of each selector lane rides to the next cycle.

    1-D lanes merge into ``len(a) + len(b)``. 2-D lanes ``(P, nA)`` /
    ``(P, nB)`` are P independent row pairs (the counterpart of
    ``jax.vmap(merge_lanes)``): each row keeps its own pointers and dir
    bits, the candidates are gathered by index, and the result is ``(P, nA
    + nB)``. ``a_lens`` / ``b_lens`` ((P,)) make the pairs ragged: a row's
    columns past its length read as padding (sentinel keys,
    ``INVALID_RANK`` ranks), and only the first ``a_lens + b_lens`` columns
    of its output are its merge.
    """
    nd = a[KEY].ndim
    if nd not in (1, 2) or b[KEY].ndim != nd:
        raise ValueError("merge_lanes takes 1-D lanes or 2-D rows of pairs")
    if w < 1 or w & (w - 1):
        raise ValueError(f"w must be a power of two, got {w}")
    if tie not in ("b", "skew"):
        raise ValueError(f"tie must be 'b' or 'skew', got {tie!r}")
    if tie == "skew" and RANK in a:
        raise ValueError("tie='skew' is key-only (rank lanes leave no ties)")
    if nd == 1:
        rows = merge_lanes(tree_map(lambda x: x[None], a),
                           tree_map(lambda x: x[None], b), w=w,
                           compare=compare, tie=tie)
        return tree_map(lambda x: x[0], rows)
    compare = compare or compare_for(a)
    P, nA = a[KEY].shape
    n_out = nA + b[KEY].shape[1]
    if n_out == 0:
        return tree_map(lambda x, y: torch.cat([x, y], dim=1), a, b)
    cycles = -(-n_out // w)
    npad = cycles * w + w               # pointers never pass cycles * w
    ap, bp = pad_lanes(a, npad, a_lens), pad_lanes(b, npad, b_lens)
    dev = a[KEY].device
    iota = torch.arange(w, device=dev)
    riota = w - 1 - iota                # MAX_i pairs a_i with b_{w-1-i}

    def take(lanes, idx):
        return tree_map(lambda x: torch.gather(x, 1, idx), lanes)

    pA = torch.zeros((P, 1), dtype=torch.int64, device=dev)
    pB = torch.zeros((P, 1), dtype=torch.int64, device=dev)
    dirb = torch.zeros((P, w), dtype=torch.bool, device=dev)
    chunks = []
    for _ in range(cycles):
        sel_cmp = skew_compare(dirb, compare) if tie == "skew" else None
        chunk, take_a = flims_cycle(take(ap, pA + iota), take(bp, pB + riota),
                                    compare, select_compare=sel_cmp)
        k = take_a.sum(1, keepdim=True)
        pA, pB, dirb = pA + k, pB + (w - k), ~take_a
        chunks.append(chunk)
    return tree_map(lambda *xs: torch.cat(xs, dim=1)[:, :n_out], *chunks)
