"""Butterfly CAS network and bitonic sorting networks (paper fig. 3 / 9).

PyTorch counterpart of ``repro/core/butterfly.py``. Every network works on
the trailing axis and is built from static stages (reshape + select).
Descending order is the paper's convention. A "CAS stage at distance d"
compares elements i and i+d inside each 2d-block and places the winner
first; the butterfly is the stages at w/2, w/4, ..., 1 and sorts any
(rotated) bitonic sequence.
"""
from __future__ import annotations

import math
from typing import Any, Callable

import torch

Compare = Callable[[Any, Any], Any]  # (x, y) -> bool mask "x goes first"


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the tensor leaves of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def _default_gt(x, y):
    return x > y


def _split(a, d: int):
    w = a.shape[-1]
    a2 = a.reshape(a.shape[:-1] + (w // (2 * d), 2, d))
    return a2[..., 0, :], a2[..., 1, :]


def _join(hi, lo):
    a2 = torch.stack([hi, lo], dim=-2)
    return a2.reshape(a2.shape[:-3] + (-1,))


def _cas(x, d: int, compare: Compare, flip=None):
    pairs = tree_map(lambda a: _split(a, d), x)
    is_pair = lambda p: isinstance(p, tuple) and len(p) == 2 \
        and isinstance(p[0], torch.Tensor)

    def pick(t, i):
        if is_pair(t):
            return t[i]
        if isinstance(t, dict):
            return {k: pick(v, i) for k, v in t.items()}
        return type(t)(pick(v, i) for v in t)

    top, bot = pick(pairs, 0), pick(pairs, 1)
    m = compare(top, bot)
    if flip is not None:
        m = m ^ flip
    hi = tree_map(lambda t, b: torch.where(m, t, b), top, bot)
    lo = tree_map(lambda t, b: torch.where(m, b, t), top, bot)
    return tree_map(_join, hi, lo)


def cas_stage(x, d: int, *, compare: Compare = _default_gt):
    """One compare-and-swap stage at distance ``d`` on the trailing axis, on
    a tensor or a tree of tensors sharing the trailing shape."""
    return _cas(x, d, compare)


def butterfly_sort(x, *, compare: Compare = _default_gt):
    """Sort a (rotated-)bitonic sequence on the trailing axis, descending:
    log2(w) stages at distances w/2 .. 1."""
    w = tree_leaves(x)[0].shape[-1]
    if w & (w - 1):
        raise ValueError(f"w must be a power of two, got {w}")
    d = w // 2
    while d >= 1:
        x = _cas(x, d, compare)
        d //= 2
    return x


def bitonic_merge_full(x, *, compare: Compare = _default_gt):
    """Full 2w -> 2w bitonic merger (paper fig. 3): the butterfly over the
    whole ``[A, reverse(B)]`` of two descending lists. The Chhugani / fig. 4
    baseline merger uses it."""
    return butterfly_sort(x, compare=compare)


def bitonic_sort(x, *, compare: Compare = _default_gt):
    """Full bitonic sorter on the trailing axis (descending), any input;
    the trailing size must be a power of two."""
    w = tree_leaves(x)[0].shape[-1]
    if w & (w - 1):
        raise ValueError(f"w must be a power of two, got {w}")
    dev = tree_leaves(x)[0].device
    k = 2
    while k <= w:
        d = k // 2
        while d >= 1:
            first = torch.arange(w, device=dev).reshape(
                w // (2 * d), 2, d)[:, 0, :]
            flip = (first // k) % 2 == 1          # odd k-blocks ascend
            x = _cas(x, d, compare, flip)
            d //= 2
        k *= 2
    return x


# --- comparator counts and pipeline depths (paper Table 2) ------------------

def comparators_flims(w: int) -> int:
    """FLiMS: w MAX units + (w/2) log2(w) CAS units."""
    return w + (w // 2) * int(math.log2(w))


def comparators_flimsj(w: int) -> int:
    """FLiMSj: FLiMS's network (its extra logic is muxes)."""
    return comparators_flims(w)


def comparators_basic(w: int) -> int:
    """Chhugani / Casper fig. 4, a full 2w-to-2w merger: w + w log2(w)."""
    return w + w * int(math.log2(w))


def comparators_pmt(w: int) -> int:
    """PMT merger, one 2w-to-w partial merger: w + (w/2) log2(w)."""
    return w + (w // 2) * int(math.log2(w))


def comparators_mms(w: int) -> int:
    """MMS / VMS: two 2w-to-w partial mergers + 1 selector comparator."""
    return 2 * w + w * int(math.log2(w)) + 1


def comparators_wms(w: int) -> int:
    """WMS: one 3w-to-w pruned odd-even merger: 3w + (w/2) log2(w)."""
    return 3 * w + (w // 2) * int(math.log2(w))


def comparators_ehms(w: int) -> int:
    """EHMS: a 2.5w-to-w pruned odd-even merger: 5w/2 + (w/2) log2(w) + 2."""
    return (5 * w) // 2 + (w // 2) * int(math.log2(w)) + 2


def pipeline_depth(design: str, w: int) -> int:
    """The latency column of Table 2."""
    lg = int(math.log2(w))
    return {"basic": lg + 2, "pmt": 2 * lg + 1, "mms": 2 * lg + 3,
            "vms": 2 * lg + 3, "wms": lg + 3, "ehms": lg + 3,
            "flims": lg + 1, "flimsj": lg + 2}[design]
