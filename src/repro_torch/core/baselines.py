"""The paper's comparison mergers (§2.2, §6, Table 2), in plain torch.

Counterpart of ``repro/core/baselines.py``: the dataflow of each merger
FLiMS is evaluated against, what it compares and keeps each cycle. All give
FLiMS's output; they differ in the work a cycle.

- ``basic_merge``: Chhugani / Casper (fig. 4). One head compare dequeues a
  whole w-row from the winning list; a full 2w -> 2w bitonic merge with the
  carry emits the top w and keeps the bottom w. w + w log2(w) comparators.
- ``mms_merge``: MMS / VMS (fig. 6). The same dequeue, then two 2w -> w
  partial mergers (the output's top w, the leftovers re-sorted) and one
  selector comparator. 2w + w log2(w) + 1.
- ``wms_merge``: WMS (fig. 7 / 11). One 3w -> w merger over the 2w
  leftovers and the new row. 3w + (w/2) log2(w).

The partial mergers take XLA's maximum / minimum, as the JAX ones do.
"""
from __future__ import annotations

import torch

from repro_torch.core.butterfly import bitonic_merge_full, butterfly_sort
from repro_torch.core.lanes import sentinel_for


def _prep(a, b, w: int):
    n_out = a.shape[0] + b.shape[0]
    cycles = -(-n_out // w)
    n_pad = (cycles + 2) * w

    def pad(x):
        return torch.cat([x, x.new_full((n_pad - x.shape[0],),
                                        sentinel_for(x.dtype))])
    return pad(a), pad(b), n_out, cycles


def _rows(a_p, b_p, pA, pB, iota):
    """The head compare and the whole w-row it dequeues."""
    take_a = a_p[pA] > b_p[pB]
    row = torch.where(take_a, a_p[pA + iota], b_p[pB + iota])
    w = iota.shape[0]
    return row, pA + torch.where(take_a, w, 0), pB + torch.where(take_a, 0, w)


def basic_merge(a: torch.Tensor, b: torch.Tensor, w: int = 32):
    """Chhugani-style merger (paper fig. 4). Descending."""
    a_p, b_p, n_out, cycles = _prep(a, b, w)
    if n_out == 0:
        return a.new_zeros((0,))
    iota = torch.arange(w, device=a.device)
    pA = torch.tensor(w, device=a.device)
    pB = torch.tensor(0, device=a.device)
    keep, chunks = a_p[:w], []
    for _ in range(cycles):
        row, pA, pB = _rows(a_p, b_p, pA, pB, iota)
        merged = bitonic_merge_full(torch.cat([keep, torch.flip(row, [0])]))
        keep = merged[w:]
        chunks.append(merged[:w])
    return torch.cat(chunks + [keep])[:n_out]


def mms_merge(a: torch.Tensor, b: torch.Tensor, w: int = 32):
    """MMS / VMS-style merger (paper fig. 6): two 2w -> w partial
    mergers."""
    from repro_torch.kernels.flims_merge import xla_max, xla_min
    a_p, b_p, n_out, cycles = _prep(a, b, w)
    if n_out == 0:
        return a.new_zeros((0,))
    iota = torch.arange(w, device=a.device)
    pA = torch.tensor(w, device=a.device)
    pB = torch.tensor(0, device=a.device)
    keep, chunks = a_p[:w], []
    for _ in range(cycles):
        row, pA, pB = _rows(a_p, b_p, pA, pB, iota)
        rr = torch.flip(row, [0])
        chunks.append(butterfly_sort(xla_max(keep, rr)))   # the output
        keep = butterfly_sort(xla_min(keep, rr))           # the leftovers
    return torch.cat(chunks + [keep])[:n_out]


def wms_merge(a: torch.Tensor, b: torch.Tensor, w: int = 32):
    """WMS-style merger (paper fig. 7): one 3w -> w merger over the sorted
    2w leftovers and the new row."""
    from repro_torch.kernels.flims_merge import xla_max, xla_min
    a_p, b_p, n_out, cycles = _prep(a, b, w)
    if n_out == 0:
        return a.new_zeros((0,))
    iota = torch.arange(w, device=a.device)

    def merge_2w_w(L2, row):
        """(top w, new 2w leftovers) of the 2w leftovers and a w row."""
        rowp = torch.flip(torch.cat([row, row.new_full(
            (w,), sentinel_for(row.dtype))]), [0])
        hi = butterfly_sort(xla_max(L2, rowp))
        lo = butterfly_sort(xla_min(L2, rowp))
        rest = butterfly_sort(torch.cat([hi[w:], torch.flip(lo[:w], [0])]))
        return hi[:w], rest

    L2 = butterfly_sort(torch.cat([a_p[:w], torch.flip(b_p[:w], [0])]))
    pA = torch.tensor(w, device=a.device)
    pB = torch.tensor(w, device=a.device)
    chunks = []
    for _ in range(cycles):
        row, pA, pB = _rows(a_p, b_p, pA, pB, iota)
        top, L2 = merge_2w_w(L2, row)
        chunks.append(top)
    return torch.cat(chunks + [L2])[:n_out]
