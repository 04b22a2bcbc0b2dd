"""Ragged-batch helpers the schedule and api use.

Counterpart of part of ``repro/engine/segments.py``. A ragged batch is a
flat 1-D tensor plus an ``(S+1,)`` offsets vector: segment ``s`` is
``values[offsets[s]:offsets[s+1]]``; offsets are non-decreasing with
``offsets[0] == 0`` and ``offsets[-1] == len(values)``. Eager tensors always
carry host-readable values, so the JAX package's ``is_concrete`` checks have
no counterpart here.
"""
from __future__ import annotations

import torch

from repro_torch.core.flims import next_pow2


def validate_offsets(offsets, total: int) -> None:
    """Host-side check of an offsets vector (reads it back from the
    device)."""
    o = torch.as_tensor(offsets).cpu()
    if o.ndim != 1 or o.shape[0] < 1:
        raise ValueError(f"offsets must be 1-D (S+1,), got shape "
                         f"{tuple(o.shape)}")
    if int(o[0]) != 0 or int(o[-1]) != total:
        raise ValueError(f"offsets must span [0, {total}], got "
                         f"[{int(o[0])}, {int(o[-1])}]")
    if bool((torch.diff(o) < 0).any()):
        raise ValueError("offsets must be non-decreasing")


def static_cap(offsets, total: int) -> int:
    """Power-of-two per-segment capacity covering the longest segment."""
    o = torch.as_tensor(offsets)
    if o.shape[0] > 1:
        return next_pow2(int(torch.diff(o).max()))
    return next_pow2(total)


def segment_ids(offsets, total: int) -> torch.Tensor:
    """(total,) segment id of every flat position."""
    i = torch.arange(total, device=offsets.device)
    S = offsets.shape[0] - 1
    return (torch.searchsorted(offsets.long(), i, right=True) - 1).clamp(
        0, max(S - 1, 0))


def reverse_segments(values, offsets, total: int):
    """Reverse each segment in place (descending <-> ascending)."""
    offsets = offsets.long()
    s = segment_ids(offsets, total)
    i = torch.arange(total, device=values.device)
    lens = torch.diff(offsets)
    return values[offsets[s] + lens[s] - 1 - (i - offsets[s])]
