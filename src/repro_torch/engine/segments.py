"""Ragged-batch (segmented) helpers and the torch reference variants.

Counterpart of ``repro/engine/segments.py``. A ragged batch is a flat 1-D
tensor plus an ``(S+1,)`` offsets vector: segment ``s`` is
``values[offsets[s]:offsets[s+1]]``; offsets are non-decreasing with
``offsets[0] == 0`` and ``offsets[-1] == len(values)``; empty segments are
legal. Eager tensors always carry host-readable values, so the JAX
package's ``is_concrete`` checks have no counterpart here: the offsets are
always checked and the tight ``cap`` is always known.

The ``*_ref`` functions are the capacity-padded torch formulations, the
engine's ``torch`` variants, op for op the JAX package's ``xla`` ones:
stable sorts whose order for keys that compare equal with unequal bits
(+0.0 and -0.0) is ``jnp.sort``'s (``kernels.ref.stable_sort_values``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.flims import next_pow2
from repro_torch.core.lanes import plus_inf_for, sentinel_for


def lengths_from_offsets(offsets):
    return torch.diff(offsets)


def offsets_from_lengths(lengths):
    lengths = torch.as_tensor(lengths, dtype=torch.int32)
    return torch.cat([lengths.new_zeros(1),
                      torch.cumsum(lengths, 0, dtype=torch.int32)])


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


def validate_cap(offsets, cap: int) -> None:
    """A cap smaller than the longest segment would truncate it: refuse."""
    o = torch.as_tensor(offsets).cpu()
    if o.shape[0] > 1:
        longest = int(torch.diff(o).max())
        if longest > cap:
            raise ValueError(f"cap={cap} is smaller than the longest segment "
                             f"({longest}); it would be truncated")


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


def pad_segments(values, offsets, cap: int, fill=None):
    """Gather the ragged batch into a dense padded (S, cap) bank (``fill``
    defaults to the dtype sentinel, which sorts last descending)."""
    from repro_torch.kernels.segmented_merge import padded_bank
    return padded_bank(values, offsets, cap, fill=fill)


def unpad_segments(bank, offsets, total: int):
    """Inverse of ``pad_segments``: the valid prefixes gathered back flat."""
    from repro_torch.kernels.segmented_merge import unpad_bank
    return unpad_bank(bank, offsets, total)


def segment_argsort_ref(keys, offsets, *, cap: int = 0,
                        descending: bool = True):
    """Capacity-padded stable per-segment argsort (local positions, int32).

    Uniform segments take the reshape fast path (the MoE-dispatch shape: one
    batched ``torch.argsort``, no padding gather); ragged batches go through
    a bank padded with a key that sorts last in the call's direction, and
    stability keeps real keys ahead of padding on ties, so each segment's
    valid prefix is its stable local permutation either way.
    """
    N, S = keys.shape[0], offsets.shape[0] - 1
    if S <= 0 or N == 0:
        return torch.zeros(N, dtype=torch.int32, device=keys.device)
    lens = torch.diff(torch.as_tensor(offsets).cpu())
    if bool((lens == lens[0]).all()) and int(lens[0]) > 0:
        perm = torch.argsort(keys.reshape(S, int(lens[0])), dim=-1,
                             stable=True, descending=descending)
        return perm.reshape(-1).to(torch.int32)
    cap = cap or next_pow2(N)
    fill = sentinel_for(keys.dtype) if descending else plus_inf_for(
        keys.dtype)
    bank = pad_segments(keys, offsets, cap, fill=fill)
    perm = torch.argsort(bank, dim=-1, stable=True,
                         descending=descending).to(torch.int32)
    return unpad_segments(perm, offsets, N)


def segment_sort_ref(values, offsets, *, cap: int = 0):
    """Capacity-padded segmented sort (descending)."""
    from repro_torch.kernels.ref import stable_sort_values
    N, S = values.shape[0], offsets.shape[0] - 1
    if S <= 0 or N == 0:
        return values.new_zeros((N,))
    cap = cap or next_pow2(N)
    bank = stable_sort_values(pad_segments(values, offsets, cap))
    return unpad_segments(bank, offsets, N)


def segment_merge_ref(a, a_offsets, b, b_offsets):
    """Capacity-padded segmented merge (descending): per segment, the
    multiset union of the two runs, sorted. Sentinels pad and sort last.
    Each side pads to the power of two over its longest run; the JAX
    reference, which may see traced offsets, pads to ``next_pow2(n_out)``,
    with the same result."""
    from repro_torch.kernels.ref import stable_sort_values
    n_out, S = a.shape[0] + b.shape[0], a_offsets.shape[0] - 1
    if S <= 0 or n_out == 0:
        return a.new_zeros((n_out,))
    cap = max(static_cap(a_offsets, a.shape[0]),
              static_cap(b_offsets, b.shape[0]))
    bank = torch.cat([pad_segments(a, a_offsets, cap),
                      pad_segments(b, b_offsets, cap)], dim=-1)
    out_offsets = (a_offsets + b_offsets).to(torch.int32)
    return unpad_segments(stable_sort_values(bank), out_offsets, n_out)


def segment_sort_oracle(values, offsets):
    """NumPy per-segment oracle (host-side, tests and debugging only)."""
    v = np.asarray(values.cpu() if isinstance(values, torch.Tensor)
                   else values)
    o = np.asarray(offsets.cpu() if isinstance(offsets, torch.Tensor)
                   else offsets)
    return np.concatenate(
        [np.sort(v[o[s]:o[s + 1]])[::-1] for s in range(o.shape[0] - 1)]
        or [np.zeros((0,), v.dtype)])
