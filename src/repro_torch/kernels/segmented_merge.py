"""K3: segmented FLiMS merge of a ragged batch of run pairs in one launch.

Counterpart of the run-merge half of ``repro/kernels/segmented_merge.py``:
``segmented_merge_runs`` / ``segmented_merge_runs_kv`` merge R run pairs
(``a[a_starts[s]:+a_lens[s]]`` with ``b[b_starts[s]:+b_lens[s]]``) over one
flat grid of (segment, C-wide block) pairs, ``G = n_out // C + R`` steps,
each with its own merge-path co-rank bounded by the dynamic run lengths.
This is the single-level pass of the ``tree_cuda`` schedule.

For a CUDA tensor they launch ``csrc/flims_merge.cu``, which reads the runs
in place and writes each block to its flat offset; the TPU kernel's
sentinel-padded banks and (G, C) output gather have no counterpart there.
For a CPU tensor they run the plain version in ``kernels/flims_merge.py``;
the ``*_plain`` twins run it on any device.
``padded_bank`` / ``unpad_bank`` are the dense-bank gathers the torch
reference executor uses.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.core.lanes import sentinel_for
from repro_torch.kernels.flims_merge import (_corank_runs, block_size,
                                             merge_blocks_cuda,
                                             merge_blocks_plain)

__all__ = ["padded_bank", "unpad_bank", "segmented_merge_runs",
           "segmented_merge_runs_kv", "segmented_merge_runs_plain",
           "segmented_merge_runs_kv_plain", "_corank_runs"]


def padded_bank(values, offsets, cap: int, fill=None):
    """Gather a ragged batch into a dense padded (S, cap) bank; shorter
    segments are filled with ``fill`` (default: the dtype sentinel)."""
    S = offsets.shape[0] - 1
    N = values.shape[0]
    fill = sentinel_for(values.dtype) if fill is None else fill
    if N == 0:
        return values.new_full((S, cap), fill)
    offsets = offsets.long()
    lens = torch.diff(offsets)
    idx = torch.arange(cap, device=values.device)
    src = (offsets[:-1, None] + idx[None, :]).clamp(0, N - 1)
    return torch.where(idx[None, :] < lens[:, None], values[src], fill)


def unpad_bank(bank, offsets, total: int):
    """Inverse of ``padded_bank``: the valid prefixes gathered back flat."""
    offsets = offsets.long()
    S = bank.shape[0]
    i = torch.arange(total, device=bank.device)
    s = (torch.searchsorted(offsets, i, right=True) - 1).clamp(0, S - 1)
    return bank[s, i - offsets[s]]


def _segmented(name, a, ra, b, rb, a_starts, a_lens, b_starts, b_lens, *,
               n_out, w, block_out, descending, cuda):
    if a_starts.shape[0] == 0 or n_out == 0:
        empty = a.new_zeros((n_out,))
        return (empty,) if ra is None else (
            empty, torch.zeros(n_out, dtype=torch.int32, device=a.device))
    if a.dtype != b.dtype:
        raise ValueError(f"{name}: key buffers of one dtype")
    if w & (w - 1):
        raise ValueError(f"{name}: w must be a power of two, got {w}")
    if ra is not None:
        ra, rb = ra.to(torch.int32), rb.to(torch.int32)
    R = a_starts.shape[0]
    C = block_size(n_out, w, block_out)
    G = n_out // C + R
    if cuda:
        i32 = lambda t: t.to(torch.int32).contiguous()
        return merge_blocks_cuda(
            name, a, ra, b, rb, i32(a_starts), i32(a_lens), i32(b_starts),
            i32(b_lens), n_out=n_out, C=C, w=w, G=G, descending=descending)
    return merge_blocks_plain(a, ra, b, rb, a_starts, a_lens, b_starts,
                              b_lens, n_out=n_out, C=C, w=w, G=G,
                              descending=descending)


@obs.scoped("kernels.segmented_merge_runs")
def segmented_merge_runs(a, b, a_starts, a_lens, b_starts, b_lens, *,
                         n_out: int, w: int = 32, block_out: int = 1024):
    """Merge R descending run pairs in one launch. Returns the (n_out,)
    concatenation of the merged runs in run order; ``n_out`` must equal
    ``sum(a_lens) + sum(b_lens)``."""
    return _segmented("segmented_merge_runs", a, None, b, None, a_starts,
                      a_lens, b_starts, b_lens, n_out=n_out, w=w,
                      block_out=block_out, descending=True,
                      cuda=a.is_cuda)[0]


def segmented_merge_runs_plain(a, b, a_starts, a_lens, b_starts, b_lens, *,
                               n_out: int, w: int = 32,
                               block_out: int = 1024):
    """``segmented_merge_runs``' plain version, on any device."""
    return _segmented("segmented_merge_runs", a, None, b, None, a_starts,
                      a_lens, b_starts, b_lens, n_out=n_out, w=w,
                      block_out=block_out, descending=True, cuda=False)[0]


@obs.scoped("kernels.segmented_merge_runs_kv")
def segmented_merge_runs_kv(a, ra, b, rb, a_starts, a_lens, b_starts, b_lens,
                            *, n_out: int, w: int = 32, block_out: int = 1024,
                            descending: bool = True):
    """Stable KV form of ``segmented_merge_runs`` over (key, int32 rank)
    lanes under the compound order. Returns ``(keys, ranks)``."""
    return _segmented("segmented_merge_runs_kv", a, ra, b, rb, a_starts,
                      a_lens, b_starts, b_lens, n_out=n_out, w=w,
                      block_out=block_out, descending=descending,
                      cuda=a.is_cuda)


def segmented_merge_runs_kv_plain(a, ra, b, rb, a_starts, a_lens, b_starts,
                                  b_lens, *, n_out: int, w: int = 32,
                                  block_out: int = 1024,
                                  descending: bool = True):
    """``segmented_merge_runs_kv``' plain version, on any device."""
    return _segmented("segmented_merge_runs_kv", a, ra, b, rb, a_starts,
                      a_lens, b_starts, b_lens, n_out=n_out, w=w,
                      block_out=block_out, descending=descending, cuda=False)
