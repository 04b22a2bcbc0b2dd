"""K3, K5 and K6: the ragged-batch kernels, and their compositions.

Counterpart of ``repro/kernels/segmented_merge.py``.

- K3 ``segmented_merge_runs`` / ``segmented_merge_runs_kv`` merge R run
  pairs (``a[a_starts[s]:+a_lens[s]]`` with ``b[b_starts[s]:+b_lens[s]]``)
  over one flat grid of (segment, C-wide block) pairs, ``G = n_out // C +
  R`` steps, each with its own merge-path co-rank bounded by the dynamic
  run lengths. This is the single-level pass of the ``tree_cuda`` schedule,
  and ``segmented_merge`` (two ragged batches, by offsets) is one launch of
  it.
- K5 ``segment_sort`` and K6 ``segment_sort_kv`` (with ``segment_argsort``
  over it) sort every segment of a ragged batch in one launch, each padded
  to the static power-of-two ``cap`` (``csrc/segment_sort.cu``: K1's
  register network, one segment a warp up to cap 256 and a CTA above; a
  NaN-free segment sorts ``next_pow2(len)`` lanes, which leave the same
  valid prefix, and a segment holding a NaN the whole cap). Past
  ``MAX_CAP`` / ``MAX_CAP_KV`` the card takes the JAX wrapper's own route,
  the plain version's: ``padded_bank``, K1's launch over the whole cap (its
  network past shared memory), ``unpad_bank``; the launch counts as K5's
  or K6's.
- ``segment_sort_two_phase`` / ``segment_argsort_two_phase`` are K1 over
  every segment's ``chunk``-wide rows, then a ``tree_cuda`` schedule over
  each segment's ``cap // chunk`` runs (K4, or K3 at one level).

For a CUDA tensor the wrappers launch the kernels, which read runs and
segments in place and write straight to flat offsets; the TPU kernels'
sentinel-padded banks and padded outputs have no counterpart there. For a
CPU tensor they run the plain versions (``kernels/flims_merge.py`` for K3,
the padded bank and ``kernels/bitonic_sort.py``'s networks for K5/K6); the
``*_plain`` twins run those on any device. ``padded_bank`` / ``unpad_bank``
are the dense-bank gathers of the plain versions and the torch reference.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.core.flims import next_pow2
from repro_torch.core.lanes import INVALID_RANK, sentinel_for
from repro_torch.kernels import _build
from repro_torch.kernels.bitonic_sort import (_bitonic_rows_desc,
                                              _bitonic_rows_kv, _launch)
from repro_torch.kernels.flims_merge import (_corank_runs, block_size,
                                             bound_keys, merge_blocks_cuda,
                                             merge_blocks_plain)

__all__ = ["padded_bank", "unpad_bank", "segmented_merge_runs",
           "segmented_merge_runs_kv", "segmented_merge_runs_plain",
           "segmented_merge_runs_kv_plain", "segmented_merge",
           "segment_sort", "segment_sort_plain", "segment_sort_kv",
           "segment_sort_kv_plain", "segment_argsort",
           "segment_sort_two_phase", "segment_argsort_two_phase",
           "MAX_CAP", "MAX_CAP_KV", "_corank_runs"]

#: the largest ``cap`` sorted a segment a CTA: cap * 4 B of keys in one
#: CTA's shared memory (K5); a larger cap sorts an (S, cap) bank with K1
MAX_CAP = 32768
#: ... and cap * 8 B of keys and ranks (K6, at 1024 threads of 16 lanes)
MAX_CAP_KV = 16384


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
               n_out, w, block_out, descending, cuda, ctas=0):
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
            i32(b_lens), n_out=n_out, C=C, w=w, G=G, descending=descending,
            ctas=ctas)
    return merge_blocks_plain(a, ra, b, rb, a_starts, a_lens, b_starts,
                              b_lens, n_out=n_out, C=C, w=w, G=G,
                              descending=descending)


@obs.scoped("kernels.segmented_merge_runs")
def segmented_merge_runs(a, b, a_starts, a_lens, b_starts, b_lens, *,
                         n_out: int, w: int = 32, block_out: int = 1024,
                         _ctas: int = 0):
    """Merge R descending run pairs in one launch. Returns the (n_out,)
    concatenation of the merged runs in run order, cut at ``n_out`` (at
    most ``sum(a_lens) + sum(b_lens)``). ``_ctas`` (tests only) forces the
    CUDA kernel's CTA count."""
    return _segmented("segmented_merge_runs", a, None, b, None, a_starts,
                      a_lens, b_starts, b_lens, n_out=n_out, w=w,
                      block_out=block_out, descending=True,
                      cuda=a.is_cuda, ctas=_ctas)[0]


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
                            descending: bool = True, _ctas: int = 0):
    """Stable KV form of ``segmented_merge_runs`` over (key, int32 rank)
    lanes under the compound order. Returns ``(keys, ranks)``. ``_ctas``
    (tests only) forces the CUDA kernel's CTA count."""
    return _segmented("segmented_merge_runs_kv", a, ra, b, rb, a_starts,
                      a_lens, b_starts, b_lens, n_out=n_out, w=w,
                      block_out=block_out, descending=descending,
                      cuda=a.is_cuda, ctas=_ctas)


def segmented_merge_runs_kv_plain(a, ra, b, rb, a_starts, a_lens, b_starts,
                                  b_lens, *, n_out: int, w: int = 32,
                                  block_out: int = 1024,
                                  descending: bool = True):
    """``segmented_merge_runs_kv``' plain version, on any device."""
    return _segmented("segmented_merge_runs_kv", a, ra, b, rb, a_starts,
                      a_lens, b_starts, b_lens, n_out=n_out, w=w,
                      block_out=block_out, descending=descending, cuda=False)


@obs.scoped("kernels.segmented_merge")
def segmented_merge(a, a_offsets, b, b_offsets, *, w: int = 32,
                    block_out: int = 1024):
    """Merge S segment pairs described by offset vectors in one K3 launch
    (counterpart of ``segmented_merge_pallas``): segment s of the result is
    the descending merge of a-run s and b-run s, at offsets ``a_offsets +
    b_offsets``. Empty segments are fine."""
    if a.ndim != 1 or b.ndim != 1 or a.dtype != b.dtype:
        raise ValueError("segmented_merge: two 1-D key tensors of one dtype")
    if a_offsets.shape != b_offsets.shape or a_offsets.ndim != 1:
        raise ValueError("segmented_merge: (S+1,) offsets of one shape")
    S = a_offsets.shape[0] - 1
    n_out = a.shape[0] + b.shape[0]
    if S <= 0 or n_out == 0:
        return a.new_zeros((n_out,))
    ao, bo = a_offsets.to(torch.int32), b_offsets.to(torch.int32)
    return segmented_merge_runs(a, b, ao[:-1], torch.diff(ao), bo[:-1],
                                torch.diff(bo), n_out=n_out, w=w,
                                block_out=block_out)


# --------------------------------------------------------------------------
# K5 / K6: fused segmented sort in one launch
# --------------------------------------------------------------------------

def _rank_bank(offsets, cap: int):
    """(S, cap) int32 bank of segment-local positions; padding is
    INVALID_RANK."""
    lens = torch.diff(offsets.to(torch.int32))
    idx = torch.arange(cap, dtype=torch.int32, device=offsets.device)
    return torch.where(idx[None, :] < lens[:, None], idx[None, :],
                       INVALID_RANK)


def _segment_geometry(name, keys, offsets, cap):
    if keys.ndim != 1 or offsets.ndim != 1:
        raise ValueError(f"{name}: 1-D keys and (S+1,) offsets")
    S, N = offsets.shape[0] - 1, keys.shape[0]
    cap = cap or next_pow2(max(N, 1))
    if cap & (cap - 1):
        raise ValueError(f"{name}: cap must be a power of two, got {cap}")
    return S, N, cap


def _segment_sort_cuda(name, keys, offsets, cap, kv, descending):
    offsets = offsets.to(torch.int32).contiguous()
    _build.check_cuda(name, keys, offsets)
    code = _build.dtype_code(name, keys.dtype)
    out = torch.empty_like(keys)
    perm = torch.empty(keys.shape, dtype=torch.int32, device=keys.device) \
        if kv else None
    P = _build.ptr
    _build.launch(name, "flims_segment_sort", code, int(kv), int(descending),
                  P(keys), P(offsets), P(out), P(perm), offsets.shape[0] - 1,
                  cap, _build.stream(keys.device))
    return (out,) if not kv else (out, perm)


def _segment_sort(values, offsets, cap, cuda):
    S, N, cap = _segment_geometry("segment_sort", values, offsets, cap)
    if S <= 0 or N == 0:
        return values.new_zeros((N,))
    if cuda and cap <= MAX_CAP:
        return _segment_sort_cuda("segment_sort", values, offsets, cap,
                                  False, True)[0]
    offsets = offsets.to(torch.int32)
    bank = padded_bank(values, offsets, cap)
    out = _launch("segment_sort", bank, None, True)[0] if cuda \
        else _bitonic_rows_desc(bank)
    return unpad_bank(out, offsets, N)


def _segment_sort_kv(keys, offsets, cap, descending, cuda):
    S, N, cap = _segment_geometry("segment_sort_kv", keys, offsets, cap)
    if S <= 0 or N == 0:
        return keys.new_zeros((N,)), torch.zeros(N, dtype=torch.int32,
                                                 device=keys.device)
    if cuda and cap <= MAX_CAP_KV:
        return _segment_sort_cuda("segment_sort_kv", keys, offsets, cap,
                                  True, descending)
    offsets = offsets.to(torch.int32)
    _, last = bound_keys(keys.dtype, descending)
    bank = padded_bank(keys, offsets, cap, fill=last)
    ranks = _rank_bank(offsets, cap)
    ok, orr = _launch("segment_sort_kv", bank, ranks, descending) if cuda \
        else _bitonic_rows_kv(bank, ranks, descending)
    return unpad_bank(ok, offsets, N), unpad_bank(orr, offsets, N)


@obs.scoped("kernels.segment_sort")
def segment_sort(values, offsets, *, cap: int = 0):
    """Sort every segment of a ragged batch descending in one K5 launch
    (counterpart of ``segment_sort_pallas``): each segment padded to the
    power-of-two ``cap`` (default ``next_pow2(len(values))``) and run
    through the full bitonic network with XLA's max/min. ``cap`` must cover
    the longest segment (``engine.segment_sort`` checks it)."""
    return _segment_sort(values, offsets, cap, values.is_cuda)


def segment_sort_plain(values, offsets, *, cap: int = 0):
    """``segment_sort``' plain version, on any device: the padded bank,
    ``_bitonic_rows_desc``, the unpad."""
    return _segment_sort(values, offsets, cap, False)


@obs.scoped("kernels.segment_sort_kv")
def segment_sort_kv(keys, offsets, *, cap: int = 0, descending: bool = True):
    """Fused stable KV segment sort in one K6 launch (counterpart of
    ``segment_sort_kv_pallas``). Returns ``(sorted_keys, perm)`` flat over
    the ragged batch; ``perm`` holds segment-local source positions."""
    return _segment_sort_kv(keys, offsets, cap, descending, keys.is_cuda)


def segment_sort_kv_plain(keys, offsets, *, cap: int = 0,
                          descending: bool = True):
    """``segment_sort_kv``' plain version, on any device."""
    return _segment_sort_kv(keys, offsets, cap, descending, False)


def segment_argsort(keys, offsets, *, cap: int = 0, descending: bool = True):
    """Stable per-segment argsort over K6: the local permutation only."""
    return segment_sort_kv(keys, offsets, cap=cap, descending=descending)[1]


# --------------------------------------------------------------------------
# two-phase: K1 over every segment's chunk rows, then the tree_cuda schedule
# --------------------------------------------------------------------------

def _two_phase_geometry(name, keys, offsets, cap, chunk):
    if keys.ndim != 1 or offsets.ndim != 1:
        raise ValueError(f"{name}: 1-D keys and (S+1,) offsets")
    if cap & (cap - 1) or chunk & (chunk - 1) or cap < 1 or chunk < 1:
        raise ValueError(f"{name}: cap and chunk must be powers of two")
    return offsets.shape[0] - 1, keys.shape[0], min(chunk, cap)


def _run_schedule(chunk: int, w: int, levels: int):
    from repro_torch.engine.schedule import MergeSchedule
    return MergeSchedule("tree_cuda", levels_per_pass=levels,
                         w=min(w, chunk), block_out=max(2 * chunk, w))


@obs.scoped("kernels.segment_sort_two_phase")
def segment_sort_two_phase(values, offsets, *, cap: int, chunk: int = 256,
                           w: int = 32, levels: int = 1):
    """Two-phase segmented sort (counterpart of ``segment_sort_two_phase``):
    one K1 launch over every segment's ``chunk``-wide rows of the padded
    bank, then a ``tree_cuda`` schedule over each segment's ``cap // chunk``
    runs (``levels`` tree levels per pass). Sentinels ride through the
    merges and sort last, so each segment's valid prefix is its sort."""
    from repro_torch.engine.schedule import merge_runs
    from repro_torch.kernels.bitonic_sort import sort_chunks
    S, N, chunk = _two_phase_geometry("segment_sort_two_phase", values,
                                      offsets, cap, chunk)
    if S <= 0 or N == 0:
        return values.new_zeros((N,))
    offsets = offsets.to(torch.int32)
    bank = padded_bank(values, offsets, cap)
    flat = sort_chunks(bank.reshape(S * (cap // chunk), chunk)).reshape(-1)
    if cap > chunk:
        run_offs = torch.arange(S * (cap // chunk) + 1, dtype=torch.int32,
                                device=values.device) * chunk
        flat = merge_runs(flat, run_offs,
                          schedule=_run_schedule(chunk, w, levels),
                          runs_per_group=cap // chunk)
    return unpad_bank(flat.reshape(S, cap), offsets, N)


@obs.scoped("kernels.segment_argsort_two_phase")
def segment_argsort_two_phase(keys, offsets, *, cap: int, chunk: int = 256,
                              w: int = 32, descending: bool = True,
                              levels: int = 1):
    """Two-phase stable per-segment argsort (counterpart of
    ``segment_argsort_two_phase``): one K1kv launch over every segment's
    rows of (key, local rank) lanes, then the KV ``tree_cuda`` schedule.
    Earlier chunks hold smaller local ranks, so the compound order keeps
    every pass stable; the rank lane of the merged bank is the
    permutation."""
    from repro_torch.engine.schedule import merge_runs
    from repro_torch.kernels.bitonic_sort import sort_chunks_kv
    S, N, chunk = _two_phase_geometry("segment_argsort_two_phase", keys,
                                      offsets, cap, chunk)
    if S <= 0 or N == 0:
        return torch.zeros(N, dtype=torch.int32, device=keys.device)
    offsets = offsets.to(torch.int32)
    _, last = bound_keys(keys.dtype, descending)
    kb = padded_bank(keys, offsets, cap, fill=last)
    rows = S * (cap // chunk)
    kr, rr = sort_chunks_kv(kb.reshape(rows, chunk),
                            _rank_bank(offsets, cap).reshape(rows, chunk),
                            descending=descending)
    kflat, rflat = kr.reshape(-1), rr.reshape(-1)
    if cap > chunk:
        run_offs = torch.arange(rows + 1, dtype=torch.int32,
                                device=keys.device) * chunk
        kflat, rflat = merge_runs(kflat, run_offs, ranks=rflat,
                                  schedule=_run_schedule(chunk, w, levels),
                                  runs_per_group=cap // chunk,
                                  descending=descending)
    return unpad_bank(rflat.reshape(S, cap), offsets, N)
