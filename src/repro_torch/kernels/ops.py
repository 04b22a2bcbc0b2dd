"""Public wrappers over the kernels and the two-level sorter.

Counterpart of ``repro/kernels/ops.py``. ``kernel_sort`` / ``kernel_argsort``
are the paper's complete sorter (§8.2): pad to a power of two of chunks,
sort the chunks with K1, then reduce the sorted rows with a ``tree_cuda``
MergeSchedule whose passes run K4 (two or more fused levels) or K3 (one
level). Each runs on its input's device: the CUDA kernels for a CUDA tensor,
their plain versions for a CPU tensor.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.core.lanes import INVALID_RANK, sentinel_for
from repro_torch.kernels.bitonic_sort import sort_chunks, sort_chunks_kv
from repro_torch.kernels.flims_merge import bound_keys, flims_merge


def merge(a: torch.Tensor, b: torch.Tensor, *, w: int = 128,
          block_out: int = 4096) -> torch.Tensor:
    """Descending merge of two sorted 1-D tensors (K2)."""
    return flims_merge(a, b, w=w, block_out=block_out)


def sort_rows(x: torch.Tensor) -> torch.Tensor:
    """Descending per-row sort of an (m, c) tensor (K1)."""
    return sort_chunks(x)


def _geometry(n: int, chunk: int):
    c = 1
    while c < min(chunk, n):
        c *= 2
    m2 = 1
    while m2 < -(-n // c):
        m2 *= 2
    return c, m2 * c


@obs.scoped("kernels.kernel_sort")
def kernel_sort(x: torch.Tensor, *, chunk: int = 512, w: int = 128,
                descending: bool = True, levels: int = 2) -> torch.Tensor:
    """Full sort of a 1-D tensor: K1 chunk sort, then fused merge-tree
    passes (``levels`` tree levels per pass)."""
    from repro_torch.engine.schedule import MergeSchedule, reduce_rows
    n = x.shape[0]
    if n <= 1:
        return x
    c, n_pad = _geometry(n, chunk)
    xp = torch.cat([x, x.new_full((n_pad - n,), sentinel_for(x.dtype))])
    rows = sort_rows(xp.reshape(-1, c))
    ww = min(w, c)
    sched = MergeSchedule("tree_cuda", levels_per_pass=levels, w=ww,
                          block_out=max(ww, 4096))
    out = reduce_rows(rows, schedule=sched)[:n]
    return out if descending else torch.flip(out, [0])


@obs.scoped("kernels.kernel_argsort")
def kernel_argsort(keys: torch.Tensor, *, chunk: int = 256, w: int = 32,
                   descending: bool = True, levels: int = 2) -> torch.Tensor:
    """Stable argsort of 1-D keys, or row-wise of a (B, n) batch, over (key,
    int32 rank) lanes: one K1kv launch sorts every chunk of every row, then
    fused KV merge-tree passes reduce each row's chunks, one launch per pass
    for the whole batch. Equals ``torch.argsort(stable=True)`` bit-for-bit
    in either direction."""
    from repro_torch.engine.schedule import MergeSchedule, reduce_rows
    rows = keys.reshape(-1, keys.shape[-1])
    B, n = rows.shape
    if n <= 1:
        return torch.zeros(keys.shape, dtype=torch.int32, device=keys.device)
    c, n_pad = _geometry(n, chunk)
    _, last = bound_keys(keys.dtype, descending)
    kp = torch.cat([rows, rows.new_full((B, n_pad - n), last)], dim=1)
    rp = torch.arange(n_pad, dtype=torch.int32, device=keys.device)
    rp[n:] = INVALID_RANK
    k2, r2 = sort_chunks_kv(kp.reshape(-1, c),
                            rp.expand(B, n_pad).reshape(-1, c),
                            descending=descending)
    ww = min(w, c)
    sched = MergeSchedule("tree_cuda", levels_per_pass=levels, w=ww,
                          block_out=max(ww, 4096))
    _, perm = reduce_rows(k2, ranks=r2, schedule=sched,
                          runs_per_group=n_pad // c, descending=descending)
    return perm.reshape(B, n_pad)[:, :n].reshape(keys.shape).contiguous()
