"""Data layout of the sharded ops (counterpart of the part of
``repro/parallel/sharding.py`` they use).

SPMD: a rank holds its own block. :func:`data_shard_1d` slices a global
1-D tensor (or a tree of them) to this rank's block along a mesh axis;
:func:`collect_prefixes` / :func:`collect_sorted` gather every rank's
padded run and count (one ``all_gather`` each) and return the valid
prefixes in global order, on every rank. The parameter, batch and cache
specs of the JAX module are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.core.butterfly import tree_map
from repro_torch.parallel import comm


def data_shard_1d(x, mesh, axis: str = "data"):
    """This rank's contiguous block of a global 1-D tensor (or a tree of
    same-length 1-D tensors) split evenly over ``axis``: the input layout
    of ``engine.sharded_sort`` / ``sharded_topk``."""
    P = mesh.axis_size(axis)
    i = mesh.axis_index(axis)

    def one(v):
        if v.shape[0] % P:
            raise ValueError(f"data_shard_1d: length {v.shape[0]} does not "
                             f"split {P} ways")
        n = v.shape[0] // P
        return v[i * n:(i + 1) * n].clone()
    return tree_map(one, x)


def collect_prefixes(values: torch.Tensor, count: torch.Tensor, mesh,
                     axis: str = "data") -> torch.Tensor:
    """Every rank's valid prefix of ``values`` (this rank's padded run of a
    sharded-sort result, keys or a payload leaf) in rank order: the flat
    (sum of counts,) tensor, on every rank."""
    v = comm.all_gather(values, axis, mesh)
    c = comm.all_gather(count.reshape(1).to(torch.int32), axis, mesh)
    c = c.reshape(-1).tolist()
    return torch.cat([v[i][:c[i]] for i in range(len(c))])


def collect_sorted(result, payload=None, *, mesh, axis: str = "data"):
    """Gather a ``ShardedSort`` (and the matching payload tree) into flat
    tensors in global descending order, on every rank."""
    keys = collect_prefixes(result.values, result.count, mesh, axis)
    if payload is None:
        return keys
    return keys, tree_map(
        lambda v: collect_prefixes(v, result.count, mesh, axis), payload)
