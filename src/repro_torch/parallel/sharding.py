"""Parameter / activation sharding rules (TP + FSDP + EP + SP) and the data
layout of the sharded ops (counterpart of ``repro/parallel/sharding.py``).

Name-based rules map every parameter leaf to a spec on the production mesh
axes: a tuple with one entry per dim, each an axis name, a tuple of names
or ``None`` (``jax.sharding.PartitionSpec``'s entries; a tuple of one name
is written as the name, as ``PartitionSpec`` writes it). Leading stacked
layer dims are replicated; dims that do not divide their axes fall back to
``None``, so the same rules serve a 2-rank test mesh and the 512-chip pod.
The rules read only axis names and sizes, so they take a
:class:`~repro_torch.launch.mesh.Mesh`, an ``AbstractMesh`` of the
production shapes, or anything else with ``axis_names`` and ``shape``.

SPMD: a rank holds its own block of every leaf. :func:`shard_leaf` cuts it
from a whole leaf, :func:`gather_leaf` puts the whole leaf back (one
``all_gather`` per named axis), :func:`param_blocks` cuts a tree.
Along a dim named by several axes the block index runs row-major over
them, as in ``NamedSharding``.

:func:`data_shard_1d` slices a global 1-D tensor (or a tree of them) to
this rank's block along a mesh axis; :func:`collect_prefixes` /
:func:`collect_sorted` gather every rank's padded run and count (one
``all_gather`` each) and return the valid prefixes in global order, on
every rank.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.core.butterfly import tree_map
from repro_torch.models.config import ShardingConfig
from repro_torch.parallel import comm

__all__ = ["param_specs", "batch_spec", "cache_specs", "layer_dims",
           "NamedSharding", "shard_leaf", "gather_leaf", "param_blocks",
           "block_slices", "spec_axes", "tree_map_like",
           "data_shard_1d", "collect_prefixes", "collect_sorted"]


class NamedSharding(NamedTuple):
    """A spec on a mesh (``jax.sharding.NamedSharding``'s two parts)."""
    mesh: Any
    spec: tuple


# --------------------------------------------------------------------------
# trees: walked by a tree's own structure, specs at its leaves
# --------------------------------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map_like(fn, like, *rest):
    """``fn(leaf, *matching entries of rest)`` over the leaves of ``like``
    (dicts, lists, tuples and NamedTuples), the result in ``like``'s
    structure. ``rest`` are trees of ``like``'s structure down to its
    leaves, whose entries there may be anything (a spec, a sharding)."""
    if isinstance(like, dict):
        return {k: tree_map_like(fn, like[k], *(r[k] for r in rest))
                for k in like}
    if _is_namedtuple(like):
        return type(like)(*(tree_map_like(fn, getattr(like, f),
                                          *(getattr(r, f) for r in rest))
                            for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(tree_map_like(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(like))
    return fn(like, *rest)


def _map_with_path(fn, tree, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over ``tree``; a path holds dict keys and list or
    tuple indices as strings (the JAX rules' ``names``)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_map_with_path(fn, getattr(tree, f),
                                           path + (f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


# --------------------------------------------------------------------------
# the rules
# --------------------------------------------------------------------------

def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= mesh.shape[a]
        return n
    return mesh.shape[axis]


def _entry(ax):
    """``PartitionSpec``'s form of one entry: a tuple of one name is the
    name."""
    if isinstance(ax, tuple) and len(ax) == 1:
        return ax[0]
    return ax


def _fit(spec_dims, shape, mesh) -> tuple:
    """Drop axis assignments that don't divide the dim size."""
    out = []
    for dim, ax in zip(shape, spec_dims):
        if ax is not None and dim % _axis_size(mesh, ax) != 0:
            ax = None
        out.append(_entry(ax))
    return tuple(out)


# base rules: last-key-name -> (spec for the *trailing* dims of the leaf)
def _base_rule(path: Tuple[str, ...], shape, sc: ShardingConfig,
               sizes: dict, zero: bool = False):
    name = path[-1]
    parent = path[-2] if len(path) > 1 else ""
    tp = sc.model_axis or None          # "" -> pure-FSDP mode (no TP)
    fs = (sc.fsdp_axis or None) if (sc.fsdp_params or zero) else None
    # --- embeddings / norms ------------------------------------------------
    if name == "embed":
        return (tp, fs)                       # vocab on TP, d on FSDP
    if "norm" in name or name in ("b", "fb", "conv_b", "dt_bias",
                                  "A_log", "D"):
        return (None,) * len(shape)
    # --- MoE ---------------------------------------------------------------
    if parent == "moe" or (len(path) > 1 and "moe" in path):
        if name == "router":
            return (fs, None)
        mode = sc.expert_mode
        # auto-fallback: an expert count that doesn't divide the TP axis
        # would replicate the expert products -- shard f instead. As the
        # JAX rule, this reads shape[0], the layer count of a stacked leaf,
        # and takes 16 for an axis the mesh lacks.
        if mode == "expert" and name in ("wi", "wg", "wo") and tp is not None:
            if shape and shape[0] % sizes.get(tp, 16) != 0:
                mode = "ffn"
        # Expert PARAMS skip FSDP on the contraction dim; optimizer state
        # (zero=True) keeps the FSDP shard -- ZeRO-1.
        efs = fs if zero else None
        if mode == "expert":
            return {"wi": (tp, efs, None), "wg": (tp, efs, None),
                    "wo": (tp, None, efs)}.get(name, (None,) * len(shape))
        return {"wi": (None, efs, tp), "wg": (None, efs, tp),
                "wo": (None, tp, efs)}.get(name, (None,) * len(shape))
    # --- attention / generic projections ------------------------------------
    if name in ("wq", "wk", "wv", "wi", "wg", "wif", "wx", "wh", "in_proj"):
        return (fs, tp)
    if name in ("wo", "out_proj"):
        return (tp, fs)
    if name in ("bq", "bk", "bv"):
        return (tp,)
    if name == "conv_w":
        return (None, tp)
    if name == "router":
        return (fs, None)
    return (None,) * len(shape)


def _leaf_spec(path, shape, sc: ShardingConfig, mesh, sizes: dict,
               zero: bool = False) -> tuple:
    base = tuple(_base_rule(path, shape, sc, sizes, zero=zero))
    # prefix None for stacked layer dims
    extra = len(shape) - len(base)
    if extra > 0:
        dims = (None,) * extra + base
    else:
        dims = base[-len(shape):] if shape else ()
    return _fit(dims, shape, mesh)


def layer_dims(path: Tuple[str, ...], shape, sc: ShardingConfig) -> int:
    """The leading stacked (layer) dims of a leaf: those its rule leaves
    to the ``None`` prefix (a norm's rule covers every dim, so 0)."""
    return max(len(shape) - len(tuple(_base_rule(path, shape, sc, {}))), 0)


def _sizes(mesh) -> dict:
    return {a: mesh.shape[a] for a in mesh.axis_names}


def param_specs(params, sc: ShardingConfig, mesh, zero: bool = False):
    """Tree of specs matching ``params`` (tensors, ``meta`` ones included).
    ``zero=True``: the optimizer-state layout (always FSDP-sharded, ZeRO-1
    even where the params are not)."""
    sizes = _sizes(mesh)
    return _map_with_path(
        lambda path, leaf: _leaf_spec(path, tuple(leaf.shape), sc, mesh,
                                      sizes, zero=zero), params)


def batch_spec(batch_shape_tree, sc: ShardingConfig, mesh):
    """Batch dims shard over the data axes; axes are dropped (innermost
    first) until the batch size divides -- so a 32-request prefill shards
    over (pod, data) even when training shards over (pod, data, model)."""
    dp_all = tuple(a for a in sc.data_axes if a in mesh.axis_names)

    def one(leaf):
        nd = len(leaf.shape)
        dp = dp_all
        while dp and leaf.shape[0] % _axis_size(mesh, dp) != 0:
            dp = dp[:-1]
        return (_entry(dp) if dp else None,) + (None,) * (nd - 1)

    return tree_map(one, batch_shape_tree)


def cache_specs(cache, sc: ShardingConfig, mesh):
    """Decode caches: batch over data axes, kv-heads over TP when divisible;
    with shard_kv_seq, the sequence dim shards over 'data' instead (SP)."""
    dp = tuple(a for a in sc.data_axes if a in mesh.axis_names)
    tp = sc.model_axis

    def one(names, leaf):
        shape = tuple(leaf.shape)
        if "mamba" in names:
            if "S" in names:          # (L, B, H, N, hd)
                return _fit((None, dp, tp, None, None), shape, mesh)
            return _fit((None, dp, None, tp), shape, mesh)   # conv state
        if "mlstm" in names:          # (ng, k-1, B, H, ...) matrix memory
            dims = (None, None, dp, tp) + (None,) * (len(shape) - 4)
            return _fit(dims, shape, mesh)
        if "slstm" in names:          # (ng, B, d)
            return _fit((None, dp, tp), shape, mesh)
        # attention K/V caches: (L, B, W, K, hd)
        if len(shape) == 5:
            if sc.shard_kv_seq:
                dp_sp = tuple(a for a in (dp or ()) if a != "data") or None
                return _fit((None, dp_sp, "data", None, None), shape, mesh)
            return _fit((None, dp, None, tp, None), shape, mesh)
        if len(shape) >= 2:
            return _fit((None, dp) + (None,) * (len(shape) - 2), shape, mesh)
        return (None,) * len(shape)

    return _map_with_path(one, cache)


# --------------------------------------------------------------------------
# SPMD blocks
# --------------------------------------------------------------------------

def spec_axes(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry, outermost first."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _block_index(axes, mesh) -> Tuple[int, int]:
    """(index, count) of this rank's block along a dim split over
    ``axes`` (row-major over them)."""
    idx, n = 0, 1
    for a in axes:
        idx = idx * mesh.axis_size(a) + mesh.axis_index(a)
        n *= mesh.axis_size(a)
    return idx, n


def block_slices(shape, spec, mesh) -> Tuple[slice, ...]:
    """The slices of this rank's block of a leaf of ``shape`` under
    ``spec``."""
    out = []
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        i, n = _block_index(axes, mesh)
        if shape[dim] % n:
            raise ValueError(f"shard_leaf: dim {dim} of {tuple(shape)} "
                             f"does not split {n} ways over {axes}")
        m = shape[dim] // n
        out.append(slice(i * m, (i + 1) * m))
    return tuple(out)


def shard_leaf(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of the whole leaf ``x`` under ``spec``: a copy
    when anything is cut (so ``x`` can be freed), else ``x`` itself."""
    if not any(spec_axes(e) for e in spec):
        return x
    return x[block_slices(tuple(x.shape), spec, mesh)].clone()


def gather_leaf(block: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole leaf from every rank's ``block`` under ``spec``: one
    ``all_gather`` per named axis, dims in spec order, a dim's axes
    innermost first."""
    x = block
    for dim, entry in enumerate(spec):
        for a in reversed(spec_axes(entry)):
            x = comm.all_gather_dim(x, dim, a, mesh)
    return x


def param_blocks(tree, specs, mesh):
    """:func:`shard_leaf` over a tree and its spec tree."""
    return tree_map_like(lambda x, s: shard_leaf(x, s, mesh), tree, specs)


# --------------------------------------------------------------------------
# distributed sort / top-k consumers (engine.sharded)
# --------------------------------------------------------------------------

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
