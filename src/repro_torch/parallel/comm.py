"""Collectives over one axis of a :class:`~repro_torch.launch.mesh.Mesh`:
the port's counterparts of the ``lax`` collectives the JAX package calls
inside ``shard_map``.

Each takes a tensor, an axis name and the mesh (by default the current
one, ``with mesh:``) and returns what the ``lax`` collective returns on
that device:

- :func:`all_to_all`: equal splits along dim 0, split ``j`` to the ``j``-th
  rank of the axis, received splits concatenated in rank order
  (``lax.all_to_all(split_axis=0, concat_axis=0, tiled=True)``);
- :func:`all_gather`: a new leading axis of size P (``lax.all_gather``);
- :func:`psum` / :func:`pmax`: the sum / maximum over the axis. ``psum``
  gathers the P operands and adds them in rank order, so every rank holds
  the same bits whatever the transport's reduction order;
- :func:`broadcast`: the source rank's tensor on every rank;
- :func:`axis_index` / :func:`axis_size`.

Under ``nccl`` CUDA tensors go to the collective as they are (a CPU tensor
goes to the rank's card first). Under ``gloo`` a CUDA tensor is copied to
the host, exchanged there, and copied back: written out here, never left
to whatever gloo accepts, and counted in :func:`host_staged_bytes` and the
``dist.host_staged_bytes`` counter of ``obs`` (both directions). ``bool``
tensors travel as ``uint8``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import obs

__all__ = ["all_to_all", "all_gather", "psum", "pmax", "broadcast",
           "agree_flag", "axis_index", "axis_size", "host_staged_bytes"]

_staged_bytes = 0


def host_staged_bytes() -> int:
    """Bytes copied between the card and the host for gloo collectives in
    this process so far (both directions)."""
    return _staged_bytes


def _mesh(mesh):
    if mesh is not None:
        return mesh
    from repro_torch.launch.mesh import current_mesh
    m = current_mesh()
    if m is None:
        raise RuntimeError("no mesh: pass mesh= or enter one (`with mesh:`)")
    return m


def _to_wire(mesh, x: torch.Tensor) -> torch.Tensor:
    """The tensor the transport takes: on the host for gloo, on the card
    for nccl; bool as uint8; contiguous."""
    global _staged_bytes
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    if mesh.backend == "gloo" and x.is_cuda:
        _staged_bytes += x.numel() * x.element_size()
        obs.inc("dist.host_staged_bytes", x.numel() * x.element_size())
        x = x.to("cpu")
    elif mesh.backend == "nccl" and not x.is_cuda:
        x = x.to(mesh.device)
    return x.contiguous()


def _from_wire(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    global _staged_bytes
    if y.device != like.device:
        if like.is_cuda and not y.is_cuda:
            _staged_bytes += y.numel() * y.element_size()
            obs.inc("dist.host_staged_bytes", y.numel() * y.element_size())
        y = y.to(like.device)
    return y.to(like.dtype) if y.dtype != like.dtype else y


def axis_size(axis: str, mesh=None) -> int:
    return _mesh(mesh).axis_size(axis)


def axis_index(axis: str, mesh=None) -> int:
    return _mesh(mesh).axis_index(axis)


def all_to_all(x: torch.Tensor, axis: str, mesh=None) -> torch.Tensor:
    """Split dim 0 into P equal parts, send part ``j`` to rank ``j`` of the
    axis, return the received parts in rank order (same shape as ``x``)."""
    mesh = _mesh(mesh)
    P = mesh.axis_size(axis)
    if x.shape[0] % P:
        raise ValueError(f"all_to_all: dim 0 of {tuple(x.shape)} does not "
                         f"split {P} ways")
    if P == 1:
        return x.clone()
    w = _to_wire(mesh, x)
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=mesh.group(axis))
    return _from_wire(out, x)


def all_gather(x: torch.Tensor, axis: str, mesh=None) -> torch.Tensor:
    """``(P,) + x.shape``: every rank's ``x`` in rank order."""
    mesh = _mesh(mesh)
    P = mesh.axis_size(axis)
    if P == 1:
        return x[None].clone()
    w = _to_wire(mesh, x)
    parts = [torch.empty_like(w) for _ in range(P)]
    dist.all_gather(parts, w, group=mesh.group(axis))
    return _from_wire(torch.stack(parts), x)


def psum(x: torch.Tensor, axis: str, mesh=None) -> torch.Tensor:
    """The sum over the axis, added in rank order (the same bits on every
    rank; for floats, in ``x``'s dtype)."""
    g = all_gather(x, axis, mesh)
    out = g[0].clone()
    for i in range(1, g.shape[0]):
        out += g[i]
    return out


def pmax(x: torch.Tensor, axis: str, mesh=None) -> torch.Tensor:
    """The elementwise maximum over the axis."""
    mesh = _mesh(mesh)
    if mesh.axis_size(axis) == 1:
        return x.clone()
    if x.dtype == torch.bool:
        return all_gather(x, axis, mesh).any(0)
    w = _to_wire(mesh, x)
    w = w.clone() if w.data_ptr() == x.data_ptr() else w
    dist.all_reduce(w, op=dist.ReduceOp.MAX, group=mesh.group(axis))
    return _from_wire(w, x)


def broadcast(x: torch.Tensor, axis: str, src: int = 0,
              mesh=None) -> torch.Tensor:
    """Rank ``src`` (its index along the axis) of the axis's ``x`` on every
    rank of the axis."""
    mesh = _mesh(mesh)
    if mesh.axis_size(axis) == 1:
        return x.clone()
    g = mesh.group(axis)
    w = _to_wire(mesh, x)
    w = w.clone() if w.data_ptr() == x.data_ptr() else w
    dist.broadcast(w, src=dist.get_global_rank(g, src), group=g)
    return _from_wire(w, x)


def agree_flag(flag: bool, axis: str, mesh=None) -> bool:
    """True on every rank of the axis when ``flag`` is true on any."""
    t = torch.tensor([1 if flag else 0], dtype=torch.int32)
    return bool(pmax(t, axis, mesh)[0])
