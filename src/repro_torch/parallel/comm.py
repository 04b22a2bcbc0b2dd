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

- :func:`reduce_scatter`: the sum over the axis, this rank's block along
  a dim (``lax.psum_scatter(tiled=True)``), added in rank order;

Differentiable forms, ``torch.autograd.Function``s over the same staged,
counted collectives, for a training step whose compiler does not place
them (``launch/steps.py``):

- :func:`all_gather_dim`: the ranks' blocks concatenated along a dim; its
  backward is a reduce-scatter (``grad="sum"``: the ranks' gradients
  differ, as along an axis whose ranks saw different tokens) or this
  rank's slice (``grad="slice"``: every rank computed the same gradient);
- :func:`psum_exit`: ``psum`` forward, identity backward (the partial
  results of a region whose ranks split the work, leaving it);
- :func:`psum_entry`: identity forward, ``psum`` backward (a replicated
  tensor entering such a region);
- :func:`ppermute`: each rank's tensor to the rank ``perm`` names, zeros
  where no rank sends (``lax.ppermute``); its backward is the inverse
  permutation.

Under ``nccl`` CUDA tensors go to the collective as they are (a CPU tensor
goes to the rank's card first). Under ``gloo`` a CUDA tensor is copied to
the host, exchanged there, and copied back: written out here, never left
to whatever gloo accepts, and counted in :func:`host_staged_bytes`, by
the kind of collective that staged it in
:func:`host_staged_bytes_by_kind`, and in the ``dist.host_staged_bytes``
counter of ``obs`` (both directions). ``bool`` tensors travel as ``uint8``.
:func:`wire_bytes_by_kind` counts the same bytes, what each collective
hands to the transport and gets back, on any device and backend: on CUDA
tensors under ``gloo`` the two are equal.

A mesh whose ``backend`` is :data:`COUNTING` (``launch/op_cost.py``'s
``counting_mesh``: rank 0 of a mesh with no process behind it) sends
nothing: each collective counts its wire bytes as above and returns a
tensor of the shape and dtype the real one returns (every peer's part a
copy of this rank's), so a dry run can walk a step of the production
mesh from one process.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import obs

__all__ = ["all_to_all", "all_gather", "psum", "pmax", "broadcast",
           "reduce_scatter", "ppermute", "all_gather_dim", "psum_exit",
           "psum_entry", "agree_flag", "axis_index",
           "axis_size", "host_staged_bytes", "host_staged_bytes_by_kind",
           "wire_bytes_by_kind", "COUNTING"]

#: the backend name of a counting mesh: collectives count and send nothing
COUNTING = "count"

_staged_bytes = 0
_staged_by_kind: dict = {}
_wire_by_kind: dict = {}


def host_staged_bytes() -> int:
    """Bytes copied between the card and the host for gloo collectives in
    this process so far (both directions)."""
    return _staged_bytes


def host_staged_bytes_by_kind() -> dict:
    """:func:`host_staged_bytes` by the collective that staged them
    (``all_gather``, ``psum``, ``reduce_scatter``, ...)."""
    return dict(_staged_by_kind)


def wire_bytes_by_kind() -> dict:
    """Bytes each kind of collective handed to the transport and got back
    in this process so far (both directions), on any device."""
    return dict(_wire_by_kind)


def _wire(kind: str, x: torch.Tensor) -> None:
    _wire_by_kind[kind] = _wire_by_kind.get(kind, 0) + \
        x.numel() * x.element_size()


def _count(kind: str, n: int) -> None:
    global _staged_bytes
    _staged_bytes += n
    _staged_by_kind[kind] = _staged_by_kind.get(kind, 0) + n
    obs.inc("dist.host_staged_bytes", n)


def _mesh(mesh):
    if mesh is not None:
        return mesh
    from repro_torch.launch.mesh import current_mesh
    m = current_mesh()
    if m is None:
        raise RuntimeError("no mesh: pass mesh= or enter one (`with mesh:`)")
    return m


def _to_wire(mesh, x: torch.Tensor, kind: str) -> torch.Tensor:
    """The tensor the transport takes: on the host for gloo, on the card
    for nccl; bool as uint8; contiguous."""
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    _wire(kind, x)
    if mesh.backend == "gloo" and x.is_cuda:
        _count(kind, x.numel() * x.element_size())
        x = x.to("cpu")
    elif mesh.backend == "nccl" and not x.is_cuda:
        x = x.to(mesh.device)
    return x.contiguous()


def _from_wire(y: torch.Tensor, like: torch.Tensor,
               kind: str) -> torch.Tensor:
    _wire(kind, y)
    if y.device != like.device:
        if like.is_cuda and not y.is_cuda:
            _count(kind, y.numel() * y.element_size())
        y = y.to(like.device)
    return y.to(like.dtype) if y.dtype != like.dtype else y


def axis_size(axis: str, mesh=None) -> int:
    return _mesh(mesh).axis_size(axis)


def axis_index(axis: str, mesh=None) -> int:
    return _mesh(mesh).axis_index(axis)


def all_to_all(x: torch.Tensor, axis: str, mesh=None) -> torch.Tensor:
    """Split dim 0 into P equal parts, send part ``j`` to rank ``j`` of the
    axis, return the received parts in rank order (same shape as ``x``)."""
    return _all_to_all(x, axis, _mesh(mesh), "all_to_all")


def _all_to_all(x, axis, mesh, kind):
    P = mesh.axis_size(axis)
    if x.shape[0] % P:
        raise ValueError(f"all_to_all: dim 0 of {tuple(x.shape)} does not "
                         f"split {P} ways")
    if P == 1:
        return x.clone()
    w = _to_wire(mesh, x, kind)
    if mesh.backend == COUNTING:
        return _from_wire(w.clone(), x, kind)
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=mesh.group(axis))
    return _from_wire(out, x, kind)


def all_gather(x: torch.Tensor, axis: str, mesh=None) -> torch.Tensor:
    """``(P,) + x.shape``: every rank's ``x`` in rank order."""
    return _all_gather(x, axis, _mesh(mesh), "all_gather")


def _all_gather(x, axis, mesh, kind):
    P = mesh.axis_size(axis)
    if P == 1:
        return x[None].clone()
    w = _to_wire(mesh, x, kind)
    if mesh.backend == COUNTING:
        return _from_wire(torch.stack([w] * P), x, kind)
    parts = [torch.empty_like(w) for _ in range(P)]
    dist.all_gather(parts, w, group=mesh.group(axis))
    return _from_wire(torch.stack(parts), x, kind)


def psum(x: torch.Tensor, axis: str, mesh=None) -> torch.Tensor:
    """The sum over the axis, added in rank order (the same bits on every
    rank; for floats, in ``x``'s dtype)."""
    g = _all_gather(x, axis, _mesh(mesh), "psum")
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
    w = _to_wire(mesh, x, "pmax")
    w = w.clone() if w.data_ptr() == x.data_ptr() else w
    if mesh.backend != COUNTING:
        dist.all_reduce(w, op=dist.ReduceOp.MAX, group=mesh.group(axis))
    return _from_wire(w, x, "pmax")


def broadcast(x: torch.Tensor, axis: str, src: int = 0,
              mesh=None) -> torch.Tensor:
    """Rank ``src`` (its index along the axis) of the axis's ``x`` on every
    rank of the axis."""
    mesh = _mesh(mesh)
    if mesh.axis_size(axis) == 1:
        return x.clone()
    w = _to_wire(mesh, x, "broadcast")
    w = w.clone() if w.data_ptr() == x.data_ptr() else w
    if mesh.backend != COUNTING:
        g = mesh.group(axis)
        dist.broadcast(w, src=dist.get_global_rank(g, src), group=g)
    return _from_wire(w, x, "broadcast")


def reduce_scatter(x: torch.Tensor, dim: int, axis: str,
                   mesh=None) -> torch.Tensor:
    """The sum over the axis of ``x``, cut to this rank's block along
    ``dim`` (P equal blocks in rank order): one ``all_to_all``, then the P
    received blocks added in rank order (in float32 for a narrower float
    dtype, rounded once to ``x``'s)."""
    mesh = _mesh(mesh)
    P = mesh.axis_size(axis)
    n = x.shape[dim]
    if n % P:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split {P} ways")
    if P == 1:
        return x.clone()
    xm = x.movedim(dim, 0).contiguous()
    parts = _all_to_all(xm, axis, mesh, "reduce_scatter")
    parts = parts.reshape((P, n // P) + xm.shape[1:])
    acc = torch.float32 if x.is_floating_point() and x.element_size() < 4 \
        else x.dtype
    out = parts[0].to(acc, copy=True)
    for i in range(1, P):
        out += parts[i]
    return out.to(x.dtype).movedim(0, dim).contiguous()


def _permute(x: torch.Tensor, axis: str, perm, mesh) -> torch.Tensor:
    me = mesh.axis_index(axis)
    dst = [d for s_, d in perm if s_ == me]
    src = [s_ for s_, d in perm if d == me]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"ppermute: {perm} is not a permutation")
    if dst and src and dst[0] == me:
        return x.clone()
    if mesh.backend == COUNTING:
        if dst:
            _to_wire(mesh, x, "ppermute")
        if not src:
            return torch.zeros_like(x)
        w = _to_wire(mesh, x[:0], "ppermute")
        return _from_wire(torch.empty(x.shape, dtype=w.dtype,
                                      device=w.device), x, "ppermute")
    g = mesh.group(axis)
    ops, w, buf = [], None, None
    if dst:
        w = _to_wire(mesh, x, "ppermute")
        ops.append(dist.P2POp(dist.isend, w, dist.get_global_rank(g, dst[0]),
                              group=g))
    if src:
        like = w if w is not None else _to_wire(mesh, x[:0], "ppermute")
        buf = torch.empty(x.shape, dtype=like.dtype, device=like.device)
        ops.append(dist.P2POp(dist.irecv, buf,
                              dist.get_global_rank(g, src[0]), group=g))
    for req in (dist.batch_isend_irecv(ops) if ops else []):
        req.wait()
    if buf is None:
        return torch.zeros_like(x)
    return _from_wire(buf, x, "ppermute")


# --------------------------------------------------------------------------
# differentiable collectives
# --------------------------------------------------------------------------

class _AllGatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis, mesh, grad):
        ctx.dim, ctx.axis, ctx.mesh, ctx.grad = dim, axis, mesh, grad
        g = all_gather(x, axis, mesh)                 # (P,) + x.shape
        g = g.movedim(0, dim)
        return g.reshape(x.shape[:dim] + (-1,) + x.shape[dim + 1:])

    @staticmethod
    def backward(ctx, gy):
        mesh, dim, axis = ctx.mesh, ctx.dim, ctx.axis
        if ctx.grad == "sum":
            gx = reduce_scatter(gy, dim, axis, mesh)
        else:
            m = gy.shape[dim] // mesh.axis_size(axis)
            gx = gy.narrow(dim, mesh.axis_index(axis) * m, m).contiguous()
        return gx, None, None, None, None


def all_gather_dim(x: torch.Tensor, dim: int, axis: str, mesh=None,
                   grad: str = "sum") -> torch.Tensor:
    """The axis's blocks ``x`` concatenated along ``dim`` in rank order
    (``lax.all_gather(tiled=True)``). Backward: ``grad="sum"`` reduce-
    scatters the gradient (the ranks' gradients are summed, as JAX
    transposes the gather); ``grad="slice"`` keeps this rank's block of
    its own gradient, for an axis whose ranks all computed the same one."""
    if grad not in ("sum", "slice"):
        raise ValueError(f"all_gather_dim: grad={grad!r}")
    mesh = _mesh(mesh)
    if mesh.axis_size(axis) == 1:
        return x
    return _AllGatherDim.apply(x, dim, axis, mesh, grad)


class _PsumExit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        return psum(x, axis, mesh)

    @staticmethod
    def backward(ctx, gy):
        return gy, None, None


class _PsumEntry(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, gy):
        return psum(gy.contiguous(), ctx.axis, ctx.mesh), None, None


def psum_exit(x: torch.Tensor, axis: str, mesh=None) -> torch.Tensor:
    """:func:`psum` forward, the identity backward: each rank's partial
    result leaves a region whose ranks split the work, and the (replicated)
    gradient of the sum is every part's gradient."""
    mesh = _mesh(mesh)
    if mesh.axis_size(axis) == 1:
        return x
    return _PsumExit.apply(x, axis, mesh)


def psum_entry(x: torch.Tensor, axis: str, mesh=None) -> torch.Tensor:
    """The identity forward, :func:`psum` backward: a tensor every rank
    holds alike enters a region where each rank uses it for its own part,
    so its gradient is the sum of the parts' gradients (in rank order:
    the same bits on every rank)."""
    mesh = _mesh(mesh)
    if mesh.axis_size(axis) == 1:
        return x
    return _PsumEntry.apply(x, axis, mesh)


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, perm, mesh):
        ctx.axis, ctx.perm, ctx.mesh = axis, perm, mesh
        return _permute(x, axis, perm, mesh)

    @staticmethod
    def backward(ctx, gy):
        inv = [(d, s_) for s_, d in ctx.perm]
        return _permute(gy.contiguous(), ctx.axis, inv, ctx.mesh), None, \
            None, None


def ppermute(x: torch.Tensor, axis: str, perm, mesh=None) -> torch.Tensor:
    """``x`` sent from rank ``s`` to rank ``d`` of the axis for each ``(s,
    d)`` of ``perm`` (indices along the axis); a rank no pair sends to
    gets zeros. Point to point (``batch_isend_irecv``). The backward sends
    the gradient back along the inverse permutation."""
    return _Ppermute.apply(x, axis, [tuple(p) for p in perm], _mesh(mesh))


def agree_flag(flag: bool, axis: str, mesh=None) -> bool:
    """True on every rank of the axis when ``flag`` is true on any."""
    t = torch.tensor([1 if flag else 0], dtype=torch.int32)
    return bool(pmax(t, axis, mesh)[0])
