"""Device meshes over ``torch.distributed`` (counterpart of
``repro/launch/mesh.py``).

The JAX package has one controller and a ``jax.sharding.Mesh`` of devices;
the port runs SPMD: every rank is one process holding its own shard, and a
:class:`Mesh` tells it its place. A mesh has named axes and their sizes,
this rank's coordinate along each (ranks laid out row-major over the axes,
as ``jax.make_mesh`` lays out devices), one ``dist.ProcessGroup`` per axis
(made with ``dist.new_group`` over the ranks that share every other
coordinate), the backend and the rank's device.

The backend is the caller's choice and is never guessed: ``nccl`` when the
ranks have cards of their own, ``gloo`` when they share one card or run on
the CPU (``parallel/comm.py`` then stages CUDA tensors through the host).
Rank ``r`` runs on ``cuda:{r % device_count}`` unless the caller passes
``device="cpu"``. The rendezvous is a ``FileStore`` under a directory the
caller passes, so concurrent test workers never race for a port.

    mesh = make_mesh((4,), ("data",), backend="gloo", rank=r, world_size=4,
                     store_dir=tmp)
    with mesh:                      # the current mesh of parallel/comm.py
        ...

:class:`AbstractMesh` is a mesh's axis names and sizes with no process
behind it: what the sharding rules of ``parallel/sharding.py`` read, so
they can be asked about the production shapes from one process.
"""
from __future__ import annotations

import datetime
import math
import os
import threading
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["Mesh", "AbstractMesh", "make_mesh", "make_test_mesh",
           "make_production_mesh", "current_mesh", "DEFAULT_TIMEOUT_S"]

#: seconds a collective may wait for its peers before it raises
DEFAULT_TIMEOUT_S = 300.0

_current = threading.local()


class Mesh:
    """One rank's view of a mesh of ranks: axis sizes, its coordinates, one
    process group per axis, the backend and its device. Entering it (``with
    mesh:``) makes it the current mesh of the collectives."""

    def __init__(self, axis_names: Tuple[str, ...], sizes: Tuple[int, ...],
                 rank: int, groups: Dict[str, object], backend: str,
                 device: torch.device, timeout_s: float):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, sizes))
        self.rank = rank
        self.size = math.prod(sizes)
        self.coords = dict(zip(self.axis_names, _coords(rank, sizes)))
        self.groups = groups
        self.backend = backend
        self.device = device
        self.timeout_s = timeout_s
        self._prev = []

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def axis_index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        return self.groups[axis]

    def __enter__(self) -> "Mesh":
        self._prev.append(getattr(_current, "mesh", None))
        _current.mesh = self
        return self

    def __exit__(self, *exc) -> None:
        _current.mesh = self._prev.pop()

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, coords={self.coords}, "
                f"backend={self.backend!r}, device={self.device})")


class AbstractMesh:
    """Axis names and sizes only (``jax.sharding.AbstractMesh``'s part that
    the sharding rules read): ``axis_names``, ``shape`` and ``size``."""

    def __init__(self, sizes: Sequence[int], axis_names: Sequence[str]):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in sizes)))
        self.size = math.prod(self.shape.values())

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def current_mesh() -> Optional[Mesh]:
    """The innermost mesh entered with ``with mesh:`` on this thread."""
    return getattr(_current, "mesh", None)


def _coords(rank: int, sizes: Sequence[int]) -> Tuple[int, ...]:
    out = []
    for s in reversed(sizes):
        out.append(rank % s)
        rank //= s
    return tuple(reversed(out))


def _rank_of(coords: Sequence[int], sizes: Sequence[int]) -> int:
    r = 0
    for c, s in zip(coords, sizes):
        r = r * s + c
    return r


def _device_for(rank: int, device) -> torch.device:
    if device is not None:
        return torch.device(device)
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("make_mesh: no CUDA device; pass device='cpu' to "
                           "run the ranks on the CPU")
    return torch.device("cuda", rank % n)


def make_mesh(sizes: Sequence[int], axis_names: Sequence[str], *,
              backend: Optional[str] = None, rank: Optional[int] = None,
              world_size: Optional[int] = None,
              store_dir: Optional[str] = None, device=None,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """This rank's :class:`Mesh` of shape ``sizes`` over ``axis_names``.

    Without a default process group one is made here: ``backend``, ``rank``,
    ``world_size`` and ``store_dir`` (the ``FileStore``'s directory, shared
    by every rank) are then required. With one, they must agree with it or
    be left out. Every rank must call this with the same shape, since each
    axis group is made by a collective ``dist.new_group`` over all ranks.
    ``timeout_s`` bounds how long a collective of the mesh waits for its
    peers; a rank that never arrives makes the others raise after it.
    """
    sizes = tuple(int(s) for s in sizes)
    axis_names = tuple(axis_names)
    if len(sizes) != len(axis_names):
        raise ValueError(f"make_mesh: {len(sizes)} sizes for "
                         f"{len(axis_names)} axes")
    need = math.prod(sizes)
    timeout = datetime.timedelta(seconds=timeout_s)
    if not dist.is_initialized():
        if backend is None or rank is None or world_size is None \
                or store_dir is None:
            raise ValueError("make_mesh: no process group yet; pass backend, "
                             "rank, world_size and store_dir")
        if world_size < need:
            raise ValueError(f"make_mesh: the mesh {dict(zip(axis_names, sizes))} "
                             f"needs a world of {need} ranks, got "
                             f"{world_size}")
        os.makedirs(store_dir, exist_ok=True)
        store = dist.FileStore(os.path.join(store_dir, "rendezvous"),
                               world_size)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world_size, timeout=timeout)
    world = dist.get_world_size()
    if backend is not None and backend != dist.get_backend():
        raise ValueError(f"make_mesh: backend {backend!r} asked, the process "
                         f"group runs {dist.get_backend()!r}")
    if rank is not None and rank != dist.get_rank():
        raise ValueError(f"make_mesh: rank {rank} asked, the process group "
                         f"has this process at {dist.get_rank()}")
    if world < need:
        raise ValueError(f"make_mesh: the mesh {dict(zip(axis_names, sizes))} "
                         f"needs a world of {need} ranks, this one has "
                         f"{world}")
    if world != need:
        raise ValueError(f"make_mesh: the mesh has {need} ranks, the world "
                         f"{world}")
    me = dist.get_rank()
    mine = _coords(me, sizes)
    groups = {}
    for i, ax in enumerate(axis_names):
        # every rank makes every group of this axis, in the same order
        others = [s for j, s in enumerate(sizes) if j != i]
        for rest in _all_coords(others):
            members = []
            for c in range(sizes[i]):
                full = list(rest)
                full.insert(i, c)
                members.append(_rank_of(full, sizes))
            g = dist.new_group(members, timeout=timeout)
            if me in members:
                groups[ax] = g
    dev = _device_for(me, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(axis_names, sizes, me, groups, dist.get_backend(), dev,
                timeout_s)


def _all_coords(sizes: Sequence[int]):
    if not sizes:
        yield ()
        return
    for head in range(sizes[0]):
        for tail in _all_coords(sizes[1:]):
            yield (head,) + tail


def make_test_mesh(n_data: int = 2, n_model: int = 2, **kw) -> Mesh:
    """A small ``(data, model)`` mesh for tests (``make_mesh``'s keywords)."""
    return make_mesh((n_data, n_model), ("data", "model"), **kw)


def make_production_mesh(*, multi_pod: bool = False, **kw) -> Mesh:
    """The JAX package's production layout: ``(data 16, model 16)``, 256
    ranks, or ``(pod 2, data 16, model 16)``, 512. Raises ``ValueError``
    naming the world size it needs when the world is smaller."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, **kw)
