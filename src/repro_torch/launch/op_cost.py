"""Counted cost of one rank's step: FLOPs, bytes, peak live bytes and
collective bytes by kind (the dry run's counterpart of
``repro/launch/hlo_cost.py``).

The JAX dry run compiles a cell and walks XLA's post-optimisation HLO
text: ``compiled.cost_analysis()`` counts a while-loop body once, so
``hlo_cost.py`` multiplies each scan-over-layers body by its trip count.
Torch lowers nothing to walk. Here the step runs eagerly, on ``meta``
tensors (shapes and dtypes, no data, no allocation), under
:class:`CountMode`, a ``TorchDispatchMode`` that sees every op below
autograd; an eager run visits every layer (and remat's recompute), so the
loop multiplicity that ``hlo_cost.py`` reconstructs comes for free.

- FLOPs: ``torch.utils.flop_counter``'s formulas (matrix products,
  convolutions, attention), counted by its ``FlopCounterMode``; like
  ``hlo_cost.py``'s dot rule, elementwise ops count nothing there.
- bytes: the operands and results of each dispatched op, each read or
  written once; ops whose results only alias their inputs (views) move
  nothing, ``empty*`` writes nothing.
- temp: the peak of the bytes of tensors the step made that were alive at
  once (a tensor counts from the op that made it until it is freed), the
  stand-in for XLA's temporary allocation.
- collectives: the step runs on a :func:`counting_mesh`, rank 0 of a mesh
  with no process behind it, whose ``parallel/comm.py`` collectives send
  nothing and count what they would hand to the transport and get back
  (``comm.wire_bytes_by_kind()``, the convention of
  ``comm.host_staged_bytes_by_kind()``).
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Dict, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core.butterfly import tree_leaves
from repro_torch.launch.mesh import Mesh
from repro_torch.parallel import comm

__all__ = ["Cost", "CountMode", "counting_mesh", "count", "tree_bytes"]


@dataclass
class Cost:
    """One rank's counted cost of a step."""
    flops: float = 0.0
    bytes: float = 0.0
    coll: Dict[str, int] = field(default_factory=dict)
    args_bytes: int = 0
    output_bytes: int = 0
    temp_bytes: int = 0

    @property
    def coll_total(self) -> int:
        return sum(self.coll.values())


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tree_bytes(*trees) -> int:
    """Bytes of every tensor leaf of ``trees``."""
    return sum(_nbytes(t) for tree in trees for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


_EMPTY = {"empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided"}


class CountMode(TorchDispatchMode):
    """Counts the bytes each dispatched op reads and writes, and the live
    bytes of the tensors made under it (``peak``)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        rets = func._schema.returns
        if rets and all(r.alias_info is not None and not r.alias_info.is_write
                        for r in rets):
            return out                      # a view: nothing moves
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        fresh = [t for t, r in zip(outs, rets) if r.alias_info is None] \
            if len(outs) == len(rets) else outs
        if func._schema.name.split("::")[-1] not in _EMPTY:
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        for t in fresh:
            n = _nbytes(t)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(t, self._free, n)
        return out


def counting_mesh(sizes: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """Rank 0 of a mesh of ``sizes`` over ``axis_names`` with no process
    behind it (no process groups, the ``meta`` device): ``parallel/
    comm.py``'s collectives on it count their wire bytes and send nothing
    (``comm.COUNTING``)."""
    return Mesh(tuple(axis_names), tuple(int(s) for s in sizes), 0, {},
                comm.COUNTING, torch.device("meta"), 0.0)


def count(fn, *args, **kw):
    """``(out, Cost)``: ``fn(*args, **kw)`` run under :class:`CountMode`
    and ``FlopCounterMode``, with the wire bytes its collectives add to
    ``comm.wire_bytes_by_kind()``. ``args_bytes`` / ``output_bytes`` are
    the arguments' and the result's tensor bytes (a tensor updated in
    place counts in both, as a donated buffer does in XLA's analysis)."""
    before = comm.wire_bytes_by_kind()
    cm = CountMode()
    fc = FlopCounterMode(display=False)
    with fc, cm:
        out = fn(*args, **kw)
    coll = {k: v - before.get(k, 0)
            for k, v in comm.wire_bytes_by_kind().items()
            if v != before.get(k, 0)}
    return out, Cost(
        flops=float(fc.get_total_flops()), bytes=float(cm.bytes), coll=coll,
        args_bytes=tree_bytes(args, kw), output_bytes=tree_bytes(out),
        temp_bytes=cm.peak)
