"""GPipe-style pipeline parallelism over a ``stage`` mesh axis
(counterpart of ``repro/parallel/pipeline.py``), SPMD: each rank of the
axis is one stage.

Microbatches stream through the stages by ``comm.ppermute`` (point to
point, and differentiable): M + S - 1 ticks for M microbatches over S
stages, the classic GPipe bubble. At tick ``t`` stage ``s`` works on
microbatch ``t - s`` when ``0 <= t - s < M`` and passes its input through
otherwise (the bubble mask); the last stage's outputs are broadcast over
the axis at the end, so every rank returns them.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.butterfly import tree_map
from repro_torch.parallel import comm

__all__ = ["gpipe"]


def gpipe(stage_fn: Callable, stage_params, x_micro: torch.Tensor, mesh,
          axis: str = "stage"):
    """Run ``stage_fn(params_s, x)`` over the S stages of ``axis``.

    stage_params: a tree whose leaves have a leading dim of S, one slice
    per stage (as the JAX function takes them). x_micro: (M, Bm, ...)
    microbatches, the same on every rank. Returns the (M, Bm, ...) outputs
    after all S stages, on every rank."""
    S = mesh.axis_size(axis)
    M = x_micro.shape[0]
    T = M + S - 1
    s = mesh.axis_index(axis)
    p_s = tree_map(lambda t: t[s], stage_params)
    buf = torch.zeros_like(x_micro[0])
    outs = []
    ring = [(i, (i + 1) % S) for i in range(S)]
    for t in range(T):
        cur = x_micro[min(max(t, 0), M - 1)] if s == 0 else buf
        active = 0 <= t - s < M                      # bubble mask
        y = stage_fn(p_s, cur) if active else cur
        buf = comm.ppermute(y, axis, ring, mesh)
        if s == S - 1 and t >= S - 1:
            outs.append(y)
    res = torch.stack(outs) if s == S - 1 else torch.zeros_like(x_micro)
    return comm.broadcast(res, axis, src=S - 1, mesh=mesh)
