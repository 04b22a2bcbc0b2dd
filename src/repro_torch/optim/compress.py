"""Int8 error-feedback gradient compression for a cross-pod all-reduce
(counterpart of ``repro/optim/compress.py``).

A compressed ``psum``: each gradient is quantised to int8 with a
per-tensor scale, the int8 payload and the scales travel (4x fewer bytes
on the wire than float32), and the quantisation error is kept locally and
added back the next step (error feedback). The order of operations is the
JAX function's: ``g + e`` in float32, the scale ``max(max|x| / 127,
1e-12)``, ``round`` (half to even) and clip to [-127, 127], the residual
``x - q * scale``, then every member's scale and payload all-gathered and
contracted over the members, over the member count. Its rounding is what
XLA compiles the JAX function to: the division by the constant 127 is a
product by float32(1/127), and the residual is rounded once (XLA fuses
the product and the difference into one multiply-add; here the exact
difference is taken in float64, where ``q * scale`` and ``x - q * scale``
are exact, and rounded to float32), so payload and residual are bit for
bit JAX's.

The JAX docstring says ``launch/train.py`` applies it under
``TrainConfig.grad_compression == "int8_ef"``; the JAX trainer never reads
that field, so neither the port's trainer nor its ``TrainConfig`` takes
it (``TrainConfig`` raises). Call :func:`compressed_psum_int8` directly.
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.core.butterfly import tree_map
from repro_torch.parallel import comm

__all__ = ["ef_state_init", "compressed_psum_int8"]


def ef_state_init(grads) -> Any:
    """Zero float32 residuals shaped like ``grads``."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


_INV127 = float(np.float32(1.0) / np.float32(127.0))   # XLA's folded 1/127


def _quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    inv = torch.tensor(_INV127, dtype=torch.float32, device=x.device)
    scale = torch.clamp(torch.max(torch.abs(x)) * inv, min=1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _residual(x, q, scale):
    """``x - q * scale`` rounded once to float32."""
    return (x.to(torch.float64) - q.to(torch.float64) *
            scale.to(torch.float64)).to(torch.float32)


def compressed_psum_int8(grads, ef, axis: str, mesh=None):
    """``psum(grads) / N`` over ``axis`` with an int8 payload and error
    feedback: this rank's gradients and residuals in, ``(mean_grads,
    new_ef)`` out (the mean in each gradient's dtype, on every rank)."""
    n = comm.axis_size(axis, mesh)

    def one(g, e):
        gf = g.to(torch.float32) + e
        q, scale = _quant(gf)
        err = _residual(gf, q, scale)          # error feedback residual
        # int8 payload on the wire; the N scales weight the shares
        scales = comm.all_gather(scale, axis, mesh)             # (N,)
        qs = comm.all_gather(q, axis, mesh)                     # (N, ...)
        mean = torch.tensordot(scales, qs.to(torch.float32),
                               dims=([0], [0])) / n
        return mean.to(g.dtype), err

    out = tree_map(one, grads, ef)
    is_pair = lambda t: isinstance(t, tuple) and len(t) == 2 and \
        isinstance(t[0], torch.Tensor)

    def pick(t, i):
        if is_pair(t):
            return t[i]
        if isinstance(t, dict):
            return {k: pick(v, i) for k, v in t.items()}
        return type(t)(pick(v, i) for v in t)
    return pick(out, 0), pick(out, 1)
