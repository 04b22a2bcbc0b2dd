"""AdamW with float32 master weights, a cosine schedule and global-norm
clipping (counterpart of ``repro/optim/adamw.py``).

The optimizer state carries float32 ``m``, ``v`` and ``master`` trees, so
bf16 parameters do not accumulate rounding. ``adamw_update`` keeps the JAX
package's order of operations, leaf by leaf under ``torch.no_grad()``, and
updates the state and the parameters in place (the JAX package donates
their buffers): no second copy of the state is ever held. A leaf's float32
temporaries (the clipped gradient, the update) live only while that leaf
is updated.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.core.butterfly import tree_leaves, tree_map

__all__ = ["AdamWState", "adamw_init", "adamw_update", "lr_schedule",
           "global_norm", "clip_by_global_norm"]


class AdamWState(NamedTuple):
    step: torch.Tensor   # 0-d int32
    m: Any
    v: Any
    master: Any


def adamw_init(params) -> AdamWState:
    """Zero moments and float32 master copies of ``params``, on their
    devices."""
    zeros = lambda: tree_map(lambda p: torch.zeros(
        p.shape, dtype=torch.float32, device=p.device), params)
    master = tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                      params)
    dev = tree_leaves(params)[0].device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                      zeros(), zeros(), master)


def lr_schedule(step: torch.Tensor, base_lr: float, warmup: int,
                total: int) -> torch.Tensor:
    """Linear warm-up to ``base_lr`` over ``warmup`` steps, then a cosine
    to 0.1 * ``base_lr`` at ``total``; a 0-d float32 tensor on ``step``'s
    device."""
    step = step.to(torch.float32)
    warm = base_lr * (step + 1.0) / max(warmup, 1)
    t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = base_lr * 0.5 * (1.0 + torch.cos(math.pi * t))
    return torch.where(step < warmup, warm,
                       torch.clamp(cos, min=0.1 * base_lr))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of their float32 sums of squares."""
    total = None
    for x in tree_leaves(tree):
        s = torch.sum(torch.square(x.to(torch.float32)))
        total = s if total is None else total + s
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """``(grads scaled to at most max_norm, float32; the norm)``."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g.to(torch.float32) * scale, grads), norm


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, *, lr, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1, grad_clip=1.0, norm=None,
                 put=None):
    """One AdamW step from ``grads`` (a tree shaped like ``params``).
    ``m``, ``v``, ``master`` and ``params`` are updated in place (each
    parameter rewritten in its own dtype from its master copy). Returns
    ``(params, new_state, {"grad_norm": norm})``, the pre-clip norm.

    On a mesh the trees are a rank's blocks: ``norm`` is then the global
    norm of the whole gradient (``global_norm`` of the blocks would count
    only this rank's), and ``put(i, w, p)`` writes parameter block ``p``
    (leaf ``i``) from its updated master block ``w`` where the two
    layouts differ (by default ``p.copy_(w)``)."""
    if norm is None:
        norm = global_norm(grads)
    scale = _clip_scale(norm, grad_clip)
    step = state.step + 1
    bc1 = 1.0 - b1 ** step.to(torch.float32)
    bc2 = 1.0 - b2 ** step.to(torch.float32)
    for i, (g, m, v, w, p) in enumerate(zip(
            tree_leaves(grads), tree_leaves(state.m), tree_leaves(state.v),
            tree_leaves(state.master), tree_leaves(params))):
        # JAX's expressions, each product and sum rounded as there, on
        # three leaf-sized float32 temporaries (g, u, t):
        #   g = g * scale
        #   m = b1 * m + (1 - b1) * g;  v = b2 * v + (1 - b2) * g^2
        #   u = (m / bc1) / (sqrt(v / bc2) + eps)
        #   w = w - lr * (u + weight_decay * w)
        g = g.to(torch.float32, copy=True).mul_(scale)
        m.mul_(b1).add_(g * (1 - b1))
        g.square_().mul_(1 - b2)
        v.mul_(b2).add_(g)
        del g
        u = torch.div(m, bc1)
        t = torch.div(v, bc2).sqrt_().add_(eps)
        u.div_(t)
        torch.mul(w, weight_decay, out=t)
        w.sub_(u.add_(t).mul_(lr))
        del u, t
        if put is None:
            p.copy_(w)
        else:
            put(i, w, p)
    return params, AdamWState(step, state.m, state.v, state.master), \
        {"grad_norm": norm}
