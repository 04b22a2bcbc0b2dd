"""Activation-sharding context (counterpart of ``repro/parallel/act.py``).

The launch layer sets a context (the mesh and which of its axes carry the
batch and the model) and model code reads it: ``moe_apply_ep`` finds its
``model`` axis here, ``group_count`` the data-shard count. In the JAX
package :func:`constrain` turns logical tags into
``lax.with_sharding_constraint`` hints for GSPMD; the port runs SPMD, one
process a rank already holding its local block, so :func:`constrain` and
:func:`constrain_expert_hidden` return their input unchanged, context or
not.
"""
from __future__ import annotations

import contextlib
import types
from typing import Optional, Tuple

# process-wide, not thread-local: autograd runs a card's backward (and
# remat's recompute, which reads the context) on its own device thread
_ctx = types.SimpleNamespace()


def set_context(mesh, data_axes: Tuple[str, ...] = ("pod", "data"),
                model_axis: str = "model"):
    """Make ``mesh`` the context: ``data_axes`` (those the mesh has) carry
    the batch, ``model_axis`` (when the mesh has it) the experts."""
    _ctx.mesh = mesh
    _ctx.dp = tuple(a for a in data_axes
                    if mesh is not None and a in mesh.axis_names)
    _ctx.tp = model_axis if (mesh is not None and
                             model_axis in mesh.axis_names) else None


def clear_context():
    _ctx.mesh = None


@contextlib.contextmanager
def context(mesh, data_axes: Tuple[str, ...] = ("pod", "data"),
            model_axis: str = "model"):
    """:func:`set_context` for the ``with`` block; the context before it
    is back on exit."""
    before = (getattr(_ctx, "mesh", None), getattr(_ctx, "dp", ()),
              getattr(_ctx, "tp", None))
    set_context(mesh, data_axes, model_axis)
    try:
        yield
    finally:
        _ctx.mesh, _ctx.dp, _ctx.tp = before


def context_mesh():
    """The context's mesh, or None."""
    return getattr(_ctx, "_force_mesh", None) or getattr(_ctx, "mesh", None)


def model_axis() -> Optional[str]:
    """The context's model axis, or None."""
    return getattr(_ctx, "tp", None) if context_mesh() is not None else None


def _axis_size(mesh, ax):
    if ax is None:
        return 1
    if isinstance(ax, tuple):
        n = 1
        for a in ax:
            n *= mesh.shape[a]
        return n
    return mesh.shape[ax]


def constrain(x, *tags):
    """The identity: a rank holds its own block of ``x`` already (the JAX
    package's GSPMD hint has nothing to place here)."""
    return x


def constrain_expert_hidden(h):
    """The identity, as :func:`constrain`."""
    return h


def group_count(batch: int) -> int:
    """Largest data-shard count dividing ``batch`` (1 without a context)."""
    mesh = getattr(_ctx, "mesh", None)
    if mesh is None:
        return 1
    g = _axis_size(mesh, getattr(_ctx, "dp", ()) or None)
    while g > 1 and batch % g:
        g //= 2
    return max(g, 1)
