"""Engine-boundary input validation: structured errors, NaN policies, lanes.

Counterpart of ``repro/guard/validate.py``:

1. :class:`EngineInputError` (a ``ValueError``) carries the op name and a
   JSON-clean ``details`` dict.
2. The ``nan=`` policy of float-keyed ops: ``"unsafe"`` (default: no check,
   the caller vouches for finite keys), ``"raise"`` (a host check before
   dispatch) and ``"sort_last"`` (keys mapped through the monotone int32 bit
   transform with every NaN pinned to ``INT32_MAX``, sorted as int32 and
   gathered back: ``torch.sort``'s and ``jnp.sort``'s NaN order, ``±0.0``
   one tie class, ties stable).
3. The int32 lane guard: rank and offset lanes are int32 everywhere, so
   sizes of ``2**31`` or more are refused.
4. :class:`RequestRejected` and :class:`QueueFull`: the serve scheduler's
   refusals of a malformed request and of a full submit queue.

The process default comes from ``REPRO_NAN_POLICY`` (else ``"unsafe"``).
"""
from __future__ import annotations

import os
from typing import Optional

import torch

__all__ = [
    "EngineInputError", "RequestRejected", "QueueFull", "NAN_POLICIES", "set_nan_policy",
    "default_nan_policy", "resolve_nan_policy", "check_finite_keys",
    "total_order_key", "check_lane_width", "check_float_dtype", "LANE_LIMIT",
]

#: rank/offset lanes are int32 throughout the engine
LANE_LIMIT = 2 ** 31

NAN_POLICIES = ("raise", "sort_last", "unsafe")

_default_nan_policy = os.environ.get("REPRO_NAN_POLICY", "unsafe")


class EngineInputError(ValueError):
    """A malformed input caught at the engine boundary."""

    def __init__(self, op: str, message: str, **details):
        self.op = op
        self.details = details
        super().__init__(f"{op}: {message}")


class RequestRejected(EngineInputError):
    """A malformed serve request refused at ``Scheduler.submit`` (empty
    prompt, geometry past the scheduler's static shapes, duplicate uid)."""


class QueueFull(RequestRejected):
    """Backpressure: the scheduler's bounded submit queue is full."""


def set_nan_policy(policy: str) -> None:
    """Set the process-wide default ``nan=`` policy."""
    global _default_nan_policy
    if policy not in NAN_POLICIES:
        raise ValueError(f"nan policy {policy!r} not in {NAN_POLICIES}")
    _default_nan_policy = policy


def default_nan_policy() -> str:
    return _default_nan_policy


def resolve_nan_policy(nan: Optional[str], op: str) -> str:
    policy = _default_nan_policy if nan is None else nan
    if policy not in NAN_POLICIES:
        raise EngineInputError(op, f"nan={policy!r} not one of {NAN_POLICIES}",
                               nan=str(policy))
    return policy


def check_finite_keys(op: str, keys: torch.Tensor) -> None:
    """The ``nan="raise"`` check: any NaN key raises before dispatch."""
    n_bad = int(torch.isnan(keys).sum())
    if n_bad:
        raise EngineInputError(
            op, f"{n_bad} NaN key(s) and nan=\"raise\": the FLiMS comparator "
            "network has no total order for NaN (silent misordering) — "
            'clean the keys, or pass nan="sort_last"',
            nan="raise", n_nan=n_bad)


def total_order_key(keys: torch.Tensor) -> torch.Tensor:
    """Float keys -> int32 keys whose ascending order is ``jnp.sort``'s:
    the monotone sign-magnitude transform, ``-0.0`` folded onto ``+0.0`` and
    every NaN pinned above ``+inf``."""
    f32 = keys.to(torch.float32)
    bits = (f32 + 0.0).view(torch.int32)          # -0.0 -> +0.0
    ikey = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    return torch.where(torch.isnan(f32), torch.iinfo(torch.int32).max, ikey)


def check_lane_width(n: int, op: str) -> None:
    """Reject sizes the int32 rank/offset lanes cannot index."""
    if n >= LANE_LIMIT:
        raise EngineInputError(
            op, f"n = {n} exceeds the engine's int32 rank/offset lanes "
            f"(max {LANE_LIMIT - 1})", n=int(n), limit=LANE_LIMIT - 1)


def check_float_dtype(op: str, keys: torch.Tensor) -> bool:
    """True iff ``keys`` is float-keyed; complex keys have no order."""
    if keys.dtype.is_complex:
        raise EngineInputError(op, f"complex keys ({keys.dtype}) have no "
                               "sort order", dtype=str(keys.dtype))
    return keys.dtype.is_floating_point
