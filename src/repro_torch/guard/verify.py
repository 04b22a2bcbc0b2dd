"""Self-verification: opt-in postconditions on engine results.

Counterpart of ``repro/guard/verify.py``. When enabled (``REPRO_VERIFY=1``
in the environment, or :func:`enable_verify`), the engine checks its own
output on the device: sortedness of the result, a permutation checksum (sum
and xor of the key bits: the output must be a rearrangement of the input,
nothing dropped or duplicated), and segment-boundary respect on the ragged
ops.

Each check leaves a 0-d bool tensor on the result's device and returns: no
host sync inside the op, as the JAX package's ``jax.debug.callback`` does
not block. The pending flags are drained, one ``.item()`` each, when
:func:`failures` or :func:`checked` is read (or when ``MAX_PENDING`` have
piled up); draining adds each outcome to the host tally and records it as
a ``guard.verify`` event and the ``guard.verify.checked`` /
``guard.verify.fail`` counters of ``obs``. The tally works with ``obs``
disabled.

Free when disabled: every check site is one ``if not verify_enabled()`` in
host dispatch code, no device math. The checks are monitors, not gates: a
failing check never aborts the computation.
"""
from __future__ import annotations

import os
from typing import List, Tuple

import torch

from repro_torch import obs

__all__ = [
    "enable_verify", "disable_verify", "verify_enabled", "failures",
    "checked", "reset_failures", "check_sorted", "check_permutation",
    "check_segments",
]

#: pending device flags past which a check drains them at once
MAX_PENDING = 1024

_enabled = os.environ.get("REPRO_VERIFY", "") not in ("", "0", "false")
_failures = 0
_checked = 0
_pending: List[Tuple[str, str, torch.Tensor]] = []


def enable_verify() -> None:
    global _enabled
    _enabled = True


def disable_verify() -> None:
    global _enabled
    _enabled = False


def verify_enabled() -> bool:
    return _enabled


def _drain() -> None:
    global _failures, _checked
    pending = _pending[:]
    _pending.clear()
    for op, check, ok in pending:
        ok = bool(ok.item())
        _checked += 1
        if not ok:
            _failures += 1
            obs.inc("guard.verify.fail")
        obs.inc("guard.verify.checked")
        obs.event("guard.verify", op=op, check=check, ok=ok)


def failures() -> int:
    """Failed checks so far (drains the pending device flags)."""
    _drain()
    return _failures


def checked() -> int:
    """Checks made so far (drains the pending device flags)."""
    _drain()
    return _checked


def reset_failures() -> None:
    global _failures, _checked
    _pending.clear()
    _failures = 0
    _checked = 0


def _emit(op: str, check: str, ok) -> None:
    if not isinstance(ok, torch.Tensor):
        ok = torch.tensor(bool(ok))
    _pending.append((op, check, ok))
    if len(_pending) >= MAX_PENDING:
        _drain()


def _key_bits(x: torch.Tensor) -> torch.Tensor:
    if x.is_floating_point():
        x = x.float().view(torch.int32)
    return x.reshape(-1).to(torch.int64)


def _xor_all(a: torch.Tensor) -> torch.Tensor:
    """XOR of every element of a 1-D int64 tensor: halving folds over a
    zero-padded power-of-two length."""
    n = a.shape[0]
    if n == 0:
        return a.new_zeros(())
    width = 1 << (n - 1).bit_length()
    if width != n:
        a = torch.cat([a, a.new_zeros(width - n)])
    while a.shape[0] > 1:
        half = a.shape[0] // 2
        a = a[:half] ^ a[half:]
    return a[0]


# --------------------------------------------------------------------------
# the postconditions
# --------------------------------------------------------------------------

def check_sorted(out: torch.Tensor, *, descending: bool, op: str) -> None:
    """Adjacent-pair sortedness along the last axis (the rows of a batched
    2-D op are independent: pairs never span rows)."""
    if not _enabled:
        return
    if out.shape[-1] < 2:
        _emit(op, "sorted", True)
        return
    adj = (out[..., 1:] >= out[..., :-1] if not descending
           else out[..., 1:] <= out[..., :-1])
    _emit(op, "sorted", adj.all())


def check_permutation(inp: torch.Tensor, out: torch.Tensor, *,
                      op: str) -> None:
    """Output keys are a rearrangement of the input keys: the sum (exact, in
    int64) and the xor of the 32-bit key bits both survive the op."""
    if not _enabled:
        return
    a, b = _key_bits(inp), _key_bits(out)
    if a.shape != b.shape:
        _emit(op, "permutation", False)
        return
    ok = (a.sum() == b.sum()) & (_xor_all(a) == _xor_all(b))
    _emit(op, "permutation", ok)


def check_segments(out: torch.Tensor, offsets: torch.Tensor, *,
                   descending: bool, op: str) -> None:
    """Per-segment sortedness of a ragged result: the adjacent-pair scan
    with the pairs that cross a segment boundary exempt."""
    if not _enabled:
        return
    n = out.shape[0]
    if n < 2:
        _emit(op, "segments_sorted", True)
        return
    adj = out[1:] >= out[:-1] if not descending else out[1:] <= out[:-1]
    # one slot past the end takes the starts of empty trailing segments
    boundary = torch.zeros((n + 1,), dtype=torch.bool, device=out.device)
    boundary[offsets[:-1].long()] = True
    _emit(op, "segments_sorted", (adj | boundary[1:n]).all())
