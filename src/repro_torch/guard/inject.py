"""Deterministic fault injection: the chaos half of the guard layer.

Counterpart of ``repro/guard/inject.py``. Every failure mode the guard
defends against has an injector, so a chaos test drives the failure rather
than waits for it:

- :func:`with_nan` / :func:`bitflip`: corrupt float keys at a fixed rate,
  drawn from a ``torch.Generator`` seeded with ``seed`` (the positions are
  not the JAX package's bits; compare engines on the same corrupted keys);
- :func:`failing_variant`: register a variant that always raises an
  :class:`InjectedFault` dressed as an allocator failure, which the
  fallback ladder demotes on the card and on the CPU alike; a context
  manager, the stub and its quarantine records go on exit (a stub under
  the name of a registered variant shadows it for the block, one rank's
  fault on a collective op);
- :func:`poison_model`: wrap a model so any slot fed a magic token emits
  non-finite logits, the serve scheduler's poison-isolation path.

Importing this module changes nothing; each fault is armed explicitly.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

__all__ = ["InjectedFault", "resource_exhausted", "with_nan", "bitflip",
           "failing_variant", "poison_model", "POISON_TOKEN"]

#: default magic token for poison_model
POISON_TOKEN = -1


class InjectedFault(RuntimeError):
    """A deliberately injected infrastructure failure (absorbed by the
    fallback ladder: ``guard.fallback.recoverable``)."""


def resource_exhausted(what: str = "injected") -> InjectedFault:
    """An :class:`InjectedFault` shaped like an allocator failure."""
    return InjectedFault(
        f"RESOURCE_EXHAUSTED: {what}: out of memory while trying to "
        "allocate 9223372036854775807 bytes")


# --------------------------------------------------------------------------
# key corruption
# --------------------------------------------------------------------------

def _as_tensor(keys) -> torch.Tensor:
    if isinstance(keys, torch.Tensor):
        return keys
    return torch.from_numpy(np.array(keys))


def _uniform(keys: torch.Tensor, seed: int) -> torch.Tensor:
    gen = torch.Generator(device=keys.device).manual_seed(seed)
    return torch.rand(keys.shape, generator=gen, device=keys.device)


def with_nan(keys, rate: float, seed: int = 0) -> torch.Tensor:
    """Replace ``rate`` of the entries of a float tensor (or array) with
    NaN, deterministic in ``seed``. At least one entry is corrupted for
    ``rate > 0``, so a chaos check cannot pass on a lucky draw."""
    keys = _as_tensor(keys)
    u = _uniform(keys, seed)
    mask = u < rate
    if rate > 0:
        mask = mask.reshape(-1)
        mask[torch.argmin(u)] = True
        mask = mask.reshape(keys.shape)
    return torch.where(mask, float("nan"), keys)


def bitflip(keys, rate: float, seed: int = 0, bit: int = 30) -> torch.Tensor:
    """Flip ``bit`` of the float32 bit pattern in ``rate`` of the entries,
    deterministic in ``seed``. Bit 30 (the top exponent bit) turns small
    numbers huge and can mint NaN / inf."""
    keys = _as_tensor(keys)
    bits = keys.float().view(torch.int32)
    flip = (1 << bit) - (1 << 32 if bit == 31 else 0)     # as an int32
    out = torch.where(_uniform(keys, seed) < rate, bits ^ flip, bits)
    return out.view(torch.float32).to(keys.dtype)


# --------------------------------------------------------------------------
# variant faults
# --------------------------------------------------------------------------

@contextlib.contextmanager
def failing_variant(op: str, name: str = "chaos_fail",
                    message: str = "injected"):
    """Register an always-failing variant ``name`` of ``op`` for the
    block. Pin it with ``variant=name`` to drive the fallback ladder; the
    registration and its quarantine records are removed on exit. A
    variant already registered under ``name`` is shadowed for the block
    and restored after it."""
    from repro_torch.engine import registry
    from repro_torch.engine.planner import default_planner

    def stub(*args, **kw):
        raise resource_exhausted(f"{op}.{name}: {message}")

    shadowed = registry.get(op, name) if name in registry.variants(op) \
        else None
    registry.register(op, name)(stub)
    try:
        yield name
    finally:
        registry.unregister(op, name)
        if shadowed is not None:
            registry.register(op, name)(shadowed)
        default_planner.clear_quarantine(variant=name)


# --------------------------------------------------------------------------
# serve poison
# --------------------------------------------------------------------------

class _PoisonModel:
    """A delegating model whose ``decode_step`` turns the logits row of any
    slot fed ``poison_tok`` to NaN; the cache and the other slots are left
    as the model made them."""

    def __init__(self, model, poison_tok: int):
        self._model = model
        self._poison_tok = poison_tok

    def __getattr__(self, name):
        return getattr(self._model, name)

    def decode_step(self, params, tok, pos, cache):
        logits, cache = self._model.decode_step(params, tok, pos, cache)
        bad = (tok == self._poison_tok)[:, None]
        return torch.where(bad, float("nan"), logits), cache


def poison_model(model, poison_tok: int = POISON_TOKEN):
    """Wrap ``model`` so slots whose input token equals ``poison_tok``
    produce all-NaN logits (a poison request: a prompt ending in the magic
    token)."""
    return _PoisonModel(model, poison_tok)
