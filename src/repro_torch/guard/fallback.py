"""Variant fallback ladder: absorb an out-of-memory error or an injected
fault, never hide a kernel.

Counterpart of ``repro/guard/fallback.py``. ``registry.call`` trusts the
resolved plan; :func:`guarded_call` wraps it. :func:`recoverable` is true
only for ``torch.cuda.OutOfMemoryError`` and for a
``guard.inject.InjectedFault`` (a chaos stub); everything else propagates:

- ``KernelError`` (a failed ``nvcc`` build, a refusal before launch, a CUDA
  error returned by a launch);
- every other ``RuntimeError``, a CUDA illegal-address or launch error
  among them;
- ``EngineInputError`` and its subclasses (a malformed call fails the same
  way on every variant).

What a recoverable error does depends on where the tensors are:

- **On the card** an out-of-memory error never changes the variant, since
  every rung below a kernel is a plain torch version that needs more
  memory, and moving a call off its kernel would hide the kernel. The
  cache allocator is emptied and the same plan runs once more (a
  ``guard.oom_retry`` event and counter); a second failure reaches the
  caller. An injected fault demotes the call to the next rung, as on the
  CPU.
- **On the CPU** every variant is a plain version, so the call moves down
  the op's ladder: the resolved variant first, the other registered
  variants, and the op's reference variant (``torch``; ``ref`` for the
  dataflow-only ``merge``) last. The failed plan is quarantined for its
  ``(op, backend, dtype, shape bucket)`` for the rest of the process and
  later calls skip its rung. The plan cache is left as it was.

Every demotion is visible, a skipped rung included:

- a ``guard.fallback`` event and counter: the variant that failed or was
  skipped, the rung that took the call, why;
- a ``guard.quarantine`` event and counter when a plan is quarantined, and a
  ``guard.quarantine.skip`` counter when a later call skips it.

:func:`demotions` counts every demotion of the process whether or not
``obs`` is recording, so a run can assert that nothing was demoted.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import obs
from repro_torch.core.butterfly import tree_leaves
from repro_torch.guard.inject import InjectedFault
from repro_torch.guard.validate import EngineInputError

__all__ = ["guarded_call", "recoverable", "reference_variant", "demotions"]

#: ops whose most conservative variant is not named "torch"
_REFERENCE = {"merge": "ref"}

_demotions = 0


def reference_variant(op: str) -> str:
    return _REFERENCE.get(op, "torch")


def recoverable(exc: BaseException) -> bool:
    """May the guard absorb this failure? Only running out of device
    memory, or an injected fault: any other error, a kernel's above all,
    reaches the caller."""
    if isinstance(exc, EngineInputError):
        return False
    return isinstance(exc, (torch.cuda.OutOfMemoryError, InjectedFault))


def demotions() -> int:
    """Demotions made in this process so far."""
    return _demotions


def _ladder(op: str, plan):
    """Demotion order: resolved variant, the other registered variants in
    the registry's order, reference variant last."""
    from repro_torch.engine import registry
    ref = reference_variant(op)
    known = registry.variants(op)
    if ref not in known and known:
        ref = known[-1]
    rungs = [plan.variant]
    rungs += [v for v in known if v != plan.variant and v != ref]
    if ref != plan.variant:
        rungs.append(ref)
    return rungs


def _bucket(op: str, args) -> Optional[tuple]:
    """The plan-cache key of this call, or None when the arguments cannot be
    bucketed (the ladder still runs, without quarantine)."""
    from repro_torch.engine.api import infer_key
    try:
        return infer_key(op, *args)
    except (ValueError, IndexError, AttributeError, TypeError):
        return None


def _on_card(key, args) -> bool:
    if key is not None:
        return key[1] == "cuda"
    return any(isinstance(t, torch.Tensor) and t.is_cuda
               for t in tree_leaves(list(args)))


def _demote(op: str, key, variant: str, to: str, why: str) -> None:
    global _demotions
    from repro_torch.engine.planner import _key_str
    _demotions += 1
    obs.inc("guard.fallback")
    obs.event("guard.fallback", op=op, from_variant=variant, to_variant=to,
              key=None if key is None else _key_str(key), error=why[:200])


def _card_call(op: str, plan, key, args, kw):
    """The resolved plan, and on an out-of-memory error the same plan once
    more after emptying the cache allocator."""
    from repro_torch.engine import registry
    from repro_torch.engine.planner import _key_str
    try:
        return registry.call(op, plan.variant, *args, plan=plan, **kw)
    except torch.cuda.OutOfMemoryError as e:
        torch.cuda.empty_cache()
        obs.inc("guard.oom_retry")
        obs.event("guard.oom_retry", op=op, variant=plan.variant,
                  key=None if key is None else _key_str(key),
                  error=f"{type(e).__name__}: {e}"[:200])
    return registry.call(op, plan.variant, *args, plan=plan, **kw)


def guarded_call(op: str, plan, *args, **kw):
    """``registry.call`` under the guard: dispatch ``op`` with ``plan``
    (passed down as ``plan=``). On the card an out-of-memory error retries
    the plan once and an injected fault moves to the next rung; on the CPU
    every recoverable error quarantines the plan and moves to the next
    rung. The last rung's failure, and every error :func:`recoverable`
    refuses, propagates."""
    from repro_torch.engine import registry
    from repro_torch.engine.planner import _key_str, default_planner

    key = _bucket(op, args)
    on_card = _on_card(key, args)
    rungs = _ladder(op, plan)
    for i, variant in enumerate(rungs):
        last_rung = i + 1 == len(rungs)
        p = plan if variant == plan.variant else plan.replace(variant=variant)
        if not last_rung and key is not None \
                and default_planner.is_quarantined(key, p):
            obs.inc("guard.quarantine.skip")
            _demote(op, key, variant, rungs[i + 1], "quarantined")
            continue
        try:
            if on_card:
                return _card_call(op, p, key, args, kw)
            return registry.call(op, p.variant, *args, plan=p, **kw)
        except Exception as e:
            demotes = isinstance(e, InjectedFault) if on_card \
                else recoverable(e)
            if last_rung or not demotes:
                raise
            if key is not None:
                default_planner.quarantine(key, p)
                obs.inc("guard.quarantine")
                obs.event("guard.quarantine", op=op, variant=variant,
                          key=_key_str(key))
            _demote(op, key, variant, rungs[i + 1],
                    f"{type(e).__name__}: {e}")
    raise AssertionError("unreachable: empty fallback ladder")  # pragma: no cover
