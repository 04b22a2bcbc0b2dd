"""``repro_torch.obs`` — the port's flight recorder.

Counterpart of ``repro.obs``: counters, gauges, timers and a bounded event
ring, **disabled by default and free when disabled** (every site checks one
module-level flag first).

    from repro_torch import obs
    obs.enable()
    engine.sort(x)
    snap = obs.snapshot()
    obs.disable()

Events the port records: ``plan.resolve`` (cache hit or heuristic, with
the variant), ``schedule.pass`` (one per fused merge-tree pass: levels,
runs, block size), ``schedule.reduce`` (passes against tree levels) and
``moe.route`` (one per routed chunk: groups, tokens, experts, k, capacity,
variant), ``autotune.candidate`` / ``autotune.winner`` (each timed
candidate plan, the plan installed), ``guard.fallback`` /
``guard.quarantine`` (a demotion down the variant ladder) and the serve
scheduler's ``serve.admit`` / ``serve.retire`` / ``serve.reject``.
Counters: ``plan_cache.*``, ``autotune.*``, ``guard.*``, ``serve.*`` and
``moe.dropped_tokens`` (pairs over capacity; counting them reads the keep
mask back from the device, which ``engine.moe_route`` does only while
recording is enabled). Gauges: ``serve.live_slots``, ``serve.waiting``,
``serve.kv_free``, ``serve.traces``. ``report()`` renders a snapshot as
text (``obs/reporting.py``).
``span`` times host wall clock into a histogram and, when a profiler runs,
opens a ``torch.profiler.record_function`` range; ``scoped("kernels.*")``
labels every kernel entry point the same way, enabled or not.
"""
from __future__ import annotations

import contextlib
import functools
import time
from typing import Callable, Optional

from repro_torch.obs.metrics import Registry, percentile, plain

__all__ = [
    "enable", "disable", "enabled", "blocking", "configure", "inc", "gauge",
    "observe", "event", "on", "span", "kernel_scope", "scoped", "snapshot", "report",
    "reset", "registry", "percentile", "plain",
]

#: the process-wide registry every instrumentation site writes to
registry = Registry()

_enabled = False
_block = False


def configure(*, block: Optional[bool] = None) -> None:
    """``block=True`` makes engine spans wait for the device
    (``torch.cuda.synchronize``) so they time execution, not enqueueing."""
    global _block
    if block is not None:
        _block = bool(block)


def enable(*, block: Optional[bool] = None) -> None:
    global _enabled
    _enabled = True
    configure(block=block)


def disable() -> None:
    global _enabled, _block
    _enabled = False
    _block = False


def enabled() -> bool:
    return _enabled


def blocking() -> bool:
    return _enabled and _block


def inc(name: str, n: int = 1) -> None:
    if _enabled:
        registry.inc(name, n)


def gauge(name: str, value) -> None:
    if _enabled:
        registry.set_gauge(name, value)


def observe(name: str, seconds: float) -> None:
    """One sample of ``seconds`` into the ``name`` timer."""
    if _enabled:
        registry.observe(name, seconds)


def event(kind: str, **data) -> None:
    if _enabled:
        registry.event(kind, **data)


def on(kind: str, fn: Callable) -> Callable:
    """Subscribe ``fn(event_dict)`` to events of ``kind`` ('*' for all).
    Subscriptions are independent of the enabled flag (events only fire
    while enabled)."""
    return registry.on(kind, fn)


def kernel_scope(name: str):
    """A ``torch.profiler.record_function`` range named ``repro.<name>``."""
    from torch.profiler import record_function
    return record_function(f"repro.{name}")


@contextlib.contextmanager
def span(name: str):
    """Host wall-time span into the ``name`` timer; no-op while disabled."""
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        with kernel_scope(name):
            yield
    finally:
        registry.observe(name, time.perf_counter() - t0)


def scoped(name: str):
    """Decorator form of ``kernel_scope``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kw):
            with kernel_scope(name):
                return fn(*args, **kw)
        return wrapper
    return deco


def snapshot(kinds: Optional[tuple] = None) -> dict:
    """One JSON-clean dict of counters, gauges, timers and events."""
    snap = registry.snapshot(kinds)
    snap["enabled"] = _enabled
    return snap


def report(snap: Optional[dict] = None) -> str:
    """Human-readable rendering of a snapshot (default: the current one)."""
    from repro_torch.obs.reporting import render_report
    return render_report(snap if snap is not None else snapshot())


def reset() -> None:
    """Clear everything recorded (the enabled flag and hooks survive)."""
    registry.reset()
