"""Process-wide metrics registry: counters, gauges, timers, and events.

The storage layer of ``repro_torch.obs``, a copy of ``repro/obs/metrics.py``
(the port imports nothing of the JAX package). One ``Registry`` holds

- **counters**   monotonic ints (``plan_cache.hit``, ``autotune.infeasible``);
- **gauges**     last-written values (``serve.batch``);
- **timers**     duration accumulators with a bounded sample reservoir, so
  ``snapshot()`` can report count/total/p50/p99/max without unbounded memory;
- **events**     a bounded ring of structured records ``{"kind", "data"}``
  for the engine decisions that would otherwise vanish (plan resolution,
  autotune candidates, the sharded sort's selected cap rung, schedule
  passes), plus subscriber hooks per kind.

Everything is guarded by one lock — instrumentation sites go through the
module-level fast path in ``repro_torch.obs`` which checks the enabled flag
first, so a disabled registry is never touched on the hot path. Values
stored must be plain JSON-serializable scalars (the ``plain`` helper coerces
numpy scalars, tensors and arrays).
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Dict, List, Optional

#: bounded history sizes — big enough for a serving session, small enough
#: to never matter for memory
MAX_EVENTS = 4096
MAX_SAMPLES = 512


def plain(v):
    """Coerce numpy scalars / 0-d arrays / tuples into JSON-clean values."""
    if isinstance(v, (str, bool, int, float)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [plain(x) for x in v]
    if isinstance(v, dict):
        return {str(k): plain(x) for k, x in v.items()}
    item = getattr(v, "item", None)           # numpy scalar / 0-d array
    if item is not None:
        try:
            return plain(item())
        except Exception:
            pass
    tolist = getattr(v, "tolist", None)       # small numpy arrays
    if tolist is not None:
        try:
            return plain(tolist())
        except Exception:
            pass
    return str(v)


def percentile(samples, q: float) -> float:
    """Nearest-rank percentile of a sequence (q in [0, 100])."""
    if not samples:
        return 0.0
    s = sorted(samples)
    idx = min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))
    return s[idx]


class Timer:
    """Duration accumulator: exact count/total/max plus a bounded reservoir
    of recent samples for the snapshot's p50/p99."""

    __slots__ = ("count", "total", "max", "samples")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.max = 0.0
        self.samples = deque(maxlen=MAX_SAMPLES)

    def observe(self, seconds: float) -> None:
        self.count += 1
        self.total += seconds
        if seconds > self.max:
            self.max = seconds
        self.samples.append(seconds)

    def summary(self) -> dict:
        us = [s * 1e6 for s in self.samples]
        return {
            "count": self.count,
            "total_us": self.total * 1e6,
            "mean_us": (self.total / self.count) * 1e6 if self.count else 0.0,
            "p50_us": percentile(us, 50),
            "p99_us": percentile(us, 99),
            "max_us": self.max * 1e6,
        }


class Registry:
    """One process-wide store for counters, gauges, timers, and events."""

    def __init__(self, max_events: int = MAX_EVENTS):
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = {}
        self.gauges: Dict[str, float] = {}
        self.timers: Dict[str, Timer] = {}
        self.events: deque = deque(maxlen=max_events)
        self._hooks: Dict[str, List[Callable]] = {}

    # -- write paths (only reached when obs is enabled) --------------------
    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def set_gauge(self, name: str, value) -> None:
        with self._lock:
            self.gauges[name] = plain(value)

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            t = self.timers.get(name)
            if t is None:
                t = self.timers[name] = Timer()
            t.observe(seconds)

    def event(self, kind: str, **data) -> None:
        rec = {"kind": kind, "data": {k: plain(v) for k, v in data.items()}}
        with self._lock:
            self.events.append(rec)
            hooks = list(self._hooks.get(kind, ())) + \
                list(self._hooks.get("*", ()))
        for fn in hooks:          # outside the lock: hooks may re-enter obs
            try:
                fn(rec)
            except Exception:
                pass              # a broken subscriber must not break the op

    def on(self, kind: str, fn: Callable) -> Callable:
        """Subscribe ``fn(event_dict)`` to events of ``kind`` ('*' = all).
        Returns ``fn`` so it can be used as a decorator."""
        with self._lock:
            self._hooks.setdefault(kind, []).append(fn)
        return fn

    # -- read / lifecycle --------------------------------------------------
    def snapshot(self, kinds: Optional[tuple] = None) -> dict:
        with self._lock:
            events = [e for e in self.events
                      if kinds is None or e["kind"] in kinds]
            return {
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "timers": {k: t.summary() for k, t in self.timers.items()},
                "events": events,
            }

    def reset(self) -> None:
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            self.timers.clear()
            self.events.clear()
