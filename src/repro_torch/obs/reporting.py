"""Rendering for ``obs.snapshot()``: the human-readable ``obs.report()``
text and a compact one-line stats summary for serving loops (counterpart
of ``repro/obs/reporting.py``)."""
from __future__ import annotations

from typing import Optional


def _fmt_us(us: float) -> str:
    if us >= 1e6:
        return f"{us / 1e6:.2f}s"
    if us >= 1e3:
        return f"{us / 1e3:.2f}ms"
    return f"{us:.1f}us"


def render_report(snap: dict) -> str:
    lines = [f"repro_torch.obs report (enabled={snap.get('enabled')})"]
    counters = snap.get("counters", {})
    if counters:
        lines.append("  counters:")
        for k in sorted(counters):
            lines.append(f"    {k:<40} {counters[k]}")
    gauges = snap.get("gauges", {})
    if gauges:
        lines.append("  gauges:")
        for k in sorted(gauges):
            lines.append(f"    {k:<40} {gauges[k]}")
    timers = snap.get("timers", {})
    if timers:
        lines.append("  timers:                                    "
                     "count    p50      p99      max      total")
        for k in sorted(timers):
            t = timers[k]
            lines.append(
                f"    {k:<40} {t['count']:<8} {_fmt_us(t['p50_us']):<8} "
                f"{_fmt_us(t['p99_us']):<8} {_fmt_us(t['max_us']):<8} "
                f"{_fmt_us(t['total_us'])}")
    events = snap.get("events", [])
    if events:
        by_kind = {}
        for e in events:
            by_kind[e["kind"]] = by_kind.get(e["kind"], 0) + 1
        lines.append("  events: " + ", ".join(
            f"{k} x{n}" for k, n in sorted(by_kind.items())))
        for e in events[-12:]:
            data = ";".join(f"{k}={v}" for k, v in e["data"].items())
            lines.append(f"    [{e['kind']}] {data}")
        if len(events) > 12:
            lines.insert(len(lines) - 12, f"    ... showing last 12 of "
                                          f"{len(events)}")
    if len(lines) == 1:
        lines.append("  (empty)")
    return "\n".join(lines)


def stats_line(step: int, window_s, batch: int,
               counters: Optional[dict] = None) -> str:
    """One periodic serving-stats line: latency percentiles over the recent
    window of per-step wall times, throughput, and plan-cache counters."""
    from repro_torch.obs.metrics import percentile
    ws = list(window_s)
    p50 = percentile(ws, 50) * 1e3
    p99 = percentile(ws, 99) * 1e3
    tput = batch * len(ws) / sum(ws) if ws and sum(ws) > 0 else 0.0
    c = counters or {}
    line = (f"[stats] step={step} p50={p50:.2f}ms p99={p99:.2f}ms "
            f"tok_s={tput:.1f} cache_hit={c.get('plan_cache.hit', 0)} "
            f"cache_miss={c.get('plan_cache.miss', 0)} "
            f"fallback={c.get('plan_cache.fallback', 0)}")
    if "moe.dropped_tokens" in c:        # only when MoE routing ran observed
        line += f" moe_drops={c['moe.dropped_tokens']}"
    return line


def serve_stats_line(snap: dict, step: Optional[int] = None) -> str:
    """One periodic serving-stats line sourced entirely from the obs
    registry (requires ``obs.enable()``): step-latency percentiles from the
    ``serve.step`` span-timer histogram — not an ad-hoc wall-time list —
    throughput from the ``serve.tokens`` counter over the timer total, and
    the scheduler occupancy gauges."""
    t = snap.get("timers", {}).get("serve.step") or {}
    c = snap.get("counters", {})
    g = snap.get("gauges", {})
    total_s = t.get("total_us", 0.0) / 1e6
    tok_s = c.get("serve.tokens", 0) / total_s if total_s > 0 else 0.0
    return (f"[serve] step={step if step is not None else t.get('count', 0)} "
            f"p50={_fmt_us(t.get('p50_us', 0.0))} "
            f"p99={_fmt_us(t.get('p99_us', 0.0))} tok_s={tok_s:.1f} "
            f"live={g.get('serve.live_slots', 0)} "
            f"waiting={g.get('serve.waiting', 0)} "
            f"traces={g.get('serve.traces', 0)}")
