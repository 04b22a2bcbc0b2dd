"""``repro_torch.obs``'s module-level ``observe`` and ``on``, mirroring
``tests/test_obs.py``'s ``test_nothing_recorded_while_disabled`` and
``test_event_hooks``: nothing is recorded while disabled, a subscriber
sees ``plan.resolve`` of an engine call while enabled; and one sequence
of ``observe`` samples gives the JAX recorder's timer summary (exact:
both compute from the same floats).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as jobs  # noqa: E402
from repro_torch import engine, obs  # noqa: E402


@pytest.fixture(autouse=True)
def clean_obs():
    """Every test starts disabled and empty, and leaves no global residue."""
    for o in (obs, jobs):
        o.disable()
        o.reset()
    engine.default_planner.clear()
    yield
    for o in (obs, jobs):
        o.disable()
        o.reset()
    engine.default_planner.clear()


def test_observe_and_on_are_exported():
    assert {"observe", "on"} <= set(obs.__all__)
    assert obs.on is not None and obs.observe is not None


def test_nothing_recorded_while_disabled():
    obs.inc("x")
    obs.gauge("g", 3)
    obs.observe("t", 0.5)
    obs.event("k", a=1)
    with obs.span("s"):
        pass
    snap = obs.snapshot()
    assert snap["counters"] == {}
    assert snap["gauges"] == {}
    assert snap["timers"] == {}
    assert snap["events"] == []
    assert snap["enabled"] is False


def test_event_hooks():
    obs.enable()
    seen = []
    obs.on("plan.resolve", seen.append)
    engine.sort(torch.arange(64, dtype=torch.int32))
    assert seen and seen[0]["kind"] == "plan.resolve"


def test_observe_summary_matches_jax():
    """The same samples through both recorders' ``observe``: the timers'
    summaries are equal (count, total, mean, p50, p99, max)."""
    samples = np.random.default_rng(3).random(40).tolist()
    for o in (obs, jobs):
        o.enable()
        for s in samples:
            o.observe("serve.step", s)
    got = obs.snapshot()["timers"]["serve.step"]
    exp = jobs.snapshot()["timers"]["serve.step"]
    assert got == exp
