"""Parity of the port's ``tree_vmapped`` executor with the JAX package's.

``repro_torch.engine.schedule.merge_runs`` / ``reduce_rows`` under
``MergeSchedule("tree_vmapped")`` and ``engine.merge_runs(variant=
"tree_vmapped")`` against the JAX package's, on the CPU (the port's lane
merge runs its plain version there; the card's K9 is held to that in
``tests/test_torch_cuda.py``). The cases mirror ``tests/test_merge_runs.py``
for this executor: ragged runs with empty ones, any K, key-only under tie b
and skew, (key, rank) lanes, both directions, grouped reductions and the
ascending mirror per group, payloads through the engine, the skew
rejections, and a plan table with ``tie`` saved by the JAX engine and loaded
into the port. Inputs are numpy arrays from a seeded generator:
duplicate-heavy keys with +0.0/-0.0, -inf and NaNs of two payloads.

Tolerance: exact. Keys, ranks and payloads are equal bit for bit; float
keys are compared as int32 bit patterns.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import engine as JE  # noqa: E402
from repro.engine.planner import Plan as JPlan  # noqa: E402
from repro.engine.planner import plan_key as jplan_key  # noqa: E402
from repro.engine.schedule import MergeSchedule as JSched  # noqa: E402
from repro.engine.schedule import merge_runs as j_merge_runs  # noqa: E402
from repro.engine.schedule import reduce_rows as j_reduce_rows  # noqa: E402
from repro_torch import engine as TE  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.engine import schedule as TS  # noqa: E402
from repro_torch.guard.validate import EngineInputError  # noqa: E402

RNG = np.random.default_rng(23)
POOL = np.array([0.0, -0.0, 1.5, 2.5, -np.inf, np.nan], np.float32)


def same(j, t):
    j = np.asarray(j)
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert j.shape == t.shape, (j.shape, t.shape)
    if j.dtype == np.float32:
        assert t.dtype == np.float32
        j, t = j.view(np.int32), t.view(np.int32)
    np.testing.assert_array_equal(j, t.astype(j.dtype))


def runs(lens, dtype=np.float32, descending=True):
    """Sorted runs (numpy's sort: NaNs at the ascending end) and offsets."""
    if dtype == np.int32:
        segs = [np.sort(RNG.integers(0, 4, n).astype(np.int32)) for n in lens]
    else:
        segs = []
        for n in lens:
            x = RNG.choice(POOL, n).astype(np.float32)
            x.view(np.int32)[RNG.random(n) < 0.05] = np.int32(-4194304)
            segs.append(np.sort(x))
    segs = [s[::-1] if descending else s for s in segs]
    flat = np.concatenate(segs + [np.zeros(0, dtype)]).astype(dtype)
    return flat, np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


@pytest.fixture(autouse=True)
def clean_state():
    JE.clear_plans()
    TE.clear_plans()
    obs.disable()
    obs.reset()
    yield
    JE.clear_plans()
    TE.clear_plans()
    obs.disable()
    obs.reset()


LENS = [
    [5, 0, 33, 7, 2],                 # ragged with an empty run, K = 5
    [64],                             # K = 1 (identity)
    [7, 19, 3],                       # K = 3
    [1] * 9,                          # many tiny, K = 9
    [100, 1, 0, 55, 23, 8, 90, 4],    # K = 8 ragged
]


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("lens", LENS, ids=lambda x: f"K{len(x)}")
@pytest.mark.parametrize("descending", [True, False])
def test_tree_vmapped_matches_jax(dtype, lens, descending):
    """Key-only under tie b and skew, and (key, rank) lanes."""
    buf, offs = runs(lens, dtype, descending)
    jb, jo, tb, to = jnp.array(buf), jnp.array(offs), torch.from_numpy(
        buf), torch.from_numpy(offs)
    for tie in ("b", "skew"):
        same(j_merge_runs(jb, jo, schedule=JSched("tree_vmapped", w=8,
                                                  tie=tie),
                          descending=descending),
             TS.merge_runs(tb, to, schedule=TS.MergeSchedule(
                 "tree_vmapped", w=8, tie=tie), descending=descending))
    ranks = RNG.permutation(buf.shape[0]).astype(np.int32)
    jk, jr = j_merge_runs(jb, jo, ranks=jnp.array(ranks),
                          schedule=JSched("tree_vmapped", w=4),
                          descending=descending)
    tk, tr = TS.merge_runs(tb, to, ranks=torch.from_numpy(ranks),
                           schedule=TS.MergeSchedule("tree_vmapped", w=4),
                           descending=descending)
    same(jk, tk)
    same(jr, tr)


@pytest.mark.parametrize("kv", [False, True])
@pytest.mark.parametrize("descending", [True, False])
def test_tree_vmapped_grouped_matches_jax(kv, descending):
    """Consecutive groups of 3 rows reduce independently (completed to 4
    with a sentinel run each), group order kept by the ascending mirror."""
    rows = np.sort(RNG.choice(POOL[:5], (6, 16)), axis=1).astype(np.float32)
    rows[3:] += 10.0
    rows = (rows[:, ::-1] if descending else rows).copy()
    ranks = np.arange(96, dtype=np.int32).reshape(6, 16)
    js = JSched("tree_vmapped", w=8)
    ts = TS.MergeSchedule("tree_vmapped", w=8)
    j = j_reduce_rows(jnp.array(rows), schedule=js, runs_per_group=3,
                      descending=descending,
                      ranks=jnp.array(ranks) if kv else None)
    t = TS.reduce_rows(torch.from_numpy(rows), schedule=ts, runs_per_group=3,
                       descending=descending,
                       ranks=torch.from_numpy(ranks) if kv else None)
    for a, b in zip(j if kv else (j,), t if kv else (t,)):
        same(a, b)


def test_reduce_rows_passes_the_uniform_length(monkeypatch):
    """``reduce_rows`` hands its row length to the executor, which then
    never reads the offsets back (as the JAX fix for its traced offsets)."""
    calls = []
    orig = TS._vmapped_reduce

    def spy(keys, offsets, ranks, m, sched, uniform_len=None):
        calls.append(uniform_len)
        return orig(keys, offsets, ranks, m, sched, uniform_len=uniform_len)
    monkeypatch.setattr(TS, "_vmapped_reduce", spy)
    monkeypatch.setattr(TS, "_uniform_len", None)     # must not be needed
    rows = np.sort(RNG.integers(-99, 99, (8, 32)).astype(np.int32),
                   axis=1)[:, ::-1].copy()
    out = TS.reduce_rows(torch.from_numpy(rows),
                         schedule=TS.MergeSchedule("tree_vmapped", w=16))
    same(np.sort(rows.reshape(-1))[::-1], out)
    assert calls == [32]


def test_engine_merge_runs_tree_vmapped_matches_jax():
    """The engine op with ``values=`` both directions and ``tie='skew'``;
    the schedule event carries ``executor="tree_vmapped"`` and one pass a
    level, as the JAX event does."""
    for d in (True, False):
        buf, offs = runs([30, 0, 12, 7, 40], np.float32, d)
        vals = {"ids": np.arange(buf.shape[0], dtype=np.int32)}
        jk, jv = JE.merge_runs(jnp.array(buf), jnp.array(offs), values={
            "ids": jnp.array(vals["ids"])}, descending=d,
            variant="tree_vmapped", nan="unsafe")
        tk, tv = TE.merge_runs(buf, offs, values=vals, descending=d,
                               variant="tree_vmapped", nan="unsafe",
                               device="cpu")
        same(jk, tk)
        same(jv["ids"], tv["ids"])
        same(JE.merge_runs(jnp.array(buf), jnp.array(offs), descending=d,
                           tie="skew", variant="tree_vmapped", nan="unsafe"),
             TE.merge_runs(buf, offs, descending=d, tie="skew",
                           variant="tree_vmapped", nan="unsafe",
                           device="cpu"))
    obs.enable()
    TE.merge_runs(buf, offs, variant="tree_vmapped", nan="unsafe",
                  device="cpu")
    ev = [e["data"] for e in obs.snapshot()["events"]
          if e["kind"] == "schedule.reduce"]
    assert ev == [dict(executor="tree_vmapped", passes=3, levels_total=3,
                       hbm_trips_saved=0, n=buf.shape[0], kv=False)]


def test_skew_same_keys_and_rejected_on_stable_paths():
    a = np.sort(RNG.choice([1, 2], 400).astype(np.int32))[::-1].copy()
    b = np.sort(RNG.choice([1, 2], 300).astype(np.int32))[::-1].copy()
    buf = np.concatenate([a, b])
    offs = np.array([0, 400, 700], np.int32)
    exp = np.sort(buf)[::-1]
    same(exp, TE.merge_runs(buf, offs, tie="skew", variant="tree_vmapped",
                            device="cpu"))
    with pytest.raises(EngineInputError):
        TE.merge_runs(buf, offs, tie="skew", stable=True,
                      variant="tree_vmapped", device="cpu")
    with pytest.raises(EngineInputError):
        TE.merge_runs(buf.astype(np.float32), offs, tie="skew",
                      nan="sort_last", device="cpu")
    with pytest.raises(ValueError):
        TS.MergeSchedule("tree_vmapped", tie="a")


def test_schedule_tie_roundtrips_a_jax_plan_table(tmp_path):
    """A plan with ``tree_vmapped`` and ``tie='skew'`` saved by the JAX
    engine loads into the port, lifts into the same schedule and serves
    the same merge."""
    key = jplan_key("merge_runs", n=512, dtype=np.int32, segments=8,
                    backend="cpu")
    JE.default_planner.put(key, JPlan("tree_vmapped", w=16, levels=3,
                                      tie="skew"))
    path = tmp_path / "plans.json"
    JE.save_plans(str(path))
    doc = json.loads(path.read_text())
    assert list(doc["plans"].values())[0]["tie"] == "skew"
    TE.load_plans(str(path))
    tkey = TE.plan_key("merge_runs", n=512, dtype=torch.int32, backend="cpu",
                       segments=8)
    back = TE.default_planner.lookup(tkey)
    assert back.variant == "tree_vmapped" and back.tie == "skew"
    sched = TS.MergeSchedule.from_plan(back)
    assert (sched.variant, sched.tie, sched.w) == ("tree_vmapped", "skew", 16)
    buf, offs = runs([100, 60, 0, 90, 20, 50, 40, 152], np.int32)
    same(JE.merge_runs(jnp.array(buf), jnp.array(offs)),
         TE.merge_runs(buf, offs, device="cpu"))
