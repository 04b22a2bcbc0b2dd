"""Parity of the port's engine with the JAX package's, on the CPU.

``repro_torch.engine.sort`` / ``argsort`` / ``merge`` / ``merge_runs`` with
the ``cuda`` / ``tree_cuda`` variants pinned run the kernels' plain versions
on CPU tensors; the JAX engine runs its ``pallas`` / ``tree_pallas``
variants in interpret mode. The same numpy inputs, made from a seeded
generator, go through both, with ``values=``, ``stable=``, both directions
and ``nan="sort_last"``. Also: the ``schedule.pass`` count is
``ceil(log2 K / L)``, and a plan table saved by the JAX engine loads into
the port and resolves the same schedule.

Tolerance: exact. Keys, payloads and permutations are equal bit for bit;
float keys are compared as int32 bit patterns.
"""
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import engine as JE  # noqa: E402
from repro.engine.planner import Plan as JPlan  # noqa: E402
from repro.engine.planner import plan_key as jplan_key  # noqa: E402
from repro.engine.schedule import MergeSchedule as JSched  # noqa: E402
from repro_torch import engine as TE  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.engine import planner as tplanner  # noqa: E402
from repro_torch.engine.schedule import MergeSchedule as TSched  # noqa: E402
from repro_torch.guard.validate import EngineInputError  # noqa: E402

RNG = np.random.default_rng(31)
FPOOL = np.array([0.0, -0.0, 2.5, -1.0, -np.inf, 7.0], np.float32)


def same(j, t):
    j = np.asarray(j)
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert j.shape == t.shape, (j.shape, t.shape)
    if j.dtype == np.float32:
        assert t.dtype == np.float32
        j, t = j.view(np.int32), t.view(np.int32)
    np.testing.assert_array_equal(j, t.astype(j.dtype))


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


def ties(n):
    return RNG.choice(FPOOL, n).astype(np.float32)


def runs(lens, descending=True):
    segs = [np.sort(ties(n)) for n in lens]
    segs = [s[::-1] if descending else s for s in segs]
    buf = np.concatenate(segs + [np.zeros(0, np.float32)])
    return buf, np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


@pytest.mark.parametrize("descending", [True, False])
def test_sort_values_and_argsort(descending):
    x = ties(150)
    v = np.arange(150, dtype=np.int32) * 3
    jk, jv = JE.sort(jnp.array(x), values=jnp.array(v), descending=descending,
                     variant="pallas")
    tk, tv = TE.sort(x, values=v, descending=descending, variant="cuda",
                     device="cpu")
    same(jk, tk)
    same(jv, tv)
    same(JE.sort(jnp.array(x), descending=descending, variant="pallas"),
         TE.sort(x, descending=descending, variant="cuda", device="cpu"))


@pytest.mark.parametrize("descending", [True, False])
def test_argsort_batched_rows(descending):
    """A (B, n) argsort equals the JAX engine's vmapped one row for row, and
    runs each merge pass once for the whole batch: ceil(log2 m / L) passes
    for m chunks per row, not B times as many."""
    x = ties(4 * 100).reshape(4, 100)
    plan_j = JPlan("pallas", chunk=16, w=8)
    plan_t = tplanner.Plan("cuda", chunk=16, w=8)
    obs.enable()
    got = TE.argsort(x, descending=descending, plan=plan_t, device="cpu")
    passes = [e for e in obs.snapshot()["events"]
              if e["kind"] == "schedule.pass"]
    assert got.dtype == torch.int32 and len(passes) == math.ceil(3 / 2)
    same(JE.argsort(jnp.array(x), descending=descending, plan=plan_j), got)


@pytest.mark.parametrize("op", ["sort", "argsort"])
def test_nan_sort_last(op):
    x = np.where(RNG.random(120) < 0.2, np.nan, ties(120)).astype(np.float32)
    jfn, tfn = getattr(JE, op), getattr(TE, op)
    same(jfn(jnp.array(x), nan="sort_last", variant="pallas"),
         tfn(x, nan="sort_last", variant="cuda", device="cpu"))
    with pytest.raises(EngineInputError):
        tfn(x, nan="raise", device="cpu")


NAN_PAYLOADS = np.array([0x7fc00000, 0xffc12345, 0x7fc00001, 0x7fa00000],
                        np.uint32).view(np.float32)


@pytest.mark.parametrize("payloads", [1, 4])
def test_sort_nan_payloads_unsafe(payloads):
    """``engine.sort`` under ``nan="unsafe"`` on float32 keys holding NaNs
    (one pattern, or four payloads), +0.0, -0.0 and -inf: the ``cuda``
    variant on the CPU against JAX ``pallas``, bit for bit, the NaN
    payloads included."""
    x = FPOOL[RNG.integers(0, FPOOL.size, 300)]
    hit = RNG.random(300) < 0.05
    x[hit] = NAN_PAYLOADS[RNG.integers(0, payloads, int(hit.sum()))]
    j = np.asarray(JE.sort(jnp.array(x), variant="pallas", nan="unsafe"))
    same(j, TE.sort(x, variant="cuda", device="cpu", nan="unsafe"))


@pytest.mark.parametrize("descending", [True, False])
def test_merge_keys_and_values(descending):
    a, b = runs([90])[0], runs([70])[0]
    if not descending:
        a, b = a[::-1].copy(), b[::-1].copy()
    same(JE.merge(jnp.array(a), jnp.array(b), descending=descending,
                  variant="pallas"),
         TE.merge(a, b, descending=descending, variant="cuda", device="cpu"))
    va, vb = np.arange(90, dtype=np.int32), 100 + np.arange(70, dtype=np.int32)
    jk, jv = JE.merge(jnp.array(a), jnp.array(b), descending=descending,
                      values=(jnp.array(va), jnp.array(vb)), variant="pallas")
    tk, tv = TE.merge(a, b, descending=descending, values=(va, vb),
                      variant="cuda", device="cpu")
    same(jk, tk)
    same(jv, tv)


@pytest.mark.parametrize("variant", ["ref", "banked"])
def test_merge_reference_variants_skew(variant):
    a, b = runs([40])[0], runs([25])[0]
    same(JE.merge(jnp.array(a), jnp.array(b), tie="skew", variant=variant),
         TE.merge(a, b, tie="skew", variant=variant, device="cpu"))


@pytest.mark.parametrize("descending", [True, False])
def test_merge_runs_key_only_and_stable(descending):
    buf, offs = runs([12, 0, 40, 7, 3, 60], descending)
    plan_j = JPlan("tree_pallas", w=8, block_out=32, levels=2)
    plan_t = tplanner.Plan("tree_cuda", w=8, block_out=32, levels=2)
    same(JE.merge_runs(jnp.array(buf), jnp.array(offs), plan=plan_j,
                       descending=descending),
         TE.merge_runs(buf, offs, plan=plan_t, descending=descending,
                       device="cpu"))
    v = np.arange(buf.shape[0], dtype=np.int32)
    jk, jv = JE.merge_runs(jnp.array(buf), jnp.array(offs), plan=plan_j,
                           descending=descending, values=jnp.array(v))
    tk, tv = TE.merge_runs(buf, offs, plan=plan_t, descending=descending,
                           values=v, device="cpu")
    same(jk, tk)
    same(jv, tv)


def test_merge_runs_nan_sort_last():
    buf, offs = runs([20, 9, 33])
    plan_j = JPlan("tree_pallas", w=8, block_out=32, levels=2)
    plan_t = tplanner.Plan("tree_cuda", w=8, block_out=32, levels=2)
    same(JE.merge_runs(jnp.array(buf), jnp.array(offs), nan="sort_last",
                       plan=plan_j),
         TE.merge_runs(buf, offs, nan="sort_last", plan=plan_t, device="cpu"))


@pytest.mark.parametrize("K,L", [(2, 1), (5, 1), (5, 2), (9, 2), (9, 3),
                                 (16, 3), (128, 2)])
def test_schedule_pass_count(K, L):
    """One ``schedule.pass`` event per fused pass: ceil(log2 K / L)."""
    lens = RNG.integers(0, 6, K)
    buf, offs = runs(list(lens))
    obs.enable()
    out = TE.merge_runs(buf, offs, plan=tplanner.Plan(
        "tree_cuda", w=8, block_out=16, levels=L), device="cpu")
    ev = obs.snapshot()["events"]
    passes = [e for e in ev if e["kind"] == "schedule.pass"]
    red = [e for e in ev if e["kind"] == "schedule.reduce"]
    levels = math.ceil(math.log2(K))
    assert len(passes) == math.ceil(levels / L)
    assert red[-1]["data"]["passes"] == len(passes)
    assert red[-1]["data"]["levels_total"] == levels
    assert sum(e["data"]["levels"] for e in passes) == levels
    np.testing.assert_array_equal(out.numpy(), np.sort(buf)[::-1])


def test_plan_table_from_jax(tmp_path):
    """A table the JAX engine saved loads into the port with its names
    mapped, resolves the same schedule and gives the same output."""
    buf, offs = runs([30, 5, 0, 61, 17, 9, 2, 40])
    n, K = buf.shape[0], offs.shape[0] - 1
    jkey = jplan_key("merge_runs", n=n, dtype=np.float32, segments=K)
    JE.default_planner.put(jkey, JPlan("tree_pallas", w=32, block_out=64,
                                       levels=3))
    JE.default_planner.put(jplan_key("sort", n=n, dtype=np.float32),
                           JPlan("xla", chunk=512))
    path = tmp_path / "plans.json"
    JE.save_plans(str(path))
    TE.load_plans(str(path))
    tkey = tplanner.plan_key("merge_runs", n=n, dtype=torch.float32,
                             backend="cpu", segments=K)
    plan = TE.default_planner.lookup(tkey)
    assert plan is not None and plan.variant == "tree_cuda"
    js = JSched.from_plan(JE.default_planner.lookup(jkey)).to_dict()
    ts = TSched.from_plan(plan).to_dict()
    assert js.pop("variant") == "tree_pallas"
    assert ts.pop("variant") == "tree_cuda"
    assert js == ts                       # tie included
    sort_plan = TE.default_planner.lookup(tplanner.plan_key(
        "sort", n=n, dtype=torch.float32, backend="cpu"))
    assert sort_plan.variant == "torch" and sort_plan.chunk == 512
    same(JE.merge_runs(jnp.array(buf), jnp.array(offs)),
         TE.merge_runs(buf, offs, device="cpu"))
    # and the port's own table round-trips
    TE.save_plans(str(tmp_path / "port.json"))
    doc = json.loads((tmp_path / "port.json").read_text())
    assert any(k.startswith("merge_runs|cpu|float32") for k in doc["plans"])


def test_plans_from_jax_maps_backends_and_drops_unserved():
    table = {"plans": {
        "sort|tpu|float32|n1024|s0": {"variant": "pallas", "chunk": 512},
        "merge|gpu|int32|n64|s0": {"variant": "pallas", "w": 8},
        "topk|tpu|float32|n64|s0": {"variant": "flims"},
        "merge_runs|tpu|int32|n64|s8": {"variant": "tree_vmapped"},
        "sharded_topk|tpu|float32|n64|s8|adev": {"variant": "flims"},
        "merge_runs|cpu|int32|n64|s8": {"variant": "no_such_executor"}}}
    out = tplanner.plans_from_jax(table)
    assert out["sort|cuda|float32|n1024|s0"]["variant"] == "cuda"
    assert out["sort|cuda|float32|n1024|s0"]["chunk"] == 512
    assert out["merge|cuda|int32|n64|s0"]["w"] == 8
    assert out["topk|cuda|float32|n64|s0"]["variant"] == "flims"
    assert out["merge_runs|cuda|int32|n64|s8"]["variant"] == "tree_vmapped"
    # served since the sharded ops were ported: kept, axis and P intact
    assert out["sharded_topk|cuda|float32|n64|s8|adev"]["variant"] == "flims"
    assert len(out) == 5


def test_planner_keeps_and_routes_the_reference_sorters(tmp_path):
    """``plans_from_jax`` keeps the JAX table's ``topk``, ``sample_*``,
    ``tree_vmapped``, ``ref`` and ``flims`` entries (each names a variant the
    port registers), a table saved by the JAX engine with them loads, and
    the heuristic serves ``topk`` / ``sample_topp`` / ``sample_minp`` from
    ``flims`` on the card for the kernels' key types and from ``torch``
    elsewhere, as the JAX TPU / CPU tables do."""
    for name in ("tree_vmapped", "ref", "flims"):
        assert tplanner.VARIANT_MAP[name] == name
    entries = [("topk", "flims", 4096), ("sample_topp", "flims", 4096),
               ("sample_minp", "flims", 4096), ("sample_topp", "xla", 64),
               ("merge_runs", "tree_vmapped", 4096), ("sort", "ref", 4096),
               ("argsort", "flims", 4096)]
    for op, v, n in entries:
        JE.default_planner.put(jplan_key(op, n=n, dtype=np.float32,
                                         backend="tpu"),
                               JPlan(v, w=16, chunk=128, tie="skew"))
    JE.save_plans(str(tmp_path / "plans.json"))
    TE.load_plans(str(tmp_path / "plans.json"))
    for op, v, n in entries:
        plan = TE.default_planner.lookup(tplanner.plan_key(
            op, n=n, dtype=torch.float32, backend="cuda"))
        assert plan.variant == tplanner.VARIANT_MAP.get(v, v), (op, v)
        assert (plan.w, plan.chunk, plan.tie) == (16, 128, "skew")
    h = tplanner.heuristic_plan
    for op in ("topk", "sample_topp", "sample_minp"):
        jtpu = JE.heuristic_plan(op, jplan_key(op, n=1 << 16,
                                               dtype=np.float32,
                                               backend="tpu"))
        for dt, be, want in ((torch.float32, "cuda", "flims"),
                             (torch.int32, "cuda", "flims"),
                             (torch.bfloat16, "cuda", "flims"),
                             (torch.int64, "cuda", "torch"),
                             (torch.float32, "cpu", "torch")):
            plan = h(op, tplanner.plan_key(op, n=1 << 16, dtype=dt,
                                           backend=be))
            assert plan.variant == want, (op, dt, be)
            assert (plan.w, plan.chunk) == (jtpu.w, jtpu.chunk)
        assert jtpu.variant == "flims"


def test_heuristic_routes_by_device_and_dtype():
    h = tplanner.heuristic_plan
    key = lambda op, dt, be: tplanner.plan_key(op, n=1 << 20, dtype=dt,
                                               backend=be)
    assert h("sort", key("sort", torch.float32, "cuda")).variant == "cuda"
    assert h("merge_runs", key("merge_runs", torch.int32, "cuda")).variant \
        == "tree_cuda"
    assert h("merge_runs", key("merge_runs", torch.int32, "cuda")).levels == 2
    assert h("sort", key("sort", torch.float64, "cuda")).variant == "torch"
    assert h("argsort", key("argsort", torch.float32, "cpu")).variant \
        == "torch"
    obs.enable()
    x = ties(64)
    np.testing.assert_array_equal(TE.sort(x, device="cpu").numpy(),
                                  np.sort(x)[::-1])
    ev = [e for e in obs.snapshot()["events"] if e["kind"] == "plan.resolve"]
    assert ev[-1]["data"]["variant"] == "torch"


def test_non_tensor_input_goes_to_the_card():
    """Numpy input without ``device=`` is placed on ``cuda``; with no card
    that raises instead of quietly running on the CPU."""
    if torch.cuda.is_available():
        assert TE.sort(ties(8)).is_cuda
        return
    with pytest.raises((RuntimeError, AssertionError)):
        TE.sort(ties(8))


def test_cpu_tensor_never_launches_a_kernel():
    """On a CPU tensor the ``cuda`` variant is the plain version; a CUDA
    kernel launch is never attempted there."""
    from repro_torch import kernels
    kernels.reset_launches()
    TE.sort(ties(100), variant="cuda", device="cpu")
    assert kernels.launch_counts() == {}
