"""The port's planner, autotuner, ``run_op`` and fallback ladder, and the
``topk(variant="torch")`` order on signed zeros and NaNs.

- ``topk``: the port's ``torch`` variant (and the CPU default, which is
  it) against JAX ``topk(variant="xla")`` (``lax.top_k``) on rows holding
  both zeros, ±inf and NaNs of both signs: indices and value bits equal.
  ``lax.top_k`` ranks by the float total order (+0.0 above -0.0, a NaN
  with the sign bit set below -inf); a stable sort of the floats ties the
  zeros and puts every NaN first.
- autotune: a raising candidate is recorded as infeasible and skipped, then
  and in the next tune (``tests/test_stability.py``); the tuned plan
  round-trips through ``save_plans`` / ``load_plans`` and serves the op
  (``tests/test_engine.py``).
- the ladder: on CPU tensors an out-of-memory error demotes with
  ``guard.fallback`` / ``guard.quarantine`` events and counters and a
  quarantine of the failed plan, whose rung later calls skip as counted
  demotions (``tests/test_chaos.py``); the plan cache is not re-pointed.
  On the card it retries the same plan once and never changes the
  variant. A ``KernelError``, any other ``RuntimeError`` and an
  ``EngineInputError`` propagate with no demotion, and a candidate that
  raised in autotune still raises when pinned.

Exact throughout: every result here is a permutation or a sort.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro import engine as JE  # noqa: E402
from repro.serve import RaggedSampler as JRaggedSampler  # noqa: E402
from repro.serve import SamplingState as JSamplingState  # noqa: E402
from repro_torch import engine as TE  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.engine import registry  # noqa: E402
from repro_torch.engine.planner import Plan  # noqa: E402
from repro_torch.guard import fallback  # noqa: E402
from repro_torch.guard.validate import EngineInputError  # noqa: E402
from repro_torch.kernels import KernelError  # noqa: E402
from repro_torch.models.convert import tensor_from_numpy  # noqa: E402
from repro_torch.serve import RaggedSampler, SamplingState  # noqa: E402

RNG = np.random.default_rng(21)
# +-0, +-inf, +-1 and three NaN payloads (quiet, another mantissa, negative)
TOTAL_POOL = np.array([0x00000000, 0x80000000, 0x7f800000, 0xff800000,
                       0x3f800000, 0xbf800000, 0x7fc00000, 0x7fc00001,
                       0xffc00000], np.uint32).view(np.float32)
PROBES = [
    np.array([-0.0, 0.0, -0.0, 0.0, 1.0, -1.0, 0.0, -0.0], np.float32),
    np.array([0x3f800000, 0x7fc00001, 0x40000000, 0xffc00000, 0x3f000000,
              0x7f800000, 0xff800000, 0x00000000],
             np.uint32).view(np.float32),
]


@pytest.fixture(autouse=True)
def clean_state():
    JE.clear_plans()
    TE.clear_plans()
    obs.reset()
    yield
    obs.disable()
    obs.reset()
    JE.clear_plans()
    TE.clear_plans()


def _same_bits(j, t):
    j = np.asarray(j)
    t = t.numpy() if t.dtype != torch.bfloat16 else \
        t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    assert j.dtype == t.dtype, (j.dtype, t.dtype)
    np.testing.assert_array_equal(j.view(np.uint8), t.view(np.uint8))


# --------------------------------------------------------------------------
# topk(variant="torch") in the float total order
# --------------------------------------------------------------------------

def _total_rows():
    return [p[None] for p in PROBES] + [
        RNG.choice(TOTAL_POOL, (3, 37)).astype(np.float32) for _ in range(100)]


@pytest.mark.parametrize("variant", ["torch", None])
@pytest.mark.parametrize("k", [2, 5, 37])
def test_topk_torch_matches_xla_on_signed_zeros_and_nans(variant, k):
    """Indices and value bits of the port's ``torch`` variant (and of the
    CPU default) equal ``lax.top_k``'s on the re-anchor's two probe rows and
    on 300 seeded rows of +-0, +-inf, +-1 and three NaN payloads."""
    for x in _total_rows():
        kk = min(k, x.shape[-1])
        jv, ji = JE.topk(jnp.array(x), kk, variant="xla")
        tv, ti = TE.topk(x, kk, variant=variant, device="cpu")
        _same_bits(ji, ti)
        _same_bits(jv, tv)


def test_topk_torch_matches_xla_bf16_and_payload():
    """bf16 keys rank through float32 bits; a payload follows the indices.
    XLA's CPU ``top_k`` returns bf16 NaNs as 0xFFFF whatever their payload,
    so the values compare as floats (NaN at the same places), and the port
    returns the input's own bits."""
    x = RNG.choice(TOTAL_POOL, (4, 29)).astype(ml_dtypes.bfloat16)
    pay = RNG.integers(0, 99, (4, 29)).astype(np.int32)
    jv, ji, jp = JE.topk(jnp.array(x), 7, values=jnp.array(pay),
                         variant="xla")
    tv, ti, tp = TE.topk(tensor_from_numpy(x, "cpu"), 7,
                         values=torch.from_numpy(pay), variant="torch")
    _same_bits(ji, ti)
    _same_bits(jp, tp)
    np.testing.assert_array_equal(np.asarray(jv).astype(np.float32),
                                  tv.float().numpy())
    _same_bits(np.take_along_axis(x, np.asarray(ji), -1), tv)


def test_ragged_sampler_torch_orders_zeros_and_nans_as_xla():
    """Greedy rows of ``RaggedSampler(k, "torch")`` pick JAX ``xla``'s
    token: +0.0 over an earlier -0.0, a real over an earlier negative
    NaN."""
    rows = np.array([[-0.0, -1.0, 0.0, -0.0, 0.0],
                     [0.0, 1.0, 0.5, -np.inf, 0.25]], np.float32)
    rows.view(np.uint32)[1, 0] = 0xffc00000
    exp = JRaggedSampler(3, "xla").sample(
        jax.random.PRNGKey(0), jnp.array(rows), JSamplingState.full(2, temperature=0.0))
    got = RaggedSampler(3, "torch").sample(
        None, torch.from_numpy(rows), SamplingState.full(2, temperature=0.0))
    assert got.tolist() == np.asarray(exp).tolist() == [2, 1]


# --------------------------------------------------------------------------
# every public op through guarded_call; run_op under an explicit plan
# --------------------------------------------------------------------------

def test_every_op_dispatches_through_guarded_call(monkeypatch):
    seen = []
    real = fallback.guarded_call

    def spy(op, plan, *a, **kw):
        seen.append(op)
        return real(op, plan, *a, **kw)
    monkeypatch.setattr(fallback, "guarded_call", spy)
    x = torch.from_numpy(RNG.standard_normal(64).astype(np.float32))
    offs = torch.tensor([0, 20, 20, 64], dtype=torch.int32)
    a, b = torch.sort(x[:30], descending=True).values, \
        torch.sort(x[30:], descending=True).values
    TE.sort(x)
    TE.argsort(x)
    TE.merge(a, b)
    TE.merge(a, b, stable=True)
    TE.merge_runs(torch.cat([a, b]), torch.tensor([0, 30, 64]))
    TE.topk(x, 4)
    TE.sample_topp(None, x[None], 0.9)
    TE.sample_minp(None, x[None], 0.1)
    TE.segment_sort(x, offs)
    TE.segment_argsort(x, offs)
    TE.segment_merge(a, torch.tensor([0, 30]), b, torch.tensor([0, 34]))
    TE.moe_route(x.reshape(8, 8), 2, 4)
    TE.external_sort(x, tile_elems=16)
    assert seen == ["sort", "argsort", "merge", "merge", "merge_runs", "topk",
                    "sample_topp", "sample_minp", "segment_sort",
                    "segment_argsort", "segment_merge", "moe_route",
                    "external_sort"]


def test_run_op_under_explicit_plan():
    x = torch.from_numpy(RNG.integers(-9, 9, 200).astype(np.int32))
    got = TE.run_op("sort", Plan("ref", w=8, chunk=32), x)
    assert torch.equal(got, torch.sort(x, descending=True).values)
    perm = TE.run_op("argsort", Plan("flims", w=8, chunk=32), x)
    assert torch.equal(perm.long(),
                       torch.argsort(x, descending=True, stable=True))
    offs = torch.tensor([0, 50, 50, 200], dtype=torch.int32)
    seg = TE.run_op("segment_sort", Plan("torch"), x, offs)   # cap from offs
    v, i = TE.run_op("topk", Plan("torch"), x.float(), 5)
    # run_op resolves nothing: the plan cache stays empty
    assert TE.default_planner.to_table() == {}
    assert torch.equal(seg, TE.segment_sort(x, offs))
    assert torch.equal(i, TE.topk(x.float(), 5)[1])


# --------------------------------------------------------------------------
# autotune
# --------------------------------------------------------------------------

def test_autotune_records_infeasible_and_continues():
    calls = {"n": 0}

    @registry.register("argsort", "broken")
    def _broken(keys, *, plan, descending):
        calls["n"] += 1
        raise RuntimeError("a kernel refused this shape")

    try:
        obs.enable()
        x = torch.from_numpy(RNG.integers(0, 9, 128).astype(np.int32))
        plan = TE.autotune("argsort", x, repeats=1)
        assert plan.variant in ("cuda", "flims", "torch")
        key = TE.plan_key("argsort", n=128, dtype=torch.int32,
                          backend="cpu")
        bad = TE.default_planner.infeasible_for(key)
        assert any(p.variant == "broken" for p in bad)
        first_calls = calls["n"]
        TE.autotune("argsort", x, repeats=1)       # skips the infeasible one
        assert calls["n"] == first_calls
        snap = obs.snapshot()
        c = snap["counters"]
        assert c["autotune.runs"] == 2 and c["autotune.infeasible"] == 2
        states = [e["data"]["status"] for e in snap["events"]
                  if e["kind"] == "autotune.candidate"
                  and e["data"]["variant"] == "broken"]
        assert states.count("infeasible") == 2
        assert states.count("known_infeasible") == 2
        assert any(e["kind"] == "autotune.winner" for e in snap["events"])
    finally:
        del registry._REGISTRY["argsort"]["broken"]


def test_autotune_roundtrip(tmp_path):
    lens = [30, 0, 80, 7]
    vals = torch.from_numpy(RNG.standard_normal(sum(lens)).astype(np.float32))
    offs = torch.tensor(np.concatenate([[0], np.cumsum(lens)]),
                        dtype=torch.int32)
    plan = TE.autotune("segment_sort", vals, offs, repeats=1)
    assert plan.variant in registry.variants("segment_sort")
    key = TE.plan_key("segment_sort", n=vals.shape[0], dtype=torch.float32,
                      backend="cpu", segments=4)
    assert TE.default_planner.lookup(key) == plan
    path = tmp_path / "plans.json"
    TE.save_plans(str(path))
    assert json.loads(path.read_text())["version"] == 1
    TE.clear_plans()
    TE.load_plans(str(path))
    assert TE.default_planner.lookup(key) == plan
    got = TE.segment_sort(vals, offs)               # the tuned plan serves
    exp = torch.cat([torch.sort(vals[a:b], descending=True).values
                     for a, b in zip(offs[:-1].tolist(), offs[1:].tolist())])
    assert torch.equal(got, exp)


def test_candidate_plans_use_the_ports_variants():
    cp = lambda op, n=4096, s=0: TE.candidate_plans(op, TE.plan_key(
        op, n=n, dtype=torch.float32, backend="cuda", segments=s))
    mr = cp("merge_runs", s=64)
    assert [p.levels for p in mr if p.variant == "tree_cuda"] == [1, 2, 3]
    assert {p.variant for p in mr} == set(registry.variants("merge_runs"))
    assert {p.variant for p in cp("topk")} == {"flims", "torch"}
    seg = cp("segment_sort", s=8)
    assert {(p.variant, p.chunk, p.levels) for p in seg} >= {
        ("cuda_fused", 256, 1), ("cuda_two_phase", 256, 2), ("torch", 512, 1)}
    ext = cp("external_sort", n=1 << 20)
    assert {(p.tile_elems, p.fan_in) for p in ext} == {
        (65536, 4), (65536, 16), (262144, 4), (262144, 16)}


def test_autotune_topk_times_both_variants():
    obs.enable()
    x = torch.from_numpy(RNG.standard_normal((4, 500)).astype(np.float32))
    plan = TE.autotune("topk", x, 16, repeats=1)
    snap = obs.snapshot()
    cands = {e["data"]["variant"]: e["data"] for e in snap["events"]
             if e["kind"] == "autotune.candidate"}
    assert set(cands) == {"flims", "torch"}
    assert all(c["status"] == "ok" and c["us"] > 0 for c in cands.values())
    best = min(cands, key=lambda v: cands[v]["us"])
    assert plan.variant == best
    assert TE.default_planner.lookup(TE.infer_key("topk", x, 16)) == plan
    v, i = TE.topk(x, 16)                       # the tuned plan serves
    assert torch.equal(i, TE.topk(x, 16, variant="torch")[1])


# --------------------------------------------------------------------------
# the fallback ladder
# --------------------------------------------------------------------------

@pytest.fixture
def failing_topk():
    """A registered ``topk`` variant that raises whatever ``box[0]`` holds."""
    box = [None]
    calls = {"n": 0}

    @registry.register("topk", "failing")
    def _failing(x, k, *, plan, values=None):
        calls["n"] += 1
        raise box[0]

    yield box, calls
    del registry._REGISTRY["topk"]["failing"]


def test_ladder_demotes_on_out_of_memory(failing_topk):
    box, calls = failing_topk
    box[0] = torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")
    obs.enable()
    x = torch.from_numpy(RNG.standard_normal((3, 40)).astype(np.float32))
    before = fallback.demotions()
    v, i = TE.topk(x, 6, variant="failing")
    ev, ei = TE.topk(x, 6, variant="torch")
    assert torch.equal(i, ei) and torch.equal(v, ev)
    snap = obs.snapshot()
    c = snap["counters"]
    assert c["guard.fallback"] == 1 and c["guard.quarantine"] == 1
    fb = [e["data"] for e in snap["events"] if e["kind"] == "guard.fallback"]
    assert fb[0]["from_variant"] == "failing"
    assert fb[0]["to_variant"] == "flims"       # the registry's next rung
    assert "OutOfMemoryError" in fb[0]["error"]
    assert any(e["kind"] == "guard.quarantine" for e in snap["events"])
    key = TE.infer_key("topk", x, 6)
    resolved = TE.default_planner.lookup(key)
    assert TE.default_planner.is_quarantined(key,
                                             resolved.replace(variant="failing"))
    assert not TE.default_planner.is_quarantined(key, resolved)
    assert resolved.variant == "torch"      # the plan cache is left alone
    assert fallback.demotions() == before + 1
    # the dead rung is skipped, not paid for again, and the skip is a
    # counted demotion
    v2, i2 = TE.topk(x, 6, variant="failing")
    assert torch.equal(i2, ei)
    assert calls["n"] == 1
    c = obs.snapshot()["counters"]
    assert c["guard.quarantine.skip"] == 1 and c["guard.fallback"] == 2
    assert fallback.demotions() == before + 2


@pytest.mark.parametrize("exc", [
    KernelError("moe_route: flims_moe_route returned CUDA error 700"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    EngineInputError("topk", "malformed"),
], ids=["KernelError", "RuntimeError", "EngineInputError"])
def test_ladder_does_not_demote_other_errors(failing_topk, exc):
    box, _ = failing_topk
    box[0] = exc
    obs.enable()
    x = torch.from_numpy(RNG.standard_normal(40).astype(np.float32))
    before = fallback.demotions()
    with pytest.raises(type(exc)) as info:
        TE.topk(x, 6, variant="failing")
    assert info.value is exc
    assert not fallback.recoverable(exc)
    c = obs.snapshot()["counters"]
    assert "guard.fallback" not in c and "guard.quarantine" not in c
    key = TE.infer_key("topk", x, 6)
    assert not TE.default_planner.is_quarantined(
        key, TE.default_planner.lookup(key).replace(variant="failing"))
    assert fallback.demotions() == before


@pytest.mark.parametrize("persistent", [False, True],
                         ids=["transient", "persistent"])
def test_card_oom_retries_same_variant(failing_topk, monkeypatch,
                                       persistent):
    """On the card an out-of-memory error runs the same plan once more and
    never moves the call to another variant."""
    box, calls = failing_topk
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")
    box[0] = oom
    if not persistent:     # the retry succeeds
        real = registry._REGISTRY["topk"]["torch"]

        def _once(x, k, *, plan, values=None):
            if calls["n"] == 0:
                calls["n"] += 1
                raise oom
            return real(x, k, plan=plan, values=values)
        monkeypatch.setitem(registry._REGISTRY["topk"], "failing", _once)
    monkeypatch.setattr(fallback, "_on_card", lambda key, args: True)
    obs.enable()
    x = torch.from_numpy(RNG.standard_normal((3, 40)).astype(np.float32))
    before = fallback.demotions()
    if persistent:
        with pytest.raises(torch.cuda.OutOfMemoryError):
            TE.topk(x, 6, variant="failing")
        assert calls["n"] == 2
    else:
        _, i = TE.topk(x, 6, variant="failing")
        assert torch.equal(i, TE.topk(x, 6, variant="torch")[1])
    snap = obs.snapshot()
    c = snap["counters"]
    assert c["guard.oom_retry"] == 1
    assert "guard.fallback" not in c and "guard.quarantine" not in c
    retry = [e["data"] for e in snap["events"]
             if e["kind"] == "guard.oom_retry"]
    assert retry[0]["variant"] == "failing"
    assert fallback.demotions() == before


def test_autotune_failure_never_hides_the_pinned_variant(monkeypatch):
    """A candidate that raised a ``KernelError`` in autotune is infeasible
    to the tuner only: a call that pins its variant still reaches it and
    still raises."""
    def _refuse(keys, *, plan, descending):
        raise KernelError("argsort: nvcc failed (injected)")
    monkeypatch.setitem(registry._REGISTRY["argsort"], "cuda", _refuse)
    obs.enable()
    x = torch.from_numpy(RNG.integers(0, 9, 128).astype(np.int32))
    plan = TE.autotune("argsort", x, repeats=1)
    assert plan.variant != "cuda"
    key = TE.infer_key("argsort", x)
    assert {p.variant for p in TE.default_planner.infeasible_for(key)} \
        == {"cuda"}
    before = fallback.demotions()
    with pytest.raises(KernelError):
        TE.argsort(x, variant="cuda")
    with pytest.raises(KernelError):
        TE.sort(x, stable=True, variant="cuda")
    c = obs.snapshot()["counters"]
    assert "guard.fallback" not in c and "guard.quarantine.skip" not in c
    assert fallback.demotions() == before


def test_reference_variants_and_ladder_order():
    assert fallback.reference_variant("merge") == "ref"
    assert fallback.reference_variant("sort") == "torch"
    assert fallback._ladder("sort", Plan("cuda")) == ["cuda", "ref", "torch"]
    assert fallback._ladder("merge", Plan("cuda")) == ["cuda", "banked",
                                                       "ref"]
    assert fallback._ladder("topk", Plan("torch")) == ["torch", "flims"]
