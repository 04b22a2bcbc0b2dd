"""The chaos suite of the port (``tests/test_chaos.py`` mirrored), and the
port's ``guard.verify`` monitors against the JAX package's.

Every injected failure either raises a structured error, or triggers a
recorded ``guard.fallback`` to another variant with a bit-exact result, or
retires only the poisoned serve slot. Results are compared bit for bit
with the JAX package (``jnp.sort`` / ``jnp.argsort(stable=True)``) on the
same corrupted keys: the port's injectors draw their positions from a
``torch.Generator``, not from ``jax.random``, so the keys are corrupted
once, by the port, and both sides sort them.

``guard.verify``: each hooked engine op (``sort``, ``argsort``, ``merge``,
``segment_sort``, ``merge_runs``, ``external_sort``) checks clean inputs
with no failure; each check reports the same outcome as the JAX check on
the same (input, output) pair, corrupted outputs included.
"""
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.guard import verify as jverify  # noqa: E402
from repro_torch import engine  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.engine.planner import default_planner, heuristic_plan  # noqa: E402,E501
from repro_torch.guard import fallback, inject, verify  # noqa: E402
from repro_torch.guard.inject import POISON_TOKEN, InjectedFault  # noqa: E402
from repro_torch.guard.validate import EngineInputError  # noqa: E402
from repro_torch.serve import Request, SamplingParams, Scheduler  # noqa: E402

REPO_SRC = __file__.rsplit("/tests/", 1)[0] + "/src"
RNG = np.random.default_rng(41)


@pytest.fixture(autouse=True)
def _clean_engine_state():
    engine.clear_plans()
    obs.enable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()
    engine.clear_plans()


@pytest.fixture
def verifying():
    was = verify.verify_enabled()
    verify.enable_verify()
    verify.reset_failures()
    yield
    verify.reset_failures()
    (verify.enable_verify if was else verify.disable_verify)()


def _counters():
    return obs.snapshot().get("counters", {})


def _normal(n):
    return torch.from_numpy(RNG.standard_normal(n).astype(np.float32))


def _bits(x):
    return np.asarray(x).view(np.int32)


# -- fallback ladder ---------------------------------------------------------

def test_failing_variant_falls_back_bit_exact():
    x = _normal(512)
    with inject.failing_variant("sort") as name:
        out = engine.sort(x, variant=name)
    ref = np.asarray(jnp.sort(jnp.asarray(x.numpy()))[::-1])
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(ref))
    c = _counters()
    assert c.get("guard.fallback", 0) >= 1
    assert c.get("guard.quarantine", 0) >= 1


def test_quarantined_variant_skipped_on_reuse():
    x = _normal(256)
    key = engine.api.infer_key("sort", x)
    with inject.failing_variant("sort") as name:
        engine.sort(x, variant=name)
        n_fb = _counters().get("guard.fallback", 0)
        engine.sort(x, variant=name)       # quarantine skips the dead rung
        c = _counters()
        assert c.get("guard.quarantine.skip", 0) >= 1
        assert c.get("guard.fallback", 0) == n_fb + 1   # the skip counts
        dead = heuristic_plan("sort", key).replace(variant=name)
        assert default_planner.is_quarantined(key, dead)
    # the context manager buried its registration and quarantine with it
    assert not default_planner.is_quarantined(key, dead)
    assert name not in engine.registry.variants("sort")


def test_failing_argsort_keeps_stable_permutation():
    keys = torch.from_numpy(RNG.integers(0, 8, 333).astype(np.float32))
    with inject.failing_variant("argsort") as name:
        perm = engine.argsort(keys, descending=False, variant=name)
    np.testing.assert_array_equal(
        perm.numpy(), np.asarray(jnp.argsort(jnp.asarray(keys.numpy()),
                                             stable=True)))


def test_input_errors_do_not_fall_back():
    with inject.failing_variant("sort"):
        with pytest.raises(EngineInputError):
            engine.sort(torch.empty(2 ** 31, device="meta"))
    assert _counters().get("guard.fallback", 0) == 0


def test_recoverable_classification():
    assert fallback.recoverable(inject.resource_exhausted("x"))
    assert fallback.recoverable(InjectedFault("mumble Mosaic mumble"))
    assert fallback.recoverable(torch.cuda.OutOfMemoryError("oom"))
    assert not fallback.recoverable(EngineInputError("sort", "bad"))
    assert not fallback.recoverable(KeyboardInterrupt())
    assert not fallback.recoverable(RuntimeError("unrelated breakage"))


def test_injected_fault_demotes_on_the_card(monkeypatch):
    """On the card an injected stub moves the call to the next rung (where
    an out-of-memory error would retry the same plan): the card path is
    taken here by patching ``_on_card``, the next rung being the ``torch``
    plain versions on these CPU tensors."""
    monkeypatch.setattr(fallback, "_on_card", lambda key, args: True)
    x = _normal(300)
    before = fallback.demotions()
    with inject.failing_variant("sort") as name:
        out = engine.sort(x, variant=name)
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(
        np.sort(x.numpy())[::-1]))
    assert fallback.demotions() == before + 1
    assert "guard.oom_retry" not in _counters()


# -- key corruption ----------------------------------------------------------

def test_nan_injection_sort_last_recovers():
    clean = RNG.standard_normal(400).astype(np.float32)
    dirty = inject.with_nan(clean, rate=0.05, seed=3)
    assert bool(torch.isnan(dirty).any())
    out = engine.sort(dirty, descending=False, nan="sort_last")
    np.testing.assert_array_equal(
        _bits(out.numpy()), _bits(jnp.sort(jnp.asarray(dirty.numpy()))))


def test_nan_injection_raise_policy_is_loud():
    dirty = inject.with_nan(RNG.standard_normal(64).astype(np.float32),
                            rate=0.1, seed=1)
    with pytest.raises(EngineInputError, match="NaN"):
        engine.sort(dirty, nan="raise")


def test_bitflip_survives_sort_last():
    clean = RNG.standard_normal(256).astype(np.float32)
    dirty = inject.bitflip(clean, rate=0.1, seed=2)   # can mint inf / NaN
    out = engine.sort(dirty, descending=False, nan="sort_last")
    np.testing.assert_array_equal(
        _bits(out.numpy()), _bits(jnp.sort(jnp.asarray(dirty.numpy()))))


def test_injectors_are_deterministic_and_exact():
    clean = torch.from_numpy(RNG.standard_normal(1000).astype(np.float32))
    a, b = inject.with_nan(clean, 0.05, seed=7), inject.with_nan(clean, 0.05,
                                                                 seed=7)
    assert torch.equal(torch.isnan(a), torch.isnan(b))
    assert not torch.equal(torch.isnan(a),
                           torch.isnan(inject.with_nan(clean, 0.05, seed=8)))
    assert int(torch.isnan(inject.with_nan(clean, 1e-9, seed=0)).sum()) == 1
    assert not torch.isnan(inject.with_nan(clean, 0.0)).any()
    for bit in (30, 31, 0):
        f = inject.bitflip(clean, 0.1, seed=4, bit=bit)
        diff = (f.view(torch.int32) ^ clean.view(torch.int32))
        assert set(diff.unique().tolist()) <= {0, np.int32(
            np.uint32(1 << bit)).item()}
        assert 0 < int((diff != 0).sum()) < 1000
    bf = torch.from_numpy(RNG.standard_normal(64).astype(np.float32)).to(
        torch.bfloat16)
    assert inject.bitflip(bf, 0.5, seed=1).dtype == torch.bfloat16


# -- serve poison isolation --------------------------------------------------

def _fake_model(vocab=64):
    def init_cache(batch, max_seq, device="cpu"):
        return {"kv": torch.zeros((batch, max_seq, 2), device=device)}

    def decode_step(params, tok, pos, cache):
        return torch.nn.functional.one_hot(
            (tok.long() + 1) % vocab, vocab).float() * 10.0, cache

    return SimpleNamespace(init_cache=init_cache, decode_step=decode_step)


def test_poisoned_slot_isolated_no_retrace():
    model = inject.poison_model(_fake_model())
    sched = Scheduler(model, params=None, n_slots=4, max_seq=64,
                      prefill_len=8, top_k_width=8, device="cpu")
    good = [Request(prompt=[1, 2, 10 * (i + 1)], max_new_tokens=6,
                    params=SamplingParams(temperature=0.0))
            for i in range(3)]
    bad = Request(prompt=[5, POISON_TOKEN], max_new_tokens=6,
                  params=SamplingParams(temperature=0.0))
    done = sched.run(good + [bad])
    by_uid = {c.uid: c for c in done}
    poisoned = by_uid[bad.uid]
    assert poisoned.status == "ERROR" and poisoned.finish_reason == "error"
    assert poisoned.tokens == []
    for r in good:                        # the rest of the batch: untouched
        c = by_uid[r.uid]
        assert c.status == "OK" and len(c.tokens) == 6
        assert c.tokens == [(r.prompt[-1] + 1 + i) % 64 for i in range(6)]
    assert sched.traces <= 2              # isolation adds no signature
    assert _counters().get("serve.poisoned", 0) == 1


# -- verify under fire -------------------------------------------------------

def test_verify_clean_under_fallback(verifying):
    """Postconditions hold on the surviving variant's output."""
    x = _normal(300)
    with inject.failing_variant("sort") as name:
        engine.sort(x, variant=name)
    assert verify.checked() > 0 and verify.failures() == 0


def test_verify_every_hooked_op_clean(verifying):
    """Every hooked op, both directions where it has them, on clean inputs:
    checks made, none failed, and each outcome an ``obs`` event."""
    x = _normal(700)
    a = torch.sort(_normal(300), descending=True).values
    b = torch.sort(_normal(200), descending=True).values
    offs = torch.tensor([0, 100, 100, 450, 700], dtype=torch.int32)
    for d in (True, False):
        engine.sort(x, descending=d)
        engine.sort(x, descending=d, nan="sort_last")
        engine.argsort(x, descending=d)
        engine.merge(a if d else a.flip(0), b if d else b.flip(0),
                     descending=d)
        runs = engine.segment_sort(x, offs, descending=d)
        engine.merge_runs(runs, offs, descending=d)
        engine.external_sort(x, descending=d, tile_elems=128, fan_in=2)
    engine.argsort(x.reshape(7, 100))
    n = verify.checked()
    # per direction: sort 2, sort_last 3 (its argsort's too), argsort 1,
    # merge 2, segment_sort 2, merge_runs 2, external_sort 2
    assert n == 2 * (2 + 3 + 1 + 2 + 2 + 2 + 2) + 1
    assert verify.failures() == 0
    ev = [e["data"] for e in obs.snapshot()["events"]
          if e["kind"] == "guard.verify"]
    assert len(ev) == n and all(e["ok"] for e in ev)
    assert {e["op"] for e in ev} == {"sort", "argsort", "merge",
                                     "segment_sort", "merge_runs",
                                     "external_sort"}
    assert _counters()["guard.verify.checked"] == n


def test_verify_off_costs_nothing():
    verify.disable_verify()
    verify.reset_failures()
    engine.sort(_normal(100))
    assert verify.checked() == 0


def _jax_outcomes(fn, *args, **kw):
    """The JAX check's outcomes on the same arrays."""
    was = jverify.verify_enabled()
    jverify.enable_verify()
    jverify.reset_failures()
    try:
        fn(*(jnp.asarray(a) for a in args), **kw)
        jax.effects_barrier()
        return jverify.checked(), jverify.failures()
    finally:
        jverify.reset_failures()
        (jverify.enable_verify if was else jverify.disable_verify)()


def _port_outcomes(fn, *args, **kw):
    verify.enable_verify()
    verify.reset_failures()
    try:
        fn(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args), **kw)
        return verify.checked(), verify.failures()
    finally:
        verify.reset_failures()
        verify.disable_verify()


def _verify_cases():
    x = RNG.standard_normal(257).astype(np.float32)
    srt = np.sort(x)[::-1].copy()
    flipped = np.asarray(inject.bitflip(srt, 0.05, seed=5))
    dup = srt.copy()
    dup[3] = dup[4]                          # one key dropped, one doubled
    swapped = srt.copy()
    swapped[[10, 11]] = swapped[[11, 10]]
    ints = RNG.integers(-5, 5, (3, 40)).astype(np.int32)
    offs = np.array([0, 50, 50, 200, 257], np.int32)
    segs = np.concatenate([np.sort(x[s:e])[::-1] for s, e in
                           zip(offs[:-1], offs[1:])])
    bad_seg = segs.copy()
    bad_seg[[60, 61]] = bad_seg[[61, 60]]
    return [
        ("sorted", "check_sorted", (srt,), dict(descending=True)),
        ("unsorted", "check_sorted", (swapped,), dict(descending=True)),
        ("ascending", "check_sorted", (srt[::-1].copy(),),
         dict(descending=False)),
        ("rows", "check_sorted", (np.sort(ints, -1),),
         dict(descending=False)),
        ("perm_ok", "check_permutation", (x, srt), {}),
        ("perm_bitflip", "check_permutation", (x, flipped), {}),
        ("perm_dup", "check_permutation", (x, dup), {}),
        ("perm_ints", "check_permutation", (ints, ints[:, ::-1].copy()), {}),
        ("perm_short", "check_permutation", (x, srt[:-1].copy()), {}),
        ("segments_ok", "check_segments", (segs, offs),
         dict(descending=True)),
        ("segments_bad", "check_segments", (bad_seg, offs),
         dict(descending=True)),
        ("segments_cross", "check_segments", (srt[::-1].copy(), offs),
         dict(descending=True)),
    ]


@pytest.mark.parametrize("case", _verify_cases(), ids=lambda c: c[0])
def test_verify_checks_match_jax(case):
    _, name, args, kw = case
    want = _jax_outcomes(getattr(jverify, name), *args, op="t", **kw)
    got = _port_outcomes(getattr(verify, name), *args, op="t", **kw)
    assert got == want
    assert want[0] == 1


def test_repro_verify_env_smoke():
    """REPRO_VERIFY=1 in a fresh process arms the monitors from the
    environment; a clean multi-op run reports zero failures (the port
    alone: no JAX in the child)."""
    prog = (
        "import sys; sys.path.insert(0, {src!r})\n"
        "import numpy as np, torch\n"
        "from repro_torch import engine\n"
        "from repro_torch.guard import verify\n"
        "assert verify.verify_enabled()\n"
        "rng = np.random.default_rng(0)\n"
        "x = torch.from_numpy(rng.standard_normal(256).astype(np.float32))\n"
        "engine.sort(x)\n"
        "engine.argsort(x, descending=False)\n"
        "engine.sort(x, nan='sort_last')\n"
        "assert verify.checked() > 0, 'monitors never fired'\n"
        "assert verify.failures() == 0, verify.failures()\n"
        "assert 'jax' not in sys.modules\n"
        "print('VERIFY_OK', verify.checked())\n"
    ).format(src=REPO_SRC)
    env = dict(os.environ, REPRO_VERIFY="1")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "VERIFY_OK" in out.stdout
