"""Parity of the port's core modules with the JAX package, on the CPU.

``repro_torch.core.lanes`` / ``butterfly`` / ``flims`` and ``repro_torch.obs``
against ``repro.core`` / ``repro.obs``: the same numpy inputs, made from a
seeded generator, go through the JAX function and its port.

Tolerance: exact. Keys, ranks, payloads and permutations must be equal bit
for bit; float keys are compared as their int32 bit patterns, so +0.0 and
-0.0 differ.
"""
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import butterfly as jb  # noqa: E402
from repro.core import flims as jf  # noqa: E402
from repro.core import lanes as jl  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import butterfly as tb  # noqa: E402
from repro_torch.core import flims as tf  # noqa: E402
from repro_torch.core import lanes as tl  # noqa: E402

RNG = np.random.default_rng(11)
ROOT = pathlib.Path(__file__).resolve().parents[1]


def same(j, t):
    """Bit-for-bit equality of a JAX result and a torch result."""
    j = np.asarray(j)
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert j.shape == t.shape, (j.shape, t.shape)
    if j.dtype == np.float32:
        assert t.dtype == np.float32
        j, t = j.view(np.int32), t.view(np.int32)
    np.testing.assert_array_equal(j, t.astype(j.dtype))


def desc(vals, dtype=np.float32):
    return np.sort(np.asarray(vals, dtype))[::-1].copy()


TIES = np.array([0.0, -0.0, 1.5, -np.inf, 3.0], np.float32)


# --------------------------------------------------------------------------
# core/lanes.py
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_sentinels_and_invalid_rank(dtype):
    assert tl.INVALID_RANK == int(jl.INVALID_RANK)
    tdt = torch.from_numpy(np.zeros(1, dtype)).dtype
    assert tl.sentinel_for(tdt) == np.asarray(jl.sentinel_for(dtype)).item()


def test_compare_fns_match():
    ka, kb = RNG.choice(TIES, 64), RNG.choice(TIES, 64)
    ra, rb = RNG.integers(0, 5, 64, dtype=np.int32), \
        RNG.integers(0, 5, 64, dtype=np.int32)
    J = lambda k, r: {"key": jnp.array(k), "rank": jnp.array(r)}
    T = lambda k, r: {"key": torch.from_numpy(k), "rank": torch.from_numpy(r)}
    same(jl.stable_compare(J(ka, ra), J(kb, rb)),
         tl.stable_compare(T(ka, ra), T(kb, rb)))
    same(jl.key_compare(jnp.array(ka), jnp.array(kb)),
         tl.key_compare(torch.from_numpy(ka), torch.from_numpy(kb)))


@pytest.mark.parametrize("kv", [False, True])
def test_flims_cycle_matches(kv):
    a, b = desc(RNG.choice(TIES, 16)), desc(RNG.choice(TIES, 16))[::-1].copy()
    r = np.arange(16, dtype=np.int32)
    if kv:
        ja = {"key": jnp.array(a), "rank": jnp.array(r)}
        jbr = {"key": jnp.array(b), "rank": jnp.array(r + 16)}
        ta = {"key": torch.from_numpy(a), "rank": torch.from_numpy(r)}
        tbr = {"key": torch.from_numpy(b), "rank": torch.from_numpy(r + 16)}
    else:
        ja, jbr, ta, tbr = jnp.array(a), jnp.array(b), torch.from_numpy(a), \
            torch.from_numpy(b)
    jc, jt = jl.flims_cycle(ja, jbr)
    tc, tt = tl.flims_cycle(ta, tbr)
    same(jt, tt)
    if kv:
        same(jc["key"], tc["key"])
        same(jc["rank"], tc["rank"])
    else:
        same(jc, tc)


@pytest.mark.parametrize("tie", ["b", "skew"])
@pytest.mark.parametrize("w", [4, 32])
def test_merge_lanes_key_only(tie, w):
    a, b = desc(RNG.choice(TIES, 45)), desc(RNG.choice(TIES, 70))
    jo = jl.merge_lanes(jl.make_lanes(jnp.array(a)),
                        jl.make_lanes(jnp.array(b)), w=w, tie=tie)
    to = tl.merge_lanes(tl.make_lanes(torch.from_numpy(a)),
                        tl.make_lanes(torch.from_numpy(b)), w=w, tie=tie)
    same(jo["key"], to["key"])


# --------------------------------------------------------------------------
# core/butterfly.py
# --------------------------------------------------------------------------

def test_cas_stage_and_butterfly():
    x = RNG.choice(TIES, (3, 32))
    for d in (16, 4, 1):
        same(jb.cas_stage(jnp.array(x), d),
             tb.cas_stage(torch.from_numpy(x), d))
    bitonic = np.concatenate([desc(x[0, :16]), desc(x[0, 16:])[::-1]])
    same(jb.butterfly_sort(jnp.array(bitonic)),
         tb.butterfly_sort(torch.from_numpy(bitonic)))


@pytest.mark.parametrize("kv", [False, True])
def test_bitonic_sort_matches(kv):
    k = RNG.choice(TIES, (2, 64))
    if not kv:
        same(jb.bitonic_sort(jnp.array(k)), tb.bitonic_sort(
            torch.from_numpy(k)))
        return
    r = np.tile(np.arange(64, dtype=np.int32), (2, 1))
    jo = jb.bitonic_sort({"key": jnp.array(k), "rank": jnp.array(r)},
                         compare=jl.stable_compare)
    to = tb.bitonic_sort({"key": torch.from_numpy(k),
                          "rank": torch.from_numpy(r)},
                         compare=tl.stable_compare)
    same(jo["key"], to["key"])
    same(jo["rank"], to["rank"])


# --------------------------------------------------------------------------
# core/flims.py
# --------------------------------------------------------------------------

def test_next_pow2():
    for n in (0, 1, 2, 3, 64, 65, 1000):
        assert tf.next_pow2(n) == jf.next_pow2(n)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("nA,nB,w", [(0, 9, 8), (1, 1, 4), (37, 90, 8),
                                     (5, 3, 32)])
def test_flims_merge_ref_and_banked(dtype, nA, nB, w):
    if dtype == np.int32:
        pool = np.array([np.iinfo(np.int32).min, -2, 0, 5, 5], np.int32)
    else:
        pool = TIES
    a, b = desc(RNG.choice(pool, nA), dtype), desc(RNG.choice(pool, nB), dtype)
    ja, jbb, ta, tbb = jnp.array(a), jnp.array(b), torch.from_numpy(a), \
        torch.from_numpy(b)
    same(jf.flims_merge_ref(ja, jbb, w), tf.flims_merge_ref(ta, tbb, w))
    same(jf.flims_merge_banked(ja, jbb, w), tf.flims_merge_banked(ta, tbb, w))


def test_flims_merge_banked_skew_stats():
    a, b = desc(RNG.integers(0, 3, 60), np.int32), \
        desc(RNG.integers(0, 3, 41), np.int32)
    js = jf.flims_merge_banked(jnp.array(a), jnp.array(b), 8, tie="skew",
                               with_stats=True)
    ts = tf.flims_merge_banked(torch.from_numpy(a), torch.from_numpy(b), 8,
                               tie="skew", with_stats=True)
    same(js.merged, ts.merged)
    same(js.k_per_cycle, ts.k_per_cycle)


def test_flims_merge_kv_stable_payload():
    a, b = desc(RNG.choice(TIES, 50)), desc(RNG.choice(TIES, 33))
    va = RNG.integers(0, 100, 50).astype(np.int32)
    vb = RNG.integers(0, 100, 33).astype(np.int32)
    jk, jv = jf.flims_merge_kv_stable(jnp.array(a), {"p": jnp.array(va)},
                                      jnp.array(b), {"p": jnp.array(vb)}, w=8)
    tk, tv = tf.flims_merge_kv_stable(torch.from_numpy(a),
                                      {"p": torch.from_numpy(va)},
                                      torch.from_numpy(b),
                                      {"p": torch.from_numpy(vb)}, w=8)
    same(jk, tk)
    same(jv["p"], tv["p"])


def test_flims_merge_ascending():
    a, b = np.sort(RNG.choice(TIES, 20)), np.sort(RNG.choice(TIES, 13))
    same(jf.flims_merge(jnp.array(a), jnp.array(b), w=4, descending=False),
         tf.flims_merge(torch.from_numpy(a), torch.from_numpy(b), w=4,
                        descending=False))


# --------------------------------------------------------------------------
# obs
# --------------------------------------------------------------------------

def test_obs_disabled_then_enabled():
    obs.disable()
    obs.reset()
    obs.inc("x")
    obs.event("e", a=1)
    assert obs.snapshot()["counters"] == {}
    obs.enable()
    try:
        obs.inc("x", 2)
        obs.event("e", a=np.int32(3))
        with obs.span("s"):
            pass
        snap = obs.snapshot()
        assert snap["counters"] == {"x": 2}
        assert snap["events"] == [{"kind": "e", "data": {"a": 3}}]
        assert snap["timers"]["s"]["count"] == 1
    finally:
        obs.disable()
        obs.reset()


# --------------------------------------------------------------------------
# the port stands alone
# --------------------------------------------------------------------------

def test_port_imports_neither_jax_nor_repro():
    """No file of the port, nor chip_smoke.py, may import JAX or the JAX
    package: the card's machine has neither."""
    bad = re.compile(r"^\s*(import\s+jax|from\s+jax|import\s+repro(?!_torch)"
                     r"|from\s+repro(?!_torch)[\s.])", re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}" for f in files
            for m in bad.finditer(f.read_text())]
    assert not hits, hits
