"""Parity of the port's segmented ops (K5, K6, two-phase, K3) with JAX's.

On the CPU the port's kernel wrappers run their plain versions; the JAX
package runs its Pallas kernels in interpret mode. The same numpy inputs,
made from a seeded generator, go through both:

- K5 ``segment_sort`` / K6 ``segment_sort_kv`` against
  ``segment_sort_pallas`` / ``segment_sort_kv_pallas``, and the two-phase
  compositions against theirs;
- ``engine.segment_sort`` / ``segment_argsort`` / ``segment_merge``, each
  port variant against its JAX counterpart (``cuda_fused`` against
  ``pallas_fused``, ``cuda_two_phase`` against ``pallas_two_phase``,
  ``cuda`` against ``pallas``, ``torch`` against ``xla``), with empty
  segments, S = 0, ascending order, payloads, ``nan="sort_last"``, a cap
  that would truncate and malformed offsets (the cases of
  ``tests/test_engine.py`` and the segmented cases of
  ``tests/test_stability.py``).

Inputs carry heavy ties, +0.0/-0.0, -inf and INT32_MIN. The key-only
kernels order a +0/-0 tie by XLA's max/min rule and ``xla`` by
``jnp.sort``'s, so each variant is held to its own counterpart.

Tolerance: exact. Keys and permutations are equal bit for bit; float keys
are compared as int32 bit patterns, so +0.0 and -0.0 differ.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import engine as JE  # noqa: E402
from repro.kernels import segmented_merge as JS  # noqa: E402
from repro_torch import engine as TE  # noqa: E402
from repro_torch import kernels as TK  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.engine import planner as tplanner  # noqa: E402
from repro_torch.engine import segments as TSG  # noqa: E402
from repro_torch.kernels import segmented_merge as TS  # noqa: E402

RNG = np.random.default_rng(37)
FPOOL = np.array([0.0, -0.0, 1.5, -1.0, -np.inf, 4.0, 2.5], np.float32)
IPOOL = np.array([np.iinfo(np.int32).min, -7, 0, 3, 3, 9], np.int32)

LENS = [
    [7, 0, 19, 1, 64],          # ragged with empties
    [0, 0, 0],                  # all empty
    [128],                      # one segment
    [1] * 17,                   # many tiny
    [33, 300, 2, 0, 100],       # long and empty mixed
]


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


def keys(n, dtype):
    pool = FPOOL if dtype == np.float32 else IPOOL
    return RNG.choice(pool, n).astype(dtype)


def ragged(lens, dtype=np.float32, sort_desc=False):
    segs = [keys(n, dtype) for n in lens]
    if sort_desc:
        segs = [np.sort(s)[::-1] for s in segs]
    flat = np.concatenate(segs + [np.zeros(0, dtype)])
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    return flat, offs


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# --------------------------------------------------------------------------
# K5 / K6 and the two-phase compositions against the Pallas kernels
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("lens", LENS)
def test_k5_segment_sort(dtype, lens):
    vals, offs = ragged(lens, dtype)
    cap = 512
    same(JS.segment_sort_pallas(jnp.array(vals), jnp.array(offs), cap=cap),
         TS.segment_sort(T(vals), T(offs), cap=cap))


@pytest.mark.parametrize("descending", [True, False])
@pytest.mark.parametrize("lens", [LENS[0], LENS[1], LENS[4]])
def test_k6_segment_sort_kv(descending, lens):
    vals, offs = ragged(lens)
    jk, jp = JS.segment_sort_kv_pallas(jnp.array(vals), jnp.array(offs),
                                       cap=512, descending=descending)
    tk, tp = TS.segment_sort_kv(T(vals), T(offs), cap=512,
                                descending=descending)
    same(jk, tk)
    same(jp, tp)
    same(jp, TS.segment_argsort(T(vals), T(offs), cap=512,
                                descending=descending))


# NaNs of several payloads among ties, +0.0 and -0.0: with a NaN the
# compound compare of K6 is no total order, so the network decides
NAN_POOL = np.concatenate([
    np.array([0x7fc00000, 0xffc12345, 0x7fa00000], np.uint32).view(
        np.float32),
    np.array([0.0, -0.0, 1.0, 2.0, -np.inf], np.float32)])


@pytest.mark.parametrize("descending", [True, False])
@pytest.mark.parametrize("cap,lens", [(8, [3, 8, 0, 5, 1, 7, 2]),
                                      (64, [7, 0, 40, 64, 13, 33])])
def test_k6_nan_segments_match_jax(cap, lens, descending):
    """K6 on float segments holding NaNs: the port's ``segment_sort_kv``
    against ``segment_sort_kv_pallas`` (the network over the whole ``cap``,
    padding included), keys and permutation bit for bit; K5 (descending)
    likewise, NaN payloads included (XLA's max / min on two NaNs)."""
    vals = RNG.choice(NAN_POOL, sum(lens)).astype(np.float32)
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    jk, jp = JS.segment_sort_kv_pallas(jnp.array(vals), jnp.array(offs),
                                       cap=cap, descending=descending)
    tk, tp = TS.segment_sort_kv(T(vals), T(offs), cap=cap,
                                descending=descending)
    same(jk, tk)
    same(jp, tp)
    if descending:
        same(JS.segment_sort_pallas(jnp.array(vals), jnp.array(offs),
                                    cap=cap),
             TS.segment_sort(T(vals), T(offs), cap=cap))


def _prefix_sorts(keys, cap, width, kv, descending):
    """Each row of ``keys`` (a list of 1-D segments) padded with the last key
    to ``width(len)`` lanes and run through the port's plain network; the
    valid prefixes, flat (keys, and ranks on KV lanes)."""
    from repro_torch.kernels.bitonic_sort import (_bitonic_rows_desc,
                                                  _bitonic_rows_kv)
    from repro_torch.kernels.flims_merge import bound_keys
    outk, outr = [], []
    for seg in keys:
        n, c = len(seg), width(len(seg))
        last = bound_keys(T(seg).dtype, descending)[1]
        k = torch.full((1, c), last, dtype=T(seg).dtype)
        k[0, :n] = T(seg)
        if kv:
            r = torch.full((1, c), np.iinfo(np.int32).max,
                           dtype=torch.int32)
            r[0, :n] = torch.arange(n, dtype=torch.int32)
            k, r = _bitonic_rows_kv(k, r, descending)
            outr.append(r[0, :n])
        else:
            k = _bitonic_rows_desc(k)
        outk.append(k[0, :n])
    return torch.cat(outk), (torch.cat(outr) if kv else None)


@pytest.mark.parametrize("kind", ["f32", "i32", "kv_f32_desc", "kv_f32_asc",
                                  "kv_i32_asc"])
def test_narrow_network_equals_full_cap_without_nan(kind):
    """What K5 / K6's fast paths rest on: without a NaN the network over
    ``next_pow2(len)`` lanes leaves the same valid prefix as the network
    over the whole ``cap`` (XLA's max/min on +0.0 / -0.0 is the order of the
    monotone int32 bits, and distinct ranks make the compound compare a
    total order), on segments dense in ties, +0.0 and -0.0."""
    cap = 64
    dtype = np.int32 if "i32" in kind else np.float32
    kv, descending = kind.startswith("kv"), not kind.endswith("asc")
    segs = [keys(n, dtype) for n in list(range(1, cap + 1)) * 2]
    full = _prefix_sorts(segs, cap, lambda n: cap, kv, descending)
    narrow = _prefix_sorts(segs, cap, lambda n: 1 << (n - 1).bit_length(),
                           kv, descending)
    for f, n in zip(full, narrow):
        if f is not None:
            same(f.numpy(), n)


def test_narrow_network_differs_on_nan_kv_segment():
    """Why K6's NaN path runs the whole ``cap``: on ``[nan, 1.0, 2.0]`` at
    cap 8 (descending) the narrow network (4 lanes) puts rank 0 third, the
    full network, as JAX's kernel, the padding's INVALID_RANK."""
    seg = np.array([np.nan, 1.0, 2.0], np.float32)
    inv = np.iinfo(np.int32).max
    _, full = _prefix_sorts([seg], 8, lambda n: 8, True, True)
    _, narrow = _prefix_sorts([seg], 8, lambda n: 4, True, True)
    assert full.tolist() == [2, 1, inv]
    assert narrow.tolist() == [2, 1, 0]
    offs = np.array([0, 3], np.int32)
    _, jp = JS.segment_sort_kv_pallas(jnp.array(seg), jnp.array(offs), cap=8)
    same(jp, full)
    same(jp, TS.segment_sort_kv(T(seg), T(offs), cap=8)[1])


@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_two_phase_sort(levels, dtype):
    vals, offs = ragged(LENS[4], dtype)
    kw = dict(cap=512, chunk=64, w=16, levels=levels)
    same(JS.segment_sort_two_phase(jnp.array(vals), jnp.array(offs), **kw),
         TS.segment_sort_two_phase(T(vals), T(offs), **kw))


@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("descending", [True, False])
def test_two_phase_argsort(levels, descending):
    vals, offs = ragged(LENS[4])
    kw = dict(cap=512, chunk=64, w=16, levels=levels, descending=descending)
    same(JS.segment_argsort_two_phase(jnp.array(vals), jnp.array(offs), **kw),
         TS.segment_argsort_two_phase(T(vals), T(offs), **kw))


def test_kernels_empty_batches():
    """S = 0 or N = 0 gives zeros, as the JAX kernels do."""
    v = T(np.zeros(0, np.float32))
    assert TS.segment_sort(v, T(np.array([0], np.int32))).shape == (0,)
    k, p = TS.segment_sort_kv(v, T(np.array([0, 0, 0], np.int32)))
    assert k.shape == (0,) and p.dtype == torch.int32
    assert TS.segment_sort_two_phase(v, T(np.array([0], np.int32)),
                                     cap=8).shape == (0,)


# --------------------------------------------------------------------------
# the engine ops, variant by variant
# --------------------------------------------------------------------------

SORT_VARIANTS = [("pallas_fused", "cuda_fused"),
                 ("pallas_two_phase", "cuda_two_phase"), ("xla", "torch")]


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("lens", LENS)
@pytest.mark.parametrize("jv,tv", SORT_VARIANTS)
def test_engine_segment_sort(dtype, lens, jv, tv):
    vals, offs = ragged(lens, dtype)
    got = TE.segment_sort(vals, offs, variant=tv, device="cpu")
    same(JE.segment_sort(jnp.array(vals), jnp.array(offs), variant=jv), got)
    assert got.dtype == T(vals).dtype
    ok = TE.segment_sort_oracle(vals, offs)
    np.testing.assert_array_equal(got.numpy(), ok)   # == on values: ±0 tie


@pytest.mark.parametrize("descending", [True, False])
@pytest.mark.parametrize("lens", [[7, 0, 19, 1, 64], [0, 0], [33] * 4,
                                  [256]])
@pytest.mark.parametrize("jv,tv", SORT_VARIANTS)
def test_engine_segment_argsort_stable(descending, lens, jv, tv):
    """Heavy ties: every variant is per-segment
    ``np.argsort(kind="stable")`` and the JAX variant's permutation."""
    k = RNG.integers(0, 3, int(sum(lens))).astype(np.int32)
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    got = TE.segment_argsort(k, offs, descending=descending, variant=tv,
                             device="cpu")
    same(JE.segment_argsort(jnp.array(k), jnp.array(offs),
                            descending=descending, variant=jv), got)
    exp = [np.argsort(-k[a:b] if descending else k[a:b], kind="stable")
           for a, b in zip(offs[:-1], offs[1:])]
    np.testing.assert_array_equal(got.numpy(),
                                  np.concatenate(exp + [np.zeros(0)]))
    assert got.dtype == torch.int32


@pytest.mark.parametrize("jv,tv", SORT_VARIANTS)
def test_engine_segment_argsort_signed_zeros(jv, tv):
    vals, offs = ragged(LENS[0])
    for d in (True, False):
        same(JE.segment_argsort(jnp.array(vals), jnp.array(offs),
                                descending=d, variant=jv),
             TE.segment_argsort(vals, offs, descending=d, variant=tv,
                                device="cpu"))


@pytest.mark.parametrize("descending", [True, False])
@pytest.mark.parametrize("jv,tv", SORT_VARIANTS)
def test_engine_segment_sort_ascending_values_and_nan(descending, jv, tv):
    vals, offs = ragged([9, 0, 30, 5])
    tok = np.arange(vals.shape[0], dtype=np.int32) * 7
    jnp_args = (jnp.array(vals), jnp.array(offs))
    same(JE.segment_sort(*jnp_args, descending=descending, variant=jv),
         TE.segment_sort(vals, offs, descending=descending, variant=tv,
                         device="cpu"))
    jk, jt = JE.segment_sort(*jnp_args, descending=descending,
                             values=jnp.array(tok), variant=jv)
    tk, tt = TE.segment_sort(vals, offs, descending=descending, values=tok,
                             variant=tv, device="cpu")
    same(jk, tk)
    same(jt, tt)
    nv = vals.copy()
    nv[[1, 12, 20]] = np.nan
    same(JE.segment_sort(jnp.array(nv), jnp.array(offs), nan="sort_last",
                         descending=descending, variant=jv),
         TE.segment_sort(nv, offs, nan="sort_last", descending=descending,
                         variant=tv, device="cpu"))


def test_engine_segment_sort_values_carries_payload():
    lens = [5, 0, 40, 3]
    k = RNG.integers(0, 2, sum(lens)).astype(np.int32)
    tok = RNG.integers(0, 99, sum(lens)).astype(np.int32)
    wgt = RNG.standard_normal(sum(lens)).astype(np.float32)
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    sk, (st, sw) = TE.segment_sort(k, offs, values=(tok, wgt),
                                   descending=False, stable=True,
                                   device="cpu")
    src = np.concatenate([a + np.argsort(k[a:b], kind="stable")
                          for a, b in zip(offs[:-1], offs[1:])])
    np.testing.assert_array_equal(sk.numpy(), k[src])
    np.testing.assert_array_equal(st.numpy(), tok[src])
    np.testing.assert_array_equal(sw.numpy(), wgt[src])


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("la,lb", [
    ([5, 0, 33, 7], [3, 9, 0, 64]),
    ([0, 0], [0, 5]),
    ([100], [1]),
    ([0], [0]),
    ([1, 2, 3, 4, 5, 6, 7, 8], [8, 7, 6, 5, 4, 3, 2, 1]),
])
@pytest.mark.parametrize("jv,tv", [("pallas", "cuda"), ("xla", "torch")])
def test_engine_segment_merge(dtype, la, lb, jv, tv):
    for d in (True, False):
        a, ao = ragged(la, dtype, sort_desc=True)
        b, bo = ragged(lb, dtype, sort_desc=True)
        if not d:
            a, b = (np.concatenate([x[o0:o1][::-1] for o0, o1 in
                                    zip(o[:-1], o[1:])] + [x[:0]])
                    for x, o in ((a, ao), (b, bo)))
        got = TE.segment_merge(a, ao, b, bo, descending=d, variant=tv,
                               device="cpu")
        same(JE.segment_merge(jnp.array(a), jnp.array(ao), jnp.array(b),
                              jnp.array(bo), descending=d, variant=jv), got)


def test_segment_merge_heavy_duplicates_across_blocks():
    """Duplicate keys crossing (segment, block) partition boundaries."""
    la, lb = [600, 0, 900], [400, 50, 1100]
    a = np.concatenate([np.sort(RNG.integers(0, 3, n))[::-1] for n in la]
                       ).astype(np.int32)
    b = np.concatenate([np.sort(RNG.integers(0, 3, n))[::-1] for n in lb]
                       ).astype(np.int32)
    ao = np.concatenate([[0], np.cumsum(la)]).astype(np.int32)
    bo = np.concatenate([[0], np.cumsum(lb)]).astype(np.int32)
    same(JS.segmented_merge_pallas(jnp.array(a), jnp.array(ao), jnp.array(b),
                                   jnp.array(bo), w=16, block_out=64),
         TS.segmented_merge(T(a), T(ao), T(b), T(bo), w=16, block_out=64))


# --------------------------------------------------------------------------
# caps, offsets, references, planning
# --------------------------------------------------------------------------

def test_segment_sort_rejects_truncating_cap():
    v = np.arange(100, dtype=np.int32)
    offs = np.array([0, 100], np.int32)
    for op in (TE.segment_sort, TE.segment_argsort):
        with pytest.raises(ValueError, match="longest segment"):
            op(v, offs, cap=64, device="cpu")
    got = TE.segment_sort(v, offs, cap=100, device="cpu")     # rounds to 128
    np.testing.assert_array_equal(got.numpy(), np.arange(100)[::-1])


def test_validate_offsets_rejects_bad():
    v = np.arange(5, dtype=np.int32)
    with pytest.raises(ValueError):
        TE.segment_sort(v, np.array([0, 3], np.int32), device="cpu")
    with pytest.raises(ValueError):
        TE.segment_argsort(v, np.array([0, 4, 2, 5], np.int32),
                           device="cpu")
    with pytest.raises(ValueError):
        TE.segment_merge(v, np.array([0, 5], np.int32), v,
                         np.array([0, 4], np.int32), device="cpu")


def test_segment_argsort_ref_uniform_fast_path():
    """The reshape fast path of uniform segments gives the padded path's
    permutation (both directions, heavy ties and ±0)."""
    vals, offs = ragged([16] * 5)
    for d in (True, False):
        fast = TSG.segment_argsort_ref(T(vals), T(offs), descending=d)
        padded = TSG.segment_argsort_ref(T(vals), T(offs), cap=32,
                                         descending=d)
        ragged_ = TSG.segment_argsort_ref(
            T(np.concatenate([vals, vals[:1]])),
            T(np.concatenate([offs, [81]]).astype(np.int32)), descending=d)
        assert torch.equal(fast, padded)
        assert torch.equal(fast, ragged_[:80])


def test_segment_helpers():
    o = TSG.offsets_from_lengths([3, 0, 2])
    assert o.dtype == torch.int32 and o.tolist() == [0, 3, 3, 5]
    assert TSG.lengths_from_offsets(o).tolist() == [3, 0, 2]
    v = torch.arange(5, dtype=torch.float32)
    bank = TSG.pad_segments(v, o, 4)
    assert bank.shape == (3, 4) and float(bank[1, 0]) == float("-inf")
    assert torch.equal(TSG.unpad_segments(bank, o, 5), v)
    TSG.validate_cap(o, 4)
    with pytest.raises(ValueError):
        TSG.validate_cap(o, 2)


def test_cpu_segment_ops_launch_no_kernel():
    TK.reset_launches()
    vals, offs = ragged(LENS[0])
    for v in ("cuda_fused", "cuda_two_phase"):
        TE.segment_sort(vals, offs, variant=v, device="cpu")
        TE.segment_argsort(vals, offs, variant=v, device="cpu")
    assert TK.launch_counts() == {}


def test_segment_heuristics_and_jax_tables():
    h, key = tplanner.heuristic_plan, tplanner.plan_key
    for op, cuda in (("segment_sort", "cuda_two_phase"),
                     ("segment_argsort", "cuda_two_phase"),
                     ("segment_merge", "cuda"), ("moe_route", "fused")):
        assert h(op, key(op, n=4096, dtype=torch.float32, backend="cuda",
                         segments=8)).variant == cuda
        assert h(op, key(op, n=4096, dtype=torch.float32, backend="cpu",
                         segments=8)).variant == "torch"
    out = tplanner.plans_from_jax({"plans": {
        "segment_sort|tpu|float32|n1024|s8": {"variant": "pallas_fused",
                                              "cap": 256},
        "segment_argsort|tpu|int32|n1024|s8": {"variant": "pallas_two_phase"},
        "moe_route|tpu|float32|n256|s1": {"variant": "fused"}}})
    assert out["segment_sort|cuda|float32|n1024|s8"] == dict(
        tplanner.Plan("cuda_fused", cap=256).to_dict())
    assert out["segment_argsort|cuda|int32|n1024|s8"]["variant"] == \
        "cuda_two_phase"
    assert out["moe_route|cuda|float32|n256|s1"]["variant"] == "fused"


def test_sort_torch_variant_orders_signed_zeros_as_xla():
    """The ``torch`` sort variant and the ``torch`` merge_runs executor
    order a +0.0/-0.0 tie as ``jnp.sort`` does (the reversed stable
    ascending sort)."""
    x = np.array([0.0, -0.0, 1.0, 0.0, -0.0, -0.0, 0.0], np.float32)
    same(JE.sort(jnp.array(x), variant="xla"),
         TE.sort(x, variant="torch", device="cpu"))
    offs = np.array([0, 3, 7], np.int32)
    runs = np.concatenate([np.sort(x[:3])[::-1], np.sort(x[3:])[::-1]])
    same(JE.merge_runs(jnp.array(runs), jnp.array(offs), variant="xla"),
         TE.merge_runs(runs, offs, variant="torch", device="cpu"))
