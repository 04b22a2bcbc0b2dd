"""Parity of the port's reference sorters with the JAX package, on the CPU.

``repro_torch.core`` ``mergesort`` (``sort_chunks``, ``flims_sort``,
``flims_argsort``, ``flims_sort_kv``), ``merge_tree`` (``pmt_merge*``,
``merge_k``), ``topk`` (``flims_topk``), ``lanes.topk_node`` and the
batched ``lanes.merge_lanes`` (the plain version of K9) against
``repro.core``, and the engine's ``sort(variant="ref")``, ``argsort(variant=
"flims")`` and ``topk`` against the JAX engine's. The same numpy inputs,
made from a seeded generator (duplicate-heavy, +0.0/-0.0, -inf and NaNs of
two payloads among them), go through both; the reductions run the
``tree_vmapped`` schedule on each side (``jax.vmap(merge_lanes)`` per
level against the port's lane merge, whose CPU form is the plain version).

Tolerance: exact. Keys, ranks, indices and payloads are equal bit for bit;
float keys are compared as int32 bit patterns.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
from repro import engine as JE  # noqa: E402
from repro.core import lanes as JL  # noqa: E402
from repro.core.merge_tree import (pmt_merge_kv_padded as j_kv_padded,  # noqa: E402
                                   pmt_merge_padded as j_padded)
from repro_torch import engine as TE  # noqa: E402
from repro_torch.core import lanes as TL  # noqa: E402
from repro_torch.core import merge_tree as TT  # noqa: E402
from repro_torch.core import mergesort as TM  # noqa: E402
from repro_torch.core.topk import flims_topk  # noqa: E402

RNG = np.random.default_rng(41)
FPOOL = np.array([0.0, -0.0, 1.5, -1.0, -np.inf, 4.0], np.float32)
NAN_POOL = np.array([np.nan, 0.0, -0.0, 1.5, -np.inf, 4.0], np.float32)


def same(j, t):
    j = np.asarray(j)
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert j.shape == t.shape, (j.shape, t.shape)
    if j.dtype == np.float32:
        assert t.dtype == np.float32
        j, t = j.view(np.int32), t.view(np.int32)
    np.testing.assert_array_equal(j, t.astype(j.dtype))


def keys(n, kind="ties"):
    if kind == "int":
        return RNG.integers(-6, 6, n).astype(np.int32)
    x = RNG.choice(NAN_POOL if kind == "nan" else FPOOL, n).astype(np.float32)
    if kind == "nan":                       # a second NaN payload
        x.view(np.int32)[RNG.random(n) < 0.1] = np.int32(-4194304)
    return x


def desc_rows(K, n, kind="ties"):
    return np.sort(keys(K * n, kind).reshape(K, n), axis=1)[:, ::-1].copy()


T = torch.from_numpy


@pytest.fixture(autouse=True)
def clean_state():
    JE.clear_plans()
    TE.clear_plans()
    yield
    JE.clear_plans()
    TE.clear_plans()


# --------------------------------------------------------------------------
# the batched lane merge (K9's plain version) and topk_node
# --------------------------------------------------------------------------

@pytest.mark.parametrize("w", [1, 4, 32])
@pytest.mark.parametrize("kind", ["ties", "nan", "int"])
def test_batched_merge_lanes_matches_vmap(w, kind):
    """The 2-D ``merge_lanes`` against ``jax.vmap(merge_lanes)`` over 5 row
    pairs: key-only under tie b and skew, and (key, rank) lanes."""
    a, b = desc_rows(5, 37, kind), desc_rows(5, 21, kind)
    for tie in ("b", "skew"):
        jf = jax.vmap(lambda x, y: JL.merge_lanes(
            {"key": x}, {"key": y}, w=w, tie=tie)["key"])
        got = TL.merge_lanes({"key": T(a)}, {"key": T(b)}, w=w, tie=tie)
        same(jf(jnp.array(a), jnp.array(b)), got["key"])
    ra = RNG.permutation(5 * 37).astype(np.int32).reshape(5, 37)
    rb = RNG.permutation(5 * 21).astype(np.int32).reshape(5, 21)

    def jkv(x, rx, y, ry):
        out = JL.merge_lanes({"key": x, "rank": rx}, {"key": y, "rank": ry},
                             w=w)
        return out["key"], out["rank"]
    jk, jr = jax.vmap(jkv)(jnp.array(a), jnp.array(ra), jnp.array(b),
                           jnp.array(rb))
    got = TL.merge_lanes({"key": T(a), "rank": T(ra)},
                         {"key": T(b), "rank": T(rb)}, w=w)
    same(jk, got["key"])
    same(jr, got["rank"])


@pytest.mark.parametrize("w", [1, 8, 32])
@pytest.mark.parametrize("kind", ["nan", "int"])
def test_lane_merge_level_matches_vmap(w, kind):
    """K9's uniform-level form (``kernels.lane_merge.lane_merge_level``, its
    plain version on the CPU) over 6 runs of 19 keys: run 2p merged with
    run 2p + 1, as ``jax.vmap(merge_lanes)`` merges the (3, 2, 19) rows,
    key-only under tie b and skew and with ranks; and equal to the ragged
    form over the same uniform pairs."""
    from repro_torch.kernels import lane_merge as K9
    x = desc_rows(6, 19, kind)
    r = RNG.permutation(6 * 19).astype(np.int32)
    flat, rt = T(x.reshape(-1)), T(r)
    st = torch.arange(3, dtype=torch.int32) * 38
    ln = torch.full((3,), 19, dtype=torch.int32)
    ab = jnp.array(x.reshape(3, 2, 19))
    for tie in ("b", "skew"):
        jf = jax.vmap(lambda y: JL.merge_lanes(
            {"key": y[0]}, {"key": y[1]}, w=w, tie=tie)["key"])
        got, none = K9.lane_merge_level(flat, None, 19, w=w, tie=tie)
        assert none is None
        same(jf(ab).reshape(-1), got)
        same(got.numpy(), K9.lane_merge_plain(flat, flat, st, ln, st + 19,
                                              ln, n_out=114, w=w, tie=tie))

    def jkv(y, ry):
        out = JL.merge_lanes({"key": y[0], "rank": ry[0]},
                             {"key": y[1], "rank": ry[1]}, w=w)
        return out["key"], out["rank"]
    jk, jr = jax.vmap(jkv)(ab, jnp.array(r.reshape(3, 2, 19)))
    gk, gr = K9.lane_merge_level(flat, rt, 19, w=w)
    same(jk.reshape(-1), gk)
    same(jr.reshape(-1), gr)
    with pytest.raises(ValueError):
        K9.lane_merge_level(flat, rt, 19, w=w, tie="skew")
    with pytest.raises(ValueError):
        K9.lane_merge_level(flat, None, 20, w=w)


@pytest.mark.parametrize("w", [2, 8])
def test_ragged_merge_lanes_rows_match_1d(w):
    """A row of the ragged 2-D form merges the row's valid prefixes exactly
    as the JAX 1-D ``merge_lanes`` does."""
    a, b = desc_rows(4, 30, "nan"), desc_rows(4, 25, "nan")
    la, lb = np.array([0, 7, 30, 13]), np.array([25, 0, 3, 17])
    got = TL.merge_lanes({"key": T(a)}, {"key": T(b)}, w=w, tie="skew",
                         a_lens=T(la), b_lens=T(lb))["key"]
    for p in range(4):
        exp = JL.merge_lanes({"key": jnp.array(a[p, :la[p]])},
                             {"key": jnp.array(b[p, :lb[p]])}, w=w,
                             tie="skew")["key"]
        same(exp, got[p, :la[p] + lb[p]])


# K9's block form: each block of a level's chains restarted at the
# merge-path co-rank of its first output (``block_starts_plain``, the
# kernel's search) and run by the plain merge_lanes, against the scan

BLOCK_POOLS = {
    "ties": FPOOL,                           # +0.0 and -0.0, -inf, ties
    "inf": np.array([np.inf, -np.inf, -np.inf, 3.0, 1.0, 1.0, -1.0],
                    np.float32),             # real keys equal to the padding
    "pos0": np.array([0.0, 0.0, 1.5, -1.0, -np.inf, 4.0], np.float32),
    "neg0": np.array([-0.0, -0.0, 1.5, -1.0, -np.inf, 4.0], np.float32),
    "int": np.array([-2 ** 31, -2 ** 31, -7, 0, 3, 3, 9, 2 ** 31 - 1],
                    np.int32),
}


def _level_runs(kind, P, L, kv):
    """2P descending runs of L keys from ``BLOCK_POOLS[kind]``; with ``kv``
    ranks (a permutation) in the compound order within each run."""
    x = RNG.choice(BLOCK_POOLS[kind], (2 * P, L))
    x = np.sort(x, axis=1)[:, ::-1].astype(x.dtype)
    if not kv:
        return x.copy(), None
    r = RNG.permutation(2 * P * L).astype(np.int32).reshape(2 * P, L)
    for i in range(2 * P):                   # key descending, rank ascending
        o = np.lexsort((r[i], -x[i].astype(np.float64)))
        x[i], r[i] = x[i][o], r[i][o]
    return x.copy(), r


def _jax_level(x, r, w, tie):
    """jax.vmap(merge_lanes) over the level's (P, 2, L) pairs, flattened."""
    P, L = x.shape[0] // 2, x.shape[1]
    ab = jnp.array(x.reshape(P, 2, L))
    if r is None:
        return jax.vmap(lambda y: JL.merge_lanes(
            {"key": y[0]}, {"key": y[1]}, w=w, tie=tie)["key"])(ab).reshape(
                -1), None

    def jkv(y, ry):
        out = JL.merge_lanes({"key": y[0], "rank": ry[0]},
                             {"key": y[1], "rank": ry[1]}, w=w)
        return out["key"], out["rank"]
    jk, jr = jax.vmap(jkv)(ab, jnp.array(r.reshape(P, 2, L)))
    return jk.reshape(-1), jr.reshape(-1)


def _block_form(flat, ranks, L, w, C, tie):
    """The level as K9's block form computes it: block j of pair p runs C
    cycles of the plain merge_lanes (its dir bits clear) from
    ``block_starts_plain``'s (pA, pB), over the C w keys of each side that
    C cycles can reach; the blocks' outputs concatenated."""
    from repro_torch.kernels import lane_merge as K9
    pA, pB = K9.block_starts_plain(flat, ranks, L, w, C)
    P, bpp = pA.shape
    cw = C * w

    def bank(x, side, p0):
        rows = x.reshape(P, 2, L)[:, side, None, :].expand(P, bpp, L)
        idx = (p0[:, :, None] + torch.arange(cw)).clamp(max=L - 1)
        return torch.gather(rows, 2, idx).reshape(P * bpp, cw)
    A, B = {"key": bank(flat, 0, pA)}, {"key": bank(flat, 1, pB)}
    if ranks is not None:
        A["rank"], B["rank"] = bank(ranks, 0, pA), bank(ranks, 1, pB)
    m = TL.merge_lanes(A, B, w=w, tie=tie,
                       a_lens=(L - pA).clamp(0, cw).reshape(-1),
                       b_lens=(L - pB).clamp(0, cw).reshape(-1))
    out = {n: v[:, :cw].reshape(P, bpp * cw)[:, :2 * L].reshape(-1)
           for n, v in m.items()}
    return out["key"], out.get("rank")


BLOCK_CASES = [("ties", "b", False), ("inf", "b", False), ("int", "b", False),
               ("ties", "b", True), ("inf", "b", True), ("int", "b", True),
               ("pos0", "skew", False), ("neg0", "skew", False),
               ("inf", "skew", False), ("int", "skew", False)]


@pytest.mark.parametrize("w", [1, 8, 32])
@pytest.mark.parametrize("kind,tie,kv", BLOCK_CASES)
def test_block_restarts_match_vmap(w, kind, tie, kv):
    """For NaN-free levels (3 pairs of two 47-key runs), K9's block form at
    blocks of 1, 2 and 3 cycles equals ``jax.vmap(merge_lanes)`` bit for
    bit: key-only under tie b with +-0, +-inf, real -inf keys and ties,
    int32 with INT32_MIN, KV, and skew on pairs without mixed signed zeros.
    The guard's plain twin flags none of these pairs; every block starts
    on its first output, inside the runs."""
    from repro_torch.kernels import lane_merge as K9
    P, L = 3, 47
    x, r = _level_runs(kind, P, L, kv)
    flat, rt = T(x.reshape(-1)), None if r is None else T(r.reshape(-1))
    jk, jr = _jax_level(x, r, w, tie)
    assert not K9.level_guard_plain(flat, rt, L, tie).any()
    for C in (1, 2, 3):
        pA, pB = K9.block_starts_plain(flat, rt, L, w, C)
        o = torch.arange(pA.shape[1]) * C * w
        assert torch.equal(pA + pB, o.expand_as(pA))
        assert int(pA.min()) >= 0 and int(pA.max()) <= L
        assert int(pB.min()) >= 0 and int(pB.max()) <= L
        gk, gr = _block_form(flat, rt, L, w, C, tie)
        same(jk, gk)
        if kv:
            same(jr, gr)


def test_level_guard_plain_flags():
    """The guard's plain twin: a pair holding a NaN, a run out of the
    selector's order (a larger key after a smaller; under ranks, equal keys
    with a falling rank), or under skew both +0.0 and -0.0 is flagged;
    NaN-free sorted pairs with one zero sign, or with both under tie b, are
    not."""
    from repro_torch.kernels import lane_merge as K9
    L = 4
    pairs = np.array([[3, 2, 1, 0], [5, 5, -1, -np.inf],       # clean
                      [np.nan, 2, 1, 0], [4, 3, 3, 1],         # NaN
                      [2, 0.0, -0.0, -1], [1, 0.0, 0.0, -2],   # +-0
                      [3, 4, 1, 0], [2, 1, 0, -1],             # unsorted
                      [2, -0.0, -0.0, -1], [9, 1, -0.0, -3]],  # -0 only
                     np.float32).reshape(-1)
    flat = T(pairs)
    assert K9.level_guard_plain(flat, None, L, "b").tolist() == \
        [False, True, False, True, False]
    assert K9.level_guard_plain(flat, None, L, "skew").tolist() == \
        [False, True, True, True, False]
    ints = T(np.array([5, 3, 3, -2 ** 31, 9, 3, 0, -2 ** 31,
                       1, 2, 0, 0, 4, 3, 2, 1], np.int32))
    assert K9.level_guard_plain(ints, None, L, "skew").tolist() == \
        [False, True]
    keys_ = T(np.array([3, 3, 1, 1, 2, 2, 0, 0], np.float32))
    assert K9.level_guard_plain(keys_, T(np.array([0, 1, 2, 3, 4, 5, 6, 7],
                                                  np.int32)), L).tolist() \
        == [False]
    assert K9.level_guard_plain(keys_, T(np.array([1, 0, 2, 3, 4, 5, 6, 7],
                                                  np.int32)), L).tolist() \
        == [True]


# two pairs on which the restart at the co-rank is not the scan (found by a
# seeded search over w 4, blocks of one cycle): under tie b with NaN keys
# the selector's predicate is not monotone; under skew with both +0.0 and
# -0.0 the dir bits decide which zero goes first
GUARD_PAIRS = [
    ("b", [[np.nan, np.nan, 4.0, 2.0, 2.0, -1.0, -1.0, -1.0],
           [np.nan, np.nan, 4.0, 4.0, 1.5, 1.5, 0.0, 0.0]]),
    ("skew", [[1.5, -0.0, 0.0, -0.0, 0.0, -0.0, -1.0, -1.0],
              [0.0, -0.0, -0.0, -0.0, 0.0, 0.0, -1.0, -1.0]]),
]


@pytest.mark.parametrize("tie,pair", GUARD_PAIRS)
def test_block_restart_needs_the_guard(tie, pair):
    """On a NaN pair and on a mixed-zero skew pair the block form (w 4,
    blocks of one cycle) differs from ``jax.vmap(merge_lanes)``; the guard
    flags both, so K9 runs their whole chain, whose plain version equals the
    scan bit for bit."""
    from repro_torch.kernels import lane_merge as K9
    x = np.array(pair, np.float32)
    flat = T(x.reshape(-1))
    jk, _ = _jax_level(x, None, 4, tie)
    gk, _ = _block_form(flat, None, 8, 4, 1, tie)
    assert not np.array_equal(np.asarray(jk).view(np.int32),
                              gk.numpy().view(np.int32))
    assert K9.level_guard_plain(flat, None, 8, tie).tolist() == [True]
    same(jk, K9.lane_merge_level_plain(flat, None, 8, w=4, tie=tie)[0])


@pytest.mark.parametrize("k", [1, 8, 32])
def test_topk_node_matches_jax(k):
    a = {"key": desc_rows(6, k, "nan"),
         "rank": RNG.permutation(6 * k).astype(np.int32).reshape(6, k)}
    b = {"key": desc_rows(6, k, "nan"),
         "rank": RNG.permutation(6 * k).astype(np.int32).reshape(6, k)}
    j = jax.jit(JL.topk_node)({q: jnp.array(v) for q, v in a.items()},
                              {q: jnp.array(v) for q, v in b.items()})
    t = TL.topk_node({q: T(v) for q, v in a.items()},
                     {q: T(v) for q, v in b.items()})
    same(j["key"], t["key"])
    same(j["rank"], t["rank"])


# --------------------------------------------------------------------------
# mergesort
# --------------------------------------------------------------------------

def test_sort_chunks_matches_jax():
    x = keys(1024, "nan")
    same(J.sort_chunks(jnp.array(x), 256), TM.sort_chunks(T(x), 256))


@pytest.mark.parametrize("n", [0, 1, 2, 17, 300, 1100])
@pytest.mark.parametrize("kind", ["ties", "nan", "int"])
def test_flims_sort_matches_jax(n, kind):
    x = keys(n, kind)
    for d in (True, False):
        same(J.flims_sort(jnp.array(x), chunk=64, w=16, descending=d),
             TM.flims_sort(T(x), chunk=64, w=16, descending=d))


@pytest.mark.parametrize("n", [1, 5, 300])
@pytest.mark.parametrize("kind", ["ties", "nan", "int"])
@pytest.mark.parametrize("descending", [True, False])
def test_flims_argsort_matches_jax(n, kind, descending):
    x = keys(n, kind)
    same(J.flims_argsort(jnp.array(x), chunk=32, w=8, descending=descending),
         TM.flims_argsort(T(x), chunk=32, w=8, descending=descending))


def test_flims_argsort_rows_are_one_grouped_reduction():
    """A (B, n) batch through the port's one grouped reduction equals the
    JAX function vmapped over the rows; a 1-D call equals its row."""
    x = keys(3 * 150, "nan").reshape(3, 150)
    for d in (True, False):
        exp = jax.vmap(lambda r: J.flims_argsort(r, chunk=32, w=8,
                                                 descending=d))(jnp.array(x))
        got = TM.flims_argsort(T(x), chunk=32, w=8, descending=d)
        same(exp, got)
        same(exp[1], TM.flims_argsort(T(x[1].copy()), chunk=32, w=8,
                                      descending=d))


def test_flims_sort_kv_matches_jax():
    k = keys(200, "int")
    v = np.arange(200, dtype=np.int32) * 3
    jk, jv = J.flims_sort_kv(jnp.array(k), jnp.array(v), chunk=16, w=4)
    tk, tv = TM.flims_sort_kv(T(k), T(v), chunk=16, w=4)
    same(jk, tk)
    same(jv, tv)
    tk, tv = TM.flims_sort_kv(T(np.array([3, 1, 3, 2, 1], np.int32)),
                              torch.arange(5))
    assert tk.tolist() == [3, 3, 2, 1, 1] and tv.tolist() == [0, 2, 3, 1, 4]


# --------------------------------------------------------------------------
# merge trees
# --------------------------------------------------------------------------

@pytest.mark.parametrize("K,n", [(1, 16), (2, 64), (5, 32), (16, 8)])
@pytest.mark.parametrize("kind", ["ties", "nan"])
def test_pmt_merge_matches_jax(K, n, kind):
    rows = desc_rows(K, n, kind)
    for tie in ("b", "skew"):
        same(J.pmt_merge(jnp.array(rows), w=8, tie=tie),
             TT.pmt_merge(T(rows), w=8, tie=tie))


@pytest.mark.parametrize("K", [1, 3, 8])
def test_pmt_merge_kv_matches_jax(K):
    rows = desc_rows(K, 16, "nan")
    pay = {"p": np.arange(K * 16, dtype=np.int32).reshape(K, 16),
           "q": keys(K * 16).reshape(K, 16)}
    jk, jp = J.pmt_merge_kv(jnp.array(rows),
                            {q: jnp.array(v) for q, v in pay.items()}, w=8)
    tk, tp = TT.pmt_merge_kv(T(rows), {q: T(v) for q, v in pay.items()},
                             w=8)
    same(jk, tk)
    same(jp["p"], tp["p"])
    same(jp["q"], tp["q"])


def test_pmt_merge_padded_variants_match_jax():
    m = np.iinfo(np.int32).min
    rows = np.array([[5, m, 777, 777], [2, 1, m, 777], [9, 9, 9, 1]],
                    np.int32)
    pay = np.arange(12, dtype=np.int32).reshape(3, 4)
    counts = np.array([2, 3, 0], np.int32)
    jk, jp = j_kv_padded(jnp.array(rows), jnp.array(counts), jnp.array(pay),
                         w=4)
    tk, tp = TT.pmt_merge_kv_padded(T(rows), T(counts), T(pay), w=4)
    same(jk, tk)
    same(jp, tp)
    assert tk[:5].tolist() == [5, 2, 1, m, m]
    same(j_padded(jnp.array(rows), jnp.array(counts), w=4),
         TT.pmt_merge_padded(T(rows), T(counts), w=4))
    mask = rows > 3
    same(j_padded(jnp.array(rows), jnp.array(mask), w=4,
                  valid_is_count=False),
         TT.pmt_merge_padded(T(rows), T(mask), w=4, valid_is_count=False))


def test_merge_k_matches_jax():
    arrays = [np.sort(keys(n, "nan"))[::-1].copy()
              for n in [3, 17, 0, 200, 1, 64]]
    same(J.merge_k([jnp.array(a) for a in arrays], w=8),
         TT.merge_k([T(a) for a in arrays], w=8))
    assert TT.merge_k([], dtype=torch.int32).dtype == torch.int32
    assert TT.merge_k([]).dtype == torch.float32
    assert TT.merge_k([torch.zeros(0, dtype=torch.int16)]).dtype == \
        torch.int16
    assert TT.merge_k([torch.tensor([3, 1], dtype=torch.int16)]).tolist() \
        == [3, 1]


# --------------------------------------------------------------------------
# top-k
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,k", [(1, 1), (7, 3), (100, 8), (200, 20),
                                 (5, 8)])
@pytest.mark.parametrize("kind", ["ties", "nan", "int"])
def test_flims_topk_matches_jax(n, k, kind):
    """1-D and batched rows, ``k`` above ``n`` (the rank-validity mask), and
    a payload riding the lanes."""
    x = keys(3 * n, kind).reshape(3, n)
    pay = {"i": RNG.integers(0, 99, (3, n)).astype(np.int32),
           "f": keys(3 * n).reshape(3, n)}
    jv, ji = J.flims_topk(jnp.array(x[0]), k)
    tv, ti = flims_topk(T(x[0].copy()), k)
    same(jv, tv)
    same(ji, ti)
    jv, ji, jp = J.flims_topk(jnp.array(x), k,
                              values={q: jnp.array(v) for q, v in pay.items()})
    tv, ti, tp = flims_topk(T(x), k, values={q: T(v) for q, v in pay.items()})
    same(jv, tv)
    same(ji, ti)
    same(jp["i"], tp["i"])
    same(jp["f"], tp["f"])


# --------------------------------------------------------------------------
# the engine ops over the reference sorters
# --------------------------------------------------------------------------

def test_engine_sort_ref_and_argsort_flims_match_jax():
    x = keys(300)
    for d in (True, False):
        same(JE.sort(jnp.array(x), descending=d, variant="ref"),
             TE.sort(x, descending=d, variant="ref", device="cpu"))
        same(JE.argsort(jnp.array(x), descending=d, variant="flims"),
             TE.argsort(x, descending=d, variant="flims", device="cpu"))
    rows = keys(4 * 90, "int").reshape(4, 90)
    same(JE.argsort(jnp.array(rows), variant="flims"),
         TE.argsort(rows, variant="flims", device="cpu"))


@pytest.mark.parametrize("variant", ["flims", "torch"])
def test_engine_topk_matches_jax(variant):
    """Both port variants against the JAX ``flims`` variant (the ``torch``
    one is a stable descending sort and a slice: ``lax.top_k``'s tie
    order), with a payload and ``nan="sort_last"``."""
    x = keys(4 * 200).reshape(4, 200)
    v = RNG.integers(0, 999, (4, 200)).astype(np.int32)
    jv, ji, jp = JE.topk(jnp.array(x), 12, values=jnp.array(v),
                         variant="flims")
    tv, ti, tp = TE.topk(x, 12, values=v, variant=variant, device="cpu")
    same(jv, tv)
    same(ji, ti)
    same(jp, tp)
    xn = keys(300, "nan")
    jv, ji = JE.topk(jnp.array(xn), 9, nan="sort_last", variant="flims")
    tv, ti = TE.topk(xn, 9, nan="sort_last", variant=variant, device="cpu")
    same(jv, tv)
    same(ji, ti)
    # k past the row: the flims variant's rank-validity mask
    same(JE.topk(jnp.array(x[0, :5]), 8, variant="flims")[1],
         TE.topk(x[0, :5], 8, variant="flims", device="cpu")[1])
