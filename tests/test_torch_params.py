"""The kernels' plain routes at the parameters the card's kernels once
refused, against the JAX package on the CPU.

- K2 / K3 at w 2048, K4 at 4 and 5 fused levels and at w 4 and 256, K8 at
  fan-in 32 and at w 4 and 256, K9 at w 256: each plain version against the
  JAX kernel in interpret mode (K8 against JAX K4 over the same uniform
  runs, since the JAX K8 does not run on this jax, and against JAX
  ``stream_xla`` and ``jnp.sort`` on keys without NaN or -0.0, where every
  merge order gives the same bits).
- Keys of every dtype of at most 32 bits (bfloat16, float16, int8, int16,
  uint8, and uint16 / uint32 on K1 and K2) through each wrapper's CPU
  route, which widens them as the card does (``kernels/_build.widen``),
  against the JAX kernels on the same dtype.
- K5 / K6 past one CTA: the plain twin of the card's route (each segment
  over its own width, ``segment_widths_plain``) against
  ``segment_sort_pallas`` / ``segment_sort_kv_pallas``.

Inputs are made by a seeded numpy generator and hold NaNs of two payloads
(a signalling one among them), +0.0 and -0.0, ties and the dtype's min and
max. Tolerance: exact, keys compared as bit patterns.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import lanes as JL  # noqa: E402
from repro.engine.schedule import stream_pass as jstream_pass  # noqa: E402
from repro.kernels.bitonic_sort import (sort_chunks_kv_pallas,  # noqa: E402
                                        sort_chunks_pallas)
from repro.kernels.flims_merge import (flims_merge_kv_pallas,  # noqa: E402
                                       flims_merge_pallas)
from repro.kernels.merge_tree import merge_tree_runs as jk4  # noqa: E402
from repro.kernels.merge_tree import merge_tree_runs_kv as jk4kv  # noqa: E402
from repro.kernels.segmented_merge import (  # noqa: E402
    segment_sort_kv_pallas, segment_sort_pallas, segmented_merge_runs)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import bitonic_sort as TB  # noqa: E402
from repro_torch.kernels import flims_merge as TF  # noqa: E402
from repro_torch.kernels import lane_merge as TL  # noqa: E402
from repro_torch.kernels import merge_tree as TT  # noqa: E402
from repro_torch.kernels import segmented_merge as TS  # noqa: E402
from repro_torch.kernels import stream_merge as TK8  # noqa: E402

RNG = np.random.default_rng(27)
POOL = np.array([np.nan, 0.0, -0.0, 1.5, -1.0, -np.inf, 4.0, 4.0, 2.0],
                np.float32)
SNAN = np.int32(0x7F800001)      # a signalling NaN
NNAN = np.int32(-4194304)        # the negative quiet NaN


def fkeys(n, nan=True):
    x = RNG.choice(POOL if nan else POOL[1:], n).astype(np.float32)
    if nan:
        u = RNG.random(n)
        x.view(np.int32)[u < 0.05] = NNAN
        x.view(np.int32)[(u >= 0.05) & (u < 0.08)] = SNAN
    return x


def run(n, nan=True):
    """A descending run (numpy's sort, reversed): NaNs at its head."""
    return np.sort(fkeys(n, nan))[::-1].copy()


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def bits(x):
    if isinstance(x, torch.Tensor):
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.view(torch.int16)
        x = x.numpy()
    x = np.asarray(x)
    if x.dtype.kind == "f" or x.dtype == jnp.bfloat16:
        return x.view({2: np.int16, 4: np.int32}[x.dtype.itemsize])
    return x


def same(got, exp, what=""):
    g, e = bits(got), bits(exp)
    assert g.shape == e.shape, (what, g.shape, e.shape)
    bad = np.flatnonzero(g != e)
    assert not bad.size, f"{what}: {bad.size} of {g.size} differ, first at " \
        f"{bad[0]}: {g.ravel()[bad[0]]} vs {e.ravel()[bad[0]]}"


def ragged(lens):
    buf = np.concatenate([run(n) for n in lens])
    off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    return buf, off[:-1].copy(), np.diff(off).astype(np.int32)


# --------------------------------------------------------------------------
# the parameters the card refused
# --------------------------------------------------------------------------

def test_k2_k3_at_w_2048_match_jax():
    a, b = run(3000), run(1700)
    ra = np.arange(3000, dtype=np.int32)
    rb = np.arange(3000, 4700, dtype=np.int32)
    kw = dict(w=2048, block_out=4096)
    same(TF.flims_merge_plain(T(a), T(b), **kw),
         flims_merge_pallas(jnp.asarray(a), jnp.asarray(b), **kw), "K2")
    got = TF.flims_merge_kv_plain(T(a), T(ra), T(b), T(rb), **kw)
    exp = flims_merge_kv_pallas(jnp.asarray(a), jnp.asarray(ra),
                                jnp.asarray(b), jnp.asarray(rb), **kw)
    same(got[0], exp[0], "K2kv keys")
    same(got[1], exp[1], "K2kv ranks")
    buf, st, ln = ragged([2100, 0, 900, 2500])
    n = int(ln.sum())
    args = (st[::2], ln[::2], st[1::2], ln[1::2])
    same(TS.segmented_merge_runs_plain(T(buf), T(buf), *map(T, args),
                                       n_out=n, **kw),
         segmented_merge_runs(jnp.asarray(buf), jnp.asarray(buf),
                              *map(jnp.asarray, args), n_out=n, **kw), "K3")


@pytest.mark.parametrize("group,w", [(4, 4), (4, 256)])
def test_k4_levels_and_widths_match_jax(group, w):
    lens = list(RNG.integers(0, 90, group))
    buf, st, ln = ragged(lens + [0] * 0)
    n = int(ln.sum())
    r = np.arange(n, dtype=np.int32)
    kw = dict(group=group, n_out=n, w=w, block_out=max(w, 128))
    same(TT.merge_tree_runs_plain(T(buf), T(st), T(ln), **kw),
         jk4(jnp.asarray(buf), jnp.asarray(st), jnp.asarray(ln), **kw),
         f"K4 group {group} w {w}")
    got = TT.merge_tree_runs_kv_plain(T(buf), T(r), T(st), T(ln),
                                      descending=False, **kw)
    exp = jk4kv(jnp.asarray(buf), jnp.asarray(r), jnp.asarray(st),
                jnp.asarray(ln), descending=False, **kw)
    same(got[0], exp[0], "K4kv keys")
    same(got[1], exp[1], "K4kv ranks")


#: 32 runs of 30 keys over a 160-key buffer, each group's first at 0 (its
#: NaNs): 960 keys in all, past n_out = 800, which JAX K4's bank (n_out / w
#: + a few rows a run) still holds
OVERLAP_STARTS = [0, 122, 114, 66, 0, 126, 126, 10, 0, 78, 36, 48, 0, 104,
                  75, 22, 0, 113, 28, 70, 0, 117, 7, 62, 0, 55, 18, 102, 0,
                  127, 120, 48]


def test_k4_overlapping_runs_match_jax():
    """Runs that overlap in the buffer, longer together than both ``n_out``
    and the buffer, in groups holding a NaN: on the card K4's run check
    hands such groups to the wide form, whose tables hold max(n_out,
    len(buf)) lanes a level, so the group that ends past them searches
    without a table (its children's searches instead); the card holds that
    route to the plain version (``test_torch_cuda``), and the plain route
    (key-only, and KV ascending) equals JAX K4 in interpret mode."""
    n, w, bo, n_out = 160, 8, 32, 800
    buf = run(n)
    buf[:2] = np.nan
    st = np.array(OVERLAP_STARTS, np.int32)
    ln = np.full(st.size, 30, np.int32)
    asc = np.sort(buf)
    r = np.arange(n, dtype=np.int32)
    for group in (4, 8):
        kw = dict(group=group, n_out=n_out, w=w, block_out=bo)
        same(TT.merge_tree_runs(T(buf), T(st), T(ln), **kw),
             jk4(jnp.asarray(buf), jnp.asarray(st), jnp.asarray(ln), **kw),
             f"K4 overlapping runs, group {group}")
        got = TT.merge_tree_runs_kv(T(asc), T(r), T(st), T(ln),
                                    descending=False, **kw)
        exp = jk4kv(jnp.asarray(asc), jnp.asarray(r), jnp.asarray(st),
                    jnp.asarray(ln), descending=False, **kw)
        same(got[0], exp[0], f"K4kv overlapping runs keys, group {group}")
        same(got[1], exp[1], f"K4kv overlapping runs ranks, group {group}")


def test_k4_k8_unsorted_int16_runs_match_jax():
    """Runs not sorted in the call's order (int16 keys at the dtype's min
    and max): the card hands their groups to the wide form, whose
    reference is the plain version; K4's plain version (group 4, w 32, a
    shape the streamed kernel takes) and K8's over the same uniform runs
    against JAX K4, which gives deterministic bits on such input too."""
    runs, run_len, w, bo = 8, 64, 32, 128
    info = np.iinfo(np.int16)
    x = RNG.integers(info.min, info.max, runs * run_len, endpoint=True,
                     dtype=np.int16)
    x[:4] = (info.min, info.max, info.min, info.max)
    # two runs sorted, the others not
    x[:run_len] = np.sort(x[:run_len])[::-1]
    x[3 * run_len:4 * run_len] = np.sort(x[3 * run_len:4 * run_len])[::-1]
    st = np.arange(runs, dtype=np.int32) * run_len
    ln = np.full(runs, run_len, np.int32)
    kw = dict(group=4, n_out=x.size, w=w, block_out=bo)
    exp = jk4(jnp.asarray(x), jnp.asarray(st), jnp.asarray(ln), **kw)
    same(TT.merge_tree_runs_plain(T(x), T(st), T(ln), **kw), exp,
         "K4 unsorted int16")
    got = TK8.stream_merge_runs_plain(T(x), runs=runs, run_len=run_len,
                                      fan_in=4, w=w, block_out=bo)
    same(got[:x.size], exp, "K8 unsorted int16 vs JAX K4")


def _uniform(runs, run_len, nan=True):
    return np.concatenate([run(run_len, nan) for _ in range(runs)])


def test_k8_at_fan_in_32_matches_jax():
    """K8's plain version at fan-in 32 against JAX K4 at group 32 (NaN /
    +-0 runs), and on keys without NaN or -0.0 against JAX ``stream_xla``
    and ``jnp.sort``; K4's plain version at group 32 against the same JAX
    K4."""
    runs, run_len, fan, w, bo = 32, 16, 32, 8, 128
    x = _uniform(runs, run_len)
    C = TK8._block(bo, run_len, fan, w)
    st = np.arange(runs, dtype=np.int32) * run_len
    ln = np.full(runs, run_len, np.int32)
    exp = jk4(jnp.asarray(x), jnp.asarray(st), jnp.asarray(ln), group=fan,
              n_out=x.size, w=w, block_out=C)
    got = TK8.stream_merge_runs_plain(T(x), runs=runs, run_len=run_len,
                                      fan_in=fan, w=w, block_out=bo,
                                      out_slack=3)
    same(got[:x.size], exp, "K8 fan 32 vs JAX K4")
    assert bool(torch.isneginf(got[x.size:]).all())
    same(TT.merge_tree_runs_plain(T(x), T(st), T(ln), group=fan,
                                  n_out=x.size, w=w, block_out=C), exp,
         "K4 group 32")
    y = np.abs(_uniform(runs, run_len, nan=False))
    y = np.sort(y.reshape(runs, run_len), axis=1)[:, ::-1].ravel().copy()
    got = TK8.stream_merge_runs_plain(T(y), runs=runs, run_len=run_len,
                                      fan_in=fan, w=w, block_out=bo)
    xla, _ = jstream_pass(jnp.asarray(y), None, runs=runs, run_len=run_len,
                          fan_in=fan, executor="stream_xla", w=w,
                          block_out=bo, descending=True, interpret=True)
    same(got, xla, "K8 fan 32 vs stream_xla")
    same(got, -jnp.sort(-jnp.asarray(y)), "K8 fan 32 vs jnp.sort")


@pytest.mark.parametrize("w", [4, 256])
def test_k8_widths_match_jax(w):
    runs, run_len, fan = 8, 256, 4
    x = _uniform(runs, run_len)
    r = np.arange(x.size, dtype=np.int32)
    C = TK8._block(512, run_len, fan, w)
    st = jnp.arange(runs, dtype=jnp.int32) * run_len
    ln = jnp.full((runs,), run_len, jnp.int32)
    kw = dict(group=fan, n_out=x.size, w=w, block_out=C)
    same(TK8.stream_merge_runs_plain(T(x), runs=runs, run_len=run_len,
                                     fan_in=fan, w=w, block_out=512),
         jk4(jnp.asarray(x), st, ln, **kw), f"K8 w {w}")
    got = TK8.stream_merge_runs_kv_plain(T(x), T(r), runs=runs,
                                         run_len=run_len, fan_in=fan, w=w,
                                         block_out=512)
    exp = jk4kv(jnp.asarray(x), jnp.asarray(r), st, ln, **kw)
    same(got[0], exp[0], "K8kv keys")
    same(got[1], exp[1], "K8kv ranks")


def test_k9_at_w_256_matches_vmap():
    """``lane_merge_level`` at w 256 (and the ragged form) against
    ``jax.vmap(merge_lanes)`` over the level's pairs, tie b and skew, and
    KV."""
    P, L, w = 3, 300, 256
    buf = _uniform(2 * P, L)
    rk = np.arange(buf.size, dtype=np.int32)
    rows = jnp.asarray(buf.reshape(P, 2, L))
    for tie in ("b", "skew"):
        jf = jax.vmap(lambda y: JL.merge_lanes({"key": y[0]}, {"key": y[1]},
                                               w=w, tie=tie)["key"])
        got, _ = TL.lane_merge_level_plain(T(buf), None, L, w=w, tie=tie)
        same(got, jf(rows).reshape(-1), f"K9 {tie}")

    def jkv(y, ry):
        o = JL.merge_lanes({"key": y[0], "rank": ry[0]},
                           {"key": y[1], "rank": ry[1]}, w=w)
        return o["key"], o["rank"]
    jk, jr = jax.vmap(jkv)(rows, jnp.asarray(rk.reshape(P, 2, L)))
    got = TL.lane_merge_level_plain(T(buf), T(rk), L, w=w)
    same(got[0], jk.reshape(-1), "K9kv keys")
    same(got[1], jr.reshape(-1), "K9kv ranks")
    a, b = run(500), run(77)
    got = TL.lane_merge(T(a), T(b), *(torch.tensor([v], dtype=torch.int32)
                                      for v in (0, 500, 0, 77)),
                        n_out=577, w=w, tie="skew")
    same(got, JL.merge_lanes({"key": jnp.asarray(a)}, {"key": jnp.asarray(b)},
                             w=w, tie="skew")["key"], "K9 ragged")


# --------------------------------------------------------------------------
# narrow key dtypes
# --------------------------------------------------------------------------

NARROW = ["bfloat16", "float16", "int8", "int16", "uint8"]


def narrow_np(x, name):
    """float32 keys as dtype ``name``: floats by value with the NaN bits
    carried over (sign and payload), integers scaled onto the dtype's range
    with its min and max."""
    if name in ("bfloat16", "float16"):
        dt = jnp.bfloat16 if name == "bfloat16" else np.float16
        y = np.array(jnp.asarray(x).astype(dt))
        nan = np.isnan(x)
        b = x.view(np.int32)[nan]
        nb = ((b >> 16) | 1) if name == "bfloat16" else (
            ((b >> 16) & -0x8000) | 0x7C00 | ((b >> 13) & 0x3FF) | 1)
        y.view(np.int16)[nan] = nb.astype(np.int16)
        return y
    info = np.iinfo(name)
    with np.errstate(invalid="ignore"):      # the signalling NaNs
        y = np.nan_to_num(x * 40, nan=info.max, posinf=info.max,
                          neginf=info.min)
    return np.clip(np.round(y), info.min, info.max).astype(name)


def tt(x):
    """numpy (bfloat16 too) to torch."""
    if x.dtype == jnp.bfloat16:
        return T(x.view(np.int16)).view(torch.bfloat16)
    return T(x)


@pytest.mark.parametrize("name", NARROW)
def test_narrow_keys_match_jax(name):
    """K1 (both forms), K2 / K2kv, K3, K4, K5, K6 and K9 on keys of dtype
    ``name`` through the wrappers' CPU routes (widened as on the card)
    against the JAX kernels on the same keys; the bfloat16 NaNs come out as
    XLA leaves them, the quiet NaN of their sign."""
    x = narrow_np(fkeys(8 * 64), name).reshape(8, 64)
    r = np.arange(x.size, dtype=np.int32).reshape(8, 64)
    same(TB.sort_chunks(tt(x)), sort_chunks_pallas(jnp.asarray(x)), "K1")
    got = TB.sort_chunks_kv(tt(x), T(r), descending=False)
    exp = sort_chunks_kv_pallas(jnp.asarray(x), jnp.asarray(r),
                                descending=False)
    same(got[0], exp[0], "K1kv")
    same(got[1], exp[1], "K1kv ranks")
    a = narrow_np(run(700), name)
    b = narrow_np(run(300), name)
    ra, rb = np.arange(700, dtype=np.int32), np.arange(300, dtype=np.int32)
    same(TF.flims_merge(tt(a), tt(b), w=16, block_out=128),
         flims_merge_pallas(jnp.asarray(a), jnp.asarray(b), w=16,
                            block_out=128), "K2")
    got = TF.flims_merge_kv(tt(a), T(ra), tt(b), T(rb), w=8, block_out=64)
    exp = flims_merge_kv_pallas(jnp.asarray(a), jnp.asarray(ra),
                                jnp.asarray(b), jnp.asarray(rb), w=8,
                                block_out=64)
    same(got[0], exp[0], "K2kv")
    same(got[1], exp[1], "K2kv ranks")
    buf, st, ln = ragged([40, 0, 33, 100, 7, 64, 1, 90])
    buf = narrow_np(buf, name)
    n = int(ln.sum())
    same(TS.segmented_merge_runs(tt(buf), tt(buf), T(st[::2]), T(ln[::2]),
                                 T(st[1::2]), T(ln[1::2]), n_out=n, w=16,
                                 block_out=64),
         segmented_merge_runs(jnp.asarray(buf), jnp.asarray(buf),
                              jnp.asarray(st[::2]), jnp.asarray(ln[::2]),
                              jnp.asarray(st[1::2]), jnp.asarray(ln[1::2]),
                              n_out=n, w=16, block_out=64), "K3")
    same(TT.merge_tree_runs(tt(buf), T(st), T(ln), group=4, n_out=n, w=16,
                            block_out=64),
         jk4(jnp.asarray(buf), jnp.asarray(st), jnp.asarray(ln), group=4,
             n_out=n, w=16, block_out=64), "K4")
    v = narrow_np(fkeys(300), name)
    offs = np.array([0, 5, 5, 140, 141, 300], np.int32)
    same(TS.segment_sort(tt(v), T(offs), cap=256),
         segment_sort_pallas(jnp.asarray(v), jnp.asarray(offs), cap=256),
         "K5")
    got = TS.segment_sort_kv(tt(v), T(offs), cap=256, descending=False)
    exp = segment_sort_kv_pallas(jnp.asarray(v), jnp.asarray(offs), cap=256,
                                 descending=False)
    same(got[0], exp[0], "K6")
    same(got[1], exp[1], "K6 perm")
    lvl = narrow_np(_uniform(4, 64), name)
    rows = jnp.asarray(lvl.reshape(2, 2, 64))
    jf = jax.vmap(lambda y: JL.merge_lanes({"key": y[0]}, {"key": y[1]},
                                           w=16, tie="skew")["key"])
    same(TL.lane_merge_level(tt(lvl), None, 64, w=16, tie="skew")[0],
         jf(rows).reshape(-1), "K9")


@pytest.mark.parametrize("name", ["uint16", "uint32"])
def test_wide_unsigned_keys_match_jax(name):
    """uint16 / uint32 keys (torch holds them, its arithmetic on them is
    thin, so the widening is views and xors only) through K1 and K2."""
    info = np.iinfo(name)
    x = RNG.integers(0, int(info.max), 8 * 64, endpoint=True).astype(name)
    x[:4] = (info.min, info.max, info.max, info.min)
    x = x.reshape(8, 64)
    tx = T(x.view({2: np.int16, 4: np.int32}[x.itemsize])).view(
        getattr(torch, name))
    same(TB.sort_chunks(tx).view({2: torch.int16, 4: torch.int32}[
        x.itemsize]), sort_chunks_pallas(jnp.asarray(x)).view(
            {2: np.int16, 4: np.int32}[x.itemsize]), "K1")
    a = np.sort(x[:4].ravel())[::-1].copy()
    b = np.sort(x[4:].ravel())[::-1].copy()
    ta, tb = (T(v.view({2: np.int16, 4: np.int32}[v.itemsize])).view(
        getattr(torch, name)) for v in (a, b))
    got = TF.flims_merge(ta, tb, w=8, block_out=64)
    exp = np.asarray(flims_merge_pallas(jnp.asarray(a), jnp.asarray(b), w=8,
                                        block_out=64))
    assert got.dtype == getattr(torch, name)
    np.testing.assert_array_equal(
        got.view({2: torch.int16, 4: torch.int32}[x.itemsize]).numpy(),
        exp.view({2: np.int16, 4: np.int32}[x.itemsize]))


def test_widen_round_trips_every_dtype():
    """``widen`` is monotone onto int32 / float32 and sends each integer
    dtype's min and max to int32's; ``narrow`` undoes it bit for bit (a
    bfloat16 NaN comes back as the quiet NaN of its sign)."""
    for dt in (torch.int8, torch.uint8, torch.int16, torch.uint16):
        info = torch.iinfo(dt)
        x = torch.arange(info.min, info.max + 1).to(dt)
        w = _build.widen(x)
        assert w.dtype == torch.int32 and bool((w[1:] > w[:-1]).all())
        assert (int(w[0]), int(w[-1])) == (-2 ** 31, 2 ** 31 - 1)
        assert torch.equal(_build.narrow(w, dt), x)
    b = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16)
    for dt in (torch.float16, torch.bfloat16):
        x = b.view(dt)
        w = _build.widen(x)
        nan = torch.isnan(x)
        assert w.dtype == torch.float32
        assert torch.equal(torch.isnan(w), nan)
        assert torch.equal(w[~nan], x[~nan].float())
        back = _build.narrow(w, dt).view(torch.int16)
        assert torch.equal(back[~nan], b[~nan])
        if dt == torch.float16:
            assert torch.equal(back, b)
        else:
            assert torch.equal(back[nan], (b[nan] & -0x8000) | 0x7FC0)


# --------------------------------------------------------------------------
# K5 / K6 past one CTA: the card's route
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kv,cap", [(False, 2 * TS.MAX_CAP),
                                    (True, 2 * TS.MAX_CAP_KV)])
def test_wide_segment_route_matches_jax(kv, cap):
    """The plain twin of K5 / K6's route past one CTA (each segment over
    ``next_pow2(len)`` lanes, its whole cap where it holds a NaN) against
    the JAX kernels, which pad every segment to the cap, on segments holding
    NaNs, dense in +-0, and of edge lengths around the CTA's width."""
    lens = [3, 0, TS.MAX_CAP_KV + 1, 257, cap // 2 - 1]
    v = RNG.choice(np.array([0.0, -0.0, 1.0, -1.0, 2.0], np.float32),
                   sum(lens)).astype(np.float32)
    off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    for s in (0, 3):                     # NaNs in two segments only
        seg = v[off[s]:off[s + 1]]
        seg.view(np.int32)[::7] = SNAN
        seg.view(np.int32)[1::11] = NNAN
    if not kv:
        got = TS.segment_widths_plain(T(v), T(off), cap)
        same(got, segment_sort_pallas(jnp.asarray(v), jnp.asarray(off),
                                      cap=cap), "K5 route")
        same(got, TS.segment_sort_plain(T(v), T(off), cap=cap), "K5 plain")
        return
    for d in (True, False):
        got = TS.segment_widths_plain(T(v), T(off), cap, kv=True,
                                      descending=d)
        exp = segment_sort_kv_pallas(jnp.asarray(v), jnp.asarray(off),
                                     cap=cap, descending=d)
        same(got[0], exp[0], f"K6 route desc={d}")
        same(got[1], exp[1], f"K6 route perm desc={d}")
