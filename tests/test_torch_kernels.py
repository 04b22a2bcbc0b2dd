"""Parity of the port's kernels with the JAX package's Pallas kernels.

On the CPU every wrapper of ``repro_torch.kernels`` runs its plain version;
the Pallas kernels run in interpret mode, as ``tests/test_kernels.py`` runs
them. The same numpy inputs, made from a seeded generator, go through both:
K1/K1kv (bitonic chunk sort), K2/K2kv (partitioned FLiMS merge), K3/K3kv
(segmented run-pair merge), K4/K4kv (fused merge tree) and the
``kernel_sort`` / ``kernel_argsort`` sorters built from them. Inputs carry
heavy ties, +0.0/-0.0, -inf and INT32_MIN keys, empty and one-sided runs and
``w`` larger than a run.

Tolerance: exact. Keys and ranks are equal bit for bit; float keys are
compared as int32 bit patterns, so +0.0 and -0.0 differ.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import bitonic_sort as JB  # noqa: E402
from repro.kernels import flims_merge as JF  # noqa: E402
from repro.kernels import merge_tree as JT  # noqa: E402
from repro.kernels import ops as JO  # noqa: E402
from repro.kernels import segmented_merge as JS  # noqa: E402
from repro_torch.kernels import bitonic_sort as TB  # noqa: E402
from repro_torch.kernels import flims_merge as TF  # noqa: E402
from repro_torch.kernels import merge_tree as TT  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.kernels import segmented_merge as TS  # noqa: E402

RNG = np.random.default_rng(23)
FPOOL = np.array([0.0, -0.0, 1.5, -1.0, -np.inf, 4.0], np.float32)
IPOOL = np.array([np.iinfo(np.int32).min, -7, 0, 3, 3, 9], np.int32)


def same(j, t):
    """Bit-for-bit equality of a JAX result and a torch result."""
    j = np.asarray(j)
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert j.shape == t.shape and j.dtype == t.dtype, \
        (j.shape, t.shape, j.dtype, t.dtype)
    if j.dtype == np.float32:
        j, t = j.view(np.int32), t.view(np.int32)
    np.testing.assert_array_equal(j, t)


def keys(n, dtype=np.float32):
    return RNG.choice(FPOOL if dtype == np.float32 else IPOOL, n).astype(dtype)


def run(n, dtype=np.float32, descending=True):
    x = np.sort(keys(n, dtype))
    return (x[::-1] if descending else x).copy()


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def ragged(lens, dtype=np.float32, descending=True):
    buf = np.concatenate([run(n, dtype, descending) for n in lens]
                         + [np.zeros(0, dtype)])
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    return buf, offs[:-1].copy(), np.diff(offs).astype(np.int32)


# --------------------------------------------------------------------------
# K1
# --------------------------------------------------------------------------

# (m, c) of K1 / K1kv: single-key rows, rows within one thread of the CUDA
# kernel (8), a warp tile of several rows (64), a row wider than a warp (512)
K1_SHAPES = [(8, 64), (3, 1), (5, 8), (2, 512)]


@pytest.mark.parametrize("m,c", K1_SHAPES)
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_k1_sort_chunks(dtype, m, c):
    x = keys(m * c, dtype).reshape(m, c)
    same(JB.sort_chunks_pallas(jnp.array(x)), TB.sort_chunks(T(x)))


@pytest.mark.parametrize("m,c", [(4, 32), (3, 1), (2, 512)])
@pytest.mark.parametrize("descending", [True, False])
def test_k1kv_sort_chunks_kv(descending, m, c):
    k = keys(m * c).reshape(m, c)
    r = np.arange(k.size, dtype=np.int32).reshape(m, c)
    r[:, -c // 4:] = np.iinfo(np.int32).max      # padding ranks repeat
    jk, jr = JB.sort_chunks_kv_pallas(jnp.array(k), jnp.array(r),
                                      descending=descending)
    tk, tr = TB.sort_chunks_kv(T(k), T(r), descending=descending)
    same(jk, tk)
    same(jr, tr)


# NaNs of differing payloads (quiet, negative, signalling), +0.0, -0.0,
# -inf: a NaN operand of XLA's max / min wins both outputs, so which keys
# survive depends on the network
NAN_PAYLOADS = np.array([0x7fc00000, 0xffc12345, 0x7fc00001, 0x7fa00000],
                        np.uint32).view(np.float32)
NAN_ROW_KEYS = np.array([0.0, -0.0, -np.inf, 1.0, -2.5], np.float32)


def nan_keys(n, payloads):
    """float32 keys over ``NAN_ROW_KEYS`` and the first ``payloads`` NaN
    patterns, each as likely as any key."""
    pool = np.concatenate([NAN_PAYLOADS[:payloads], NAN_ROW_KEYS])
    return RNG.choice(pool, n).astype(np.float32)


@pytest.mark.parametrize("payloads", [1, 4])
def test_k1_nan_payloads_match_jax(payloads):
    """K1's plain version against the JAX kernel (interpret mode) on rows
    holding NaNs of one or four payloads, +0.0, -0.0 and -inf, bit for bit:
    where XLA's max / min meets two NaNs, ``xla_max`` / ``xla_min`` keep
    the payload XLA keeps (the first operand's sign bit decides)."""
    x = nan_keys(4 * 64, payloads).reshape(4, 64)
    same(JB.sort_chunks_pallas(jnp.array(x)), TB.sort_chunks(T(x)))


# --------------------------------------------------------------------------
# K2
# --------------------------------------------------------------------------

MERGE_CASES = [(np.int32, 8, 0, 10, 64), (np.float32, 8, 1, 1, 64),
               (np.float32, 32, 300, 200, 128), (np.int32, 32, 5, 3, 1024),
               (np.float32, 128, 500, 400, 256)]


@pytest.mark.parametrize("dtype,w,nA,nB,bo", MERGE_CASES)
def test_k2_flims_merge(dtype, w, nA, nB, bo):
    a, b = run(nA, dtype), run(nB, dtype)
    same(JF.flims_merge_pallas(jnp.array(a), jnp.array(b), w=w, block_out=bo),
         TF.flims_merge(T(a), T(b), w=w, block_out=bo))


@pytest.mark.parametrize("descending", [True, False])
@pytest.mark.parametrize("w,nA,nB", [(8, 130, 77), (32, 4, 9)])
def test_k2kv_flims_merge_kv(descending, w, nA, nB):
    a, b = run(nA, descending=descending), run(nB, descending=descending)
    ra = np.arange(nA, dtype=np.int32)
    rb = nA + np.arange(nB, dtype=np.int32)
    jk, jr = JF.flims_merge_kv_pallas(jnp.array(a), jnp.array(ra),
                                      jnp.array(b), jnp.array(rb), w=w,
                                      block_out=64, descending=descending)
    tk, tr = TF.flims_merge_kv(T(a), T(ra), T(b), T(rb), w=w, block_out=64,
                               descending=descending)
    same(jk, tk)
    same(jr, tr)


# --------------------------------------------------------------------------
# K3
# --------------------------------------------------------------------------

PAIR_LENS = [5, 0, 33, 7, 0, 0, 90, 4, 17, 1]   # empty and one-sided pairs


def _pairs(st, ln, conv):
    return (conv(st[0::2]), conv(ln[0::2]), conv(st[1::2]), conv(ln[1::2]))


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("w,bo", [(8, 16), (32, 64)])
def test_k3_segmented_merge_runs(dtype, w, bo):
    buf, st, ln = ragged(PAIR_LENS, dtype)
    n = buf.shape[0]
    jo = JS.segmented_merge_runs(jnp.array(buf), jnp.array(buf),
                                 *_pairs(st, ln, jnp.array), n_out=n, w=w,
                                 block_out=bo)
    to = TS.segmented_merge_runs(T(buf), T(buf), *_pairs(st, ln, T), n_out=n,
                                 w=w, block_out=bo)
    same(jo, to)


@pytest.mark.parametrize("descending", [True, False])
def test_k3kv_segmented_merge_runs_kv(descending):
    buf, st, ln = ragged(PAIR_LENS, descending=descending)
    n = buf.shape[0]
    rk = np.arange(n, dtype=np.int32)
    jk, jr = JS.segmented_merge_runs_kv(
        jnp.array(buf), jnp.array(rk), jnp.array(buf), jnp.array(rk),
        *_pairs(st, ln, jnp.array), n_out=n, w=8, block_out=32,
        descending=descending)
    tk, tr = TS.segmented_merge_runs_kv(T(buf), T(rk), T(buf), T(rk),
                                        *_pairs(st, ln, T), n_out=n, w=8,
                                        block_out=32, descending=descending)
    same(jk, tk)
    same(jr, tr)


# NaN runs: the co-rank predicate is not monotone there, so only the binary
# search's own sequence of probes gives its answer
NAN_POOL = np.array([np.nan, 0.0, -0.0, 1.5, -1.0, -np.inf, 4.0], np.float32)


@pytest.mark.parametrize("kv,descending", [(False, True), (True, True),
                                           (True, False)])
def test_k23_corank_rounds_match_jax(kv, descending):
    """The card's co-rank search (``corank_rounds``, five binary-search
    steps a round over a warp) against JAX ``_corank_runs`` /
    ``_corank_runs_kv`` at every C-wide block of ragged run pairs holding
    NaNs, +0.0/-0.0 and empty runs, at the step count of the output size."""
    import jax
    lens = PAIR_LENS + [64, 3, 0, 40]
    runs = []
    for n in lens:
        x = np.sort(RNG.choice(NAN_POOL, n).astype(np.float32))
        runs.append(x[::-1].copy() if descending else x)
    buf = np.concatenate(runs)
    offs = np.concatenate([[0], np.cumsum(lens)])
    rk = np.arange(buf.shape[0], dtype=np.int32)
    n_out, C = buf.shape[0], 16
    steps = TF.search_steps(n_out)
    wins = TF.wins_fn(kv, descending)
    tb, tr = T(buf), T(rk) if kv else None
    if kv:
        ref = jax.jit(lambda *a: JS._corank_runs_kv(*a, steps, descending))
    else:
        ref = jax.jit(lambda *a: JS._corank_runs(*a, steps))
    checked = 0
    for s in range(0, len(lens), 2):
        la, lb = lens[s], lens[s + 1]
        sa, sb = int(offs[s]), int(offs[s + 1])
        for o in range(0, la + lb, C):
            def pred(m):
                x = TF.run_elem(tb, tr, torch.tensor(sa), torch.tensor(la),
                                torch.tensor(m - 1), descending)
                y = TF.run_elem(tb, tr, torch.tensor(sb), torch.tensor(lb),
                                torch.tensor(o - m), descending)
                return bool(wins(x, y))
            got = TF.corank_rounds(pred, max(0, o - lb), min(o, la), steps)
            args = (o, la, lb, sa, sb, jnp.array(buf))
            args += (jnp.array(rk), jnp.array(buf), jnp.array(rk)) if kv \
                else (jnp.array(buf),)
            assert got == int(ref(*args)), (s, o)
            checked += 1
    assert checked > 10


# --------------------------------------------------------------------------
# K4
# --------------------------------------------------------------------------

TREE_LENS = [5, 0, 33, 7, 0, 0, 90, 4]


@pytest.mark.parametrize("group,w,bo", [(4, 8, 32), (2, 32, 64)])
def test_k4_merge_tree_runs(group, w, bo):
    buf, st, ln = ragged(TREE_LENS)
    n = buf.shape[0]
    same(JT.merge_tree_runs(jnp.array(buf), jnp.array(st), jnp.array(ln),
                            group=group, n_out=n, w=w, block_out=bo),
         TT.merge_tree_runs(T(buf), T(st), T(ln), group=group, n_out=n, w=w,
                            block_out=bo))


@pytest.mark.parametrize("group,descending", [(4, True), (4, False),
                                              (8, False)])
def test_k4kv_merge_tree_runs_kv(group, descending):
    buf, st, ln = ragged(TREE_LENS, descending=descending)
    n = buf.shape[0]
    rk = np.arange(n, dtype=np.int32)
    jk, jr = JT.merge_tree_runs_kv(jnp.array(buf), jnp.array(rk),
                                   jnp.array(st), jnp.array(ln), group=group,
                                   n_out=n, w=8, block_out=32,
                                   descending=descending)
    tk, tr = TT.merge_tree_runs_kv(T(buf), T(rk), T(st), T(ln), group=group,
                                   n_out=n, w=8, block_out=32,
                                   descending=descending)
    same(jk, tk)
    same(jr, tr)


# --------------------------------------------------------------------------
# the sorters
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,descending", [(np.int32, True),
                                              (np.float32, False)])
def test_kernel_sort(dtype, descending):
    """Eight 32-key chunks: one 2-level (K4) and one 1-level (K3) pass."""
    x = keys(250, dtype)
    same(JO.kernel_sort(jnp.array(x), chunk=32, w=8, descending=descending),
         TO.kernel_sort(T(x), chunk=32, w=8, descending=descending))


@pytest.mark.parametrize("descending", [True, False])
def test_kernel_argsort(descending):
    """Four 32-key chunks: one fused 2-level KV pass."""
    x = keys(120)
    same(JO.kernel_argsort(jnp.array(x), chunk=32, w=8,
                           descending=descending),
         TO.kernel_argsort(T(x), chunk=32, w=8, descending=descending))


@pytest.mark.parametrize("descending", [True, False])
def test_all_equal_keys(descending):
    """Every key equal: ranks alone order the KV merges and sorts, and the
    key-only selector takes every tie from B."""
    a, b = np.full(70, 3.0, np.float32), np.full(45, 3.0, np.float32)
    ra, rb = np.arange(70, dtype=np.int32), 70 + np.arange(45, dtype=np.int32)
    jk, jr = JF.flims_merge_kv_pallas(jnp.array(a), jnp.array(ra),
                                      jnp.array(b), jnp.array(rb), w=8,
                                      block_out=32, descending=descending)
    tk, tr = TF.flims_merge_kv(T(a), T(ra), T(b), T(rb), w=8, block_out=32,
                               descending=descending)
    same(jk, tk)
    same(jr, tr)
    buf = np.full(100, -5, np.int32)
    st = np.array([0, 10, 10, 55], np.int32)
    ln = np.array([10, 0, 45, 45], np.int32)
    rk = np.arange(100, dtype=np.int32)
    jk, jr = JT.merge_tree_runs_kv(jnp.array(buf), jnp.array(rk),
                                   jnp.array(st), jnp.array(ln), group=4,
                                   n_out=100, w=8, block_out=32,
                                   descending=descending)
    tk, tr = TT.merge_tree_runs_kv(T(buf), T(rk), T(st), T(ln), group=4,
                                   n_out=100, w=8, block_out=32,
                                   descending=descending)
    same(jk, tk)
    same(jr, tr)
