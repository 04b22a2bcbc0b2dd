"""The port's CUDA kernels against their plain versions, on a card.

Each wrapper of ``repro_torch.kernels`` launches its CUDA kernel for a CUDA
tensor and its ``*_plain`` twin runs the plain PyTorch version; these tests
hold the two equal on small inputs with heavy ties, +0.0/-0.0 and -inf,
empty and one-sided runs. They need an NVIDIA GPU (the kernels have no CPU
mode) and skip without one; this file imports neither JAX nor the JAX
package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance: exact; float keys are compared as int32 bit patterns. The one
exception is K7's weights lane, held to ``ROUTE_WEIGHT_ULPS`` = 8 ulps of
float32 against ``torch.softmax`` on the card: both compute exp(v - max) /
sum, with CUDA's ``expf`` (within 2 ulps of exp) on one side and torch's
exp and its own order of the k-term sum on the other.
"""
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import bitonic_sort as TB  # noqa: E402
from repro_torch.kernels import flims_merge as TF  # noqa: E402
from repro_torch.kernels import lane_merge as TL  # noqa: E402
from repro_torch.kernels import merge_tree as TT  # noqa: E402
from repro_torch.kernels import route_fuse as TR  # noqa: E402
from repro_torch.kernels import segmented_merge as TS  # noqa: E402
from repro_torch.kernels import stream_merge as TK8  # noqa: E402

RNG = np.random.default_rng(29)
FPOOL = np.array([0.0, -0.0, 1.5, -1.0, -np.inf, 4.0], np.float32)
PAIR_LENS = [5, 0, 33, 7, 0, 0, 90, 4, 17, 1]   # empty and one-sided pairs
SEG_LENS = [5, 0, 33, 7, 0, 0, 90, 4, 17, 1, 256]
ROUTE_WEIGHT_ULPS = 8
TREE_LENS = [5, 0, 33, 7, 0, 0, 90, 4]


def keys(n):
    return RNG.choice(FPOOL, n).astype(np.float32)


def run(n, descending=True):
    x = np.sort(keys(n))
    return (x[::-1] if descending else x).copy()


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def ragged(lens, descending=True):
    buf = np.concatenate([run(n, descending) for n in lens])
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    return buf, offs[:-1].copy(), np.diff(offs).astype(np.int32)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _bits(t):
    if t.dtype in (torch.float16, torch.bfloat16):
        return t.view(torch.int16)
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same_on_card(fn, *args, **kw):
    plain = getattr(sys.modules[fn.__module__], fn.__name__ + "_plain")
    got = fn(*args, **kw)
    kw.pop("_ctas", None)      # the plain version has no CTAs
    exp = plain(*args, **kw)
    got = got if isinstance(got, tuple) else (got,)
    exp = exp if isinstance(exp, tuple) else (exp,)
    for g, e in zip(got, exp):
        if g is None or e is None:       # a form without its rank lane
            assert g is None and e is None
            continue
        assert g.shape == e.shape and g.dtype == e.dtype
        bad = (_bits(g) != _bits(e)).flatten().nonzero()
        assert not bad.numel(), (
            f"{fn.__name__} {kw}: {bad.shape[0]} of {tuple(g.shape)} differ, "
            f"first at {int(bad[0, 0])}: {g.flatten()[int(bad[0, 0])].item()}"
            f" vs {e.flatten()[int(bad[0, 0])].item()}")


@pytest.mark.cuda
@pytest.mark.parametrize("descending", [True, False])
def test_cuda_kernels_match_plain(card, descending):
    x = T(keys(64 * 128)).to(card)
    r = torch.arange(x.numel(), dtype=torch.int32, device=card)
    if descending:
        _same_on_card(TB.sort_chunks, x.reshape(64, 128))
        _same_on_card(TB.sort_chunks, r.reshape(16, 512) % 37)
    _same_on_card(TB.sort_chunks_kv, x.reshape(64, 128),
                  r.reshape(64, 128), descending=descending)
    a = T(run(3000, descending=descending)).to(card)
    b = T(run(1000, descending=descending)).to(card)
    ra = torch.arange(3000, dtype=torch.int32, device=card)
    rb = 3000 + torch.arange(1000, dtype=torch.int32, device=card)
    for w in (8, 128):
        if descending:
            _same_on_card(TF.flims_merge, a, b, w=w, block_out=512)
        _same_on_card(TF.flims_merge_kv, a, ra, b, rb, w=w, block_out=512,
                      descending=descending)
    buf, st, ln = (T(v).to(card) for v in ragged(PAIR_LENS * 20,
                                                 descending=descending))
    rk = torch.arange(buf.numel(), dtype=torch.int32, device=card)
    pairs = tuple(t.contiguous() for t in (st[0::2], ln[0::2], st[1::2],
                                           ln[1::2]))
    if descending:
        _same_on_card(TS.segmented_merge_runs, buf, buf, *pairs,
                      n_out=buf.numel(), w=32, block_out=256)
    _same_on_card(TS.segmented_merge_runs_kv, buf, rk, buf, rk, *pairs,
                  n_out=buf.numel(), w=32, block_out=256,
                  descending=descending)
    for group in (2, 4, 8):
        buf, st, ln = (T(v).to(card) for v in ragged(TREE_LENS * 4,
                                                     descending=descending))
        rk = torch.arange(buf.numel(), dtype=torch.int32, device=card)
        if descending:
            _same_on_card(TT.merge_tree_runs, buf, st, ln, group=group,
                          n_out=buf.numel(), w=32, block_out=256)
        _same_on_card(TT.merge_tree_runs_kv, buf, rk, st, ln, group=group,
                      n_out=buf.numel(), w=32, block_out=256,
                      descending=descending)


MERGE_NAN_POOL = np.array([np.nan, 0.0, -0.0, 1.5, -1.0, -np.inf, 4.0, 4.0],
                          np.float32)


def nan_run(n, descending=True):
    """A run of ``n`` keys with NaNs of two payloads, +0.0/-0.0 and ties,
    sorted by numpy (NaNs at the descending run's head)."""
    x = RNG.choice(MERGE_NAN_POOL, n).astype(np.float32)
    x.view(np.int32)[RNG.random(n) < 0.1] = np.int32(-4194304)  # -NaN
    x = np.sort(x)
    return (x[::-1] if descending else x).copy()


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1 << i for i in range(11)])
def test_merge_blocks_match_plain(card, w):
    """K2 / K2kv / K3 / K3kv against their plain versions at every w the
    wrappers take (1 to 1024: a partial warp below 32, w / 32 lanes a
    thread above), under forced CTA counts (1, 7, the card's own): runs
    holding NaNs of two payloads and +0.0/-0.0; ragged pairs with empty and
    one-sided runs at starts off 16 bytes; the output whole and cut below
    the pairs' total; KV both ways."""
    bo = 16 * w
    for d in (True, False):
        a = T(nan_run(3001, d)).to(card)
        b = T(nan_run(1003, d)).to(card)
        ra = torch.arange(3001, dtype=torch.int32, device=card)
        rb = 3001 + torch.arange(1003, dtype=torch.int32, device=card)
        lens = (PAIR_LENS + [2 * bo + 5, 3, 0, bo - 1]) * 6
        parts = [nan_run(n, d) for n in lens]
        buf = T(np.concatenate(parts)).to(card)
        offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
        st, ln = T(offs[:-1].copy()).to(card), T(np.array(lens, np.int32)).to(card)
        pairs = tuple(t.contiguous() for t in (st[0::2], ln[0::2], st[1::2],
                                               ln[1::2]))
        rk = torch.arange(buf.numel(), dtype=torch.int32, device=card)
        n = buf.numel()
        for ctas in (1, 7, 0):
            if d:
                _same_on_card(TF.flims_merge, a, b, w=w, block_out=bo,
                              _ctas=ctas)
            _same_on_card(TF.flims_merge_kv, a, ra, b, rb, w=w, block_out=bo,
                          descending=d, _ctas=ctas)
            for n_out in (n, 3 * n // 4):
                if d:
                    _same_on_card(TS.segmented_merge_runs, buf, buf, *pairs,
                                  n_out=n_out, w=w, block_out=bo, _ctas=ctas)
                _same_on_card(TS.segmented_merge_runs_kv, buf, rk, buf, rk,
                              *pairs, n_out=n_out, w=w, block_out=bo,
                              descending=d, _ctas=ctas)


# K1 / K1kv: widths from one key a row (a row within one thread) through
# one warp's 256 to 16384 (one CTA of 1024 threads, stages at d >= 256 in
# shared memory); row counts that leave the last CTA's warps partly idle
K1_WIDTHS = [1, 2, 32, 64, 128, 256, 512, 1024, 4096, 16384]
K1_ROWS = [1, 3, 4099]
K1_NAN_POOL = np.array([np.nan, -np.nan, 0.0, -0.0, -np.inf, 1.0, -1.0],
                       np.float32)
K1_INT_POOL = np.array([np.iinfo(np.int32).min, -7, 0, 3, 3, 9,
                        np.iinfo(np.int32).max], np.int32)


def k1_keys(n, dtype, kind, device):
    """Duplicate-heavy keys (float: +0.0, -0.0, -inf among them), float rows
    holding +NaN and -NaN besides, or random int32."""
    if kind == "random":
        x = RNG.integers(-2 ** 31, 2 ** 31 - 1, n, dtype=np.int64)
        return torch.from_numpy(x.astype(np.int32)).to(device)
    pool = {"dup": FPOOL if dtype == torch.float32 else K1_INT_POOL,
            "nan": K1_NAN_POOL}[kind]
    return torch.from_numpy(RNG.choice(pool, n)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("c", K1_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_k1_matches_plain(card, dtype, c):
    """K1 and K1kv (both directions) against their plain versions bit for
    bit at every width and row count, on duplicate-heavy keys, float rows
    holding NaNs, +0.0, -0.0 and -inf (the exact path), and ranks that
    repeat INVALID_RANK as padding does."""
    kinds = ("dup", "nan") if dtype == torch.float32 else ("dup", "random")
    for m in K1_ROWS:
        r = torch.arange(m * c, dtype=torch.int32, device=card).reshape(m, c)
        r = torch.where(r % 7 == 3, torch.iinfo(torch.int32).max, r)
        for kind in kinds:
            k = k1_keys(m * c, dtype, kind, card).reshape(m, c)
            _same_on_card(TB.sort_chunks, k)
            for d in (True, False):
                _same_on_card(TB.sort_chunks_kv, k, r, descending=d)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [2 * TB.ROW_TILE, 4 * TB.ROW_TILE])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_k1_rows_past_tile_match_plain(card, dtype, c):
    """K1 / K1kv at rows wider than one CTA's tile (32768 and 65536 keys:
    tiles of 16384 in shared memory, the wider stages over device memory)
    against their plain versions bit for bit, on duplicate-heavy rows and
    rows holding NaNs of two payloads, +0.0 and -0.0; one row and three."""
    kinds = ("dup", "nan") if dtype == torch.float32 else ("dup", "random")
    for m in (1, 3):
        r = torch.arange(m * c, dtype=torch.int32, device=card).reshape(m, c)
        r = torch.where(r % 7 == 3, torch.iinfo(torch.int32).max, r)
        for kind in kinds:
            k = k1_keys(m * c, dtype, kind, card).reshape(m, c)
            _same_on_card(TB.sort_chunks, k)
            for d in (True, False):
                _same_on_card(TB.sort_chunks_kv, k, r, descending=d)


# (run lengths, group, w, block_out) of K4 under forced CTA counts: runs at
# starts off 16 bytes (after the 5-key run) and on them (the 4096-key runs
# at multiples of 4 keys), partial last rows, empty runs and an empty group;
# w 8, 32 and 128 (one, one and four lanes a thread); L 2 and 3
K4_SPANS = [
    ([5, 0, 33, 7, 0, 0, 0, 0, 900, 4, 170, 1, 300, 301, 299, 3] * 2, 4, 32,
     64),
    ([5, 0, 330, 7, 0, 0, 90, 4] + [0] * 8 + [640, 1, 0, 400, 3, 3, 9, 1000],
     8, 8, 32),
    ([4096, 2048, 3, 0, 0, 517, 1000, 999] * 2, 8, 128, 256),
    ([4096, 0, 1, 2000, 7, 7, 7, 7], 4, 128, 512),
]


@pytest.mark.cuda
@pytest.mark.parametrize("geom", K4_SPANS)
def test_merge_tree_spans_match_plain(card, geom):
    """K4 / K4kv against one plain result each under forced CTA counts (one
    CTA taking every group in turn, 2, 7, and the card's own count): key-only
    and KV both directions, the output whole and cut below the group total
    (``n_out``), the buffers at their allocation and one key into it (every
    start off 16 bytes: no row goes by bulk copy)."""
    lens, group, w, bo = geom
    for descending in (True, False):
        buf, st, ln = (T(v).to(card) for v in ragged(lens, descending))
        n = buf.numel()
        rk = torch.arange(n, dtype=torch.int32, device=card)
        shifted = [torch.cat([x.new_zeros(1), x])[1:] for x in (buf, rk)]
        assert shifted[0].data_ptr() % 16 and torch.equal(shifted[1], rk)
        for n_out in (n, n - n // 3):
            kw = dict(group=group, n_out=n_out, w=w, block_out=bo)
            cases = [(TT.merge_tree_runs_kv, (buf, rk),
                      dict(kw, descending=descending))]
            if descending:
                cases.append((TT.merge_tree_runs, (buf,), kw))
            for fn, args, ckw in cases:
                plain = getattr(TT, fn.__name__ + "_plain")(*args, st, ln,
                                                            **ckw)
                plain = plain if isinstance(plain, tuple) else (plain,)
                for xs in (args, shifted[:len(args)]):
                    for ctas in (1, 2, 7, 0):
                        got = fn(*xs, st, ln, _ctas=ctas, **ckw)
                        got = got if isinstance(got, tuple) else (got,)
                        for g, e in zip(got, plain):
                            assert torch.equal(_bits(g), _bits(e)), (
                                fn.__name__, n_out, ctas)


@pytest.mark.cuda
@pytest.mark.parametrize("w,lens", [(128, [300, 0, 129, 77] * 8),
                                    (32, [40, 3, 0, 1] * 16)])
def test_k4_nan_rows_match_plain(card, w, lens):
    """Key-only float lanes travel K4's tree as monotone integers, and a
    node that reads a row holding a NaN runs the float selection and
    butterfly: runs holding +NaN, -NaN, +0.0, -0.0 and -inf against the
    plain version bit for bit, under forced CTA counts. One output block a
    group, so no partition (its order is not a total one with NaNs)."""
    pool = np.array([np.nan, -np.nan, 0.0, -0.0, 1.0, -1.0, -np.inf],
                    np.float32)
    buf = np.concatenate([np.sort(RNG.choice(pool, n))[::-1] for n in lens])
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    buf, st, ln = (T(v).to(card) for v in (buf.astype(np.float32),
                                            offs[:-1].copy(),
                                            np.diff(offs).astype(np.int32)))
    kw = dict(group=4, n_out=buf.numel(), w=w, block_out=1024)
    plain = TT.merge_tree_runs_plain(buf, st, ln, **kw)
    for ctas in (1, 7, 0):
        got = TT.merge_tree_runs(buf, st, ln, _ctas=ctas, **kw)
        assert torch.equal(_bits(got), _bits(plain)), ctas


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [False, True])
def test_k4_k8_nan_groups_match_plain(card, kv):
    """Groups holding a NaN, cut into many output blocks: the streamed
    trees' partition and their restarts assume an order, which NaNs break
    (on such runs the fast K4 wrote other bits, or read out of bounds), so
    K4 and K8 leave those groups to the wide form (the JAX kernel's
    per-block partition and dataflow) and stream the rest; every group
    against the plain version, under forced CTA counts (KV lanes
    ascending, on runs sorted so)."""
    from repro_torch.kernels import launch_counts, reset_launches
    lens = [64, 0, 33, 300, 1, 128, 7, 190, 5, 64, 0, 0, 257, 3, 64, 40] * 2
    desc = not kv
    # NaNs in every other run of 4: groups of 2 and 4 with and without them
    buf = T(np.concatenate([nan_run(n, desc) if i % 8 < 4 else run(n, desc)
                            for i, n in enumerate(lens)])).to(card)
    off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    st, ln = T(off[:-1]).to(card), T(np.diff(off).astype(np.int32)).to(card)
    rk = torch.arange(buf.numel(), dtype=torch.int32, device=card)
    for group, w, bo in ((2, 32, 256), (4, 32, 256), (8, 8, 128),
                         (4, 128, 512)):
        for ctas in (1, 0):
            reset_launches()
            if kv:
                _same_on_card(TT.merge_tree_runs_kv, buf, rk, st, ln,
                              group=group, n_out=buf.numel() - 3, w=w,
                              block_out=bo, descending=False, _ctas=ctas)
            else:
                _same_on_card(TT.merge_tree_runs, buf, st, ln, group=group,
                              n_out=buf.numel(), w=w, block_out=bo,
                              _ctas=ctas)
            assert sum(launch_counts().values()) == 1
    k = np.concatenate([nan_run(512, desc) if i % 8 < 4 else run(512, desc)
                        for i in range(16)])
    kw = dict(runs=16, run_len=512, fan_in=4, w=32, block_out=256)
    for ctas in (3, 0):
        if kv:
            _same_on_card(TK8.stream_merge_runs_kv, T(k).to(card),
                          torch.arange(k.size, dtype=torch.int32,
                                       device=card), descending=False,
                          _ctas=ctas, **kw)
        else:
            _same_on_card(TK8.stream_merge_runs, T(k).to(card), out_slack=3,
                          _ctas=ctas, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [False, True])
def test_k4_k8_unsorted_runs_match_plain(card, kv):
    """Runs not sorted in the call's order (int16 keys, the dtype's min and
    max among them, one sorted run in each group of four but the last):
    the streamed trees would read past a run on such input, so the check
    in the same call hands their groups to the wide form; every group
    against the plain version, which gives the JAX kernel's bits (CPU test
    ``test_k4_k8_unsorted_int16_runs_match_jax``), one launch a call."""
    from repro_torch.kernels import launch_counts, reset_launches
    runs, run_len = 16, 512
    info = np.iinfo(np.int16)
    rng = np.random.default_rng(5)
    x = rng.integers(info.min, info.max, runs * run_len, endpoint=True,
                     dtype=np.int16)
    x[:4] = (info.min, info.max, info.min, info.max)
    for r in range(runs):
        if r % 4 == 0 or r >= 12:       # the last group sorted throughout
            seg = x[r * run_len:(r + 1) * run_len]
            seg[:] = np.sort(seg)[::-1] if not kv else np.sort(seg)
    k = T(x).to(card)
    rk = torch.arange(k.numel(), dtype=torch.int32, device=card)
    st = torch.arange(runs, dtype=torch.int32, device=card) * run_len
    ln = torch.full((runs,), run_len, dtype=torch.int32, device=card)
    for group, w, bo in ((4, 32, 256), (2, 128, 512), (8, 8, 128)):
        for ctas in (1, 0):
            reset_launches()
            if kv:
                _same_on_card(TT.merge_tree_runs_kv, k, rk, st, ln,
                              group=group, n_out=k.numel(), w=w,
                              block_out=bo, descending=False, _ctas=ctas)
            else:
                _same_on_card(TT.merge_tree_runs, k, st, ln, group=group,
                              n_out=k.numel(), w=w, block_out=bo,
                              _ctas=ctas)
            assert sum(launch_counts().values()) == 1
    kw = dict(runs=runs, run_len=run_len, fan_in=4, w=32, block_out=256)
    for ctas in (3, 0):
        if kv:
            _same_on_card(TK8.stream_merge_runs_kv, k, rk, descending=False,
                          _ctas=ctas, **kw)
        else:
            _same_on_card(TK8.stream_merge_runs, k, out_slack=3,
                          _ctas=ctas, **kw)


def wide_tree_runs(group, C, descending, rng):
    """Two groups of ``group`` ragged runs (empty ones among them, about
    3.5 blocks of ``C`` keys a group): NaN / +-0 runs sorted in the
    direction, and in the second group every third run left unsorted."""
    lens = rng.integers(0, max(2, int(7 * C / group)), 2 * group)
    lens[::5] = 0
    parts = []
    for i, n in enumerate(lens):
        x = nan_run(int(n), descending)
        if i >= group and i % 3 == 0:
            rng.shuffle(x)
        parts.append(x)
    off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    return (np.concatenate(parts).astype(np.float32), off[:-1].copy(),
            np.diff(off).astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("w", [4, 8, 32, 64, 256, 2048])
def test_wide_tree_matches_plain(card, w):
    """The wide tree form (csrc/wide_merge.cu: pulled node cycles, a team
    a block) bit for bit against the plain version at 1 to 5 fused levels,
    key-only and KV in both directions, on ragged runs holding NaNs of two
    payloads and +-0, some out of order, several blocks a group, ``n_out``
    short of the total; under forced CTA counts (1, and 3: not a multiple
    of the two groups) and the card's own. K4 reaches it directly past 3
    levels or outside w 8-128, else through its run check, which flags
    every group here; one launch a call."""
    from repro_torch.kernels import launch_counts, reset_launches
    rng = np.random.default_rng(w)
    for L in range(1, 6):
        group = 1 << L
        bo = max(w, 64)
        for kv, desc in ((False, True), (True, True), (True, False)):
            buf, st, ln = (T(v).to(card) for v in wide_tree_runs(
                group, TF.block_size(1 << 20, w, bo), desc, rng))
            n = int(ln.sum())
            rk = torch.arange(buf.numel(), dtype=torch.int32, device=card)
            kw = dict(group=group, n_out=n - 5, w=w, block_out=bo)
            if kv:
                fn, args = TT.merge_tree_runs_kv, (buf, rk, st, ln)
                kw["descending"] = desc
            else:
                fn, args = TT.merge_tree_runs, (buf, st, ln)
            plain = getattr(TT, fn.__name__ + "_plain")(*args, **kw)
            plain = plain if isinstance(plain, tuple) else (plain,)
            for ctas in (1, 3, 0):
                reset_launches()
                got = fn(*args, _ctas=ctas, **kw)
                assert sum(launch_counts().values()) == 1
                got = got if isinstance(got, tuple) else (got,)
                for g, e in zip(got, plain):
                    assert torch.equal(_bits(g), _bits(e)), (L, kv, desc,
                                                             ctas)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [2, 3, 4, 5])
def test_k4_overlapping_runs_in_a_flagged_group_match_plain(card, L):
    """K4 on runs that overlap in the buffer, longer together than both
    ``n_out`` and the buffer, in groups its run check flags (a NaN in
    each): up to 3 levels the wide form's tables hold max(n_out, len(buf))
    lanes a level, so the group ending past them searches without a table
    (its children's searches instead); past 3 levels K4 runs the wide form
    directly, its tables sized by the runs' total. Every output lane is
    written and equals the plain version (which JAX K4 matches on the CPU
    for the first geometry,
    ``test_torch_params.test_k4_overlapping_runs_match_jax``), key-only and
    KV, under forced CTA counts; at w 4 K4 runs the wide form directly;
    then the same on 4096 keys in runs of up to 4000."""
    starts = [0, 122, 114, 66, 0, 126, 126, 10, 0, 78, 36, 48, 0, 104, 75,
              22, 0, 113, 28, 70, 0, 117, 7, 62, 0, 55, 18, 102, 0, 127, 120,
              48]
    rng = np.random.default_rng(L)
    big = rng.integers(0, 3000, 32)
    big[::4] = 0
    for n, st, ln, n_out, w, bo in (
            (160, starts, [30] * 32, 800, 8, 32),
            (160, starts, [30] * 32, 800, 4, 32),
            (4096, big, rng.integers(1000, 4000, 32), 40000, 32, 256)):
        x = np.sort(RNG.choice(MERGE_NAN_POOL, n).astype(np.float32))[::-1]
        x[:2] = np.nan
        ln = np.minimum(np.asarray(ln), n - np.asarray(st))
        buf, st, ln = (T(np.ascontiguousarray(v)).to(card) for v in (
            x, np.asarray(st, np.int32), ln.astype(np.int32)))
        rk = torch.arange(n, dtype=torch.int32, device=card)
        for ctas in (1, 3, 0):
            _same_on_card(TT.merge_tree_runs, buf, st, ln, group=1 << L,
                          n_out=n_out, w=w, block_out=bo, _ctas=ctas)
            _same_on_card(TT.merge_tree_runs_kv, buf, rk, st, ln,
                          group=1 << L, n_out=n_out, w=w, block_out=bo,
                          _ctas=ctas)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [16384, 32768])
def test_wide_tree_past_register_width_matches_plain(card, w):
    """The tree form past w 8192, where a team's lanes stay in its arena
    (512 threads, a barrier a butterfly stage): K2 and K3 over NaN / +-0
    run pairs, and K4 over two ragged groups at 1 and 2 levels (some runs
    out of order), key-only and KV in both directions, bit for bit against
    the plain versions, under forced CTA counts and the card's own; one
    launch a call."""
    from repro_torch.kernels import launch_counts, reset_launches
    a = T(nan_run(3 * w + 17)).to(card)
    b = T(nan_run(2 * w - 5)).to(card)
    ra = torch.arange(a.numel(), dtype=torch.int32, device=card)
    rb = a.numel() + torch.arange(b.numel(), dtype=torch.int32, device=card)
    _same_on_card(TF.flims_merge, a, b, w=w, block_out=2 * w)
    _same_on_card(TF.flims_merge_kv, a, ra, b, rb, w=w, block_out=w)
    buf, st, ln = (T(v).to(card) for v in ragged([3 * w, 0, w + 7, 2 * w]))
    n = int(ln.sum())
    rk = torch.arange(buf.numel(), dtype=torch.int32, device=card)
    _same_on_card(TS.segmented_merge_runs, buf, buf, st[::2], ln[::2],
                  st[1::2], ln[1::2], n_out=n - 3, w=w, block_out=w)
    _same_on_card(TS.segmented_merge_runs_kv, buf, rk, buf, rk, st[::2],
                  ln[::2], st[1::2], ln[1::2], n_out=n, w=w, block_out=w)
    rng = np.random.default_rng(w)
    for L in (1, 2):
        for kv, desc in ((False, True), (True, True), (True, False)):
            buf, st, ln = (T(v).to(card) for v in wide_tree_runs(
                1 << L, w, desc, rng))
            rk = torch.arange(buf.numel(), dtype=torch.int32, device=card)
            kw = dict(group=1 << L, n_out=int(ln.sum()) - 5, w=w,
                      block_out=w)
            if kv:
                fn, args = TT.merge_tree_runs_kv, (buf, rk, st, ln)
                kw["descending"] = desc
            else:
                fn, args = TT.merge_tree_runs, (buf, st, ln)
            for ctas in (1, 3, 0):
                reset_launches()
                _same_on_card(fn, *args, _ctas=ctas, **kw)
                assert sum(launch_counts().values()) == 1


@pytest.mark.cuda
def test_k4_footprint_does_not_depend_on_block(card):
    """The streaming tree's shared memory (rings, mbarriers, partition
    windows), read from the compiled kernel, depends on (L, w, lanes) and
    not on the output block: it fits the card for every plan the planner
    can give (w 8 to 128, L 1 to 3, both dtypes, key-only and KV both
    directions), below the first version's whole-block slots at the
    planner's block of 4096 from two levels on, and the plan the first
    version refused (KV, L 3, w 128, a block of the whole 8192-key group:
    227 KB of slots) runs at every block from 128 to 8192 and matches the
    plain version."""
    def first_version(L, kv, w, C=4096):
        lane = 8 if kv else 4
        return max(w, 32) * lane + ((1 << L) - 2) * (C // w + L - 1) * w * lane

    for dtype in (torch.float32, torch.int32):
        for L in range(1, TT.MAX_LEVELS + 1):
            for w in (8, 16, 32, 64, 128):
                for kv, desc in ((False, True), (True, True), (True, False)):
                    smem = TT.tree_smem(dtype, kv, desc, L, w)
                    assert smem <= TT.MAX_SMEM
                    if L >= 2:
                        assert smem < first_version(L, kv, w)
    n = 8192
    buf, st, ln = (T(v).to(card) for v in ragged([n] + [0] * 7))
    rk = torch.arange(n, dtype=torch.int32, device=card)
    for bo in (128, 1024, 8192):
        _same_on_card(TT.merge_tree_runs_kv, buf, rk, st, ln, group=8,
                      n_out=n, w=128, block_out=bo)


@pytest.mark.cuda
def test_k4_refuses_before_launch(card):
    """What the streaming tree cannot run (w past 128 or under 8, more than
    three fused levels: it refused these before) runs the wide form and
    matches the plain version, key-only and KV in both directions, on
    ragged runs holding NaNs of two payloads and +0.0 / -0.0, one launch a
    call."""
    from repro_torch.kernels import launch_counts, reset_launches
    lens = [64, 0, 33, 100, 1, 64, 7, 90, 5, 64, 0, 0, 128, 3, 64, 40] * 2
    buf = T(np.concatenate([nan_run(n) for n in lens])).to(card)
    off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    st, ln = T(off[:-1]).to(card), T(np.diff(off).astype(np.int32)).to(card)
    rk = torch.arange(buf.numel(), dtype=torch.int32, device=card)
    for group, w in ((4, 4), (4, 256), (16, 32), (32, 8), (2, 1)):
        for bo in (64, 512):
            reset_launches()
            n_out = buf.numel() - 17
            _same_on_card(TT.merge_tree_runs, buf, st, ln, group=group,
                          n_out=n_out, w=w, block_out=bo)
            assert launch_counts() == {"merge_tree_runs": 1}
            for d in (True, False):
                _same_on_card(TT.merge_tree_runs_kv, buf, rk, st, ln,
                              group=group, n_out=n_out, w=w, block_out=bo,
                              descending=d)


@pytest.mark.cuda
@pytest.mark.parametrize("descending", [True, False])
def test_engine_on_card_matches_torch(card, descending):
    from repro_torch import engine
    x = torch.randn(5000, device=card)
    kt = torch.randint(0, 50, (5000,), device=card).float()
    assert torch.equal(engine.sort(x, descending=descending),
                       torch.sort(x, descending=descending).values)
    assert torch.equal(engine.argsort(kt, descending=descending).long(),
                       torch.argsort(kt, descending=descending, stable=True))
    kb = kt.reshape(5, 1000)
    assert torch.equal(engine.argsort(kb, descending=descending).long(),
                       torch.argsort(kb, descending=descending, stable=True))
    offs = torch.tensor([0, 700, 700, 2100, 5000], dtype=torch.int32,
                        device=card)
    runs = torch.cat([torch.sort(kt[a:b], descending=descending).values
                      for a, b in zip(offs[:-1].tolist(), offs[1:].tolist())])
    assert torch.equal(engine.merge_runs(runs, offs, descending=descending),
                       torch.sort(kt, descending=descending).values)
    got = engine.merge_runs(runs, offs, descending=descending,
                            values=torch.arange(5000, device=card))[1]
    assert torch.equal(got, torch.argsort(runs, descending=descending,
                                          stable=True))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_engine_on_card_edge_sizes(card, dtype):
    """Heuristic plans across sizes (w from 8 to 128, tail blocks, one
    chunk, one key, empty runs) against torch, both directions."""
    from repro_torch import engine
    g = torch.Generator(device=card)
    g.manual_seed(5)
    for n in (1, 2, 3, 255, 1000, 4097, 70001):
        x = torch.randint(-20, 20, (n,), generator=g, device=card).to(dtype)
        for d in (True, False):
            assert torch.equal(engine.sort(x, descending=d),
                               torch.sort(x, descending=d).values)
            assert torch.equal(engine.argsort(x, descending=d).long(),
                               torch.argsort(x, descending=d, stable=True))
        a = torch.sort(x[: n // 3], descending=True).values
        b = torch.sort(x[n // 3:], descending=True).values
        assert torch.equal(engine.merge(a, b),
                           torch.sort(x, descending=True).values)
        k, v = engine.merge(a, b, values=(torch.arange(a.numel(), device=card),
                                          torch.arange(b.numel(), device=card)
                                          + a.numel()))
        ref = torch.sort(torch.cat([a, b]), descending=True, stable=True)
        assert torch.equal(k, ref.values) and torch.equal(v, ref.indices)
        cuts = sorted(torch.randint(0, n + 1, (6,), generator=g,
                                  device=card).tolist())
        offs = torch.tensor([0] + cuts + [cuts[-1], n], dtype=torch.int32,
                            device=card)
        runs = torch.cat([torch.sort(x[s:e], descending=True).values
                          for s, e in zip(offs[:-1].tolist(),
                                          offs[1:].tolist())])
        assert torch.equal(engine.merge_runs(runs, offs),
                           torch.sort(x, descending=True).values)


# NaNs of several payloads, +0.0, -0.0, ties and -inf (float32), and
# int32 keys with their extremes
SEG_NAN_POOL = np.concatenate([
    np.array([0x7fc00000, 0xffc12345, 0x7fa00000], np.uint32).view(
        np.float32), np.array([0.0, -0.0, 1.0, 2.0, -np.inf], np.float32)])
SEG_ZERO_POOL = np.array([0.0, -0.0, 0.0, -0.0, 1.0], np.float32)
SEG_INT_POOL = np.array([np.iinfo(np.int32).min, np.iinfo(np.int32).max, -1,
                         0, 0, 7], np.int32)


def seg_lens(cap):
    """Every edge length up to ``cap``: 0, 1, 2, around a warp (31-33) and
    its tile (255-257), and 2^k - 1, 2^k, 2^k + 1; a 3-key segment first,
    so that the later starts sit off 16 bytes."""
    edge = {0, 1, 2, 31, 32, 33, 255, 256, 257}
    edge |= {(1 << k) + d for k in range(16) for d in (-1, 0, 1)}
    return [min(3, cap)] + sorted(n for n in edge if 0 <= n <= cap)


def seg_keys(lens, kind, dtype, device):
    """Keys for ``lens`` on the card, in a buffer that starts 4 bytes past
    a 16-byte boundary. ``kind``: ``mixed`` (ties, +0.0 / -0.0, -inf),
    ``nan`` (NaNs in every other segment), ``zeros`` (dense in +0.0 /
    -0.0)."""
    n = sum(lens)
    if dtype == torch.int32:
        k = RNG.choice(SEG_INT_POOL if kind != "zeros" else
                       np.array([0, -1], np.int32), n).astype(np.int32)
    else:
        pool = {"mixed": FPOOL, "nan": SEG_NAN_POOL,
                "zeros": SEG_ZERO_POOL}[kind]
        k = RNG.choice(pool, n).astype(np.float32)
        if kind == "nan":
            starts = np.concatenate([[0], np.cumsum(lens)])
            for s in range(0, len(lens), 2):
                seg = k[starts[s]:starts[s + 1]]
                seg[np.isnan(seg)] = 1.0
    buf = torch.empty(n + 1, dtype=dtype, device=device)
    buf[1:] = T(k).to(device)
    offs = T(np.concatenate([[0], np.cumsum(lens)]).astype(np.int32))
    return buf[1:], offs.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_segment_kernels_match_plain(card, dtype):
    """K5 (with the +0/-0 sign rule of XLA's max/min) and K6 against their
    plain versions at every cap from 1 to 32768 (K5) / 16384 (K6), on
    segments of every edge length (empty, one key, around a warp, its tile
    and every power of two), with ties, dense +0.0 / -0.0, NaNs of several
    payloads, starts off 16 bytes, both directions (K6)."""
    for logcap in range(16):
        cap = 1 << logcap
        lens = seg_lens(cap)
        for kind in ("mixed", "nan", "zeros"):
            k, offs = seg_keys(lens, kind, dtype, card)
            _same_on_card(TS.segment_sort, k, offs, cap=cap)
            if cap <= TS.MAX_CAP_KV:
                for d in (True, False):
                    _same_on_card(TS.segment_sort_kv, k, offs, cap=cap,
                                  descending=d)


@pytest.mark.cuda
@pytest.mark.parametrize("descending", [True, False])
def test_k6_nan_segments_match_plain(card, descending):
    """K6 on float segments holding a NaN sorts over the whole cap, padding
    included, as its plain version and the JAX kernel do (with a NaN the
    compound compare is no total order, so the network decides): the pinned
    cases of a narrower network's fault, then NaN segments at every cap."""
    for seg, cap in (([np.nan, 1.0, 2.0], 8), ([2.0, np.nan, 1.0, 3.0, 0.0],
                                               16)):
        k = T(np.array(seg, np.float32)).to(card)
        offs = torch.tensor([0, len(seg)], dtype=torch.int32, device=card)
        _same_on_card(TS.segment_sort_kv, k, offs, cap=cap,
                      descending=descending)
    for logcap in range(1, 15):
        cap = 1 << logcap
        k, offs = seg_keys(seg_lens(cap), "nan", torch.float32, card)
        _same_on_card(TS.segment_sort_kv, k, offs, cap=cap,
                      descending=descending)


@pytest.mark.cuda
@pytest.mark.parametrize("G,n_tok,E,k,cap", [
    (1, 64, 8, 2, 10), (2, 64, 8, 2, 10), (1, 100, 6, 3, 5),
    (1, 16, 4, 1, 2), (3, 33, 5, 2, 1), (1, 32, 8, 4, 1000),
    (2, 128, 16, 6, 20), (1, 2048, 8, 2, 641), (1, 2048, 64, 6, 241),
    (1, 4096, 8, 2, 1281), (2, 300, 160, 6, 20), (1, 64, 8, 8, 9),
    (1, 40, 64, 64, 50), (1, 50, 300, 4, 3), (2, 9, 5000, 3, 2)])
def test_route_kernel_matches_plain(card, G, n_tok, E, k, cap):
    """K7 against ``moe_route_plain`` and ``moe_route_torch``: integer lanes
    bit for bit, weights within ROUTE_WEIGHT_ULPS; ties with +0.0/-0.0.
    E from 4 to 5000 (experts read again at each sweep above 256), k up to
    E; token counts that leave the last tile of 16 tokens partial (9, 33,
    50, 100, 300)."""
    rng = np.random.default_rng(G * n_tok + E + k)
    lg = np.round(rng.standard_normal((G, n_tok, E)).astype(np.float32)
                  * 2) / 2
    lg[lg == 0.0] = np.where(rng.random((lg == 0.0).sum()) < 0.5, -0.0, 0.0)
    x = T(lg.astype(np.float32)).to(card)
    got = TR.moe_route(x, k, cap)
    for ref in (TR.moe_route_plain(x, k, cap), TR.moe_route_torch(x, k, cap)):
        for i, (g, e) in enumerate(zip(got, ref)):
            assert g.shape == e.shape and g.dtype == e.dtype
            if i == 3:
                d = g.view(torch.int32).long() - e.view(torch.int32).long()
                assert int(d.abs().max()) <= ROUTE_WEIGHT_ULPS
            else:
                assert torch.equal(g, e), i


def _route_same(got, ref, what):
    """Routing lanes: integers bit for bit, weights NaN at the same places
    and within ROUTE_WEIGHT_ULPS elsewhere."""
    names = ("experts", "tokens", "perm", "weights", "slabs", "keep")
    for name, g, e in zip(names, got, ref):
        assert g.shape == e.shape and g.dtype == e.dtype, (what, name)
        if name == "weights":
            nan = torch.isnan(g)
            assert torch.equal(nan, torch.isnan(e)), f"{what}: NaN weights"
            d = (g[~nan].view(torch.int32).long()
                 - e[~nan].view(torch.int32).long())
            assert not d.numel() or int(d.abs().max()) <= ROUTE_WEIGHT_ULPS
            continue
        bad = (g != e).flatten().nonzero()
        assert not bad.numel(), (
            f"{what} {name}: {bad.shape[0]} of {tuple(g.shape)} differ, "
            f"first at {int(bad[0, 0])}: {g.flatten()[int(bad[0, 0])].item()}"
            f" vs {e.flatten()[int(bad[0, 0])].item()}")


@pytest.mark.cuda
@pytest.mark.parametrize("G,n_tok,E,k,cap,per_row", [
    (1, 1, 4, 4, 8, None), (2, 16, 8, 6, 5, 3), (1, 24, 8, 8, 7, 5),
    (3, 9, 5, 5, 2, 4), (1, 2048, 64, 6, 241, 60), (1, 4096, 8, 2, 1281, 7)])
def test_k7_int_min_logits_match_plain(card, G, n_tok, E, k, cap, per_row):
    """K7 on logits whose monotone key is INT32_MIN (the bits 0xFFFFFFFF):
    once every expert not yet picked reads INT32_MIN, ``moe_route_plain``
    and the JAX kernel pick expert 0 again (``[1.0, 0xFFFFFFFF, 2.0,
    0xFFFFFFFF]`` at k = 4 routes to ``[0, 0, 0, 2]``), and so must the
    kernel."""
    if per_row is None:
        lg = np.array([[[1.0, 0.0, 2.0, 0.0]]], np.float32)
        lg.view(np.int32)[0, 0, [1, 3]] = -1
    else:
        rng = np.random.default_rng(G * n_tok + E + k)
        lg = rng.standard_normal((G, n_tok, E)).astype(np.float32)
        pick = np.argsort(rng.random((G, n_tok, E)), axis=-1)[..., :per_row]
        np.put_along_axis(lg.view(np.int32), pick, -1, axis=-1)
    x = T(lg).to(card)
    _route_same(TR.moe_route(x, k, cap), TR.moe_route_plain(x, k, cap),
                f"moe_route {tuple(x.shape)} k={k} cap={cap}")


@pytest.mark.cuda
def test_past_shared_memory_shapes_match_plain(card):
    """Where one CTA's shared memory ends, the wrappers return their plain
    versions' results (they refused these shapes before): K7 at 4097 x 8
    tokens k 4 (32768 padded pairs), K5 at cap 2^17, K6 at cap 2^15 and
    2^16 (an (S, cap) bank through K1's network past its tile), on
    segments of edge lengths holding NaNs, +0.0 / -0.0 and ties."""
    lg = torch.round(torch.randn(1, 4097, 8, device=card) * 2) / 2
    x = torch.where(lg == 0, -0.0, lg)
    _route_same(TR.moe_route(x, 4, 10), TR.moe_route_plain(x, 4, 10),
                "moe_route (1, 4097, 8) k=4")
    for kind in ("mixed", "nan", "zeros"):
        for cap in (1 << 15, 1 << 16, 1 << 17):
            lens = [3, 0, 1, 257, cap // 2 + 1, cap - 1, cap, 4099]
            k, offs = seg_keys(lens, kind, torch.float32, card)
            if cap > TS.MAX_CAP:
                _same_on_card(TS.segment_sort, k, offs, cap=cap)
            if cap <= 1 << 16:
                for d in (True, False):
                    _same_on_card(TS.segment_sort_kv, k, offs, cap=cap,
                                  descending=d)
    k, offs = seg_keys([5, 1 << 17, 70000], "mixed", torch.int32, card)
    _same_on_card(TS.segment_sort, k, offs, cap=1 << 17)
    _same_on_card(TS.segment_sort_kv, k, offs, cap=1 << 17)


@pytest.mark.cuda
def test_open_refusals_raise(card):
    """Parameters the JAX kernels take and the port's refused before
    (ROADMAP queue 3): K2 / K3 at w 2048 and 4096 (the fast kernel takes w
    up to 1024) and K8 at fan-in 32, now run and match their plain versions
    on NaN / +-0 runs, key-only and KV."""
    a = T(nan_run(4096)).to(card)
    b = T(nan_run(3001)).to(card)
    ra = torch.arange(4096, dtype=torch.int32, device=card)
    rb = 4096 + torch.arange(3001, dtype=torch.int32, device=card)
    for w in (2048, 4096):
        _same_on_card(TF.flims_merge, a, b, w=w, block_out=8192)
        _same_on_card(TF.flims_merge_kv, a, ra, b, rb, w=w, block_out=4096)
    buf, st, ln = (T(v).to(card) for v in ragged([4000, 0, 2500, 3000]))
    n = int(ln.sum())
    rk = torch.arange(buf.numel(), dtype=torch.int32, device=card)
    _same_on_card(TS.segmented_merge_runs, buf, buf, st[::2], ln[::2],
                  st[1::2], ln[1::2], n_out=n - 3, w=2048, block_out=4096)
    _same_on_card(TS.segmented_merge_runs_kv, buf, rk, buf, rk, st[::2],
                  ln[::2], st[1::2], ln[1::2], n_out=n, w=2048,
                  block_out=2048)
    k = np.concatenate([nan_run(128) for _ in range(64)])
    kw = dict(runs=64, run_len=128, fan_in=32, w=32, block_out=1024)
    _same_on_card(TK8.stream_merge_runs, T(k).to(card), out_slack=7, **kw)
    _same_on_card(TK8.stream_merge_runs_kv, T(k).to(card),
                  torch.arange(k.size, dtype=torch.int32, device=card),
                  descending=False, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("G,n_tok,E,k,cap", [
    (1, 1 << 21, 8, 1, 1 << 18), (1, 65536, 64, 6, 6144),
    (2, 1 << 17, 4, 2, 1 << 16)])
def test_route_kernel_past_grid_y_matches_plain(card, G, n_tok, E, k, cap):
    """K7 on groups of up to 2^21 tokens (131072 tiles of 16, past the
    65535 a grid's y holds) against ``moe_route_plain`` and
    ``moe_route_torch``: integer lanes bit for bit, weights within
    ROUTE_WEIGHT_ULPS."""
    gen = torch.Generator(device=card)
    gen.manual_seed(G * n_tok + E)
    x = torch.randn(G, n_tok, E, generator=gen, device=card)
    got = TR.moe_route(x, k, cap)
    _route_same(got, TR.moe_route_plain(x, k, cap), "plain")
    _route_same(got, TR.moe_route_torch(x, k, cap), "torch")


@pytest.mark.cuda
def test_engine_segment_ops_and_route_on_card(card):
    """The heuristic plans on the card (two-phase segment sorts, K3
    segment_merge, fused route) against the torch variants."""
    from repro_torch import engine
    g = torch.Generator(device=card)
    g.manual_seed(11)
    lens = [300, 0, 4000, 17, 1, 9000, 0, 64]
    n = sum(lens)
    x = torch.randint(-40, 40, (n,), generator=g, device=card).float()
    offs = torch.tensor(np.concatenate([[0], np.cumsum(lens)]),
                        dtype=torch.int32, device=card)
    for d in (True, False):
        for v in ("cuda_fused", "cuda_two_phase"):
            assert torch.equal(
                engine.segment_sort(x, offs, descending=d, variant=v),
                engine.segment_sort(x, offs, descending=d, variant="torch"))
            assert torch.equal(
                engine.segment_argsort(x, offs, descending=d, variant=v),
                engine.segment_argsort(x, offs, descending=d,
                                       variant="torch"))
    a = engine.segment_sort(x, offs)
    assert torch.equal(engine.segment_merge(a, offs, a, offs),
                       engine.segment_merge(a, offs, a, offs,
                                            variant="torch"))
    lg = torch.randn(3, 700, 16, generator=g, device=card)
    r1 = engine.moe_route(lg, 4, 200)
    r2 = engine.moe_route(lg, 4, 200, variant="torch")
    for name in ("experts", "tokens", "perm", "slabs", "keep"):
        assert torch.equal(getattr(r1, name), getattr(r2, name)), name


def uniform_runs(runs, run_len, descending=True):
    """(keys, ranks) of ``runs`` uniform runs: keys from FPOOL (+0.0, -0.0,
    -inf, ties), each run in the compound (key, rank) order."""
    k = keys(runs * run_len).reshape(runs, run_len)
    r = RNG.permutation(runs * run_len).astype(np.int32).reshape(runs,
                                                                 run_len)
    for i in range(runs):
        p = np.lexsort((r[i], -k[i] if descending else k[i]))
        k[i], r[i] = k[i][p], r[i][p]
    return k.ravel().copy(), r.ravel().copy()


@pytest.mark.cuda
@pytest.mark.parametrize("geom", [(8, 256, 2, 32, 128), (16, 64, 8, 8, 128),
                                  (16, 32, 16, 8, 32)])
@pytest.mark.parametrize("descending", [True, False])
def test_stream_kernel_matches_plain(card, geom, descending):
    """K8 and K8kv against their plain versions at fan 2, 8 and 16, with
    run lengths above and equal to the output block, and a two-pass chain
    reading the first pass's output slack as is."""
    runs, run_len, fan, w, bo = geom
    k, r = (T(v).to(card) for v in uniform_runs(runs, run_len, descending))
    kw = dict(runs=runs, run_len=run_len, fan_in=fan, w=w, block_out=bo)
    if descending:
        _same_on_card(TK8.stream_merge_runs, k, out_slack=33, **kw)
    _same_on_card(TK8.stream_merge_runs_kv, k, r, descending=descending,
                  out_slack=7, **kw)
    if descending and fan < 16:
        slack = TK8.stream_slack(fan, w, bo)
        b1 = TK8.stream_merge_runs(k, out_slack=slack, **kw)
        _same_on_card(TK8.stream_merge_runs, b1, runs=runs // fan,
                      run_len=run_len * fan, fan_in=fan if runs // fan >= fan
                      else runs // fan, w=w, block_out=bo)


@pytest.mark.cuda
@pytest.mark.parametrize("runs,run_len,w", [(8, 64, 32), (16, 512, 128)])
def test_stream_kernel_nan_runs_match_plain(card, runs, run_len, w):
    """K8's key-only butterfly runs NaN-free warps on monotone integers and
    a warp holding a NaN on the float selects (XLA's max / min): runs
    holding +NaN, -NaN of two payloads, +0.0, -0.0 and -inf against the
    plain version bit for bit. One output block a group, so no partition
    (its order is not a total one with NaNs)."""
    pool = np.concatenate([np.array([0x7fc00000, 0xffc12345], np.uint32).view(
        np.float32), np.array([0.0, -0.0, 1.0, -1.0, -np.inf], np.float32)])
    k = np.concatenate([np.sort(RNG.choice(pool, run_len))[::-1]
                        for _ in range(runs)])
    kw = dict(runs=runs, run_len=run_len, fan_in=8, w=w,
              block_out=8 * run_len)
    _same_on_card(TK8.stream_merge_runs, T(k.astype(np.float32)).to(card),
                  out_slack=5, **kw)


@pytest.mark.cuda
def test_stream_kernel_footprint_guard_raises(card):
    """What the streaming tree cannot run, w past 128 or under 8 (it refused
    these before), runs the wide form and matches the plain version; the
    planner's largest plan, fan 16 on KV lanes at w 128, fits the card's
    shared memory and launches the fast kernel."""
    from repro_torch.kernels import launch_counts
    k, r = uniform_runs(16, 512)
    k[::37] = np.float32("nan")
    kt, rt = T(k).to(card), T(r).to(card)
    for w in (256, 4, 512):
        _same_on_card(TK8.stream_merge_runs, kt, runs=16, run_len=512,
                      fan_in=16, w=w, block_out=1024, out_slack=3)
        _same_on_card(TK8.stream_merge_runs_kv, kt, rt, runs=16,
                      run_len=512, fan_in=16, w=w, block_out=1024)
    n = 16 * 8192
    k = torch.zeros(n, device=card)
    r = torch.zeros(n, dtype=torch.int32, device=card)
    before = launch_counts().get("stream_merge_runs_kv", 0)
    assert TK8.stream_smem(torch.float32, True, True, 4, 128) <= \
        TT.MAX_SMEM
    TK8.stream_merge_runs_kv(k, r, runs=16, run_len=8192, fan_in=16, w=128,
                             block_out=4096)
    assert launch_counts().get("stream_merge_runs_kv", 0) == before + 1


@pytest.mark.cuda
def test_stream_kernel_footprint_fits_every_plan(card):
    """The compiled kernel's shared memory (FIFO rings, mbarriers, partition
    scratch) stays under the card's 232,448 B for every plan the planner
    can produce (w 8 to 128, fan-in 2 to 16, both dtypes, key-only and KV
    both directions), and at the default plan (fan 8, w 128) under the
    first version's whole-block slots (68 KB key-only, 137 KB KV)."""
    for dtype in (torch.float32, torch.int32):
        for L in range(1, TK8.MAX_LEVELS + 1):
            for w in (8, 16, 32, 64, 128):
                for kv, desc in ((False, True), (True, True), (True, False)):
                    assert TK8.stream_smem(dtype, kv, desc, L, w) <= \
                        TT.MAX_SMEM
    assert TK8.stream_smem(torch.float32, False, True, 3, 128) < 68 * 1024
    assert TK8.stream_smem(torch.float32, True, True, 3, 128) < 137 * 1024


@pytest.mark.cuda
def test_stream_kernel_misaligned_buffer_raises(card):
    """K8 reads its buffers by 16-byte bulk copies: a key or rank buffer
    whose storage does not start on 16 bytes (which it refused before)
    goes through an aligned copy the wrapper makes, and the result is the
    plain version's."""
    from repro_torch.kernels import launch_counts, reset_launches
    kw = dict(runs=4, run_len=64, fan_in=4, w=32, block_out=64)
    n = 4 * 64 + TK8.stream_slack(4, 32, 64)
    k0, r0 = uniform_runs(4, 64)
    k = torch.full((n + 1,), float("-inf"), device=card)
    r = torch.full((n + 1,), 2 ** 31 - 1, dtype=torch.int32, device=card)
    k[1:257], r[1:257] = T(k0).to(card), T(r0).to(card)
    reset_launches()
    _same_on_card(TK8.stream_merge_runs, k[1:], **kw)
    kk = k[1:].clone()
    _same_on_card(TK8.stream_merge_runs_kv, kk, r[1:], **kw)
    assert launch_counts() == {"stream_merge_runs": 1,
                               "stream_merge_runs_kv": 1}


# (runs, run_len, fan_in, w): two groups each, the output block at w, so a
# group holds 4 fan_in .. 16 fan_in blocks; w 8 and 32 hold one lane a
# thread (8 of a warp's 32 live), 64 two and 128 four; L 1 to 4
SPAN_GEOMS = [(4, 128, 2, 8), (8, 256, 4, 32), (16, 256, 8, 64),
              (16, 512, 8, 128), (32, 128, 16, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("geom", SPAN_GEOMS)
def test_stream_kernel_spans_match_plain(card, geom):
    """K8 / K8kv at span geometries forced through ``_ctas``, each against
    one plain result: one CTA taking both groups in turn, spans of many
    blocks of which the second starts mid-group (5 CTAs: two spans a
    group), the card's own count, and more CTAs than blocks (a span is a
    block); key-only, and KV both directions (fan 16: KV descending only).
    The plain version runs on host copies: at fan 16 it is millions of
    small tensor operations, slower on the card than on its host."""
    runs, run_len, fan, w = geom
    G = runs * run_len // w
    kw = dict(runs=runs, run_len=run_len, fan_in=fan, w=w, block_out=w)
    for descending in (True, False):
        if fan == 16 and not descending:
            continue
        k, r = (T(v).to(card) for v in uniform_runs(runs, run_len,
                                                    descending))
        cases = [(TK8.stream_merge_runs_kv, (k, r),
                  dict(kw, descending=descending, out_slack=5))]
        if descending and fan < 16:
            cases.append((TK8.stream_merge_runs, (k,), dict(kw, out_slack=3)))
        for fn, args, ckw in cases:
            plain = getattr(TK8, fn.__name__ + "_plain")(
                *(a.cpu() for a in args), **ckw)
            plain = tuple(p.to(card) for p in (
                plain if isinstance(plain, tuple) else (plain,)))
            for ctas in (1, 5, 0, G + 3):
                got = fn(*args, _ctas=ctas, **ckw)
                got = got if isinstance(got, tuple) else (got,)
                for g, e in zip(got, plain):
                    assert torch.equal(_bits(g), _bits(e)), (fn.__name__,
                                                             ctas)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_external_sort_on_card_matches_torch(card, dtype):
    """``engine.external_sort`` on its heuristic plan (K1, K4, K8) against
    torch: 300000 keys in tiles of 2^16 (five runs, completed to eight),
    key-only both directions and stable with a payload both directions."""
    from repro_torch import engine
    g = torch.Generator(device=card)
    g.manual_seed(13)
    n = 300_000
    x = torch.randint(-1000, 1000, (n,), generator=g, device=card).to(dtype)
    for d in (True, False):
        for fan in (4, 16):
            got = engine.external_sort(x, descending=d, tile_elems=1 << 16,
                                       fan_in=fan)
            assert torch.equal(got, torch.sort(x, descending=d).values)
            ks, vs = engine.external_sort(x, descending=d, tile_elems=1 << 16,
                                          fan_in=fan, values=torch.arange(
                                              n, device=card))
            perm = torch.argsort(x, descending=d, stable=True)
            assert torch.equal(vs, perm) and torch.equal(ks, x[perm])


# K9: the lane merge of a tree level's run pairs, at every w the kernel
# takes, on pair lengths 0, 1, w - 1, w, w + 1 and ragged ones


def _lane_runs(lens, dtype):
    """Flat descending runs of ``lens`` (float32: NaNs of two payloads,
    +0.0/-0.0 and ties; int32: duplicates and both extremes), their starts,
    and a permutation as ranks."""
    if dtype == torch.float32:
        parts = [nan_run(n) for n in lens]
    else:
        parts = [np.sort(RNG.choice(K1_INT_POOL, n))[::-1] for n in lens]
    buf = np.concatenate(parts + [np.zeros(0, parts[0].dtype)]).copy()
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
    ranks = RNG.permutation(buf.shape[0]).astype(np.int32)
    return T(buf), T(starts), T(np.array(lens, np.int32)), T(ranks)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1 << i for i in range(8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_lane_merge_matches_plain(card, w, dtype):
    """K9 (key-only under tie b and skew, and KV) against its plain
    version: one pair, and a launch of many ragged pairs with empty and
    one-sided ones; the output whole and cut below the total."""
    edge = [0, 1, max(w - 1, 0), w, w + 1, 2 * w + 3]
    a_sets = [[3 * w + 5], edge + [int(x) for x in RNG.integers(0, 4 * w + 9,
                                                                 40)]]
    for la in a_sets:
        lb = list(reversed(la))
        a, sa, na, ra = (t.to(card) for t in _lane_runs(la, dtype))
        b, sb, nb, rb = (t.to(card) for t in _lane_runs(lb, dtype))
        n = sum(la) + sum(lb)
        for n_out in (n, n - n // 3):
            for tie in ("b", "skew"):
                _same_on_card(TL.lane_merge, a, b, sa, na, sb, nb,
                              n_out=n_out, w=w, tie=tie)
            _same_on_card(TL.lane_merge_kv, a, ra, b, rb, sa, na, sb, nb,
                          n_out=n_out, w=w)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [8, 128])
def test_lane_merge_thousands_of_pairs(card, w):
    """One launch over 3000 short ragged pairs of one buffer (a tree level's
    shape: A and B the same buffer), key-only and KV."""
    lens = [int(x) for x in RNG.integers(0, 2 * w + 2, 6000)]
    buf, st, ln, rk = (t.to(card) for t in _lane_runs(lens, torch.float32))
    pairs = tuple(t.contiguous() for t in (st[0::2], ln[0::2], st[1::2],
                                           ln[1::2]))
    _same_on_card(TL.lane_merge, buf, buf, *pairs, n_out=buf.numel(), w=w)
    _same_on_card(TL.lane_merge, buf, buf, *pairs, n_out=buf.numel(), w=w,
                  tie="skew")
    _same_on_card(TL.lane_merge_kv, buf, rk, buf, rk, *pairs,
                  n_out=buf.numel(), w=w)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1 << i for i in range(8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_lane_merge_level_matches_plain(card, w, dtype):
    """K9's uniform-level form (the executor's: starts derived from the pair
    index) against its plain version and against the ragged form over the
    same pairs: runs of 1, w - 1, w + 1 and 3w + 5 keys, 2 and 1500 pairs a
    launch, key-only under tie b and skew and with ranks."""
    for L in sorted({1, max(w - 1, 1), w + 1, 3 * w + 5}):
        for pairs in (2, 1500):
            buf, _, _, rk = (t.to(card) for t in _lane_runs([L] * (2 * pairs),
                                                            dtype))
            st = torch.arange(pairs, dtype=torch.int32, device=card) * (2 * L)
            ln = torch.full((pairs,), L, dtype=torch.int32, device=card)
            for ranks, tie in ((None, "b"), (None, "skew"), (rk, "b")):
                got = TL.lane_merge_level(buf, ranks, L, w=w, tie=tie)
                exp = TL.lane_merge_level_plain(buf, ranks, L, w=w, tie=tie)
                if ranks is None:
                    ragged = (TL.lane_merge(buf, buf, st, ln, st + L, ln,
                                            n_out=buf.numel(), w=w, tie=tie),
                              None)
                else:
                    ragged = TL.lane_merge_kv(buf, rk, buf, rk, st, ln,
                                              st + L, ln, n_out=buf.numel(),
                                              w=w)
                for g, e, r in zip(got, exp, ragged):
                    if g is None:
                        assert e is None and r is None
                        continue
                    assert torch.equal(_bits(g), _bits(e)), (L, pairs, tie)
                    assert torch.equal(_bits(g), _bits(r)), (L, pairs, tie)


# K9's block form: a uniform level's chains cut into blocks restarted at
# their co-ranks, against the plain version and the whole chain

K9_POS0_POOL = np.array([0.0, 0.0, 1.5, -1.0, -np.inf, 4.0], np.float32)


def _block_level(P, L, dtype, *, pool=None, nan_pairs=()):
    """A uniform level on the host: P pairs of two descending L-key runs
    from ``pool`` (float32: ``FPOOL``, +0.0 and -0.0 among its keys; int32:
    ``K1_INT_POOL``), the runs of ``nan_pairs`` from ``nan_run`` (NaNs of
    two payloads); ranks rising along each run (a permutation), so KV runs
    are in the compound order."""
    if pool is None:
        pool = FPOOL if dtype == torch.float32 else K1_INT_POOL
    runs = [nan_run(L) if i // 2 in nan_pairs else
            np.sort(RNG.choice(pool, L))[::-1] for i in range(2 * P)]
    perm = RNG.permutation(2 * P * L).astype(np.int32).reshape(2 * P, L)
    return T(np.concatenate(runs).copy()), T(np.sort(perm, 1).reshape(-1))


def _level_same(got, exp, what):
    for g, e in zip(got, exp):
        if g is None:
            assert e is None, what
            continue
        bad = (_bits(g) != _bits(e)).nonzero()
        assert not bad.numel(), (f"{what}: {bad.shape[0]} of {g.numel()} "
                                 f"differ, first at {int(bad[0, 0])}")


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1 << i for i in range(8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_lane_merge_blocks_match_plain_and_chain(card, w, dtype):
    """K9's block form at a uniform level of 4 pairs of two 20w + 7-key runs
    (chains of about 41 cycles), at blocks of 1, 2, 3 and the planner's
    cycles, bit for bit against the plain version and ``chain=True``, one
    counted launch each: key-only under tie b, under skew with and without
    mixed signed zeros, and KV; a float level's pair 1 holds NaNs."""
    from repro_torch.kernels import launch_counts, reset_launches
    L, P = 20 * w + 7, 4
    nan = (1,) if dtype == torch.float32 else ()
    buf, rk = (t.to(card) for t in _block_level(P, L, dtype, nan_pairs=nan))
    pos0 = _block_level(P, L, dtype, pool=K9_POS0_POOL if
                        dtype == torch.float32 else None)[0].to(card)
    cases = [(buf, None, "b"), (buf, None, "skew"), (pos0, None, "skew"),
             (buf, rk, "b")]
    for keys_, ranks, tie in cases:
        kind = "lane_merge" if ranks is None else "lane_merge_kv"
        exp = TL.lane_merge_level_plain(keys_, ranks, L, w=w, tie=tie)
        whole = TL.lane_merge_level(keys_, ranks, L, w=w, tie=tie,
                                    chain=True)
        _level_same(whole, exp, f"chain w {w} {tie} {kind}")
        for cycles in (1, 2, 3, None):
            reset_launches()
            got = TL.lane_merge_level(keys_, ranks, L, w=w, tie=tie,
                                      _cycles=cycles)
            assert launch_counts() == {kind: 1}
            what = f"w {w} {tie} {kind} cycles {cycles}"
            _level_same(got, exp, what)
            _level_same(got, whole, what)


@pytest.mark.cuda
@pytest.mark.parametrize("w,L,P", [(8, 1 << 16, 2), (128, 1 << 20, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_lane_merge_long_chains_match_chain(card, w, L, P, dtype):
    """Chains of 16384 cycles (2 pairs of two 2^16-key runs at w 8, one
    pair of two 2^20-key runs at w 128): the block form, at the planner's
    cycles and at blocks of 7, bit for bit against ``chain=True`` (the
    plain version would run 16384 cycles in Python), key-only under tie b,
    skew on runs of one zero sign, and KV."""
    buf, rk = (t.to(card) for t in _block_level(P, L, dtype))
    pos0 = _block_level(P, L, dtype, pool=K9_POS0_POOL if
                        dtype == torch.float32 else None)[0].to(card)
    for keys_, ranks, tie in ((buf, None, "b"), (pos0, None, "skew"),
                              (buf, rk, "b")):
        whole = TL.lane_merge_level(keys_, ranks, L, w=w, tie=tie,
                                    chain=True)
        assert TL.level_blocks(keys_, ranks, L, w=w, tie=tie)[1] > 1
        for cycles in (None, 7):
            got = TL.lane_merge_level(keys_, ranks, L, w=w, tie=tie,
                                      _cycles=cycles)
            _level_same(got, whole, f"w {w} L {L} {tie} cycles {cycles}")
        srt = torch.sort(keys_.reshape(P, 2 * L), 1, descending=True).values
        assert torch.equal(whole[0].reshape(P, 2 * L), srt)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [300, 256])
@pytest.mark.parametrize("tie", ["b", "skew"])
def test_lane_merge_guarded_pairs_run_the_chain_on_card(card, tie, L,
                                                        monkeypatch):
    """A level of 6 pairs (w 32, cut into blocks of 2 cycles) that mixes
    NaN pairs (0 and 3) with NaN-free ones holding +0.0 and -0.0: K9's
    output equals the plain version computed before, with ``merge_lanes``
    refused and one counted launch, so the flagged pairs ran their chain on
    the card; key-only under ``tie`` and, under tie b, KV. Runs of 300 keys
    take the guard's one-key-a-thread pass, runs of 256 its 16-byte one."""
    from repro_torch.kernels import launch_counts, reset_launches
    w = 32
    buf, rk = (t.to(card) for t in _block_level(6, L, torch.float32,
                                                nan_pairs=(0, 3)))
    cases = [(None, "lane_merge")] + ([(rk, "lane_merge_kv")] if tie == "b"
                                      else [])
    exp = {kind: TL.lane_merge_level_plain(buf, r, L, w=w, tie=tie)
           for r, kind in cases}

    def refuse(*a, **k):
        raise AssertionError("the plain lane merge ran on the card")
    monkeypatch.setattr(TL, "merge_lanes", refuse)
    for r, kind in cases:
        reset_launches()
        got = TL.lane_merge_level(buf, r, L, w=w, tie=tie, _cycles=2)
        assert launch_counts() == {kind: 1}
        _level_same(got, exp[kind], f"{tie} {kind}")


@pytest.mark.cuda
def test_lane_merge_refuses_before_launch(card):
    """What K9 refused before, a bfloat16 key (ragged and level forms) or a
    w above 128, now launches (bf16 widened to float32 around the launch,
    w past 128 the wide lane form) and matches the plain version on NaN /
    +-0 runs; ``tree_vmapped`` on bfloat16 keys launches K9 once a level
    and equals its torch variant."""
    from repro_torch.engine.schedule import MergeSchedule, merge_runs
    from repro_torch.kernels import launch_counts, reset_launches
    a = T(nan_run(700)).to(card)
    b = T(nan_run(513)).to(card)
    st = torch.tensor([0, 300], dtype=torch.int32, device=card)
    ln = torch.tensor([300, 400], dtype=torch.int32, device=card)
    bst = torch.tensor([0, 13], dtype=torch.int32, device=card)
    bln = torch.tensor([13, 500], dtype=torch.int32, device=card)
    ra = torch.arange(700, dtype=torch.int32, device=card)
    rb = torch.arange(513, dtype=torch.int32, device=card)
    for w, dt in ((32, torch.bfloat16), (256, torch.float32),
                  (1024, torch.float16), (4096, torch.float32)):
        for tie in ("b", "skew"):
            _same_on_card(TL.lane_merge, a.to(dt), b.to(dt), st, ln, bst,
                          bln, n_out=1200, w=w, tie=tie)
        _same_on_card(TL.lane_merge_kv, a.to(dt), ra, b.to(dt), rb, st, ln,
                      bst, bln, n_out=1213, w=w)
        buf = T(np.concatenate([nan_run(256) for _ in range(6)])).to(card)
        for tie in ("b", "skew"):
            _same_on_card(TL.lane_merge_level, buf.to(dt), None, 256, w=w,
                          tie=tie)
        _same_on_card(TL.lane_merge_level, buf.to(dt),
                      torch.arange(buf.numel(), dtype=torch.int32,
                                   device=card), 256, w=w)
    x = torch.arange(64, 0, -1, device=card).bfloat16()
    offs = torch.tensor([0, 32, 64], dtype=torch.int32, device=card)
    reset_launches()
    got = merge_runs(x, offs, schedule=MergeSchedule("tree_vmapped", w=8))
    assert launch_counts() == {"lane_merge": 1}
    ref = merge_runs(x, offs, schedule=MergeSchedule("torch"))
    assert torch.equal(_bits(got), _bits(ref))


NARROW_DTYPES = [torch.bfloat16, torch.float16, torch.int8, torch.int16,
                 torch.uint8]


def _narrow(x, dtype):
    """float32 keys on the card as ``dtype``: floats by value (NaNs and
    +-0 kept), integers scaled onto the dtype's range with its min and
    max."""
    if dtype.is_floating_point:
        return x.to(dtype)
    info = torch.iinfo(dtype)
    y = torch.nan_to_num(x, nan=info.max, posinf=info.max, neginf=info.min)
    return y.clamp(info.min, info.max).round().to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", NARROW_DTYPES)
def test_narrow_keys_match_plain(card, dtype):
    """Every key kernel (K1 to K6, K8, K9) on keys of ``dtype`` (widened to
    int32 / float32 around each launch) against its plain version, on
    keys holding NaNs, +-0, ties and the dtype's min and max."""
    x = _narrow(T(keys(64 * 128)).to(card), dtype)
    x[::97] = _narrow(torch.tensor([float("nan")], device=card), dtype)
    r = torch.arange(x.numel(), dtype=torch.int32, device=card)
    _same_on_card(TB.sort_chunks, x.reshape(64, 128))
    _same_on_card(TB.sort_chunks_kv, x.reshape(32, 256), r.reshape(32, 256))
    a = _narrow(T(nan_run(3000)).to(card), dtype)
    b = _narrow(T(nan_run(1000)).to(card), dtype)
    _same_on_card(TF.flims_merge, a, b, w=64, block_out=512)
    _same_on_card(TF.flims_merge_kv, a, r[:3000], b, r[:1000], w=32,
                  block_out=256)
    buf, st, ln = ragged(PAIR_LENS)
    buf = _narrow(T(buf).to(card), dtype)
    st, ln = T(st).to(card), T(ln).to(card)
    _same_on_card(TS.segmented_merge_runs, buf, buf, st[::2], ln[::2],
                  st[1::2], ln[1::2], n_out=int(ln.sum()), w=16,
                  block_out=64)
    _same_on_card(TT.merge_tree_runs, buf, st[:8], ln[:8], group=4,
                  n_out=int(ln[:8].sum()), w=16, block_out=64)
    k, offs = seg_keys(SEG_LENS, "nan" if dtype.is_floating_point else
                       "mixed", torch.float32, card)
    k = _narrow(k, dtype)
    _same_on_card(TS.segment_sort, k, offs, cap=256)
    _same_on_card(TS.segment_sort_kv, k, offs, cap=512, descending=False)
    k8, r8 = uniform_runs(8, 128)
    _same_on_card(TK8.stream_merge_runs, _narrow(T(k8).to(card), dtype),
                  runs=8, run_len=128, fan_in=4, w=32, block_out=128,
                  out_slack=5)
    lvl = _narrow(T(np.concatenate([nan_run(128) for _ in range(4)])).to(
        card), dtype)
    _same_on_card(TL.lane_merge_level, lvl, None, 128, w=32)
    _same_on_card(TL.lane_merge_level, lvl, r[:512], 128, w=64)


@pytest.mark.cuda
@pytest.mark.parametrize("descending", [True, False])
def test_tree_vmapped_on_card_launches_k9(card, descending, monkeypatch):
    """``merge_runs(variant="tree_vmapped")`` on CUDA tensors launches K9
    once a level and never runs the plain lane loop; key-only (tie b and
    skew) and stable with a payload, against torch."""
    from repro_torch import engine
    from repro_torch.kernels import launch_counts, reset_launches

    def refuse(*a, **k):
        raise AssertionError("the plain lane merge ran on the card")
    monkeypatch.setattr(TL, "merge_lanes", refuse)
    lens = [300, 0, 129, 77, 1, 1000, 5]           # 7 runs: 3 levels
    buf, offs = ragged(lens, descending=descending)[0], np.concatenate(
        [[0], np.cumsum(lens)]).astype(np.int32)
    x, o = T(buf).to(card), T(offs).to(card)
    for tie in ("b", "skew"):
        reset_launches()
        got = engine.merge_runs(x, o, descending=descending, tie=tie,
                                variant="tree_vmapped")
        assert launch_counts() == {"lane_merge": 3}
        assert torch.equal(got, torch.sort(x, descending=descending).values)
    reset_launches()
    vals = torch.arange(x.numel(), device=card)
    ks, vs = engine.merge_runs(x, o, descending=descending, values=vals,
                               variant="tree_vmapped")
    assert launch_counts() == {"lane_merge_kv": 3}
    perm = torch.argsort(x, descending=descending, stable=True)
    assert torch.equal(vs, perm) and torch.equal(_bits(ks), _bits(x[perm]))


@pytest.mark.cuda
@pytest.mark.parametrize("n_tok", [8, 1], ids=["decode_step", "prefill_tok"])
def test_k7_serving_shapes_match_plain(card, n_tok):
    """K7 at the serving path's route shapes, Moonlight-16B-A3B's 64 experts
    top-6: (1, 8, 64) (a decode step over 8 slots) and (1, 1, 64) (a
    prefill token), capacity ``expert_capacity(1.25, T, 6, 64)`` = 1, so
    most pairs drop; against the plain version and the torch variant,
    untied and with ties and +0.0/-0.0."""
    from repro_torch.models.moe import expert_capacity
    k, E = 6, 64
    cap = expert_capacity(1.25, n_tok, k, E)
    assert cap == 1
    for seed in range(6):
        rng = np.random.default_rng(seed)
        lg = rng.standard_normal((1, n_tok, E)).astype(np.float32)
        if seed % 2:
            lg = np.round(lg * 2) / 2
            lg[lg == 0.0] = np.where(rng.random((lg == 0.0).sum()) < 0.5,
                                     -0.0, 0.0)
        x = T(lg.astype(np.float32)).to(card)
        got = TR.moe_route(x, k, cap)
        assert int(got[5].sum()) <= E * cap
        for ref in (TR.moe_route_plain(x, k, cap),
                    TR.moe_route_torch(x, k, cap)):
            _route_same(got, ref, f"moe_route (1, {n_tok}, {E}) seed {seed}")


@pytest.mark.cuda
def test_moonlight_decode_step_matches_torch_route(card):
    """One decode step of the ``moonshot_v1_16b_a3b`` config at its
    widths, one layer, 8 slots: one K7 launch, and the logits within 2^-6 relative
    Frobenius of the same step routed by the torch variant (bf16 weights:
    K7's weights differ from torch's by a few float32 ulps, which bf16
    rounding between the products can carry)."""
    import dataclasses
    from repro_torch import engine
    from repro_torch.configs import get_config
    from repro_torch.engine.planner import plan_key
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(get_config("moonshot_v1_16b_a3b"), n_layers=1)
    model = build_model(cfg)
    gen = torch.Generator(device=card).manual_seed(0)
    params = model.init(gen)
    B = 8
    cache = model.init_cache(B, 64, device=card)
    tok = torch.randint(0, cfg.vocab_size, (B,), generator=gen, device=card,
                        dtype=torch.int32)
    offs = torch.arange(B, device=card, dtype=torch.int32)
    engine.clear_plans()
    for t in range(3):
        logits, cache = model.decode_step(params, tok, offs + t, cache)
        tok = torch.argmax(logits, -1).to(torch.int32)
    torch.cuda.synchronize()
    reset_launches()
    logits, _ = model.decode_step(params, tok, offs + 3, cache)
    torch.cuda.synchronize()
    assert launch_counts() == {"moe_route": 1}
    key = plan_key("moe_route", n=B * cfg.n_experts_active,
                   dtype=torch.float32, backend="cuda", segments=1)
    engine.default_planner.put(key, engine.Plan("torch"))
    try:
        reset_launches()
        ref, _ = model.decode_step(params, tok, offs + 3, cache)
        torch.cuda.synchronize()
        assert launch_counts() == {}
    finally:
        engine.clear_plans()
    assert logits.shape == (B, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    rel = float((logits - ref).norm() / ref.norm())
    assert rel <= 2.0 ** -6, rel


def _rel_frob(got, ref):
    return float((got - ref).norm() / ref.norm())


@pytest.mark.cuda
def test_zamba2_group_decode_matches_forward(card):
    """One group of the ``zamba2_2p7b`` config at its widths (d 2560, 80
    Mamba2 heads of 64 with state 64, the shared attention block of 32
    heads of 80, vocab 32000), 6 layers, float32: token-by-token decode
    logits within 1e-3 relative Frobenius of the teacher-forced
    forward's."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import lm_logits
    cfg = dataclasses.replace(get_config("zamba2_2p7b"), n_layers=6,
                              param_dtype="float32", compute_dtype="float32")
    model = build_model(cfg)
    gen = torch.Generator(device=card).manual_seed(0)
    params = model.init(gen)
    B, S = 2, 12
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device=card, dtype=torch.int32)
    full = lm_logits(params, model.forward(params, {"tokens": toks}), cfg)
    cache = model.init_cache(B, S, device=card)
    steps = []
    for t in range(S):
        logits, cache = model.decode_step(
            params, toks[:, t], torch.full((B,), t, dtype=torch.int32,
                                           device=card), cache)
        steps.append(logits)
    got = torch.stack(steps, dim=1)
    assert got.shape == full.shape == (B, S, cfg.vocab_size)
    assert bool(torch.isfinite(got).all())
    assert _rel_frob(got, full) <= 1e-3


@pytest.mark.cuda
def test_slot_kv_insert_xlstm_on_card(card):
    """``SlotKVCache.insert`` on an xLSTM cache on the card writes only its
    slot, on each leaf's own axis (2 for the mLSTM states, 1 for the
    sLSTM's), and leaves every other slot as it was."""
    from repro_torch.configs import get_config
    from repro_torch.core.butterfly import tree_leaves, tree_map
    from repro_torch.models.model import build_model
    from repro_torch.serve import SlotKVCache
    model = build_model(get_config("xlstm_1p3b").reduced())
    kv = SlotKVCache(model, n_slots=4, max_seq=16, device=card)
    before = tree_map(lambda t: t.clone(), kv.cache)
    leaves = tree_leaves(kv.cache)
    sub = tree_map(lambda t: torch.full_like(t, 7.0),
                   model.init_cache(1, 16, device=card))
    kv.insert(2, sub)
    assert all(a is b for a, b in zip(tree_leaves(kv.cache), leaves))
    for leaf, old, ax in zip(leaves, tree_leaves(before),
                             tree_leaves(kv.axes)):
        assert leaf.is_cuda
        assert bool((leaf.narrow(ax, 2, 1) == 7.0).all())
        for s in (0, 1, 3):
            assert torch.equal(leaf.narrow(ax, s, 1), old.narrow(ax, s, 1))
    assert {ax for ax in tree_leaves(kv.axes)} == {1, 2}


@pytest.mark.cuda
@pytest.mark.parametrize("G,n_tok,E,k,cap,per_row", [
    (1, 2048, 64, 6, 241, None), (1, 2048, 64, 6, 241, 60),
    (2, 16, 8, 6, 5, 3), (1, 1, 4, 4, 8, 2)])
def test_k7_backward_matches_plain(card, G, n_tok, E, k, cap, per_row):
    """K7's autograd Function against the plain version's on the card, at
    Moonlight's grouped route shape and on logits whose monotone key is
    INT32_MIN (a repeated pick, a NaN weight): the (G, T, E) gradient of
    the logits NaN at the same places and within rtol 1e-5 / atol 1e-7
    elsewhere (the weights differ by a few float32 ulps), zero where no
    pair was picked; the forward launched K7 once."""
    from repro_torch.kernels import launch_counts, reset_launches
    rng = np.random.default_rng(G * n_tok + E + k)
    lg = rng.standard_normal((G, n_tok, E)).astype(np.float32)
    if per_row is not None:
        pick = np.argsort(rng.random((G, n_tok, E)), axis=-1)[..., :per_row]
        np.put_along_axis(lg.view(np.int32), pick, -1, axis=-1)
    g_w = T(rng.standard_normal((G, n_tok * k)).astype(np.float32)).to(card)
    grads = []
    for fn in (TR.moe_route, TR.moe_route_plain):
        x = T(lg).to(card).requires_grad_(True)
        reset_launches()
        out = fn(x, k, cap)
        launches = launch_counts()
        gx, = torch.autograd.grad((out[3] * g_w).sum(), x)
        grads.append((gx, out, launches))
    (got, out_k, l_k), (ref, out_p, l_p) = grads
    assert l_k == {"moe_route": 1} and l_p == {}
    _route_same(out_k, out_p, "forward")
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(got), nan)
    torch.testing.assert_close(got[~nan], ref[~nan], rtol=1e-5, atol=1e-7)
    picked = torch.zeros_like(ref, dtype=torch.bool)
    picked.view(G, -1).scatter_(
        -1, (out_p[1].long() * E + out_p[0].long()), True)
    assert (got[~picked] == 0).all()
    if per_row is None:
        assert float(got.abs().sum()) > 0


@pytest.mark.cuda
def test_reduced_train_step_on_card_matches_cpu(card):
    """One ``make_train_step`` step of reduced float32 Moonlight-16B-A3B
    (grouped routing: K7 on the card, the ``torch`` route on the CPU) from
    the same weights, state and batch: the loss within rtol 1e-5, every
    gradient leaf (the router's included) within 1e-4 relative Frobenius,
    ``grad_norm`` within rtol 1e-4; K7 launched in the step. The updated
    parameters: each leaf within 1e-5 relative Frobenius of the CPU step's,
    every element within 2 * lr. Adam's first update is lr * g / (|g| +
    eps) per element, so an element whose gradient is near 0 can move by
    up to 2 * lr when its float32 rounding differs between the devices
    (one element of 65536 moved 1.7e-5 on an H100)."""
    from repro_torch import engine
    from repro_torch.configs import get_config
    from repro_torch.core.butterfly import tree_leaves, tree_map
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.models.config import TrainConfig
    from repro_torch.optim import adamw_init
    cfg = get_config("moonshot_v1_16b_a3b").reduced()
    tcfg = TrainConfig(global_batch=2, seq_len=64, lr=1e-3, warmup_steps=1,
                       total_steps=10)
    model, step = make_train_step(cfg, tcfg)
    p_cpu = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = SyntheticLM(cfg.vocab_size, 64, 2, seed=1, device="cpu").batch(0)
    out = {}
    engine.clear_plans()
    for dev in ("cpu", card):
        # a copy on either device: the step updates its tensors in place
        params = tree_map(lambda t: t.to(dev, copy=True), p_cpu)
        b = {k: v.to(dev) for k, v in batch.items()}
        _, _, grads = loss_and_grads(model, params, b)
        reset_launches()
        params, opt, met = step(params, adamw_init(params), b)
        out[str(dev)] = (met, [g.cpu() for g in grads],
                         [t.cpu() for t in tree_leaves(params)],
                         launch_counts())
    (m0, g0, p0, l0), (m1, g1, p1, l1) = out["cpu"], out[str(card)]
    assert l0 == {} and l1.get("moe_route", 0) > 0
    np.testing.assert_allclose(float(m1["loss"]), float(m0["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m1["grad_norm"]), float(m0["grad_norm"]),
                               rtol=1e-4)
    for a, b in zip(g1, g0):
        assert float((a - b).norm() / max(float(b.norm()), 1e-30)) <= 1e-4
    for a, b in zip(p1, p0):
        torch.testing.assert_close(a, b, rtol=0, atol=2 * tcfg.lr)
        assert float((a - b).norm() / max(float(b.norm()), 1e-30)) <= 1e-5


# --------------------------------------------------------------------------
# the mesh: 2 gloo ranks sharing the card
# --------------------------------------------------------------------------

def _two_ranks_on_card(rank, store, case, out_dir):
    """One of 2 gloo ranks on ``cuda:0``: the case's op under its kernel
    variant and under ``torch``, compared here; the rank exits 1 on a
    mismatch."""
    import os
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    try:
        from repro_torch import engine
        from repro_torch.kernels import launch_counts, reset_launches
        from repro_torch.launch.mesh import make_mesh
        mesh = make_mesh((2,), ("data",), backend="gloo", rank=rank,
                         world_size=2, store_dir=store, timeout_s=60.0)
        gen = torch.Generator(device="cuda").manual_seed(31 + rank)
        if case == "sort":
            pool = torch.tensor([-np.inf, -1.0, 0.0, 0.5, 2.0, 7.0],
                                device="cuda")
            x = pool[torch.randint(0, 6, (1 << 16,), generator=gen,
                                   device="cuda")]
            gidx = rank * x.numel() + torch.arange(
                x.numel(), dtype=torch.int32, device="cuda")
            for levels in (1, 2):
                plan = engine.Plan("tree_cuda", w=32, levels=levels)
                reset_launches()
                got = engine.sharded_sort(x, mesh, plan=plan)
                gkv, gp = engine.sharded_sort(x, mesh, payload=gidx,
                                              plan=plan)
                n = launch_counts()
                want = engine.sharded_sort(x, mesh, variant="torch")
                wkv, wp = engine.sharded_sort(x, mesh, payload=gidx,
                                              variant="torch")
                # 2 runs a rank: one tree level, a K3 pass at either depth
                assert n.get("segmented_merge_runs", 0) >= 1 and \
                    n.get("segmented_merge_runs_kv", 0) >= 1, n
                for a, b in ((got.values, want.values),
                             (got.count, want.count),
                             (got.overflow, want.overflow),
                             (gkv.values, wkv.values), (gp, wp)):
                    assert torch.equal(_bits(a), _bits(b))
        else:
            lg = torch.randn(512, 16, generator=gen, device="cuda")
            for cap in (1, 40, 1024):
                reset_launches()
                got = engine.moe_route_ep(lg, 2, cap, mesh, "data",
                                          variant="fused")
                assert launch_counts().get("moe_route", 0) == 1
                want = engine.moe_route_ep(lg, 2, cap, mesh, "data",
                                           variant="torch")
                for f in got._fields:
                    a, b = getattr(got, f), getattr(want, f)
                    if f == "weights":
                        d = (a.view(torch.int32).long()
                             - b.view(torch.int32).long()).abs().max()
                        assert int(d) <= ROUTE_WEIGHT_ULPS, (cap, int(d))
                    else:
                        assert torch.equal(a, b), (cap, f)
        open(os.path.join(out_dir, f"ok{rank}"), "w").close()
    except Exception:
        import traceback
        traceback.print_exc()
        os._exit(1)
    os._exit(0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["sort", "route"])
def test_two_ranks_share_the_card(card, case, tmp_path):
    """``sharded_sort`` on ``tree_cuda`` (2 runs a rank: one K3 pass at
    levels 1 and 2; key-only and KV) and ``moe_route_ep`` on ``fused`` (K7; capacities 1, 40 and
    slack) on 2 gloo ranks sharing the card, each against its ``torch``
    variant on the same shard: bit for bit (K7's weights within
    ``ROUTE_WEIGHT_ULPS``)."""
    import os
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_two_ranks_on_card,
                         args=(r, str(tmp_path / "store"), case,
                               str(tmp_path))) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(180)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0, 0]
    assert all(os.path.exists(tmp_path / f"ok{r}") for r in range(2))


def _train_rank_on_card(rank, store, out_dir):
    """One of 2 gloo ranks on ``cuda:0``: one ``make_train_step`` step of
    reduced Moonlight-16B-A3B on a (1, 2) ``("data", "model")`` mesh (2
    experts a rank through ``moe_apply_ep``) from the seeded init; the
    loss, the gathered parameters and K7's launches to ``out_dir``."""
    import os
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    try:
        from repro_torch.configs import get_config
        from repro_torch.core.butterfly import tree_leaves
        from repro_torch.data.pipeline import SyntheticLM
        from repro_torch.kernels import launch_counts, reset_launches
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.launch.steps import make_train_step
        from repro_torch.models.config import TrainConfig
        from repro_torch.parallel.sharding import gather_leaf
        mesh = make_mesh((1, 2), ("data", "model"), backend="gloo",
                         rank=rank, world_size=2, store_dir=store,
                         timeout_s=120.0)
        cfg = get_config("moonshot_v1_16b_a3b").reduced()
        tcfg = TrainConfig(global_batch=2, seq_len=64, lr=1e-3,
                           warmup_steps=1, total_steps=10)
        _, step = make_train_step(cfg, tcfg, mesh)
        lay = step.layout
        params = lay.init(torch.Generator(device="cuda").manual_seed(0))
        opt = lay.opt_init(params)
        batch = SyntheticLM(cfg.vocab_size, 64, 2, seed=1).batch(0)
        reset_launches()
        params, opt, met = step(params, opt, lay.batch_block(batch))
        k7 = launch_counts().get("moe_route", 0)
        full = {"/".join(lf.path): gather_leaf(b, lf.pspec, mesh).cpu()
                for lf, b in zip(lay.plans(params), tree_leaves(params))}
        if rank == 0:
            torch.save({"loss": float(met["loss"]),
                        "grad_norm": float(met["grad_norm"]),
                        "params": full, "k7": k7},
                       os.path.join(out_dir, "mesh.pt"))
        open(os.path.join(out_dir, f"ok{rank}"), "w").close()
    except Exception:
        import traceback
        traceback.print_exc()
        os._exit(1)
    os._exit(0)


@pytest.mark.cuda
def test_mesh_train_step_on_card_matches_one_process(card, tmp_path):
    """A 2-rank (1, 2) train step of reduced float32 Moonlight-16B-A3B
    (K7 in every MoE layer's forward and in its gradient's path, expert
    parallel over ``model``) on the shared card against the one-process
    card step from the same seeded init and batch: the loss and the
    gradient's norm within rtol 1e-5, each leaf within 1e-5 relative
    Frobenius and every element within 2 * lr
    (``test_reduced_train_step_on_card_matches_cpu`` says why an element
    may move by that much)."""
    import os
    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.config import TrainConfig
    from repro_torch.optim import adamw_init
    cfg = get_config("moonshot_v1_16b_a3b").reduced()
    tcfg = TrainConfig(global_batch=2, seq_len=64, lr=1e-3, warmup_steps=1,
                       total_steps=10)
    model, step = make_train_step(cfg, tcfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    batch = SyntheticLM(cfg.vocab_size, 64, 2, seed=1).batch(0)
    params, _, met = step(params, adamw_init(params), batch)
    one = {n: t.cpu() for n, t in _flatten(params)}
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_train_rank_on_card,
                         args=(r, str(tmp_path / "store"), str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0, 0]
    got = torch.load(os.path.join(tmp_path, "mesh.pt"))
    assert got["k7"] > 0
    np.testing.assert_allclose(got["loss"], float(met["loss"]), rtol=1e-5)
    # the gradient's norm: a backward that sums where it should slice
    # scales a leaf's gradient, which AdamW's update does not show
    np.testing.assert_allclose(got["grad_norm"], float(met["grad_norm"]),
                               rtol=1e-5)
    assert set(got["params"]) == set(one)
    for n, b in one.items():
        a = got["params"][n]
        torch.testing.assert_close(a, b, rtol=0, atol=2 * tcfg.lr)
        assert float((a - b).norm() / max(float(b.norm()), 1e-30)) <= 1e-5, n
