"""The plain versions of K1, K5, K6 and K7 at shapes past the card's old
limits (one CTA's shared memory: rows of 16384 keys, caps 32768 / 16384,
16384 padded routing pairs), which the kernels now take, against the JAX
package on the CPU:

- K1 / K1kv at rows of 32768, K5 at cap 65536 and K6 at cap 32768 against
  the JAX kernels in interpret mode (``sort_chunks_pallas``,
  ``sort_chunks_kv_pallas``, ``segment_sort_pallas``,
  ``segment_sort_kv_pallas``; a few seconds each at these widths), on keys
  holding NaNs of two payloads, +0.0 and -0.0: bit for bit, as the card
  holds each kernel to its plain version (``tests/test_torch_cuda.py``);
- ``moe_route_plain`` at (1, 4096, 64) k 6 (T*k = 24576 pairs, Np 32768)
  against ``moe_route_xla``: the integer lanes bit for bit, the weights
  within ``WEIGHT_ULPS`` = 4 ulps (``tests/test_torch_moe.py``'s bound).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.bitonic_sort import (sort_chunks_kv_pallas,  # noqa: E402
                                        sort_chunks_pallas)
from repro.kernels.route_fuse import moe_route_xla  # noqa: E402
from repro.kernels.segmented_merge import (segment_sort_kv_pallas,  # noqa: E402,E501
                                           segment_sort_pallas)
from repro_torch.kernels import bitonic_sort as TB  # noqa: E402
from repro_torch.kernels import route_fuse as TR  # noqa: E402
from repro_torch.kernels import segmented_merge as TS  # noqa: E402

WEIGHT_ULPS = 4
POOL = np.array([np.nan, 0.0, -0.0, 1.5, -1.0, -np.inf, 4.0, 4.0],
                np.float32)


def keys(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.choice(POOL, n).astype(np.float32)
    x.view(np.int32)[rng.random(n) < 0.05] = np.int32(-4194304)   # -NaN
    return x


def same_bits(got, exp, what):
    g = got.numpy()
    e = np.asarray(exp)
    assert g.shape == e.shape, what
    g, e = (a.view(np.int32) if a.dtype == np.float32 else a for a in (g, e))
    bad = np.flatnonzero(g != e)
    assert not bad.size, f"{what}: {bad.size} differ, first at {bad[0]}"


def test_k1_rows_of_32768_match_jax():
    c = 2 * TB.ROW_TILE
    x = keys(2 * c, 1).reshape(2, c)
    r = np.arange(2 * c, dtype=np.int32).reshape(2, c)
    same_bits(TB.sort_chunks_plain(torch.from_numpy(x)),
              sort_chunks_pallas(jnp.asarray(x)), "K1")
    kt, rt = TB.sort_chunks_kv_plain(torch.from_numpy(x), torch.from_numpy(r),
                                     descending=False)
    kj, rj = sort_chunks_kv_pallas(jnp.asarray(x), jnp.asarray(r),
                                   descending=False)
    same_bits(kt, kj, "K1kv keys")
    same_bits(rt, rj, "K1kv ranks")


def _segments(lens, seed):
    x = keys(sum(lens), seed)
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    return x, offs


def test_k5_cap_65536_matches_jax():
    cap = 2 * TS.MAX_CAP
    x, offs = _segments([3, cap, 40000, 0, 17], 2)
    same_bits(TS.segment_sort_plain(torch.from_numpy(x),
                                    torch.from_numpy(offs), cap=cap),
              segment_sort_pallas(jnp.asarray(x), jnp.asarray(offs),
                                  cap=cap), "K5")


def test_k6_cap_32768_matches_jax():
    cap = 2 * TS.MAX_CAP_KV
    x, offs = _segments([5, 20000, cap, 1], 3)
    kt, pt = TS.segment_sort_kv_plain(torch.from_numpy(x),
                                      torch.from_numpy(offs), cap=cap)
    kj, pj = segment_sort_kv_pallas(jnp.asarray(x), jnp.asarray(offs),
                                    cap=cap)
    same_bits(kt, kj, "K6 keys")
    same_bits(pt, pj, "K6 perm")


def test_route_plain_past_16384_pairs_matches_xla():
    rng = np.random.default_rng(4)
    lg = (np.round(rng.standard_normal((1, 4096, 64)) * 2) / 2).astype(
        np.float32)
    lg[lg == 0.0] = np.where(rng.random((lg == 0.0).sum()) < 0.5, -0.0, 0.0)
    k, cap = 6, 480
    got = TR.moe_route_plain(torch.from_numpy(lg), k, cap)
    ref = moe_route_xla(jnp.asarray(lg), k, cap)
    for i, (g, r) in enumerate(zip(got, ref)):
        r = np.asarray(r)
        if i == 3:
            d = g.numpy().view(np.int32).astype(np.int64) - \
                r.view(np.int32).astype(np.int64)
            assert np.abs(d).max() <= WEIGHT_ULPS
        else:
            np.testing.assert_array_equal(g.numpy(), r.astype(np.int32))
