"""K9: the FLiMS lane merge of every run pair of one tree level.

No ``pl.pallas_call`` of the JAX package corresponds. Its ``tree_vmapped``
executor (``repro/engine/schedule.py`` ``_vmapped_reduce``) merges the pairs
of each tree level with ``jax.vmap(merge_lanes)`` (``repro/core/lanes.py``),
a ``lax.scan`` over ``ceil(n_out / w)`` FLiMS cycles that XLA runs as one
loop on the device. Run as Python, those cycles are some 30 tensor
operations each, tens of thousands a level at a real width; so on the card
the scan is a kernel, one launch a level (``csrc/lane_merge.cu``, a warp a
pair).

``lane_merge`` merges key-only pairs (``tie="b"``: algorithm 1, ties to B;
``tie="skew"``: algorithm 2's oscillating selector), ``lane_merge_kv``
(key, int32 rank) pairs under the compound order (algorithm 3). Pair ``p``
merges ``a[a_starts[p]:+a_lens[p]]`` with ``b[b_starts[p]:+b_lens[p]]``;
the merged pairs are concatenated in pair order and cut at ``n_out``. Both
launch the kernel for CUDA tensors (keys of at most 32 bits, widened to
int32 / float32 by ``_build.widen``; w a power of two, past 128 the wide
lane form of ``csrc/wide_merge.cu``, a CTA a pair) and run the plain version,
the batched ``core.lanes.merge_lanes`` over the pairs gathered into rows,
for CPU tensors. ``lane_merge_plain`` / ``lane_merge_kv_plain`` run the plain
version on any device. Results are ``merge_lanes``' bit for bit: +0.0 /
-0.0 and NaN payloads included.

``lane_merge_level`` is the executor's form: one buffer of uniform runs of
``run_len`` keys, run 2p merged with run 2p + 1 in place of both. The kernel
derives every pair's starts from its index, so a level costs no host-side
tensors; the plain version, ``lane_merge_level_plain``, is the batched
``merge_lanes`` over the buffer viewed as (P, 2, run_len) rows. A level's
launches count as ``lane_merge`` (no ranks) or ``lane_merge_kv`` (ranks).

On the card a level's chains are cut into blocks of ``level_blocks`` cycles,
one warp a block, each restarted at the merge-path co-rank of its first
output (``block_starts_plain`` is the plain twin of that search), so that a
level of few long pairs fills the card. A pair holding a NaN or a run out of
order, or under ``tie="skew"`` both +0.0 and -0.0, runs its whole chain
instead (``level_guard_plain`` is the plain twin of that flag); the output is
the chain's on every input. ``chain=True`` runs every pair's whole chain, one
warp a pair (a test hook; the executor never passes it). The ragged forms
run one warp a pair.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.core.lanes import (INVALID_RANK, KEY, RANK, key_compare,
                                    merge_lanes, plus_inf_for, sentinel_for,
                                    stable_compare)
from repro_torch.kernels import _build

__all__ = ["lane_merge", "lane_merge_plain", "lane_merge_kv",
           "lane_merge_kv_plain", "lane_merge_level", "lane_merge_level_plain",
           "level_blocks", "block_starts_plain", "level_guard_plain", "MAX_W",
           "MIN_BLOCK_CYCLES"]

#: the widest selector the kernel takes (a warp of four elements a lane)
MAX_W = 128
#: fewest cycles a block of a cut chain runs: its co-rank search, a few
#: rounds of dependent loads, is paid once a block
MIN_BLOCK_CYCLES = 16


def _check(name, a, b, ra, rb, starts, w, tie, n_out):
    if a.ndim != 1 or b.ndim != 1 or a.dtype != b.dtype:
        raise ValueError(f"{name}: two 1-D key buffers of one dtype")
    if (ra is None) != (rb is None):
        raise ValueError(f"{name}: ranks for both sides or neither")
    if len({t.shape for t in starts}) != 1 or starts[0].ndim != 1:
        raise ValueError(f"{name}: (P,) starts and lengths of one shape")
    if w < 1 or w & (w - 1):
        raise ValueError(f"{name}: w must be a power of two, got {w}")
    if tie not in ("b", "skew") or (tie == "skew" and ra is not None):
        raise ValueError(f"{name}: tie 'b', or 'skew' on key-only lanes; "
                         f"got {tie!r}")
    if n_out < 0:
        raise ValueError(f"{name}: n_out={n_out} < 0")


def _out_starts(a_lens, b_lens):
    lens = a_lens.to(torch.int32) + b_lens.to(torch.int32)
    return torch.cumsum(lens, 0, dtype=torch.int32) - lens


def _bank(x, starts, lens):
    """(P, cap) rows ``x[starts[p] : starts[p] + cap]``, cap the longest
    length; columns past a row's length are masked by ``merge_lanes``."""
    cap = int(lens.max()) if lens.numel() else 0
    if x.shape[0] == 0 or cap == 0:
        return x.new_zeros((starts.shape[0], cap))
    idx = starts.long()[:, None] + torch.arange(cap, device=x.device)
    return x[idx.clamp(0, x.shape[0] - 1)]


def _plain(a, ra, b, rb, a_starts, a_lens, b_starts, b_lens, n_out, w, tie):
    dev = a.device
    P = a_starts.shape[0]
    if P == 0 or n_out == 0:
        return a.new_zeros((n_out,)), (
            None if ra is None else torch.zeros(n_out, dtype=torch.int32,
                                                device=dev))
    la, lb = a_lens.to(dev).long(), b_lens.to(dev).long()
    sa, sb = a_starts.to(dev), b_starts.to(dev)
    A, B = {KEY: _bank(a, sa, la)}, {KEY: _bank(b, sb, lb)}
    if ra is not None:
        A[RANK] = _bank(ra.to(torch.int32), sa, la)
        B[RANK] = _bank(rb.to(torch.int32), sb, lb)
    rows = merge_lanes(A, B, w=w, tie=tie, a_lens=la, b_lens=lb,
                       compare=key_compare if ra is None else stable_compare)
    # each pair's merge back to its flat place, cut at n_out
    width = rows[KEY].shape[1]
    pos = torch.arange(n_out, device=dev)
    start = _out_starts(la, lb).long()
    p = (torch.searchsorted(start, pos, right=True) - 1).clamp(0, P - 1)
    flat = p * width + (pos - start[p])
    keys = rows[KEY].reshape(-1)[flat]
    return keys, None if ra is None else rows[RANK].reshape(-1)[flat]


def _launch(name, a, ra, b, rb, starts, run_len, pairs, n_out, w, tie,
            cycles=0):
    """One K9 launch; ``starts`` the five (P,) int32 pair vectors (A / B
    starts and lengths, out starts), or None for a uniform level, whose
    chains run whole (``cycles`` 0) or in blocks of ``cycles``."""
    code = _build.dtype_code(name, a.dtype)
    if w > MAX_W:
        return _launch_wide(name, code, a, ra, b, rb, starts, run_len, pairs,
                            n_out, w, tie)
    _build.check_cuda(name, a, ra, b, rb, *(starts or ()))
    out = torch.empty(n_out, dtype=a.dtype, device=a.device)
    rout = None if ra is None else torch.empty(n_out, dtype=torch.int32,
                                               device=a.device)
    # the guard's per-pair bits, where a level's chains are cut
    flags = torch.empty(pairs, dtype=torch.int32, device=a.device) if \
        cycles else None
    if pairs and n_out:
        _build.launch(name, "flims_lane_merge", code, int(ra is not None),
                      int(tie == "skew"), w, int(not cycles), _build.ptr(a),
                      _build.ptr(ra), _build.ptr(b), _build.ptr(rb),
                      *map(_build.ptr, starts or (None,) * 5), run_len,
                      pairs, cycles, _build.ptr(flags), n_out,
                      _build.ptr(out), _build.ptr(rout),
                      _build.stream(a.device))
    return out, rout


def _launch_wide(name, code, a, ra, b, rb, starts, run_len, pairs, n_out, w,
                 tie):
    """K9 past ``MAX_W``: the lane form of ``csrc/wide_merge.cu``, a CTA a
    pair running its whole chain with the lanes in shared memory. A uniform
    level's five pair vectors are made here."""
    dev = a.device
    if starts is None:
        a_st = torch.arange(pairs, dtype=torch.int32, device=dev) * (
            2 * run_len)
        ln = torch.full((pairs,), run_len, dtype=torch.int32, device=dev)
        starts = (a_st, ln, a_st + run_len, ln, a_st)
    _build.check_cuda(name, a, ra, b, rb, *starts)
    out = torch.empty(n_out, dtype=a.dtype, device=dev)
    rout = None if ra is None else torch.empty(n_out, dtype=torch.int32,
                                               device=dev)
    if pairs and n_out:
        lib = _build.library()
        ctas = max(1, min(pairs, 2 * torch.cuda.get_device_properties(
            dev).multi_processor_count))
        per_cta = lib.flims_lane_wide_scratch(int(ra is not None), w)
        scratch = torch.empty(max(ctas * per_cta, 1), dtype=torch.uint8,
                              device=dev)
        P = _build.ptr
        _build.launch(name, "flims_lane_wide", code, int(ra is not None),
                      int(tie == "skew"), w, P(a), P(ra), P(b), P(rb),
                      *map(P, starts), pairs, n_out, P(scratch), ctas,
                      P(out), P(rout), _build.stream(dev))
    return out, rout


_resident = {}


def _resident_warps(code: int, kv: bool, skew: bool, w: int, device) -> int:
    """Warps of the uniform-level kernel the card holds at once: SMs times
    its occupancy at w."""
    key = (code, kv, skew, w, device)
    if key not in _resident:
        per_sm = _build.library().flims_lane_merge_occupancy(
            code, int(kv), int(skew), w)
        if per_sm <= 0:
            raise _build.KernelError(
                f"lane_merge: occupancy query failed ({per_sm}) at w={w}")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _resident[key] = per_sm * sms
    return _resident[key]


def level_blocks(buf, ranks, run_len: int, *, w: int, tie: str = "b",
                 cycles=None):
    """``(cycles a block, blocks a pair)`` of K9 at a level of ``buf``'s
    runs of ``run_len`` (a CUDA buffer): each pair's chain of ceil(2 run_len
    / w) cycles cut so that the level's cycles spread over the warps the
    card holds, at least ``MIN_BLOCK_CYCLES`` a block (``cycles`` forces
    the count)."""
    chain_len = -(-2 * run_len // w)
    pairs = buf.shape[0] // (2 * run_len) if run_len > 0 else 0
    if pairs == 0:
        return chain_len, 1
    if cycles is None:
        code = _build.dtype_code("lane_merge_level", buf.dtype)
        warps = _resident_warps(code, ranks is not None, tie == "skew", w,
                                buf.device)
        cycles = max(MIN_BLOCK_CYCLES, -(-chain_len * pairs // warps))
    if cycles < 1:
        raise ValueError(f"lane_merge_level: cycles={cycles} < 1")
    cycles = min(cycles, chain_len)
    return cycles, -(-chain_len // cycles)


def _cuda(name, a, ra, b, rb, a_starts, a_lens, b_starts, b_lens, n_out, w,
          tie):
    i32 = lambda t: t.to(device=a.device, dtype=torch.int32).contiguous()
    a_starts, a_lens, b_starts, b_lens = map(i32, (a_starts, a_lens,
                                                   b_starts, b_lens))
    starts = (a_starts, a_lens, b_starts, b_lens,
              _out_starts(a_lens, b_lens))
    return _launch(name, a, ra, b, rb, starts, 0, a_starts.shape[0], n_out,
                   w, tie)


def _run(name, a, ra, b, rb, starts, n_out, w, tie, cuda):
    _check(name, a, b, ra, rb, starts, w, tie, n_out)
    if ra is not None:
        ra, rb = ra.to(torch.int32), rb.to(torch.int32)
    dt, a, b = a.dtype, _build.widen(a), _build.widen(b)
    out = _cuda(name, a, ra, b, rb, *starts, n_out, w, tie) if cuda \
        else _plain(a, ra, b, rb, *starts, n_out, w, tie)
    return _build.narrow_keys(out, dt)


@obs.scoped("kernels.lane_merge")
def lane_merge(a, b, a_starts, a_lens, b_starts, b_lens, *, n_out: int,
               w: int = 32, tie: str = "b"):
    """Merge P descending key-only run pairs, each by the FLiMS lane merge.
    Returns the ``(n_out,)`` concatenation of the merged pairs."""
    return _run("lane_merge", a, None, b, None,
                (a_starts, a_lens, b_starts, b_lens), n_out, w, tie,
                a.is_cuda)[0]


def lane_merge_plain(a, b, a_starts, a_lens, b_starts, b_lens, *,
                     n_out: int, w: int = 32, tie: str = "b"):
    """``lane_merge``'s plain version, on any device."""
    return _run("lane_merge", a, None, b, None,
                (a_starts, a_lens, b_starts, b_lens), n_out, w, tie,
                False)[0]


@obs.scoped("kernels.lane_merge_kv")
def lane_merge_kv(a, ra, b, rb, a_starts, a_lens, b_starts, b_lens, *,
                  n_out: int, w: int = 32):
    """Stable form of ``lane_merge`` over (key, int32 rank) lanes in the
    compound (key descending, rank ascending) order. Returns ``(keys,
    ranks)``."""
    return _run("lane_merge_kv", a, ra, b, rb,
                (a_starts, a_lens, b_starts, b_lens), n_out, w, "b",
                a.is_cuda)


def lane_merge_kv_plain(a, ra, b, rb, a_starts, a_lens, b_starts, b_lens, *,
                        n_out: int, w: int = 32):
    """``lane_merge_kv``'s plain version, on any device."""
    return _run("lane_merge_kv", a, ra, b, rb,
                (a_starts, a_lens, b_starts, b_lens), n_out, w, "b", False)


def _level(buf, ranks, run_len, w, tie, cuda, chain=False, cycles=None):
    name = "lane_merge" if ranks is None else "lane_merge_kv"
    n = buf.shape[0]
    P = n // (2 * run_len) if run_len > 0 else 0
    if buf.ndim != 1 or P * 2 * run_len != n or not 0 <= run_len < 2 ** 30:
        raise ValueError(f"{name}: a 1-D buffer of pairs of runs of "
                         f"run_len={run_len} keys, got {tuple(buf.shape)}")
    _check(name, buf, buf, ranks, ranks, (buf,), w, tie, n)
    if ranks is not None:
        ranks = ranks.to(torch.int32)
    dt, buf = buf.dtype, _build.widen(buf)
    if cuda:
        blocks = 1
        if P and w <= MAX_W and not chain:
            cycles, blocks = level_blocks(buf, ranks, run_len, w=w, tie=tie,
                                          cycles=cycles)
        return _build.narrow_keys(_launch(
            name, buf, ranks, buf, ranks, None, run_len, P, n, w, tie,
            cycles=cycles if blocks > 1 else 0), dt)
    rows = lambda x: x.reshape(P, 2, run_len)
    A, B = {KEY: rows(buf)[:, 0]}, {KEY: rows(buf)[:, 1]}
    if ranks is not None:
        A[RANK], B[RANK] = rows(ranks)[:, 0], rows(ranks)[:, 1]
    out = merge_lanes(A, B, w=w, tie=tie,
                      compare=key_compare if ranks is None else
                      stable_compare)
    return _build.narrow(out[KEY].reshape(-1), dt), (
        None if ranks is None else out[RANK].reshape(-1))


@obs.scoped("kernels.lane_merge_level")
def lane_merge_level(buf, ranks, run_len: int, *, w: int = 32,
                     tie: str = "b", chain: bool = False, _cycles=None):
    """One tree level over ``buf``'s uniform descending runs of ``run_len``
    keys: run 2p merged with run 2p + 1 (key-only under ``tie``, or with
    int32 ``ranks`` under the compound order and ``tie="b"``). Returns
    ``(keys, ranks or None)``; K9 for CUDA tensors, the plain version for
    CPU ones. On the card each pair's chain runs in blocks restarted at
    their co-ranks; ``chain=True`` runs it whole (a test hook, the same
    output), ``_cycles`` forces the cycles a block (tests and measurement
    only)."""
    return _level(buf, ranks, run_len, w, tie, buf.is_cuda, chain, _cycles)


def lane_merge_level_plain(buf, ranks, run_len: int, *, w: int = 32,
                           tie: str = "b"):
    """``lane_merge_level``'s plain version, on any device."""
    return _level(buf, ranks, run_len, w, tie, False)


def _probe(x, r, idx, length):
    """Lanes ``x[:, idx]`` with the co-rank search's guards: the first key
    (and the lowest rank) before 0, the last key (and ``INVALID_RANK``) from
    ``length`` on."""
    take = lambda t: torch.gather(t, 1, idx.clamp(0, length - 1))
    k = take(x)
    k = torch.where(idx < 0, k.new_full((), plus_inf_for(x.dtype)), k)
    k = torch.where(idx >= length, k.new_full((), sentinel_for(x.dtype)), k)
    if r is None:
        return {KEY: k}
    rk = take(r)
    rk = torch.where(idx < 0, rk.new_full((), -2 ** 31), rk)
    return {KEY: k, RANK: torch.where(idx >= length,
                                      rk.new_full((), INVALID_RANK), rk)}


def block_starts_plain(buf, ranks, run_len: int, w: int,
                       cycles_per_block: int):
    """The plain twin of K9's block restarts at a uniform level: ``(pA,
    pB)``, each (P, blocks a pair) int64, of block j of pair p, the
    merge-path co-rank of ``o = j * cycles_per_block * w`` under the
    selector's order (strict ``>`` key-only, the compound order with
    ``ranks``), by the kernel's binary search: lo, hi = (mid, hi) if
    A[mid - 1] goes before B[o - mid] else (lo, mid - 1), mid = (lo + hi +
    1) // 2, from [max(0, o - run_len), min(o, run_len)]."""
    L, C = run_len, cycles_per_block
    P = buf.shape[0] // (2 * L)
    rows = lambda x: None if x is None else x.reshape(P, 2, L)
    kb, rb = rows(buf), rows(ranks)
    ak, bk = kb[:, 0], kb[:, 1]
    ar, br = (None, None) if rb is None else (rb[:, 0], rb[:, 1])
    compare = key_compare if ranks is None else stable_compare
    chain = -(-2 * L // w)
    bpp = -(-chain // C)
    o = (torch.arange(bpp, device=buf.device) * C * w).expand(P, bpp)
    lo, hi = (o - L).clamp(min=0), o.clamp(max=L)
    for _ in range(L.bit_length() + 1):
        mid = lo + (hi - lo + 1) // 2
        ok = compare(_probe(ak, ar, mid - 1, L), _probe(bk, br, o - mid, L))
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid - 1)
    return lo, o - lo


def level_guard_plain(buf, ranks, run_len: int, tie: str = "b"):
    """The plain twin of K9's guard at a uniform level: (P,) bool, set where
    pair p must run its whole chain: it holds a NaN, or a run out of the
    selector's order (a key that goes before its predecessor), or under
    ``tie="skew"`` both +0.0 and -0.0."""
    P = buf.shape[0] // (2 * run_len)
    k = buf.reshape(P, 2, run_len)
    lanes = {KEY: k}
    if ranks is not None:
        lanes[RANK] = ranks.to(torch.int32).reshape(P, 2, run_len)
    nxt = {n: x[..., 1:] for n, x in lanes.items()}
    prv = {n: x[..., :-1] for n, x in lanes.items()}
    compare = key_compare if ranks is None else stable_compare
    flag = compare(nxt, prv).flatten(1).any(1)
    if buf.dtype.is_floating_point:
        flag |= torch.isnan(k).flatten(1).any(1)
        if tie == "skew":
            bits = k.view(torch.int32).flatten(1)
            flag |= (bits == 0).any(1) & (bits == -2 ** 31).any(1)
    return flag
