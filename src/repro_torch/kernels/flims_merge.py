"""K2: merge-path partitioned FLiMS 2-way merge, and the shared plain dataflow.

Counterpart of ``repro/kernels/flims_merge.py``. A merge-path co-rank
search splits the output into ``C``-wide blocks (``C`` a multiple of ``w``,
so the rotation invariant ``(lA + lB) ≡ 0 (mod w)`` holds at every block
start) and each block runs ``C/w`` FLiMS cycles: the MAX selector over the A
heads and the reversed B heads, a log2(w) butterfly, and two-row windows
that advance by the selector count.

``flims_merge`` / ``flims_merge_kv`` launch the CUDA kernel
``csrc/flims_merge.cu`` (the K3 kernel with one run pair) for a CUDA tensor
and run the plain version below for a CPU tensor; ``flims_merge_plain`` /
``flims_merge_kv_plain`` run it on any device. The plain version repeats
the TPU kernel's arithmetic vectorised over blocks; the CPU tests hold it
against the JAX kernel and ``chip_smoke.py`` holds the CUDA kernel against
it. Key-only lanes merge descending with XLA's max/min rule; KV lanes by
(key in the call's direction, rank ascending). Past ``MAX_W`` the card
runs :func:`wide_tree`, the wide form of ``csrc/wide_merge.cu`` that K4
and K8 also take past their fast kernels' levels and widths. Keys of any
dtype of at most 32 bits run widened (``_build.widen``).
"""
from __future__ import annotations

import math
from typing import Callable, Tuple

import torch

from repro_torch import obs
from repro_torch.core.lanes import INVALID_RANK, plus_inf_for, sentinel_for
from repro_torch.kernels import _build

__all__ = ["flims_merge", "flims_merge_kv", "flims_merge_plain",
           "flims_merge_kv_plain", "bound_keys", "plus_inf_for", "lane_first",
           "xla_max", "xla_min", "corank_rounds"]

_INT_VIEW = {torch.float32: torch.int32, torch.float64: torch.int64,
             torch.float16: torch.int16, torch.bfloat16: torch.int16}

_RANK_LO = -2 ** 31


def _keeps_a(a: torch.Tensor, b: torch.Tensor, on_sign: bool):
    """Where the result is ``a`` for a NaN ``a``: always against a number;
    against a NaN ``b``, where ``a``'s sign bit is ``on_sign``."""
    neg = a.view(_INT_VIEW[a.dtype]) < 0
    return torch.isnan(a) & (~torch.isnan(b) | (neg if on_sign else ~neg))


def xla_max(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum`` as XLA computes it: a NaN operand wins, and of a
    +0/-0 pair the result is +0 in either order (``torch.maximum`` returns
    its first operand there). Of two NaNs: ``a`` if its sign bit is set,
    else ``b`` (XLA on the CPU, jax 0.9.0)."""
    if not a.dtype.is_floating_point:
        return torch.maximum(a, b)
    it = _INT_VIEW[a.dtype]
    eq = (a.view(it) & b.view(it)).view(a.dtype)
    out = torch.where(a > b, a, torch.where(b > a, b, eq))
    out = torch.where(torch.isnan(b), b, out)
    return torch.where(_keeps_a(a, b, True), a, out)


def xla_min(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.minimum`` as XLA computes it (-0 for a +0/-0 pair; of two NaNs,
    ``b`` if ``a``'s sign bit is set, else ``a``)."""
    if not a.dtype.is_floating_point:
        return torch.minimum(a, b)
    it = _INT_VIEW[a.dtype]
    eq = (a.view(it) | b.view(it)).view(a.dtype)
    out = torch.where(a < b, a, torch.where(b < a, b, eq))
    out = torch.where(torch.isnan(b), b, out)
    return torch.where(_keeps_a(a, b, False), a, out)


def bound_keys(dtype, descending: bool = True):
    """(first, last): key values sorting before / after everything real."""
    lo, hi = sentinel_for(dtype), plus_inf_for(dtype)
    return (hi, lo) if descending else (lo, hi)


def lane_first(descending: bool = True) -> Callable:
    """The compound (key, rank) comparator of the KV kernels: key
    descending-or-ascending, rank ascending."""
    if descending:
        return lambda ka, ra, kb, rb: (ka > kb) | ((ka == kb) & (ra < rb))
    return lambda ka, ra, kb, rb: (ka < kb) | ((ka == kb) & (ra < rb))


def block_size(n_out: int, w: int, block_out: int) -> int:
    """The output block ``C``: a multiple of ``w``, at most ``block_out``
    unless ``w`` is larger, no larger than ``next_pow2(n_out)``."""
    C = max(w, min(block_out, 1 << max(n_out - 1, 0).bit_length()))
    return (C // w) * w


def search_steps(n_out: int) -> int:
    return max(1, math.ceil(math.log2(max(n_out, 2))) + 1)


# --------------------------------------------------------------------------
# plain version: butterflies, co-rank search and the windowed dataflow,
# vectorised over the leading (block) axis
# --------------------------------------------------------------------------

def _butterfly_desc(v: torch.Tensor) -> torch.Tensor:
    """Sort (rotated-)bitonic rows descending: log2(w) max/min stages."""
    w = v.shape[-1]
    lead = v.shape[:-1]
    d = w // 2
    while d >= 1:
        x = v.reshape(lead + (w // (2 * d), 2, d))
        hi = xla_max(x[..., 0, :], x[..., 1, :])
        lo = xla_min(x[..., 0, :], x[..., 1, :])
        v = torch.stack([hi, lo], dim=-2).reshape(lead + (w,))
        d //= 2
    return v


def _butterfly_kv(v, r, descending: bool = True):
    """Butterfly over (key, rank) rows under the compound order."""
    first = lane_first(descending)
    w = v.shape[-1]
    lead = v.shape[:-1]
    d = w // 2
    while d >= 1:
        x = v.reshape(lead + (w // (2 * d), 2, d))
        y = r.reshape(lead + (w // (2 * d), 2, d))
        kt, kb, rt, rb = x[..., 0, :], x[..., 1, :], y[..., 0, :], y[..., 1, :]
        m = first(kt, rt, kb, rb)
        v = torch.stack([torch.where(m, kt, kb), torch.where(m, kb, kt)],
                        dim=-2).reshape(lead + (w,))
        r = torch.stack([torch.where(m, rt, rb), torch.where(m, rb, rt)],
                        dim=-2).reshape(lead + (w,))
        d //= 2
    return v, r


def wins_fn(kv: bool, descending: bool):
    """Element order of the selectors and searches: strict ``>`` on keys
    (ties to B) for key-only lanes, the compound order for KV lanes."""
    if kv:
        first = lane_first(descending)
        return lambda x, y: first(x[0], x[1], y[0], y[1])
    return lambda x, y: x[0] > y[0]


def guard(lanes, i, ln, kv: bool, descending: bool):
    """Co-rank guards: a key that precedes everything (and ``_RANK_LO``)
    before index 0, the last key (and INVALID_RANK) from ``ln`` on."""
    first_k, last_k = bound_keys(lanes[0].dtype, descending)
    k = torch.where(i < 0, first_k, lanes[0])
    k = torch.where(i >= ln, last_k, k)
    if not kv:
        return (k,)
    r = torch.where(i < 0, _RANK_LO, lanes[1])
    r = torch.where(i >= ln, INVALID_RANK, r)
    return (k, r)


def run_elem(buf, rbuf, start, ln, i, descending: bool):
    """Element ``i`` of the run ``buf[start : start + ln]`` (tensors of one
    shape), guarded past both ends."""
    n = buf.shape[0]
    src = (start + i).clamp(0, max(n - 1, 0))
    lanes = (buf[src],) if rbuf is None else (buf[src], rbuf[src])
    return guard(lanes, i, ln, rbuf is not None, descending)


def _corank_runs(o, la, lb, astart, bstart, a, ra, b, rb, steps: int,
                 descending: bool = True):
    """Merge-path co-rank inside (A-run, B-run) pairs: the number of A
    elements among the top-``o`` of each pair's union (ties to B on key-only
    lanes, the compound order on KV lanes). All arguments but the buffers
    are tensors of one shape; ``steps`` fixed binary-search steps."""
    wins = wins_fn(ra is not None, descending)
    lo = torch.clamp(o - lb, min=0)
    hi = torch.minimum(o, la)
    for _ in range(steps):
        mid = (lo + hi + 1) // 2
        ok = wins(run_elem(a, ra, astart, la, mid - 1, descending),
                  run_elem(b, rb, bstart, lb, o - mid, descending))
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid - 1)
    return lo


def corank_rounds(pred, lo: int, hi: int, steps: int,
                  levels: int = 5) -> int:
    """Python twin of the card's co-rank search (``corank`` in
    ``csrc/flims_merge.cu``): ``steps`` steps of the binary search ``lo, hi
    = (mid, hi) if pred(mid) else (lo, mid - 1)``, ``mid = (lo + hi + 1) //
    2``, taken ``levels`` a round. A round probes every node of its search
    tree (a warp lane each; node n's range replayed from the path bits of
    n), then walks the path: the binary search's own probes, whatever
    ``pred`` is."""
    def mid(lo, hi):
        return lo + (hi - lo + 1) // 2

    while steps > 0 and lo < hi:
        lv = min(steps, levels)
        took = 0
        for n in range(1, 1 << lv):
            nlo, nhi = lo, hi
            for d in range(n.bit_length() - 2, -1, -1):
                m = mid(nlo, nhi)
                nlo, nhi = (m, nhi) if (n >> d) & 1 else (nlo, m - 1)
            took |= int(bool(pred(mid(nlo, nhi)))) << (n - 1)
        node = 1
        for _ in range(lv):
            m = mid(lo, hi)
            t = (took >> (node - 1)) & 1
            lo, hi = (m, hi) if t else (lo, m - 1)
            node = 2 * node + t
        steps -= lv
    return lo


def run_rows(buf, rbuf, start, ln, base, w: int, descending: bool):
    """Row reader over runs read in place: ``read(r)`` gives, for each block,
    elements ``base + r*w .. + w`` of its run, the last key (and
    INVALID_RANK) past the end."""
    iota = torch.arange(w, device=buf.device)
    n = buf.shape[0]
    _, last_k = bound_keys(buf.dtype, descending)

    def read(r):
        pos = (base + r * w)[:, None] + iota
        valid = pos < ln[:, None]
        src = (start[:, None] + pos).clamp(0, max(n - 1, 0))
        k = torch.where(valid, buf[src], last_k)
        if rbuf is None:
            return (k,)
        return (k, torch.where(valid, rbuf[src], INVALID_RANK))
    return read


def dataflow(read_a, read_b, lA, lB, cycles: int, *, w: int, kv: bool,
             descending: bool, sel_max: bool):
    """``cycles`` FLiMS cycles for every block at once: the windowed
    dataflow of ``_merge_kernel`` / ``tree_dataflow``. ``read_*(r)`` gives
    (G, w) lanes of relative row ``r`` ((G,) tensor). ``sel_max`` is the
    key-only selector of ``_merge_kernel`` (``jnp.maximum`` of the heads);
    otherwise heads are selected by the element order. Returns (G,
    cycles*w) lanes."""
    dev = lA.device
    G = lA.shape[0]
    iota = torch.arange(w, device=dev)
    wins = wins_fn(kv, descending)
    zero = torch.zeros(G, dtype=torch.int64, device=dev)
    WA0, WA1 = read_a(zero), read_a(zero + 1)
    WB0, WB1 = read_b(zero), read_b(zero + 1)
    rA, rB = zero + 2, zero + 2
    lA, lB = lA.to(torch.int64), lB.to(torch.int64)

    def heads(W0, W1, l):
        return tuple(torch.where(iota < l[:, None], y, x)
                     for x, y in zip(W0, W1))

    def advance(W0, W1, l, r, read, consumed):
        l2 = l + consumed
        shift = l2 >= w
        nxt = read(r)
        s = shift[:, None]
        W0n = tuple(torch.where(s, y, x) for x, y in zip(W0, W1))
        W1n = tuple(torch.where(s, z, y) for y, z in zip(W1, nxt))
        return W0n, W1n, torch.where(shift, l2 - w, l2), r + shift.long()

    chunks = []
    for _ in range(cycles):
        cA = heads(WA0, WA1, lA)
        cB = tuple(torch.flip(x, [-1]) for x in heads(WB0, WB1, lB))
        take = wins(cA, cB)
        if kv:
            chunk = _butterfly_kv(torch.where(take, cA[0], cB[0]),
                                  torch.where(take, cA[1], cB[1]), descending)
        elif sel_max:
            chunk = (_butterfly_desc(xla_max(cA[0], cB[0])),)
        else:
            chunk = (_butterfly_desc(torch.where(take, cA[0], cB[0])),)
        chunks.append(chunk)
        k = take.sum(-1)
        WA0, WA1, lA, rA = advance(WA0, WA1, lA, rA, read_a, k)
        WB0, WB1, lB, rB = advance(WB0, WB1, lB, rB, read_b, w - k)
    return tuple(torch.cat(parts, dim=-1) for parts in zip(*chunks))


def _exclusive_cumsum(x):
    return torch.cat([x.new_zeros(1), torch.cumsum(x, 0, dtype=x.dtype)])


def nonempty(buf, fill):
    """``buf``, or one ``fill`` element when it is empty (gathers need an
    index; every read of it is masked)."""
    return buf if buf.shape[0] else buf.new_full((1,), fill)


def merge_blocks_plain(a, ra, b, rb, a_starts, a_lens, b_starts, b_lens, *,
                       n_out: int, C: int, w: int, G: int, descending: bool):
    """Plain version of K2/K3: R run pairs, ``G`` blocks of ``C`` over a flat
    grid of (segment, block) pairs, co-ranks, ``C/w`` cycles per block, and
    the valid prefix of every block gathered back to the flat layout."""
    dev = a.device
    kv = ra is not None
    R = a_starts.shape[0]
    _, last_k = bound_keys(a.dtype, descending)
    a, b = nonempty(a, last_k), nonempty(b, last_k)
    if kv:
        ra, rb = nonempty(ra, INVALID_RANK), nonempty(rb, INVALID_RANK)
    la, lb = a_lens.long(), b_lens.long()
    a_starts, b_starts = a_starts.long(), b_starts.long()
    lo_len = la + lb
    blk0 = _exclusive_cumsum(-(-lo_len // C))
    g = torch.arange(G, device=dev)
    seg = (torch.searchsorted(blk0, g, right=True) - 1).clamp(0, R - 1)
    o = torch.minimum((g - blk0[seg]) * C, (lo_len[seg] // C) * C)
    acut = _corank_runs(o, la[seg], lb[seg], a_starts[seg], b_starts[seg],
                        a, ra, b, rb, search_steps(n_out), descending)
    bcut = o - acut
    read_a = run_rows(a, ra, a_starts[seg], la[seg], acut - acut % w, w,
                      descending)
    read_b = run_rows(b, rb, b_starts[seg], lb[seg], bcut - bcut % w, w,
                      descending)
    out = dataflow(read_a, read_b, acut % w, bcut % w, C // w, w=w, kv=kv,
                   descending=descending, sel_max=not kv)
    oo = _exclusive_cumsum(lo_len)
    i = torch.arange(n_out, device=dev)
    s = (torch.searchsorted(oo, i, right=True) - 1).clamp(0, R - 1)
    pos = i - oo[s]
    gg = (blk0[s] + pos // C).clamp(0, G - 1)
    return tuple(x[gg, pos % C] for x in out)


_per_sm = {}


def resident_ctas(code: int, kv: bool, descending: bool, w: int,
                  device) -> int:
    """CTAs of the merge kernel the card holds at once: SMs times its
    occupancy at w."""
    key = (code, kv, descending, w, torch.device(device).index)
    if key not in _per_sm:
        per_sm = _build.library().flims_merge_blocks_occupancy(
            code, int(kv), int(descending), w)
        if per_sm <= 0:
            raise _build.KernelError(
                f"flims_merge: occupancy query failed ({per_sm}) at w={w}")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _per_sm[key] = per_sm * sms
    return _per_sm[key]


#: the widest w of the fast K2 / K3 kernel (a warp's registers hold w / 32
#: lanes a thread); wider merges run the wide form (csrc/wide_merge.cu)
MAX_W = 1024
# the most fused levels at which a group past the wide form's tables
# searches without one (its children's searches, one level deeper each)
FREE_LEVELS = 3


def wide_buffers(name, dev, *, code: int, kv: bool, descending: bool,
                 runs: int, L: int, w: int, C: int, G: int, ntot: int,
                 ctas: int = 0):
    """Device scratch of one launch of the wide tree form
    (``csrc/wide_merge.cu``) and its CTA count: ``(meta, tables, scratch,
    ctas)``, as ``flims_wide_tree`` takes them for keys of dtype ``code``
    merged in the direction ``descending``. ``ntot`` is the lanes a level
    of the inner tables holds (0 at ``L == 1``, which has none); a group
    ending past it searches without a table. ``ctas`` (tests only) forces
    the CTA count, else as many as the card holds at once, at most one a
    block."""
    lib = _build.library()
    per_cta = lib.flims_wide_tree_scratch(int(kv), L, w, C)
    if per_cta < 0:
        raise _build.KernelError(f"{name}: no wide form at L={L}, w={w}, "
                                 f"C={C}")
    if not ctas:
        key = ("wide", code, kv, descending, L, w, torch.device(dev).index)
        if key not in _per_sm:
            per_sm = lib.flims_wide_tree_occupancy(code, int(kv),
                                                   int(descending), L, w)
            if per_sm <= 0:
                raise _build.KernelError(
                    f"{name}: wide form occupancy query failed ({per_sm}) "
                    f"at L={L}, w={w}")
            _per_sm[key] = per_sm * torch.cuda.get_device_properties(
                dev).multi_processor_count
        ctas = max(1, min(G, _per_sm[key]))
    meta = torch.empty(runs + 1 + 3 * (runs // (1 << L) + 1),
                       dtype=torch.int32, device=dev)
    tables = torch.empty((L - 1) * ntot * (2 if kv else 1),
                         dtype=torch.int32, device=dev)
    scratch = torch.empty(ctas * per_cta, dtype=torch.uint8, device=dev)
    return meta, tables, scratch, ctas


def wide_tree(name, ka, ra, kb, rb, starts, lens, *, L: int, n_out: int,
              C: int, w: int, steps: int, descending: bool, sel_max: bool,
              pairs: bool, G: int, disjoint: bool = False, ctas: int = 0):
    """One launch of the wide tree form (``csrc/wide_merge.cu``): every
    group of ``2^L`` runs (run r is ``k[starts[r] :+ lens[r]]``, ``k`` the
    buffer ``kb`` for odd runs where ``pairs``, else ``ka``) merged through
    ``L`` levels in C-wide output blocks, the JAX kernels' nested co-ranks
    and FLiMS dataflow at any ``w`` and ``L``. ``G`` bounds the blocks; the
    inner levels' tables hold max(n_out, len(ka)) lanes a level, the runs'
    total where they do not overlap (``disjoint``). Runs that may overlap
    may end past them: up to ``FREE_LEVELS`` a group past them searches
    without a table, and past it the runs' total is read back to size the
    tables. ``ctas`` (tests only) forces the CTA count. Returns ``(keys,)``
    or ``(keys, ranks)`` of ``n_out``."""
    kv = ra is not None
    dev = ka.device
    starts = starts.to(device=dev, dtype=torch.int32).contiguous()
    lens = lens.to(device=dev, dtype=torch.int32).contiguous()
    _build.check_cuda(name, ka, ra, kb, rb, starts, lens)
    code = _build.dtype_code(name, ka.dtype)
    runs = starts.shape[0]
    ntot = max(n_out, ka.shape[0]) if L > 1 else 0
    if L > FREE_LEVELS and not disjoint:
        # a search without a table costs about (2 steps + 2)^(L - 1) reads
        ntot = max(ntot, int(lens.sum()))
    meta, tables, scratch, ctas = wide_buffers(
        name, dev, kv=kv, runs=runs, L=L, w=w, C=C, G=G, ntot=ntot,
        code=code, descending=descending, ctas=ctas)
    out = (torch.empty(n_out, dtype=ka.dtype, device=dev),) + ((
        torch.empty(n_out, dtype=torch.int32, device=dev),) if kv else ())
    P = _build.ptr
    _build.launch(name, "flims_wide_tree", code, int(kv), int(descending),
                  int(sel_max), L, P(ka), P(ra), P(kb), P(rb), int(pairs),
                  P(starts), P(lens), runs, n_out, C, w, steps, None,
                  P(meta), P(tables), ntot, P(scratch), ctas, P(out[0]),
                  P(out[1] if kv else None), _build.stream(dev))
    return out


def merge_blocks_cuda(name, a, ra, b, rb, a_starts, a_lens, b_starts, b_lens,
                      *, n_out: int, C: int, w: int, G: int,
                      descending: bool, ctas: int = 0):
    """Launch ``csrc/flims_merge.cu`` over R run pairs (``a_starts`` ..
    ``b_lens`` None: the one pair ``a``, ``b``). The pairs' output offsets
    and first blocks are computed on the card; each block finds its pair
    and co-rank. ``ctas`` (tests only) forces the CTA count, else the card
    holds every CTA launched."""
    kv = ra is not None
    _build.check_cuda(name, a, ra, b, rb, a_starts, a_lens, b_starts, b_lens)
    code = _build.dtype_code(name, a.dtype)
    if not kv and not descending:
        raise _build.KernelError(f"{name}: key-only lanes merge descending")
    if b.dtype != a.dtype or any(t is not None and t.dtype != torch.int32
                                 for t in (ra, rb, a_starts, a_lens,
                                           b_starts, b_lens)):
        raise _build.KernelError(f"{name}: keys of one dtype, int32 lanes")
    R = 1 if a_starts is None else a_starts.shape[0]
    if a_starts is not None and not (
            a_lens.shape[0] == b_starts.shape[0] == b_lens.shape[0] == R):
        raise _build.KernelError(f"{name}: run vectors of one length")
    dev = a.device
    if w > MAX_W:
        if a_starts is None:
            zero = torch.zeros(1, dtype=torch.int32, device=dev)
            a_starts, b_starts = zero, zero
            a_lens, b_lens = zero + a.shape[0], zero + b.shape[0]
        return wide_tree(
            name, a, ra, b, rb, torch.stack([a_starts, b_starts], 1).view(-1),
            torch.stack([a_lens, b_lens], 1).view(-1), L=1, n_out=n_out, C=C,
            w=w, steps=search_steps(n_out), descending=descending,
            sel_max=not kv, pairs=True, G=G, ctas=ctas)
    # out_off and blk0 of the pairs, written on the card
    meta = torch.empty(2 * (R + 1), dtype=torch.int32, device=dev) \
        if R > 1 else None
    out = torch.empty(n_out, dtype=a.dtype, device=dev)
    out_r = torch.empty(n_out, dtype=torch.int32, device=dev) if kv else None
    ctas = ctas or resident_ctas(code, kv, descending, w, dev)
    P = _build.ptr
    _build.launch(name, "flims_merge_blocks", code, int(kv), int(descending),
                  P(a), P(ra), P(b), P(rb), P(a_starts), P(a_lens),
                  P(b_starts), P(b_lens), a.shape[0], b.shape[0], P(meta),
                  P(out), P(out_r), R, n_out, G, C, w, search_steps(n_out),
                  ctas, _build.stream(dev))
    return (out,) if not kv else (out, out_r)


def _merge_one(name, a, ra, b, rb, *, w, block_out, descending, cuda,
               ctas=0):
    if a.ndim != 1 or b.ndim != 1 or a.dtype != b.dtype:
        raise ValueError(f"{name}: two 1-D key tensors of one dtype")
    if w & (w - 1):
        raise ValueError(f"{name}: w must be a power of two, got {w}")
    n_out = a.shape[0] + b.shape[0]
    C = block_size(n_out, w, block_out)
    G = -(-n_out // C)
    dev = a.device
    dt = a.dtype
    a, b = _build.widen(a), _build.widen(b)
    if cuda:
        out = merge_blocks_cuda(name, a, ra, b, rb, None, None, None, None,
                                n_out=n_out, C=C, w=w, G=G,
                                descending=descending, ctas=ctas)
    else:
        zero = torch.zeros(1, dtype=torch.int64, device=dev)
        out = merge_blocks_plain(a, ra, b, rb, zero, zero + a.shape[0], zero,
                                 zero + b.shape[0], n_out=n_out, C=C, w=w,
                                 G=G, descending=descending)
    return _build.narrow_keys(out, dt)


def _flims_merge(a, b, w, block_out, cuda, ctas=0):
    if a.shape[0] + b.shape[0] == 0:
        return a.new_zeros((0,))
    if a.shape[0] == 0:
        return b
    if b.shape[0] == 0:
        return a
    return _merge_one("flims_merge", a, None, b, None, w=w,
                      block_out=block_out, descending=True, cuda=cuda,
                      ctas=ctas)[0]


def _flims_merge_kv(a, ra, b, rb, w, block_out, descending, cuda, ctas=0):
    if ra.shape != a.shape or rb.shape != b.shape:
        raise ValueError("flims_merge_kv: rank lanes shaped like the keys")
    if a.shape[0] + b.shape[0] == 0:
        return a.new_zeros((0,)), torch.zeros(0, dtype=torch.int32,
                                               device=a.device)
    if a.shape[0] == 0:
        return b, rb
    if b.shape[0] == 0:
        return a, ra
    return _merge_one("flims_merge_kv", a, ra.to(torch.int32), b,
                      rb.to(torch.int32), w=w, block_out=block_out,
                      descending=descending, cuda=cuda, ctas=ctas)


@obs.scoped("kernels.flims_merge")
def flims_merge(a: torch.Tensor, b: torch.Tensor, *, w: int = 128,
                block_out: int = 4096, _ctas: int = 0) -> torch.Tensor:
    """Merge two descending 1-D tensors with the partitioned FLiMS kernel
    (counterpart of ``flims_merge_pallas``). ``_ctas`` (tests only) forces
    the CUDA kernel's CTA count."""
    return _flims_merge(a, b, w, block_out, a.is_cuda, _ctas)


def flims_merge_plain(a: torch.Tensor, b: torch.Tensor, *, w: int = 128,
                      block_out: int = 4096) -> torch.Tensor:
    """``flims_merge``' plain version, on any device."""
    return _flims_merge(a, b, w, block_out, False)


@obs.scoped("kernels.flims_merge_kv")
def flims_merge_kv(a, ra, b, rb, *, w: int = 128, block_out: int = 4096,
                   descending: bool = True,
                   _ctas: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable partitioned FLiMS merge of (key, int32 rank) lanes (counterpart
    of ``flims_merge_kv_pallas``). Returns ``(keys, ranks)``. ``_ctas``
    (tests only) forces the CUDA kernel's CTA count."""
    return _flims_merge_kv(a, ra, b, rb, w, block_out, descending, a.is_cuda,
                           _ctas)


def flims_merge_kv_plain(a, ra, b, rb, *, w: int = 128, block_out: int = 4096,
                         descending: bool = True):
    """``flims_merge_kv``' plain version, on any device."""
    return _flims_merge_kv(a, ra, b, rb, w, block_out, descending, False)
