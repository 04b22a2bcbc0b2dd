"""K4: the fused multi-level FLiMS merge tree (paper §2.1's HPMT).

Counterpart of ``repro/kernels/merge_tree.py``. One launch merges every
group of ``2^L`` consecutive runs through ``L`` tree levels per ``C``-wide
output block: a nested merge-path search gives every tree node an aligned
start (a multiple of ``w``) and an initial rotation, so each of the
``2^L - 1`` windowed dataflows starts mid-rotation with no realignment;
inner nodes stream through scratch and only the root writes.

``merge_tree_runs`` / ``merge_tree_runs_kv`` launch ``csrc/merge_tree.cu``
for a CUDA tensor and run the plain version below for a CPU tensor (the
``*_plain`` twins run it on any device): the nested co-rank partition
(``_tree_fns`` / ``_tree_meta``) and the post-order dataflow, vectorised
over grid steps. The CUDA kernel is a persistent streaming merge tree (see
its header): as many CTAs as the card holds, each taking an equal share of
the flat blocks cut into spans at group boundaries (:func:`tree_spans`),
one partition per span (:func:`leaf_count_partition`) and the tree
streamed to the span's end through shared-memory FIFOs (:func:`tree_smem`).
Its output does not depend on the split, which is why the plain version,
one block at a time, is its reference. Past three fused levels or outside
w in [8, 128] the card runs the wide tree form
(``flims_merge.wide_tree``, ``csrc/wide_merge.cu``: the same partition
and dataflow, a CTA a node). The streamed kernel needs NaN-free runs in
the call's order: a check in the same C call flags the other groups, and
the wide form merges them there, on the card.
"""
from __future__ import annotations

from bisect import bisect_right

import torch

from repro_torch import obs
from repro_torch.core.lanes import INVALID_RANK
from repro_torch.kernels import _build
from repro_torch.kernels.flims_merge import (_exclusive_cumsum, block_size,
                                             bound_keys, dataflow, guard,
                                             nonempty, run_elem, run_rows,
                                             search_steps, wide_buffers,
                                             wide_tree, wins_fn)

#: shared memory one CTA may use on Hopper (232,448 bytes)
MAX_SMEM = 232448
#: the fast CUDA kernel's fused levels and FLiMS widths (the planner's
#: range, one warp per node); any other group or width runs the wide form
#: (``flims_merge.wide_tree``)
MAX_LEVELS = 3
W_MIN, W_MAX = 8, 128

_per_sm: dict = {}


def _tree_nodes(group: int):
    """Static preorder list of internal nodes (lo, mid, hi, idx)."""
    nodes = []

    def rec(lo, hi):
        if hi - lo <= 1:
            return
        mid = (lo + hi) // 2
        nodes.append((lo, mid, hi, len(nodes)))
        rec(lo, mid)
        rec(mid, hi)

    rec(0, group)
    return nodes


def _node_index(group: int):
    return {(lo, hi): idx for lo, mid, hi, idx in _tree_nodes(group)}


def _tree_fns(buf, rbuf, starts_u, lens_u, *, steps: int, descending: bool):
    """(elem, corank, materialize) over one tree's leaves in every distinct
    group (``starts_u[j]`` / ``lens_u[j]`` are (U,) tensors); each index
    comes with ``u``, the group of each of its entries.

    ``elem(lo, hi, i, u)`` is element ``i`` of the node's merged sequence
    under the selector's order, guarded past both ends (an inner node reads
    the table ``materialize(lo, hi)`` made); ``corank(lo, mid, hi, o, u)``
    the left child's count among the node's top-``o``, found in ``steps``
    binary-search steps. A table holds the node's merged sequence of every
    group, each element found by the co-rank search over its children's:
    the nested search stays one level deep, where searching through the
    children's own searches costs ``steps ** depth`` reads."""
    kv = rbuf is not None
    wins = wins_fn(kv, descending)
    tables = {}

    def node_len(lo, hi, u):
        return sum(lens_u[j][u] for j in range(lo, hi))

    def elem(lo, hi, i, u):
        if hi - lo == 1:
            return run_elem(buf, rbuf, starts_u[lo][u], lens_u[lo][u], i,
                            descending)
        lanes, off = tables[(lo, hi)]
        ln = node_len(lo, hi, u)
        src = off[u] + torch.minimum(i.clamp(min=0), (ln - 1).clamp(min=0))
        return guard(tuple(x[src] for x in lanes), i, ln, kv, descending)

    def corank(lo, mid, hi, o, u):
        la, lb = node_len(lo, mid, u), node_len(mid, hi, u)
        lo_b, hi_b = (o - lb).clamp(min=0), torch.minimum(o, la)
        for _ in range(steps):
            m = (lo_b + hi_b + 1) // 2
            ok = wins(elem(lo, mid, m - 1, u), elem(mid, hi, o - m, u))
            lo_b, hi_b = torch.where(ok, m, lo_b), torch.where(ok, hi_b, m - 1)
        return lo_b

    def materialize(lo, hi):
        mid = (lo + hi) // 2
        for clo, chi in ((lo, mid), (mid, hi)):
            if chi - clo > 1:
                materialize(clo, chi)
        ln = node_len(lo, hi, torch.arange(lens_u[0].shape[0],
                                           device=lens_u[0].device))
        off = _exclusive_cumsum(ln)
        u = torch.repeat_interleave(torch.arange(ln.shape[0],
                                                 device=ln.device), ln)
        i = torch.arange(u.shape[0], device=ln.device) - off[u]
        c = corank(lo, mid, hi, i, u)
        ea, eb = elem(lo, mid, c, u), elem(mid, hi, i - c, u)
        take = wins(ea, eb)
        # one spare element past the last group: an empty group's reads
        # (all guarded) index it
        tables[(lo, hi)] = (tuple(
            torch.cat([torch.where(take, xa, xb), xa.new_zeros(1)])
            for xa, xb in zip(ea, eb)), off)

    return elem, corank, materialize


def _tree_meta(starts_g, lens_g, o, buf, rbuf, *, group: int, w: int,
               steps: int, descending: bool):
    """The nested partition of every grid step (``_tree_meta_one``): the
    aligned start of each leaf and, per internal node in preorder, the
    (left, right) initial rotations. The searches run once per distinct
    group of the grid steps' leaves."""
    rows = torch.stack(list(starts_g) + list(lens_g), dim=1)
    uniq, u = torch.unique(rows, dim=0, return_inverse=True)
    _, corank, materialize = _tree_fns(
        buf, rbuf, list(uniq[:, :group].unbind(1)),
        list(uniq[:, group:].unbind(1)), steps=steps, descending=descending)
    mid = group // 2
    for clo, chi in ((0, mid), (mid, group)):
        if chi - clo > 1:
            materialize(clo, chi)
    leaf_base = [None] * group
    rots = []

    def assign(lo, hi, a):
        mid = (lo + hi) // 2
        sx = corank(lo, mid, hi, a, u)
        sy = a - sx
        rots.append((sx % w, sy % w))
        for clo, chi, s in ((lo, mid, sx), (mid, hi, sy)):
            if chi - clo == 1:
                leaf_base[clo] = s - s % w
            else:
                assign(clo, chi, s - s % w)

    assign(0, group, o)
    return leaf_base, rots


def _stream_rows(acc, nrows: int, w: int, fills):
    """Row reader over an inner node's produced stream; rows from ``nrows``
    on read as fill, as the sentinel-initialised scratch does."""
    iota = torch.arange(w, device=acc[0].device)

    def read(r):
        idx = (r.clamp(max=nrows - 1) * w)[:, None] + iota
        past = (r >= nrows)[:, None]
        return tuple(torch.where(past, f, a.gather(1, idx))
                     for a, f in zip(acc, fills))
    return read


def _merge_tree_plain(buf, rbuf, starts, lens, *, group, n_out, C, w, G,
                      descending):
    dev = buf.device
    kv = rbuf is not None
    n_groups = starts.shape[0] // group
    _, last_k = bound_keys(buf.dtype, descending)
    buf = nonempty(buf, last_k)
    rbuf = nonempty(rbuf, INVALID_RANK) if kv else None
    fills = (last_k, INVALID_RANK)[: 2 if kv else 1]
    starts, lens = starts.long(), lens.long()
    glen = lens.reshape(n_groups, group).sum(1)
    blk0 = _exclusive_cumsum(-(-glen // C))
    g = torch.arange(G, device=dev)
    grp = (torch.searchsorted(blk0, g, right=True) - 1).clamp(0, n_groups - 1)
    o = torch.minimum((g - blk0[grp]) * C, (glen[grp] // C) * C)
    starts_g = [starts[grp * group + j] for j in range(group)]
    lens_g = [lens[grp * group + j] for j in range(group)]
    leaf_base, rots = _tree_meta(starts_g, lens_g, o, buf, rbuf, group=group,
                                 w=w, steps=search_steps(n_out),
                                 descending=descending)
    node_idx = _node_index(group)

    def produce(lo, hi, depth):
        mid = (lo + hi) // 2
        rot_l, rot_r = rots[node_idx[(lo, hi)]]
        cycles = C // w + depth

        def child(clo, chi):
            if chi - clo == 1:
                return run_rows(buf, rbuf, starts_g[clo], lens_g[clo],
                                leaf_base[clo], w, descending)
            acc, ccycles = produce(clo, chi, depth + 1)
            return _stream_rows(acc, ccycles, w, fills)

        return dataflow(child(lo, mid), child(mid, hi), rot_l, rot_r, cycles,
                        w=w, kv=kv, descending=descending,
                        sel_max=False), cycles

    out, _ = produce(0, group, 0)
    goff = _exclusive_cumsum(glen)
    i = torch.arange(n_out, device=dev)
    s = (torch.searchsorted(goff, i, right=True) - 1).clamp(0, n_groups - 1)
    pos = i - goff[s]
    gg = (blk0[s] + pos // C).clamp(0, G - 1)
    return tuple(x[gg, pos % C] for x in out)


def leaf_count_partition(keys, ranks, o: int, *, w: int,
                         descending: bool):
    """The CUDA kernel's partition of a span at group offset ``o``, in
    plain Python: ``keys[j]`` (and ``ranks[j]``) are leaf j's lanes as
    lists. At the root each leaf's count among the group's top-``o`` under
    the tree's order (key, with rank on KV lanes; leaf descending;
    position); below it each node's top-``a'`` is its top-``s`` less its
    last ``s % w``, found among the last ``min(s % w, count)`` counted
    elements of each leaf. Returns ``(leaf_base, rots)`` as
    :func:`_tree_meta` gives them for one block (rotations in preorder)."""
    group = len(keys)
    kv = ranks is not None

    def lane(j, p):
        return (keys[j][p], ranks[j][p]) if kv else (keys[j][p],)

    def wins(x, y):
        if descending and x[0] != y[0]:
            return x[0] > y[0]
        if not descending and x[0] != y[0]:
            return x[0] < y[0]
        return kv and x[1] < y[1]

    def precedes(y, jj, x, j):
        return not wins(x, y) if jj > j else wins(y, x)

    def prefix(n, ok):
        """Largest m in [0, n] with ok(m - 1) for all below (ok monotone)."""
        lo, hi = 0, n
        while lo < hi:
            m = (lo + hi + 1) // 2
            lo, hi = (m, hi) if ok(m - 1) else (lo, m - 1)
        return lo

    def rank(j, p):
        x = lane(j, p)
        return p + sum(prefix(len(keys[jj]),
                              lambda q, jj=jj: precedes(lane(jj, q), jj, x, j))
                       for jj in range(group) if jj != j)

    cnt = [prefix(min(o, len(keys[j])), lambda p, j=j: rank(j, p) < o)
           for j in range(group)]
    off = {1: o}
    rot, base = {}, [0] * group
    span, d = group, 0
    while span >= 2:
        if d:
            new = []
            for j in range(group):
                first = j // span * span
                node = range(first, first + span)
                r = sum(cnt[jj] for jj in node) - off[(1 << d) + j // span]
                q = min(r, cnt[j])
                dropped = 0
                for i in range(q):
                    x = lane(j, cnt[j] - q + i)
                    after = q - 1 - i
                    for jj in node:
                        if jj != j:
                            qq = min(r, cnt[jj])
                            after += qq - prefix(qq, lambda m, jj=jj: precedes(
                                lane(jj, cnt[jj] - qq + m), jj, x, j))
                    dropped += after < r
                new.append(cnt[j] - dropped)
            cnt = new
        for t in range(1 << d):
            h, lo = (1 << d) + t, t * span
            sx = sum(cnt[lo:lo + span // 2])
            sy = off[h] - sx
            rot[h] = (sx % w, sy % w)
            if span == 2:
                base[lo], base[lo + 1] = sx - sx % w, sy - sy % w
            else:
                off[2 * h], off[2 * h + 1] = sx - sx % w, sy - sy % w
        span, d = span // 2, d + 1
    # heap order to _tree_nodes' preorder
    heap = {}

    def walk(lo, hi, h):
        if hi - lo > 1:
            heap[(lo, hi)] = h
            walk(lo, (lo + hi) // 2, 2 * h)
            walk((lo + hi) // 2, hi, 2 * h + 1)

    walk(0, group, 1)
    return base, [rot[heap[(lo, hi)]] for lo, _, hi, _ in _tree_nodes(group)]


def tree_spans(blk0, grid: int):
    """The CUDA kernel's span split: per CTA, the ``(group, first block,
    end block)`` spans (flat block indices) it takes. CTA ``c`` takes the
    flat blocks ``[c G // grid, (c + 1) G // grid)``, ``G = blk0[-1]``, cut
    at group boundaries; a group with no block is passed over."""
    G = blk0[-1]
    out = []
    for c in range(grid):
        b, end, mine = c * G // grid, (c + 1) * G // grid, []
        while b < end:
            grp = bisect_right(blk0, b) - 1
            stop = min(end, blk0[grp + 1])
            mine.append((grp, b, stop))
            b = stop
        out.append(mine)
    return out


def tree_smem(dtype, kv: bool, descending: bool, L: int, w: int) -> int:
    """Shared-memory bytes of one CTA of the CUDA kernel at (dtype, lane
    form, direction, L, w), read from the compiled kernel on the card: its
    static scratch plus the FIFO rings, mbarriers and partition windows its
    launch requests. It does not depend on the output block."""
    code = _build.dtype_code("merge_tree", dtype)
    nbytes = _build.library().flims_merge_tree_smem(
        code, int(kv), int(descending), L, w)
    if nbytes < 0:
        raise _build.KernelError(
            f"merge_tree: footprint query failed ({nbytes}) at L={L}, w={w}")
    return nbytes


def _resident_ctas(code: int, kv: bool, descending: bool, L: int, w: int,
                   device) -> int:
    """CTAs the card holds at once: SMs times the kernel's occupancy at its
    shared memory."""
    key = (code, kv, descending, L, w, torch.device(device).index)
    if key not in _per_sm:
        per_sm = _build.library().flims_merge_tree_occupancy(
            code, int(kv), int(descending), L, w)
        if per_sm <= 0:
            raise _build.KernelError(
                f"merge_tree: occupancy query failed ({per_sm}) at L={L}, "
                f"w={w}")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _per_sm[key] = per_sm * sms
    return _per_sm[key]


def _merge_tree_cuda(name, buf, rbuf, starts, lens, *, group, n_out, C, w, G,
                     descending, ctas):
    kv = rbuf is not None
    L = group.bit_length() - 1
    if not kv and not descending:
        raise _build.KernelError(f"{name}: key-only lanes merge descending")
    steps = search_steps(n_out)
    if L > MAX_LEVELS or not W_MIN <= w <= W_MAX:
        # past one warp a node: the wide form, a CTA a node
        return wide_tree(name, buf, rbuf, buf, rbuf, starts, lens, L=L,
                         n_out=n_out, C=C, w=w, steps=steps,
                         descending=descending, sel_max=False, pairs=False,
                         G=G, ctas=ctas)
    starts = starts.to(torch.int32).contiguous()
    lens = lens.to(torch.int32).contiguous()
    _build.check_cuda(name, buf, rbuf, starts, lens)
    code = _build.dtype_code(name, buf.dtype)
    if rbuf is not None and rbuf.dtype != torch.int32:
        raise _build.KernelError(f"{name}: int32 rank lanes")
    runs = starts.shape[0]
    n_groups = runs // group
    # the group table (offsets and first blocks) and the check's flags,
    # written on the card
    meta = torch.empty(3 * (n_groups + 1), dtype=torch.int32,
                       device=buf.device)
    out = torch.empty(n_out, dtype=buf.dtype, device=buf.device)
    out_r = torch.empty(n_out, dtype=torch.int32, device=buf.device) \
        if kv else None
    # groups holding a NaN or a run out of order: the same call merges them
    # by the wide form (the streamed partition and its restarts need
    # NaN-free runs in order), which returns at once where there are none.
    # Its tables hold max(n_out, len(buf)) lanes a level, the runs' total
    # (read on the card) wherever they do not overlap; a group of runs that
    # overlap past it searches without a table
    wtot = max(n_out, buf.shape[0]) if L > 1 else 0
    wmeta, tables, wscratch, wctas = wide_buffers(
        name, buf.device, kv=kv, runs=runs, L=L, w=w, C=C, G=G, ntot=wtot,
        code=code, descending=descending, ctas=ctas)
    ctas = ctas or _resident_ctas(code, kv, descending, L, w, buf.device)
    P = _build.ptr
    _build.launch(name, "flims_merge_tree", code, int(kv), int(descending),
                  L, P(buf), P(rbuf), P(starts), P(lens), P(meta), P(out),
                  P(out_r), n_groups, n_out, C, w, min(ctas, G), steps,
                  P(wmeta), P(tables), wtot, P(wscratch), wctas,
                  _build.stream(buf.device))
    return (out,) if not kv else (out, out_r)


def _merge_tree_call(name, buf, ranks, starts, lens, *, group, n_out, w,
                     block_out, descending, cuda, ctas=0):
    """``ctas`` forces the CUDA kernel's CTA count (0: as many as the card
    holds at once); the result does not depend on it."""
    kv = ranks is not None
    if kv:
        ranks = ranks.to(torch.int32)
    R = starts.shape[0]
    if group < 2 or group & (group - 1):
        raise ValueError(f"{name}: group must be 2^L >= 2, got {group}")
    if R % group:
        raise ValueError(f"{name}: run count must be a multiple of group")
    if w & (w - 1):
        raise ValueError(f"{name}: w must be a power of two, got {w}")
    if R == 0 or n_out == 0:
        empty = buf.new_zeros((n_out,))
        return (empty, torch.zeros(n_out, dtype=torch.int32,
                                   device=buf.device)) if kv else (empty,)
    C = block_size(n_out, w, block_out)
    G = n_out // C + R // group
    dt, buf = buf.dtype, _build.widen(buf)
    if cuda:
        out = _merge_tree_cuda(name, buf, ranks, starts, lens, group=group,
                               n_out=n_out, C=C, w=w, G=G,
                               descending=descending, ctas=ctas)
    else:
        out = _merge_tree_plain(buf, ranks, starts, lens, group=group,
                                n_out=n_out, C=C, w=w, G=G,
                                descending=descending)
    return _build.narrow_keys(out, dt)


@obs.scoped("kernels.merge_tree")
def merge_tree_runs(buf, starts, lens, *, group: int, n_out: int, w: int = 32,
                    block_out: int = 1024, _ctas: int = 0):
    """Merge consecutive groups of ``group = 2^L`` descending runs (run r is
    ``buf[starts[r] : starts[r] + lens[r]]``) through ``L`` fused levels in
    one launch. Returns the (n_out,) merged groups in group order.
    ``_ctas`` (tests only) forces the CUDA kernel's CTA count."""
    return _merge_tree_call("merge_tree_runs", buf, None, starts, lens,
                            group=group, n_out=n_out, w=w,
                            block_out=block_out, descending=True,
                            cuda=buf.is_cuda, ctas=_ctas)[0]


def merge_tree_runs_plain(buf, starts, lens, *, group: int, n_out: int,
                          w: int = 32, block_out: int = 1024):
    """``merge_tree_runs``' plain version, on any device."""
    return _merge_tree_call("merge_tree_runs", buf, None, starts, lens,
                            group=group, n_out=n_out, w=w,
                            block_out=block_out, descending=True,
                            cuda=False)[0]


@obs.scoped("kernels.merge_tree_kv")
def merge_tree_runs_kv(buf, ranks, starts, lens, *, group: int, n_out: int,
                       w: int = 32, block_out: int = 1024,
                       descending: bool = True, _ctas: int = 0):
    """Stable KV form of ``merge_tree_runs``: (key, int32 rank) lanes under
    the compound order, either direction natively. Returns ``(keys,
    ranks)``. ``_ctas`` (tests only) forces the CUDA kernel's CTA count."""
    return _merge_tree_call("merge_tree_runs_kv", buf, ranks, starts, lens,
                            group=group, n_out=n_out, w=w,
                            block_out=block_out, descending=descending,
                            cuda=buf.is_cuda, ctas=_ctas)


def merge_tree_runs_kv_plain(buf, ranks, starts, lens, *, group: int,
                             n_out: int, w: int = 32, block_out: int = 1024,
                             descending: bool = True):
    """``merge_tree_runs_kv``' plain version, on any device."""
    return _merge_tree_call("merge_tree_runs_kv", buf, ranks, starts, lens,
                            group=group, n_out=n_out, w=w,
                            block_out=block_out, descending=descending,
                            cuda=False)
