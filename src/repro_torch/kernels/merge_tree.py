"""K4: the fused multi-level FLiMS merge tree (paper §2.1's HPMT).

Counterpart of ``repro/kernels/merge_tree.py``. One launch merges every
group of ``2^L`` consecutive runs through ``L`` tree levels per ``C``-wide
output block: a nested merge-path search gives every tree node an aligned
start (a multiple of ``w``) and an initial rotation, so each of the
``2^L - 1`` windowed dataflows starts mid-rotation with no realignment;
inner nodes stream through scratch and only the root writes.

``merge_tree_runs`` / ``merge_tree_runs_kv`` launch ``csrc/merge_tree.cu``
for a CUDA tensor. There the kernel computes the nested partition itself,
keeps the inner nodes in shared memory and reads the leaves in place; the
wrapper raises when the shared-memory footprint passes the card's 227 KB.
For a CPU tensor they run the plain version below (the ``*_plain`` twins run
it on any device): the nested co-rank partition (``_tree_fns`` /
``_tree_meta``) and the post-order dataflow, vectorised over grid steps.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.core.lanes import INVALID_RANK
from repro_torch.kernels import _build
from repro_torch.kernels.flims_merge import (_exclusive_cumsum, block_size,
                                             bound_keys, dataflow, guard,
                                             nonempty, run_elem, run_rows,
                                             search_steps, wins_fn)

#: shared memory one CTA may use on Hopper (232,448 bytes)
MAX_SMEM = 232448
MAX_LEVELS = 3


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


def _tree_fns(buf, rbuf, starts_g, lens_g, *, steps: int, descending: bool):
    """(elem, corank, node_len) over one group's leaves, vectorised over
    grid steps (``starts_g[j]`` / ``lens_g[j]`` are (G,) tensors).

    ``elem(lo, hi, i)`` is element ``i`` of the node's merged sequence under
    the selector's order, guarded past both ends; ``corank(lo, mid, hi, o)``
    the left child's count among the node's top-``o``, found in ``steps``
    binary-search steps."""
    kv = rbuf is not None
    wins = wins_fn(kv, descending)

    def node_len(lo, hi):
        return sum(lens_g[j] for j in range(lo, hi))

    def elem(lo, hi, i):
        if hi - lo == 1:
            return run_elem(buf, rbuf, starts_g[lo], lens_g[lo], i,
                            descending)
        mid = (lo + hi) // 2
        ln = node_len(lo, hi)
        c = corank(lo, mid, hi, torch.minimum(i.clamp(min=0), ln))
        ea, eb = elem(lo, mid, c), elem(mid, hi, i - c)
        take = wins(ea, eb)
        out = tuple(torch.where(take, xa, xb) for xa, xb in zip(ea, eb))
        return guard(out, i, ln, kv, descending)

    def corank(lo, mid, hi, o):
        la, lb = node_len(lo, mid), node_len(mid, hi)
        lo_b, hi_b = (o - lb).clamp(min=0), torch.minimum(o, la)
        for _ in range(steps):
            m = (lo_b + hi_b + 1) // 2
            ok = wins(elem(lo, mid, m - 1), elem(mid, hi, o - m))
            lo_b, hi_b = torch.where(ok, m, lo_b), torch.where(ok, hi_b, m - 1)
        return lo_b

    return elem, corank, node_len


def _tree_meta(starts_g, lens_g, o, buf, rbuf, *, group: int, w: int,
               steps: int, descending: bool):
    """The nested partition of every grid step (``_tree_meta_one``): the
    aligned start of each leaf and, per internal node in preorder, the
    (left, right) initial rotations."""
    _, corank, _ = _tree_fns(buf, rbuf, starts_g, lens_g, steps=steps,
                             descending=descending)
    leaf_base = [None] * group
    rots = []

    def assign(lo, hi, a):
        mid = (lo + hi) // 2
        sx = corank(lo, mid, hi, a)
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


def _merge_tree_cuda(name, buf, rbuf, starts, lens, *, group, n_out, C, w, G,
                     descending):
    kv = rbuf is not None
    L = group.bit_length() - 1
    if L > MAX_LEVELS:
        raise _build.KernelError(f"{name}: at most {MAX_LEVELS} fused levels")
    if not kv and not descending:
        raise _build.KernelError(f"{name}: key-only lanes merge descending")
    starts = starts.to(torch.int32).contiguous()
    lens = lens.to(torch.int32).contiguous()
    _build.check_cuda(name, buf, rbuf, starts, lens)
    code = _build.dtype_code(name, buf.dtype)
    if rbuf is not None and rbuf.dtype != torch.int32:
        raise _build.KernelError(f"{name}: int32 rank lanes")
    smem = _build.library().flims_merge_tree_smem(L, int(kv),
                                                  buf.element_size(), C, w)
    if smem > MAX_SMEM:
        raise _build.KernelError(
            f"{name}: {smem} bytes of shared memory at L={L}, C={C}, w={w} "
            f"pass the card's {MAX_SMEM}; lower block_out or levels")
    n_groups = starts.shape[0] // group
    glen = lens.reshape(n_groups, group).sum(1, dtype=torch.int32)
    goff = _exclusive_cumsum(glen)
    blk0 = _exclusive_cumsum((glen + (C - 1)) // C)
    out = torch.empty(n_out, dtype=buf.dtype, device=buf.device)
    out_r = torch.empty(n_out, dtype=torch.int32, device=buf.device) \
        if kv else None
    P = _build.ptr
    _build.launch(name, "flims_merge_tree", code, int(kv), int(descending),
                  L, P(buf), P(rbuf), P(starts), P(lens), P(goff), P(blk0),
                  P(out), P(out_r), n_groups, n_out, G, C, w,
                  _build.stream(buf.device))
    return (out,) if not kv else (out, out_r)


def _merge_tree_call(name, buf, ranks, starts, lens, *, group, n_out, w,
                     block_out, descending, cuda):
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
    if cuda:
        return _merge_tree_cuda(name, buf, ranks, starts, lens, group=group,
                                n_out=n_out, C=C, w=w, G=G,
                                descending=descending)
    return _merge_tree_plain(buf, ranks, starts, lens, group=group,
                             n_out=n_out, C=C, w=w, G=G,
                             descending=descending)


@obs.scoped("kernels.merge_tree")
def merge_tree_runs(buf, starts, lens, *, group: int, n_out: int, w: int = 32,
                    block_out: int = 1024):
    """Merge consecutive groups of ``group = 2^L`` descending runs (run r is
    ``buf[starts[r] : starts[r] + lens[r]]``) through ``L`` fused levels in
    one launch. Returns the (n_out,) merged groups in group order."""
    return _merge_tree_call("merge_tree_runs", buf, None, starts, lens,
                            group=group, n_out=n_out, w=w,
                            block_out=block_out, descending=True,
                            cuda=buf.is_cuda)[0]


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
                       descending: bool = True):
    """Stable KV form of ``merge_tree_runs``: (key, int32 rank) lanes under
    the compound order, either direction natively. Returns ``(keys,
    ranks)``."""
    return _merge_tree_call("merge_tree_runs_kv", buf, ranks, starts, lens,
                            group=group, n_out=n_out, w=w,
                            block_out=block_out, descending=descending,
                            cuda=buf.is_cuda)


def merge_tree_runs_kv_plain(buf, ranks, starts, lens, *, group: int,
                             n_out: int, w: int = 32, block_out: int = 1024,
                             descending: bool = True):
    """``merge_tree_runs_kv``' plain version, on any device."""
    return _merge_tree_call("merge_tree_runs_kv", buf, ranks, starts, lens,
                            group=group, n_out=n_out, w=w,
                            block_out=block_out, descending=descending,
                            cuda=False)
