"""K8: streaming k-way merge of device-resident sorted runs.

Counterpart of ``repro/kernels/stream_merge.py``, phase 2 of the
out-of-core sort (``engine.external_sort``) and the executor of the
``stream_cuda`` merge schedule. The input is one flat buffer of ``runs``
uniform sorted runs of ``run_len`` elements (a power of two ``>= w``);
consecutive ``fan_in = 2^L`` runs (any L >= 1) form a group, and every
``C``-wide output block of a group is produced by the same nested co-rank
partition and post-order FLiMS dataflow as K4 (``merge_tree``), with each
leaf read from a window of ``Ha = C/w + L + 2`` rows at a run-relative
start row; rows past the run's end read as sentinel lanes.

The buffer contract is the JAX kernel's: the input carries
``stream_slack`` trailing elements past ``runs * run_len`` (it is copied
and sentinel-padded when it has fewer), and the output is returned flat
with ``out_slack`` trailing sentinel elements, so passes chain with no
copy.

``stream_merge_runs`` / ``stream_merge_runs_kv`` launch
``csrc/stream_merge.cu`` for a CUDA tensor and run the plain version below
for a CPU tensor; the ``*_plain`` twins run it on any device. The plain
version repeats the TPU kernel's arithmetic vectorised over grid steps: the
nested partition of ``_stream_meta_one`` (``merge_tree._tree_meta``), the
windowed leaf readers, and ``dataflow`` per tree node. The CUDA kernel is a
persistent streaming merge tree (see its header): as many CTAs as the
card holds, each group split into spans of consecutive blocks
(:func:`stream_spans`), one partition per span and the tree streamed to
the span's end through shared-memory FIFOs (:func:`stream_smem`). Its
output does not depend on the split, which is why the plain version, one
block at a time, is its reference. Past its fan-in (16) or widths ([8,
128]) the card runs the wide tree form instead
(``flims_merge.wide_tree``, ``csrc/wide_merge.cu``); a buffer off 16
bytes goes to the fast kernel through an aligned copy. The streamed
kernel needs NaN-free runs in the call's order: a check in the same C call
flags the other groups, and the wide form merges them there, on the card
(it indexes in int32, so the card takes ``runs * run_len < 2^31``).
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.core.lanes import INVALID_RANK
from repro_torch.kernels import _build
from repro_torch.kernels.flims_merge import (bound_keys, dataflow,
                                             wide_buffers, wide_tree)
from repro_torch.kernels.merge_tree import (_node_index, _stream_rows,
                                            _tree_meta)

#: the fast CUDA kernel's fan-in 2^L (up to 16, the JAX planner's autotune
#: grid) and FLiMS widths (the planner's range, one warp per node); any
#: other fan-in or width runs the wide form (``flims_merge.wide_tree``)
MAX_LEVELS = 4
W_MIN, W_MAX = 8, 128

_per_sm: dict = {}


def _block(block_out: int, run_len: int, fan_in: int, w: int) -> int:
    """The output block: a power of two, ``>= w``, capped at the group
    length so every group splits into whole blocks."""
    glen = fan_in * run_len
    C = max(w, min(block_out, glen))
    return 1 << (C.bit_length() - 1)


def stream_slack(fan_in: int, w: int, block_out: int) -> int:
    """Trailing elements a buffer carries past the live data: the deepest
    leaf window (``C/w + L + 2`` rows) starting at a run's end."""
    L = max(fan_in.bit_length() - 1, 1)
    C = 1 << (max(w, block_out).bit_length() - 1)
    return (C // w + L + 2) * w


def _window_reader(buf, rbuf, row0, srow, *, w: int, Ha: int, run_rows: int,
                   fills):
    """Leaf reader over a window of ``Ha`` rows from flat row ``row0 +
    srow`` ((G,) tensors): rows past the run's end read as ``fills``."""
    iota = torch.arange(w, device=buf.device)
    n = buf.shape[0]

    def read(r):
        row = r.clamp(max=Ha - 1)
        valid = (srow + r < run_rows)[:, None]
        src = (((row0 + srow + row) * w)[:, None] + iota).clamp(0, n - 1)
        lanes = (buf,) if rbuf is None else (buf, rbuf)
        return tuple(torch.where(valid, x[src], f)
                     for x, f in zip(lanes, fills))
    return read


def _stream_plain(buf, rbuf, *, runs, run_len, fan_in, w, C, descending):
    """The merged groups, (n_val,) flat: one grid step per (group, block)."""
    dev = buf.device
    kv = rbuf is not None
    L = fan_in.bit_length() - 1
    _, last_k = bound_keys(buf.dtype, descending)
    fills = (last_k, INVALID_RANK)[: 2 if kv else 1]
    Ha = C // w + L + 2
    run_rows = run_len // w
    bpg = fan_in * run_len // C
    G = runs // fan_in * bpg
    g = torch.arange(G, device=dev)
    grp, o = g // bpg, (g % bpg) * C
    starts_g = [(grp * fan_in + j) * run_len for j in range(fan_in)]
    lens_g = [torch.full_like(g, run_len) for _ in range(fan_in)]
    # a search ranges over at most the root's left child's
    # (fan_in/2)·run_len + 1 co-ranks: its bit_length steps converge at
    # every node
    leaf_base, rots = _tree_meta(
        starts_g, lens_g, o, buf, rbuf, group=fan_in, w=w,
        steps=(fan_in // 2 * run_len).bit_length(), descending=descending)
    node_idx = _node_index(fan_in)

    def produce(lo, hi, depth):
        mid = (lo + hi) // 2
        rot_l, rot_r = rots[node_idx[(lo, hi)]]
        cycles = C // w + depth

        def child(clo, chi):
            if chi - clo == 1:
                return _window_reader(buf, rbuf, (grp * fan_in + clo) *
                                      run_rows, leaf_base[clo] // w, w=w,
                                      Ha=Ha, run_rows=run_rows, fills=fills)
            acc, ccycles = produce(clo, chi, depth + 1)
            return _stream_rows(acc, ccycles, w, fills)

        return dataflow(child(lo, mid), child(mid, hi), rot_l, rot_r, cycles,
                        w=w, kv=kv, descending=descending,
                        sel_max=False), cycles

    out, _ = produce(0, fan_in, 0)
    return tuple(x[:, :C].reshape(-1) for x in out)


def stream_smem(dtype, kv: bool, descending: bool, L: int, w: int) -> int:
    """Shared-memory bytes of one CTA of the CUDA kernel at (dtype, lane
    form, direction, L, w), read from the compiled kernel on the card: its
    static scratch plus the FIFO rings and mbarriers its launch requests.
    It does not depend on the output block."""
    code = _build.dtype_code("stream_merge", dtype)
    nbytes = _build.library().flims_stream_merge_smem(
        code, int(kv), int(descending), L, w)
    if nbytes < 0:
        raise _build.KernelError(
            f"stream_merge: footprint query failed ({nbytes}) at L={L}, "
            f"w={w}")
    return nbytes


def stream_spans(groups: int, bpg: int, ctas: int) -> int:
    """Spans per group for ``ctas`` persistent CTAs over ``groups`` groups
    of ``bpg`` blocks: as many as the CTAs allow, one block at least each;
    with fewer CTAs than groups each group is one span and CTAs take
    several."""
    return max(1, min(bpg, ctas // groups))


def span_blocks(groups: int, bpg: int, spg: int):
    """``(group, first block, end block)`` of every span, in the kernel's
    order: span ``s`` of a group covers blocks ``[s bpg // spg, (s + 1)
    bpg // spg)``."""
    return [(g, s * bpg // spg, (s + 1) * bpg // spg)
            for g in range(groups) for s in range(spg)]


def _resident_ctas(code: int, kv: bool, descending: bool, L: int, w: int,
                   device) -> int:
    """CTAs the card holds at once: SMs times the kernel's occupancy at its
    shared memory."""
    key = (code, kv, descending, L, w, torch.device(device).index)
    if key not in _per_sm:
        per_sm = _build.library().flims_stream_merge_occupancy(
            code, int(kv), int(descending), L, w)
        if per_sm <= 0:
            raise _build.KernelError(
                f"stream_merge: occupancy query failed ({per_sm}) at L={L}, "
                f"w={w}")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _per_sm[key] = per_sm * sms
    return _per_sm[key]


def _stream_cuda(name, buf, rbuf, *, runs, run_len, fan_in, w, C, n_out,
                 descending, ctas):
    kv = rbuf is not None
    L = fan_in.bit_length() - 1
    _build.check_cuda(name, buf, rbuf)
    code = _build.dtype_code(name, buf.dtype)
    if L > MAX_LEVELS or not W_MIN <= w <= W_MAX:
        return _stream_wide(name, buf, rbuf, runs=runs, run_len=run_len,
                            L=L, w=w, C=C, n_out=n_out,
                            descending=descending, ctas=ctas)
    # leaf rows go by 16-byte bulk copies from the buffers' bases: a buffer
    # off 16 bytes goes through an aligned copy
    buf = buf if buf.data_ptr() % 16 == 0 else buf.clone()
    if kv and rbuf.data_ptr() % 16:
        rbuf = rbuf.clone()
    out = torch.empty(n_out, dtype=buf.dtype, device=buf.device)
    out_r = torch.empty(n_out, dtype=torch.int32, device=buf.device) \
        if kv else None
    groups, bpg = runs // fan_in, fan_in * run_len // C
    n_val = runs * run_len
    # the check's flags and the runs' starts and lens, written on the card:
    # groups holding a NaN or a run out of order are merged in the same
    # call by the wide form (the streamed partition and its restarts need
    # NaN-free runs in order), which returns at once where there are none
    check = torch.empty(groups + 1 + 2 * runs, dtype=torch.int32,
                        device=buf.device)
    wmeta, tables, wscratch, wctas = wide_buffers(
        name, buf.device, kv=kv, runs=runs, L=L, w=w, C=C, G=n_val // C,
        ntot=n_val if L > 1 else 0, code=code, descending=descending,
        ctas=ctas)
    ctas = ctas or _resident_ctas(code, kv, descending, L, w, buf.device)
    spg = stream_spans(groups, bpg, ctas)
    P = _build.ptr
    _build.launch(name, "flims_stream_merge", code, int(kv), int(descending),
                  L, P(buf), P(rbuf), P(out), P(out_r), n_val, n_out,
                  run_len, C, w, groups, spg, min(ctas, groups * spg),
                  P(check), _wide_steps(L, run_len), P(wmeta), P(tables),
                  P(wscratch), wctas, _build.stream(buf.device))
    return (out,) if not kv else (out, out_r)


def _wide_steps(L, run_len):
    """The wide form's search steps over a group of 2^L runs of run_len."""
    return ((1 << L) // 2 * run_len).bit_length()


def _stream_wide(name, buf, rbuf, *, runs, run_len, L, w, C, n_out,
                 descending, ctas=0):
    """K8 past the fast kernel's fan-in or widths: the wide tree form over
    the uniform runs (``_stream_plain``'s partition and dataflow: every
    block's leaf windows lie inside their runs), then ``out_slack``
    sentinels."""
    dev = buf.device
    n_val = runs * run_len
    starts = torch.arange(runs, dtype=torch.int32, device=dev) * run_len
    lens = torch.full((runs,), run_len, dtype=torch.int32, device=dev)
    res = wide_tree(name, buf, rbuf, buf, rbuf, starts, lens, L=L,
                    n_out=n_val, C=C, w=w, steps=_wide_steps(L, run_len),
                    descending=descending, sel_max=False, pairs=False,
                    G=n_val // C, disjoint=True, ctas=ctas)
    if n_out == n_val:
        return res
    _, last_k = bound_keys(buf.dtype, descending)
    return tuple(torch.cat([x, x.new_full((n_out - n_val,), f)])
                 for x, f in zip(res, (last_k, INVALID_RANK)))


def _stream_call(name, buf, ranks, *, runs, run_len, fan_in, w, block_out,
                 out_slack, descending, cuda, ctas=0):
    """``ctas`` forces the CUDA kernel's CTA count (0: as many as the card
    holds at once); the result does not depend on it."""
    kv = ranks is not None
    L = fan_in.bit_length() - 1
    if fan_in < 2 or fan_in & (fan_in - 1):
        raise ValueError(f"{name}: fan_in must be 2^L, L >= 1, got {fan_in}")
    if runs % fan_in:
        raise ValueError(f"{name}: run count {runs} is not a multiple of "
                         f"fan_in {fan_in}")
    if w & (w - 1) or run_len < w or run_len & (run_len - 1):
        raise ValueError(f"{name}: run_len {run_len} and w {w} must be "
                         "powers of two with run_len >= w")
    if not kv and not descending:
        raise ValueError(f"{name}: key-only lanes merge descending")
    n_val = runs * run_len
    need = n_val + stream_slack(fan_in, w, block_out)
    dt, buf = buf.dtype, _build.widen(buf)
    _, last_k = bound_keys(buf.dtype, descending)

    def with_slack(x, fill):
        if x.shape[0] >= need:
            return x
        return torch.cat([x, x.new_full((need - x.shape[0],), fill)])

    buf = with_slack(buf, last_k)
    if kv:
        ranks = with_slack(ranks.to(torch.int32), INVALID_RANK)
    C = _block(block_out, run_len, fan_in, w)
    if cuda:
        return _build.narrow_keys(_stream_cuda(
            name, buf, ranks, runs=runs, run_len=run_len, fan_in=fan_in, w=w,
            C=C, n_out=n_val + out_slack, descending=descending, ctas=ctas),
            dt)
    out = _stream_plain(buf, ranks, runs=runs, run_len=run_len,
                        fan_in=fan_in, w=w, C=C, descending=descending)
    if out_slack:
        fills = (last_k, INVALID_RANK)
        out = tuple(torch.cat([x, x.new_full((out_slack,), f)])
                    for x, f in zip(out, fills))
    return _build.narrow_keys(out, dt)


@obs.scoped("kernels.stream_merge")
def stream_merge_runs(buf, *, runs: int, run_len: int, fan_in: int,
                      w: int = 32, block_out: int = 1024,
                      out_slack: int = 0, _ctas: int = 0):
    """Merge consecutive groups of ``fan_in = 2^L`` descending runs of
    uniform ``run_len`` (``buf`` their flat concatenation) in one launch.
    Returns a flat buffer whose ``[:runs * run_len]`` prefix is the merged
    groups in group order, followed by ``out_slack`` sentinel elements.
    ``_ctas`` (tests only) forces the CUDA kernel's CTA count."""
    return _stream_call("stream_merge_runs", buf, None, runs=runs,
                        run_len=run_len, fan_in=fan_in, w=w,
                        block_out=block_out, out_slack=out_slack,
                        descending=True, cuda=buf.is_cuda, ctas=_ctas)[0]


def stream_merge_runs_plain(buf, *, runs: int, run_len: int, fan_in: int,
                            w: int = 32, block_out: int = 1024,
                            out_slack: int = 0):
    """``stream_merge_runs``' plain version, on any device."""
    return _stream_call("stream_merge_runs", buf, None, runs=runs,
                        run_len=run_len, fan_in=fan_in, w=w,
                        block_out=block_out, out_slack=out_slack,
                        descending=True, cuda=False)[0]


@obs.scoped("kernels.stream_merge_kv")
def stream_merge_runs_kv(buf, ranks, *, runs: int, run_len: int,
                         fan_in: int, w: int = 32, block_out: int = 1024,
                         out_slack: int = 0, descending: bool = True,
                         _ctas: int = 0):
    """Stable KV form of ``stream_merge_runs``: int32 rank lanes ride the
    same windows and the tree compares the compound (key, rank) order,
    either direction natively. Returns ``(keys, ranks)``. ``_ctas`` (tests
    only) forces the CUDA kernel's CTA count."""
    return _stream_call("stream_merge_runs_kv", buf, ranks, runs=runs,
                        run_len=run_len, fan_in=fan_in, w=w,
                        block_out=block_out, out_slack=out_slack,
                        descending=descending, cuda=buf.is_cuda, ctas=_ctas)


def stream_merge_runs_kv_plain(buf, ranks, *, runs: int, run_len: int,
                               fan_in: int, w: int = 32,
                               block_out: int = 1024, out_slack: int = 0,
                               descending: bool = True):
    """``stream_merge_runs_kv``' plain version, on any device."""
    return _stream_call("stream_merge_runs_kv", buf, ranks, runs=runs,
                        run_len=run_len, fan_in=fan_in, w=w,
                        block_out=block_out, out_slack=out_slack,
                        descending=descending, cuda=False)
