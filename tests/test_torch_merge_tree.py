"""K4's persistent design on the CPU: the facts its CUDA kernel rests on.

The kernel streams the merge tree over spans of output blocks from one
partition per span, computes that partition from per-leaf counts, and
splits the flat blocks between its CTAs on the card. Each is held here in
plain PyTorch / Python against the per-block reference:

- the hinge: the plain version (one block at a time) gives the same bits at
  every output block from ``w`` to the whole group, so a span streamed from
  one partition is the per-block kernel;
- the partition: :func:`merge_tree.leaf_count_partition`, the kernel's
  algorithm, gives ``_tree_meta``'s leaf bases and rotations at every block;
- the span split: :func:`merge_tree.tree_spans` tiles every group's blocks.

Inputs: ragged runs with empty runs and empty groups, keys with +0.0/-0.0,
-inf and heavy ties, ranks a permutation. Tolerance: exact (float keys
compared as int32 bit patterns).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import merge_tree as TT  # noqa: E402
from repro_torch.kernels.flims_merge import search_steps  # noqa: E402

RNG = np.random.default_rng(41)
FPOOL = np.array([0.0, -0.0, 1.5, -1.0, -np.inf, 4.0], np.float32)
# run lengths per group size: empty runs, one-run groups and an empty group
GEOMS = {
    2: [5, 0, 33, 7, 0, 0, 90, 4, 17, 1],
    4: [5, 0, 33, 7, 0, 0, 0, 0, 90, 4, 17, 1],
    8: [5, 0, 33, 7, 0, 0, 90, 4] + [0] * 8 + [64, 1, 0, 40, 3, 3, 9, 100],
}


def ragged_runs(lens, descending):
    """(keys, ranks, starts, lens): each run in the compound (key, rank)
    order of the direction, ranks a permutation of the whole buffer."""
    n = sum(lens)
    k = RNG.choice(FPOOL, n).astype(np.float32)
    r = RNG.permutation(n).astype(np.int32)
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    for a, b in zip(offs[:-1], offs[1:]):
        p = np.lexsort((r[a:b], -k[a:b] if descending else k[a:b]))
        k[a:b], r[a:b] = k[a:b][p], r[a:b][p]
    return (torch.from_numpy(k), torch.from_numpy(r),
            torch.from_numpy(offs[:-1].astype(np.int32)),
            torch.tensor(lens, dtype=torch.int32))


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("group,w", [(2, 8), (4, 8), (4, 32), (8, 8)])
@pytest.mark.parametrize("kv,descending", [(False, True), (True, True),
                                           (True, False)])
def test_plain_output_does_not_depend_on_block(group, w, kv, descending):
    """The hinge of the CUDA kernel's persistent design: a span streams
    through the tree from one partition, which is the per-block kernel at
    an output block of the span's length. The plain version gives the same
    bits at every block from w to the longest group."""
    lens = GEOMS[group]
    k, r, st, ln = ragged_runs(lens, descending)
    n = k.shape[0]
    glen = max(sum(lens[i:i + group]) for i in range(0, len(lens), group))
    blocks = [w << i for i in range(max(glen - 1, 1).bit_length() + 1)
              if w << i <= max(w, 1 << (glen - 1).bit_length())]
    assert blocks[-1] >= glen
    outs = []
    for bo in blocks:
        kw = dict(group=group, n_out=n, w=w, block_out=bo)
        got = TT.merge_tree_runs_kv(k, r, st, ln, descending=descending,
                                    **kw) if kv else \
            (TT.merge_tree_runs(k, st, ln, **kw),)
        outs.append([_bits(x) for x in got])
    for o in outs[1:]:
        for a, b in zip(outs[0], o):
            assert torch.equal(a, b)


@pytest.mark.parametrize("group,w", [(2, 8), (4, 8), (4, 32), (8, 8),
                                     (8, 16)])
@pytest.mark.parametrize("kv,descending", [(False, True), (True, True),
                                           (True, False)])
def test_leaf_count_partition_is_tree_meta(group, w, kv, descending):
    """The kernel's partition (per-leaf counts at the root, the dropped
    tail below it) gives the nested co-rank search's leaf bases and
    rotations at every w-aligned block offset of every group, the empty
    group included (offset 0 only)."""
    lens = GEOMS[group]
    k, r, st, ln = ragged_runs(lens, descending)
    n = k.shape[0]
    cases = []
    for grp in range(len(lens) // group):
        j0 = grp * group
        glen = sum(lens[j0:j0 + group])
        for o in range(0, max(glen, 1), w):
            cases.append((grp, o))
    grps = torch.tensor([g for g, _ in cases])
    starts_g = [st[grps * group + j].long() for j in range(group)]
    lens_g = [ln[grps * group + j].long() for j in range(group)]
    o_t = torch.tensor([o for _, o in cases])
    base, rots = TT._tree_meta(starts_g, lens_g, o_t, k, r if kv else None,
                               group=group, w=w, steps=search_steps(n),
                               descending=descending)
    for i, (grp, o) in enumerate(cases):
        leaves = range(grp * group, (grp + 1) * group)
        keys = [k[st[j]:st[j] + ln[j]].tolist() for j in leaves]
        ranks = [r[st[j]:st[j] + ln[j]].tolist() for j in leaves] if kv \
            else None
        got_base, got_rots = TT.leaf_count_partition(
            keys, ranks, o, w=w, descending=descending)
        assert got_base == [int(b[i]) for b in base], (grp, o)
        assert got_rots == [(int(a[i]), int(b[i])) for a, b in rots], \
            (grp, o)


@pytest.mark.parametrize("blocks", [
    [1] * 16384, [4] * 1024, [8, 0, 3, 0, 0, 5, 1], [0, 0, 7], [7, 0, 0],
    [4096], [0], [1, 0, 1, 0, 1]])
def test_tree_spans_tile_each_group(blocks):
    """The CUDA kernel's span split over groups of ``blocks[g]`` blocks: in
    CTA order the spans tile the flat blocks with no gap or overlap, each
    lies inside one group, a group with no block has none, and the CTAs'
    shares differ by at most one block."""
    blk0 = [0]
    for b in blocks:
        blk0.append(blk0[-1] + b)
    for grid in sorted({1, 2, 7, 528, 1056, max(blk0[-1], 1), blk0[-1] + 3}):
        per_cta = TT.tree_spans(blk0, grid)
        assert len(per_cta) == grid
        flat = [s for spans in per_cta for s in spans]
        ends = [e for _, _, e in flat]
        assert [b for _, b, _ in flat] == ([0] + ends[:-1] if flat else [])
        assert (ends[-1] if flat else 0) == blk0[-1]
        for grp, b, e in flat:
            assert blk0[grp] <= b < e <= blk0[grp + 1]
        shares = [sum(e - b for _, b, e in spans) for spans in per_cta]
        assert max(shares) - min(shares) <= 1


@pytest.mark.parametrize("op", ["sort", "argsort", "merge_runs",
                                "segment_sort", "segment_argsort",
                                "external_sort"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_planner_widths_are_the_kernels(op, dtype):
    """Every w the planner gives an op whose plan reaches K4 (any n) is one
    the CUDA kernel runs, one warp per tree node: 8 to 128. The call sites
    pass it on unchanged whenever a merge runs (``min(w, chunk)`` cuts it
    only below the 256-key chunk, where one chunk needs no merge)."""
    from repro_torch.engine import planner
    ws = {planner.heuristic_plan(op, planner.plan_key(
        op, n=1 << e, dtype=dtype, backend="cuda")).w for e in range(34)}
    assert ws == {8, 16, 32, 64, 128}
    assert (TT.W_MIN, TT.W_MAX) == (min(ws), max(ws))
    assert planner.heuristic_plan(op, planner.plan_key(
        op, n=1 << 24, dtype=dtype, backend="cuda")).chunk >= TT.W_MAX
