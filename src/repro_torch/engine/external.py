"""``engine.external_sort`` internals: the two-phase out-of-core sort.

Counterpart of ``repro/engine/external.py`` (TopSort, arXiv:2205.07991).
Only a tile ever has to be sorted in one piece:

- **Phase 1, run formation.** The input is padded to ``R = ceil(n / T)``
  tiles of ``T = plan.tile_elems`` keys and every tile is sorted: on
  ``stream_cuda`` by K1 over chunks, then the ``tree_cuda`` schedule (K4)
  with ``T / chunk`` runs per group; on ``torch`` by one row sort (a stable
  row argsort carrying the rank lane for KV). One read and one write of the
  data.
- **Phase 2, run reduction.** The ``R`` device-resident runs reduce with
  ``ceil(log_fan_in(R))`` streamed passes (``schedule.stream_pass``):
  groups of ``plan.fan_in`` runs merge in one launch of K8 on
  ``stream_cuda``, by binary-search pair merges on ``torch``. Each pass is
  one more read and write (``launch.roofline.external_sort_bytes``).

KV calls (rank lanes) sort in the requested direction at every stage;
key-only calls reduce descending and reverse once at the end. Rank lanes
must be non-decreasing along the input (the engine passes positions), so
the result is ``torch.argsort(stable=True)``'s permutation bit for bit.

``obs`` events: ``external.run_form`` (phase 1) and one ``external.pass``
per phase-2 pass, each carrying ``bytes_streamed``.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.core.flims import next_pow2
from repro_torch.core.lanes import INVALID_RANK
from repro_torch.engine.schedule import MergeSchedule, reduce_rows, stream_pass
from repro_torch.kernels.flims_merge import bound_keys

#: phase-1 run length and phase-2 fan-in when neither the call nor the plan
#: sets them (the JAX package's defaults off the TPU)
DEFAULT_TILE = 1 << 20
DEFAULT_FAN_IN = 8


def resolve_dofs(plan, n: int, *, tile_elems: int = 0, fan_in: int = 0):
    """Fill the out-of-core degrees of freedom: explicit arguments win, then
    the plan's fields, then the defaults. Tiles clamp to a power of two
    ``>= w``; fan-in to a power of two ``>= 2``."""
    t = tile_elems or plan.tile_elems or DEFAULT_TILE
    t = max(next_pow2(max(t, 2)), plan.w)
    f = fan_in or plan.fan_in or DEFAULT_FAN_IN
    f = max(next_pow2(max(f, 2)), 2)
    return plan.replace(tile_elems=t, fan_in=f)


def _form_runs_torch(kp, rp, R: int, T: int, descending: bool):
    """Phase 1 in plain torch: one directional row sort per tile. Key-only
    rows order a +0/-0 tie as ``jnp.sort`` does (``stable_sort_values``);
    KV rows by a stable row argsort carrying the rank lane."""
    from repro_torch.kernels.ref import stable_sort_values
    rows = kp.reshape(R, T)
    if rp is None:
        return stable_sort_values(rows, descending=descending).reshape(-1), \
            None
    perm = torch.argsort(rows, dim=-1, stable=True, descending=descending)
    return (torch.gather(rows, -1, perm).reshape(-1),
            torch.gather(rp.reshape(R, T), -1, perm).reshape(-1))


def _form_runs_cuda(kp, rp, R: int, T: int, *, w: int, chunk: int,
                    levels: int, block_out: int, descending: bool):
    """Phase 1 on the kernels: K1 sorts every chunk, then ``tree_cuda``
    passes (K4) reduce ``T // chunk`` runs per tile, all tiles in each
    launch."""
    from repro_torch.kernels.bitonic_sort import sort_chunks, sort_chunks_kv
    c = min(next_pow2(max(chunk, 2)), T)
    sched = MergeSchedule("tree_cuda", levels_per_pass=max(levels, 1),
                          w=min(w, c), block_out=max(block_out, w))
    if rp is None:
        rows = sort_chunks(kp.reshape(-1, c))
        if c == T:
            return rows.reshape(-1), None
        return reduce_rows(rows, schedule=sched, runs_per_group=T // c), None
    k2, r2 = sort_chunks_kv(kp.reshape(-1, c), rp.reshape(-1, c),
                            descending=descending)
    if c == T:
        return k2.reshape(-1), r2.reshape(-1)
    return reduce_rows(k2, ranks=r2, schedule=sched, runs_per_group=T // c,
                       descending=descending)


def _pad(x, size: int, fill):
    return torch.cat([x, x.new_full((size - x.shape[0],), fill)]) \
        if size > x.shape[0] else x


def run_external_sort(keys, *, plan, descending: bool = True, ranks=None):
    """The two-phase sort behind ``engine.external_sort``.

    ``plan`` carries resolved ``tile_elems`` / ``fan_in``
    (``resolve_dofs``). Key-only: returns the sorted keys. With ``ranks=``
    (int32, non-decreasing): returns ``(keys, ranks)`` merged under the
    stable compound order."""
    n = keys.shape[0]
    kv = ranks is not None
    T, fan = plan.tile_elems, plan.fan_in
    w, block_out = plan.w, plan.block_out
    executor = "stream_cuda" if plan.variant == "stream_cuda" \
        else "stream_torch"
    desc_i = descending if kv else True       # key-only: reverse at the end
    R = -(-n // T)
    itemsize = keys.element_size() + (4 if kv else 0)
    _, last_k = bound_keys(keys.dtype, desc_i)
    kp = _pad(keys, R * T, last_k)
    rp = _pad(ranks.to(torch.int32), R * T, INVALID_RANK) if kv else None

    with obs.kernel_scope("external.run_form"):
        if plan.variant == "stream_cuda":
            buf, rbuf = _form_runs_cuda(
                kp, rp, R, T, w=w, chunk=plan.chunk, levels=plan.levels,
                block_out=block_out, descending=desc_i)
        else:
            buf, rbuf = _form_runs_torch(kp, rp, R, T, desc_i)
    obs.event("external.run_form", n=int(n), runs=int(R), tile=int(T),
              variant=plan.variant, kv=kv,
              bytes_streamed=int(2 * R * T * itemsize))

    slack = 0
    if executor == "stream_cuda":
        from repro_torch.kernels.stream_merge import stream_slack
        slack = stream_slack(fan, w, block_out)
        buf = _pad(buf, R * T + slack, last_k)
        if kv:
            rbuf = _pad(rbuf, R * T + slack, INVALID_RANK)

    runs, run_len, idx = R, T, 0
    while runs > 1:
        f = min(fan, next_pow2(runs))
        runs_pad = -(-runs // f) * f
        if runs_pad != runs:                  # complete with sentinel runs
            size = runs_pad * run_len + slack
            buf = _pad(buf[:runs * run_len], size, last_k)
            if kv:
                rbuf = _pad(rbuf[:runs * run_len], size, INVALID_RANK)
        with obs.kernel_scope(f"external.pass{idx}"):
            buf, rbuf = stream_pass(
                buf, rbuf, runs=runs_pad, run_len=run_len, fan_in=f,
                executor=executor, w=w, block_out=block_out,
                descending=desc_i, out_slack=slack)
        obs.event("external.pass", idx=idx, fan_in=int(f),
                  runs=int(runs_pad), run_len=int(run_len),
                  executor=executor, level_kind="hbm_run", kv=kv,
                  bytes_streamed=int(2 * runs_pad * run_len * itemsize))
        runs = runs_pad // f
        run_len *= f
        idx += 1

    if kv:
        return buf[:n], rbuf[:n]
    out = buf[:n]
    return out if descending else torch.flip(out, [0])
