"""Sharded sort, top-k and expert-parallel routing across a mesh axis as
planned engine ops (counterpart of ``repro/engine/sharded.py``).

SPMD: every rank calls an op with its local shard and the
:class:`~repro_torch.launch.mesh.Mesh`, and gets back its own slice of the
JAX package's per-device result, bit for bit. The two-phase sample sort:

  1. every rank FLiMS-sorts its local shard (``ref`` key-only, the stable
     ``flims`` argsort with a payload; chunk 512, the JAX plan pins);
  2. splitter selection (regular sampling, or oversampled candidates
     refined by their exact global rank through one ``psum``) -> (P-1,)
     global splitters;
  3. bucket partition by ``searchsorted`` and one ``all_to_all``;
  4. every rank reduces the P runs it received through the plan's
     ``MergeSchedule`` executor (``torch`` | ``tree_vmapped``: K9 |
     ``tree_cuda``: K3 / K4).

Overflow contract: buckets are padded to a fixed cap for the exchange. The
cap is chosen before it: the largest bucket size over the axis (one
``pmax``, so every rank reaches the same rung and makes the same
collectives) picks the smallest rung of the ladder ``cap, 2*cap, ...,
n_local`` that holds it; ``overflow`` is set only when even the last rung
cannot. The JAX package takes the rung inside one compiled graph
(``lax.switch``); here it is a host branch on the ``pmax``'d size, the
same rule.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import obs
from repro_torch.core.flims import next_pow2
from repro_torch.core.lanes import sentinel_for
from repro_torch.engine.planner import Plan
from repro_torch.engine.schedule import MergeSchedule
from repro_torch.parallel import comm

#: per-rank sample count for the 'hist' policy = OVERSAMPLE * P
OVERSAMPLE = 8

SPLITTER_POLICIES = ("regular", "hist")


class ShardedSort(NamedTuple):
    values: torch.Tensor   # (P * cap,) this rank's run, sentinel-padded
    count: torch.Tensor    # (1,) int32 valid prefix length
    overflow: torch.Tensor  # (1,) bool: a bucket exceeded the last rung


def cap_ladder(n_local: int, n_dev: int, cap_factor: int,
               retries: int) -> tuple:
    """Cap-escalation rungs: the base cap, then doubling (at most
    ``retries`` times) toward ``n_local``, the cap no bucket can exceed."""
    base = min(n_local, cap_factor * max(n_local // n_dev, 1))
    caps = [base]
    for _ in range(max(retries, 0)):
        if caps[-1] >= n_local:
            break
        caps.append(min(2 * caps[-1], n_local))
    return tuple(caps)


# --------------------------------------------------------------------------
# per-rank pipeline pieces
# --------------------------------------------------------------------------

def _local_sort(xl, payload, w: int):
    """Descending local sort through the engine; with a payload the stable
    KV path permutes keys and payload together."""
    from repro_torch.engine import api
    if payload is None:
        return api.sort(xl, plan=Plan("ref", w=w, chunk=512)), None
    return api.sort(xl, values=payload, stable=True,
                    plan=Plan("flims", w=w, chunk=512))


def _sample_ids(n_local: int, m: int, device):
    """``m`` regular sample positions into a sorted local shard, clamped to
    a fixed ``m`` when the shard is shorter than ``m``."""
    step = max(n_local // m, 1)
    return torch.clamp(torch.arange(m, dtype=torch.int64, device=device)
                       * step, max=n_local - 1)


def _splitters_regular(loc, axis: str, mesh, n_dev: int, w: int):
    """Regular sampling: P local quantile draws a rank, all_gather, sort,
    stride."""
    from repro_torch.engine import api
    samples = loc[_sample_ids(loc.shape[0], n_dev, loc.device)]
    allsmp = comm.all_gather(samples, axis, mesh).reshape(-1)   # (P*P,)
    allsmp = api.sort(allsmp, plan=Plan(
        "ref", w=min(w, next_pow2(allsmp.shape[0])), chunk=512))
    return allsmp[::n_dev][1:n_dev]                              # (P-1,)


def _ge_counts(loc, cand):
    """Local count of elements >= each candidate (``loc`` descending)."""
    asc = torch.flip(loc, [0])
    return loc.shape[0] - torch.searchsorted(asc, cand.contiguous(),
                                             side="left",
                                             out_int32=True)


def _splitters_hist(loc, axis: str, mesh, n_dev: int):
    """Skew-robust splitters: oversampled local quantiles, each candidate's
    exact global rank (a local count ``psum``'d over the axis), and per
    target rank ``p*n/P`` the closest candidate (the first on a tie)."""
    n_local = loc.shape[0]
    m = max(min(n_local, OVERSAMPLE * n_dev), 1)
    pool = comm.all_gather(loc[_sample_ids(n_local, m, loc.device)], axis,
                           mesh).reshape(-1)                    # (P*m,)
    ge = _ge_counts(loc, pool).to(torch.int32)
    g = comm.psum(ge, axis, mesh)
    n_glob = n_local * n_dev
    targets = torch.arange(1, n_dev, dtype=torch.int32,
                           device=loc.device) * (n_glob // n_dev)
    pick = torch.argmin(torch.abs(g[None, :] - targets[:, None]), dim=1)
    return torch.sort(pool[pick], descending=True).values


def _bucket_bounds(loc, splitters):
    """Bucket boundaries ``b_p`` = #elements >= ``s_p`` (ties stay with the
    higher bucket). Returns ``(bounds (P+1,), sizes (P,))`` int32."""
    n_local = loc.shape[0]
    b = _ge_counts(loc, splitters)
    z = b.new_zeros(1)
    bounds = torch.cat([z, b, z + n_local])
    return bounds, bounds[1:] - bounds[:-1]


def _exchange(loc, ploc, bounds, sizes, *, cap: int, axis: str, mesh):
    """One rung's exchange: each bucket gathered into a fixed-``cap`` row
    (the sentinel past its size), then one ``all_to_all`` of the keys, the
    counts and each payload leaf. Returns ``(recv (P, cap), cnt (P,),
    precv)``."""
    from repro_torch.core.butterfly import tree_map
    n_local = loc.shape[0]
    sent = sentinel_for(loc.dtype)
    ar = torch.arange(cap, dtype=torch.int32, device=loc.device)
    pos = bounds[:-1][:, None] + ar[None, :]                     # (P, cap)
    valid = ar[None, :] < torch.clamp(sizes, max=cap)[:, None]
    src = torch.clamp(pos, 0, n_local - 1)
    send = torch.where(valid, loc[src], loc.new_full((), sent))
    recv = comm.all_to_all(send, axis, mesh)
    cnt = comm.all_to_all(torch.clamp(sizes, max=cap).to(torch.int32), axis,
                          mesh)
    precv = None
    if ploc is not None:
        # payload rows travel beside the keys; validity is governed by the
        # counts, so rows past a bucket's size need no masking
        precv = tree_map(lambda pv: comm.all_to_all(pv[src], axis, mesh),
                         ploc)
    return recv, cnt, precv


def _reduce_received(recv, cnt, precv, *, cap: int, out_cap: int,
                     sched: MergeSchedule, dtype):
    """The K-way reduction of the received runs through the schedule,
    padded to the ladder's uniform ``next_pow2(P) * out_cap`` length."""
    from repro_torch.core.butterfly import tree_map
    from repro_torch.core.merge_tree import pmt_merge, pmt_merge_kv_padded
    sent = sentinel_for(dtype)
    k_pad = next_pow2(recv.shape[0])
    if k_pad != recv.shape[0]:
        grow = k_pad - recv.shape[0]
        recv = torch.cat([recv, recv.new_full((grow, cap), sent)])
        if precv is not None:
            precv = tree_map(lambda pv: torch.cat(
                [pv, pv.new_zeros((grow, cap))]), precv)
    total = cnt.sum(dtype=torch.int32).reshape(1)
    # a lane width wider than the rung's rows is wasted selector work
    sched = sched.replace(w=min(sched.w, next_pow2(cap)))
    n_out = k_pad * out_cap

    def grow_tail(v, fill):
        return torch.cat([v, v.new_full((n_out - v.shape[0],), fill)])

    if precv is None:
        return grow_tail(pmt_merge(recv, w=sched.w, schedule=sched),
                         sent), None, total
    # validity-aware KV merge: padding sorts behind real sentinel-valued
    # keys, or its payload would land inside the count prefix
    cnt_pad = torch.cat([cnt, cnt.new_zeros(k_pad - cnt.shape[0])])
    merged, pmerged = pmt_merge_kv_padded(recv, cnt_pad, precv, w=sched.w,
                                          schedule=sched)
    return (grow_tail(merged, sent), tree_map(lambda v: grow_tail(v, 0),
                                              pmerged), total)


def _exchange_merge(loc, ploc, bounds, sizes, *, cap: int, out_cap: int,
                    axis: str, mesh, sched: MergeSchedule):
    """One ladder rung: exchange, then reduce."""
    recv, cnt, precv = _exchange(loc, ploc, bounds, sizes, cap=cap,
                                 axis=axis, mesh=mesh)
    return _reduce_received(recv, cnt, precv, cap=cap, out_cap=out_cap,
                            sched=sched, dtype=loc.dtype)


def _emit_exec(rung: int, need: int, overflow: bool, *, caps: tuple):
    """The rung taken, the ``pmax``'d needed cap and the overflow flag: one
    ``sharded.exec`` event a rank."""
    obs.event("sharded.exec", rung=rung, cap=int(caps[min(rung,
                                                           len(caps) - 1)]),
              need=need, overflow=overflow, rungs=len(caps))
    obs.inc("sharded.overflow" if overflow else "sharded.ok")


def _rung(need: int, caps: tuple) -> int:
    return min(sum(need > c for c in caps), len(caps) - 1)


def _sharded_pass(xl, payload, *, axis: str, mesh, n_dev: int, caps: tuple,
                  w: int, sched: MergeSchedule, splitter: str):
    """The whole per-rank pipeline: local sort, splitters, bucket sizes,
    the rung (from the ``pmax``'d largest bucket), exchange and merge."""
    loc, ploc = _local_sort(xl, payload, w)
    if splitter == "hist":
        spl = _splitters_hist(loc, axis, mesh, n_dev)
    else:
        spl = _splitters_regular(loc, axis, mesh, n_dev, w)
    bounds, sizes = _bucket_bounds(loc, spl)
    # the needed cap is known before any exchange, and the same on every
    # rank of the axis: they all take the same rung and its collectives
    need = int(comm.pmax(sizes.max().reshape(1), axis, mesh)[0])
    overflow = need > caps[-1]
    rung = _rung(need, caps)
    merged, pmerged, total = _exchange_merge(
        loc, ploc, bounds, sizes, cap=caps[rung], out_cap=caps[-1],
        axis=axis, mesh=mesh, sched=sched)
    if obs.enabled():
        _emit_exec(rung, need, overflow, caps=caps)
    res = ShardedSort(merged, total, torch.tensor([overflow],
                                                  device=xl.device))
    return res if payload is None else (res, pmerged)


# --------------------------------------------------------------------------
# mesh-level runners (the registry's entry points)
# --------------------------------------------------------------------------

def _pass_kwargs(xl, mesh, axis: str, plan: Plan, kv: bool,
                 schedule: Optional[MergeSchedule] = None) -> dict:
    n_dev = mesh.axis_size(axis)
    n_local = xl.shape[0]
    sched = schedule or MergeSchedule.from_plan(plan)
    if kv:
        sched = sched.replace(tie="b")   # rank lanes leave no ties for skew
    if plan.splitter not in SPLITTER_POLICIES:
        raise ValueError(f"splitter {plan.splitter!r} not in "
                         f"{SPLITTER_POLICIES}")
    caps = cap_ladder(n_local, n_dev, plan.cap_factor, plan.retries)
    obs.event("sharded.plan", n_local=n_local, n_dev=n_dev, axis=axis,
              caps=list(caps), splitter=plan.splitter,
              executor=sched.variant, levels=sched.levels_per_pass,
              kv=kv, w=plan.w)
    return dict(axis=axis, mesh=mesh, n_dev=n_dev, caps=caps, w=plan.w,
                sched=sched, splitter=plan.splitter)


def run_sharded_sort(xl, mesh, axis: str = "data", *, payload=None,
                     plan: Optional[Plan] = None,
                     schedule: Optional[MergeSchedule] = None):
    """The sharded sort of this rank's shard ``xl`` under an explicit plan
    (no planner lookup).

    Returns this rank's padded run: a :class:`ShardedSort` whose ``values``
    concatenated over the ranks in axis order are the global descending
    order (``parallel.sharding.collect_sorted`` gathers them). With
    ``payload=`` (a tensor or dict / list / tuple of tensors shaped like
    ``xl``) returns ``(ShardedSort, payload)`` permuted identically.
    ``schedule`` overrides the step-4 executor the plan names (the
    ``sample_sort(merge_schedule=)`` path).
    """
    plan = plan or Plan("tree_vmapped")
    with obs.kernel_scope("sharded.sort"):
        return _sharded_pass(xl, payload,
                             **_pass_kwargs(xl, mesh, axis, plan,
                                            kv=payload is not None,
                                            schedule=schedule))


# --------------------------------------------------------------------------
# sharded top-k
# --------------------------------------------------------------------------

def _topk_pass(xl, payload, *, axis: str, mesh, k: int, kk: int,
               variant: str, sched: MergeSchedule):
    """Local top-kk with global indices (and the payload) on the lanes,
    all_gather of the P candidate runs, a stable merge, the first k. The
    union of local top-kk runs holds the global top-k in ``lax.top_k``'s
    tie order: an element beaten locally by kk others is beaten globally
    by the same kk."""
    from repro_torch.core.butterfly import tree_map
    from repro_torch.core.merge_tree import pmt_merge_kv
    from repro_torch.engine import api
    n_local = xl.shape[0]
    base = comm.axis_index(axis, mesh) * n_local
    lanes = {"idx": base + torch.arange(n_local, dtype=torch.int32,
                                        device=xl.device)}
    if payload is not None:
        lanes["pay"] = payload
    vals, _, sel = api.topk(xl, kk, variant=variant, values=lanes)
    av = comm.all_gather(vals, axis, mesh)                       # (P, kk)
    asel = tree_map(lambda v: comm.all_gather(v, axis, mesh), sel)
    # row-major ranks == (rank, local rank) == global-index tie order
    mk, mp = pmt_merge_kv(av, asel, schedule=sched)
    out = (mk[:k], mp["idx"][:k])
    if payload is None:
        return out
    return out + (tree_map(lambda v: v[:k], mp["pay"]),)


def run_sharded_topk(xl, k: int, mesh, axis: str = "data", *, payload=None,
                     plan: Optional[Plan] = None):
    """``(values, global indices)`` of the k largest elements over the
    axis, bit for bit ``lax.top_k`` of the gathered array (ties to the lower
    global index), the same on every rank. With ``payload=`` returns
    ``(values, indices, payload_topk)``."""
    plan = plan or Plan("torch")
    n_dev = mesh.axis_size(axis)
    n_local = xl.shape[0]
    if k > n_local * n_dev:
        raise ValueError(f"sharded_topk: k={k} exceeds the "
                         f"{n_local * n_dev} keys")
    # the JAX package's schedule for a non-executor variant: tree_vmapped
    sched = MergeSchedule.from_plan(
        plan, variant=None if plan.variant in ("torch", "tree_vmapped",
                                               "tree_cuda")
        else "tree_vmapped").replace(tie="b")
    variant = plan.variant if plan.variant in ("flims", "torch") else None
    with obs.kernel_scope("sharded.topk"):
        return _topk_pass(xl, payload, axis=axis, mesh=mesh, k=k,
                          kk=min(k, n_local), variant=variant, sched=sched)


# --------------------------------------------------------------------------
# expert-parallel MoE routing: the fused route composed with the
# sharded-topk candidate lemma
# --------------------------------------------------------------------------

class RouteShard(NamedTuple):
    """This rank's routing result: the (token, expert) pairs routed to its
    experts, in global stable (expert, pair rank) order. Lanes are (P * A,)
    (A = the per-source candidate cap), padded past ``count``."""
    experts: torch.Tensor  # global expert id, E where invalid
    tokens: torch.Tensor   # global source token id
    perm: torch.Tensor     # global stable pair position t*k + j
    weights: torch.Tensor  # combine weight (float32)
    slabs: torch.Tensor    # LOCAL slab (e - e0)*cap + pos, E_loc*cap if drop
    keep: torch.Tensor     # bool: survives the GLOBAL capacity cut
    count: torch.Tensor    # (1,) candidates arrived at this rank


#: -ckey of any real pair is larger
_NEG_PAD = torch.iinfo(torch.int32).min + 1


def _route_ep_pass(lg, *, axis: str, mesh, k: int, cap: int,
                   local_variant: str, w: int):
    """Route the local token rows (the local capacity cut doubling as the
    sharded-topk union-of-local-top-k prefilter), send the candidates to
    their expert's owner with one ``all_to_all``, and re-rank them there
    by global stable pair position.

    The prefilter is lossless: a pair's owner-side rank counts only
    arrived earlier pairs, so it can undercount the global rank; but a
    missing earlier pair was dropped locally (local rank >= cap), and the
    cap locally kept pairs before it all arrive, so an undercounted pair
    already has >= cap arrivals ahead of it. Hence owner rank < cap iff
    global rank < cap, and the two are equal on every kept pair.
    """
    from repro_torch.engine import api, registry
    n_dev = mesh.axis_size(axis)
    T_loc, E = lg.shape
    dev = lg.device
    d = comm.axis_index(axis, mesh)
    Npl = T_loc * k
    E_loc = E // n_dev
    A = min(Npl, E_loc * cap)      # kept-per-owner bound: both are hard caps
    span = n_dev * Npl             # one expert's band of global pair ranks
    route = registry.call("moe_route", local_variant, lg[None], k, cap,
                          plan=Plan(local_variant, w=w, cap=cap))
    e_s, _t_s, perm, w_s, _slab, keep = (x[0] for x in route)
    keep = keep.to(torch.bool)

    # ---- pack the locally kept candidates into (P, A) owner rows ---------
    grank = d * Npl + perm                     # global stable pair position
    ckey = e_s * span + grank                  # global compound sort key
    owner = torch.clamp(torch.div(e_s, E_loc, rounding_mode="floor"), 0,
                        n_dev - 1)
    onehot_o = owner[:, None] == torch.arange(n_dev, dtype=owner.dtype,
                                              device=dev)[None, :]
    sel = onehot_o & keep[:, None]
    seli = sel.to(torch.int32)
    col = torch.where(sel, torch.cumsum(seli, 0, dtype=torch.int32) - 1,
                      0).sum(1)
    row = torch.where(keep, owner, n_dev).long()
    send_k = torch.full((n_dev + 1, A), _NEG_PAD, dtype=torch.int32,
                        device=dev)
    send_w = torch.zeros((n_dev + 1, A), dtype=torch.int32, device=dev)
    # negate so the engine's descending sort yields ascending compound order
    send_k[row, col.long()] = torch.where(keep, -ckey,
                                          _NEG_PAD).to(torch.int32)
    send_w[row, col.long()] = w_s.to(torch.float32).view(torch.int32)
    cnt_send = seli.sum(0, dtype=torch.int32)                     # (P,)

    # ---- one all_to_all: candidates travel to their expert's owner -------
    recv_k = comm.all_to_all(send_k[:n_dev].contiguous(), axis, mesh)
    recv_w = comm.all_to_all(send_w[:n_dev].contiguous(), axis, mesh)
    cnt = comm.all_to_all(cnt_send, axis, mesh)
    total = cnt.sum(dtype=torch.int32)

    # ---- owner merge: P sorted runs -> global stable order, re-cut -------
    keys, pay = api.sort(recv_k.reshape(-1),
                         values={"w": recv_w.reshape(-1)}, stable=True,
                         plan=Plan("flims", w=w, chunk=512))
    M = n_dev * A
    iota_m = torch.arange(M, dtype=torch.int32, device=dev)
    valid = iota_m < total                     # pads sort to the tail
    ckey2 = -keys
    e_g = torch.where(valid, torch.div(ckey2, span, rounding_mode="floor"),
                      E).to(torch.int32)
    gr = torch.where(valid, torch.remainder(ckey2, span), 0).to(torch.int32)
    el = torch.where(valid, e_g - d * E_loc, E_loc)
    onehot_e = el[:, None] == torch.arange(E_loc, dtype=el.dtype,
                                           device=dev)[None, :]
    counts = onehot_e.sum(0, dtype=torch.int32)
    first = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    pos = iota_m - torch.where(onehot_e, first[None, :], 0).sum(
        1, dtype=torch.int32)
    keep2 = valid & (pos < cap)
    if obs.enabled():
        dropped = int(total) - int(keep2.sum())
        obs.event("moe.route_ep.exec", arrived=int(total), dropped=dropped)
        obs.inc("moe.dropped_tokens", dropped)
    wts = pay["w"].view(torch.float32)
    return RouteShard(
        experts=e_g,
        tokens=torch.where(valid, torch.div(gr, k, rounding_mode="floor"),
                           0).to(torch.int32),
        perm=gr,
        weights=torch.where(valid, wts, wts.new_zeros(())),
        slabs=torch.where(keep2, el * cap + pos, E_loc * cap).to(
            torch.int32),
        keep=keep2,
        count=total.reshape(1),
    )


def run_moe_route_ep(lg, k: int, capacity: int, mesh, axis: str = "data",
                     *, plan: Optional[Plan] = None):
    """Expert-parallel MoE routing of this rank's (T_loc, E) logits rows
    (tokens split over the P ranks of ``axis`` in rank order; rank ``d``
    owns experts ``[d*E/P, (d+1)*E/P)``). Returns this rank's
    :class:`RouteShard`: the pairs routed to its experts in global stable
    order, with local slab indices into an (E/P * cap + 1, d) buffer. The
    keep mask is ``moe_route``'s capacity cut on the gathered logits, pair
    for pair. The variant names the local route (``fused``: K7;
    ``torch``)."""
    plan = plan or Plan("torch")
    n_dev = mesh.axis_size(axis)
    T_loc, E = lg.shape
    if E % n_dev:
        raise ValueError(f"moe_route_ep: E={E} not divisible by P={n_dev}")
    span = n_dev * T_loc * k
    if E * span >= 2 ** 31:
        raise ValueError(f"moe_route_ep: compound key e*{span}+grank "
                         f"overflows int32 at E={E}; shrink the token chunk")
    local_variant = plan.variant if plan.variant in ("fused", "torch") \
        else "torch"
    obs.event("moe.route_ep.plan", n_dev=n_dev, axis=axis, t_local=T_loc,
              experts=E, k=k, capacity=int(capacity),
              cand_cap=min(T_loc * k, (E // n_dev) * int(capacity)),
              local_variant=local_variant)
    with obs.kernel_scope("sharded.moe_route_ep"):
        return _route_ep_pass(lg.to(torch.float32), axis=axis, mesh=mesh,
                              k=k, cap=int(capacity),
                              local_variant=local_variant, w=plan.w)
