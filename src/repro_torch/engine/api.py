"""`repro_torch.engine` — the port's facade over the FLiMS stack.

Counterpart of ``repro/engine/api.py`` for ``sort``, ``argsort``,
``merge``, ``merge_runs``, ``topk``, the samplers ``sample_topp`` /
``sample_minp``, the ragged ``segment_sort`` / ``segment_argsort`` /
``segment_merge``, the fused MoE routing op ``moe_route``, the
out-of-core ``external_sort`` and the ops across a mesh axis
``sharded_sort``, ``sharded_topk`` and ``moe_route_ep``. Each call
resolves a ``Plan`` (explicit, cache, table, heuristic) and dispatches to
the registered variant through ``guard.fallback.guarded_call``, which
absorbs only ``torch.cuda.OutOfMemoryError``: on the card by running the
same plan once more, on the CPU by moving down the variant ladder (a
kernel's failure always reaches the caller). ``autotune`` times the registered variants on an example workload
and installs the winner; ``run_op`` runs an op under an explicit plan.
With ``guard.verify`` enabled (``REPRO_VERIFY=1``), ``sort``,
``argsort``, ``merge``, ``segment_sort``, ``merge_runs`` and
``external_sort`` check their results at the JAX package's sites.

Every op runs on its input's device. A tensor stays where it is (or moves to
``device=`` when given); anything else (numpy arrays, lists) becomes a
tensor on ``device``, which defaults to ``"cuda"``: without a card that
raises, it never falls back to the CPU.

    from repro_torch import engine
    y    = engine.sort(x)                          # descending
    k, v = engine.sort(x, values=v)                # stable key/value sort
    perm = engine.argsort(keys, descending=False)
    m    = engine.merge(a, b)
    m    = engine.merge_runs(keys, run_offsets)    # K sorted runs -> one
    v, i = engine.topk(logits, 16)                 # ties to the lower index
    tok  = engine.sample_topp(gen, logits, 0.9)    # nucleus over the argsort
    tok  = engine.sample_minp(gen, logits, 0.1)    # min-p over the same
    s    = engine.segment_sort(values, offsets)    # ragged batch
    perm = engine.segment_argsort(keys, offsets)   # local stable perms
    r    = engine.moe_route(logits, k=2, capacity=64)  # fused MoE routing
    y    = engine.external_sort(x, tile_elems=1 << 20)  # out-of-core sort
    r    = engine.sharded_sort(x_local, mesh, "data")  # this rank's run
    v, i = engine.sharded_topk(x_local, 16, mesh)  # global top-k, replicated
    plan = engine.autotune("topk", logits, 64)     # time the variants
    engine.save_plans("plans.json")
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.butterfly import tree_map
from repro_torch.core.flims import next_pow2
from repro_torch.engine import registry, segments
from repro_torch.engine.planner import (Plan, _key_str, backend_of,
                                        default_planner, heuristic_plan,
                                        plan_key)
from repro_torch.engine.schedule import MergeSchedule
from repro_torch.guard import fallback as _fallback
from repro_torch.guard import validate as _validate
from repro_torch.guard import verify as _verify

__all__ = ["sort", "argsort", "merge", "merge_runs", "topk", "sample_topp",
           "sample_minp", "segment_sort", "segment_argsort", "segment_merge",
           "moe_route", "RouteResult", "external_sort", "sharded_sort",
           "sharded_topk", "moe_route_ep", "run_op", "autotune",
           "save_plans", "load_plans", "clear_plans", "Plan",
           "MergeSchedule"]

#: ops whose variants make collectives over a mesh axis: (index of the
#: mesh in the registry's argument list, index of the axis)
COLLECTIVE_OPS = {"sharded_sort": (1, 2), "sharded_topk": (2, 3),
                  "moe_route_ep": (3, 4)}


def mesh_axis_of(op: str, args):
    """``(mesh, axis)`` of a collective op's registry arguments, else
    None."""
    if op not in COLLECTIVE_OPS:
        return None
    i, j = COLLECTIVE_OPS[op]
    return args[i], args[j]


def _gcall(op: str, plan: Plan, *args, **kw):
    """Registry dispatch under the guard layer (``guard/fallback.py``): an
    out-of-memory error retries the plan on the card and demotes down the
    candidate order on the CPU; everything else propagates."""
    return _fallback.guarded_call(op, plan, *args, **kw)


def _tensor(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return torch.as_tensor(np.asarray(x), device=device or "cuda")


def _payload(values, like: torch.Tensor):
    return None if values is None else tree_map(
        lambda v: _tensor(v, like.device), values)


def _nan_keys(op: str, keys, nan: Optional[str]):
    """The monotone int32 keys when the resolved NaN policy is
    ``"sort_last"`` on float keys, else None (``"raise"`` has checked)."""
    policy = _validate.resolve_nan_policy(nan, op)
    if policy == "unsafe" or not _validate.check_float_dtype(op, keys):
        return None
    if policy == "raise":
        _validate.check_finite_keys(op, keys)
        return None
    return _validate.total_order_key(keys)


def infer_key(op: str, *args):
    """Plan-cache key for an op's arguments (the samplers' logits may
    follow their generator, as the registry takes them)."""
    x = args[0]
    if op in ("sample_topp", "sample_minp") and (
            x is None or isinstance(x, torch.Generator)):
        x = args[1]
    backend = backend_of(x.device)
    if op == "merge":
        return plan_key(op, n=x.shape[0] + args[1].shape[0], dtype=x.dtype,
                        backend=backend)
    if op in ("sort", "argsort", "external_sort", "topk", "sample_topp",
              "sample_minp"):
        return plan_key(op, n=x.shape[-1], dtype=x.dtype, backend=backend)
    if op in ("merge_runs", "segment_sort", "segment_argsort"):
        return plan_key(op, n=x.shape[0], dtype=x.dtype, backend=backend,
                        segments=args[1].shape[0] - 1)
    if op == "segment_merge":
        return plan_key(op, n=x.shape[0] + args[2].shape[0], dtype=x.dtype,
                        backend=backend, segments=args[1].shape[0] - 1)
    if op == "moe_route":
        return plan_key(op, n=x.shape[-2] * args[1], dtype=x.dtype,
                        backend=backend, segments=x.shape[0])
    if op in COLLECTIVE_OPS:
        # the JAX key: the GLOBAL length, P in segments, the axis name
        mesh, axis = mesh_axis_of(op, args)
        P = mesh.axis_size(axis)
        n = x.shape[-2] * P * args[1] if op == "moe_route_ep" \
            else x.shape[0] * P
        return plan_key(op, n=n, dtype=x.dtype, backend=backend, segments=P,
                        axis=str(axis))
    raise ValueError(f"unknown op {op!r}")


def _resolve(op: str, plan: Optional[Plan], variant: Optional[str],
             *args) -> Plan:
    if plan is None:
        key = infer_key(op, *args)
        plan = default_planner.lookup(key)
        source = "cache"
        if plan is None:
            plan, source = heuristic_plan(op, key), "heuristic"
            obs.inc("plan_cache.miss")
            default_planner.put(key, plan)
        else:
            obs.inc("plan_cache.hit")
        obs.event("plan.resolve", op=op, key=_key_str(key), source=source,
                  variant=plan.variant)
    else:
        obs.inc("plan_cache.pinned")
    if variant is not None:
        plan = plan.replace(variant=variant)
    ma = mesh_axis_of(op, args)
    if ma is not None:
        plan = _agree_plan(plan, *ma)
    return plan


#: room for one plan's JSON in the agreement broadcast
_PLAN_BYTES = 512


def _agree_plan(plan: Plan, mesh, axis: str) -> Plan:
    """Rank 0's plan on every rank of the axis (one broadcast): ranks that
    resolved differently, from their own plan caches or tables, would make
    different collectives and wait on each other for ever."""
    import json
    from repro_torch.parallel import comm
    if mesh.axis_size(axis) == 1:
        return plan
    blob = json.dumps(plan.to_dict(), sort_keys=True).encode()
    if len(blob) > _PLAN_BYTES:
        raise ValueError(f"plan too long to agree on: {len(blob)} bytes")
    buf = torch.zeros(_PLAN_BYTES, dtype=torch.uint8)
    buf[:len(blob)] = torch.frombuffer(bytearray(blob), dtype=torch.uint8)
    buf = comm.broadcast(buf, axis, 0, mesh)
    agreed = Plan.from_dict(json.loads(bytes(buf.tolist()).rstrip(b"\0")))
    if agreed != plan:
        obs.inc("plan.agree.adopted")
    return agreed


def run_op(op: str, plan: Plan, *args):
    """Run ``op`` on the registry's argument list under an explicit plan
    (the autotuner's entry point): no plan resolution, no fallback ladder,
    so a candidate that fails raises. Segment ops without a ``cap`` get the
    tight one, ``external_sort`` its default tile and fan-in; the ops with
    a direction sort descending."""
    if op in ("segment_sort", "segment_merge", "segment_argsort") \
            and plan.cap == 0:
        total = (args[0].shape[0] + args[2].shape[0]
                 if op == "segment_merge" else args[0].shape[0])
        plan = plan.replace(cap=segments.static_cap(args[1], total))
    if op == "external_sort":
        from repro_torch.engine.external import resolve_dofs
        plan = resolve_dofs(plan, args[0].shape[0])
    kw = {"plan": plan}
    if op in ("argsort", "segment_argsort", "merge_runs", "external_sort"):
        kw["descending"] = True
    return registry.call(op, plan.variant, *args, **kw)


def autotune(op: str, *example_args, repeats: int = 3, candidates=None):
    """Time every candidate plan of ``op`` on the example workload (the
    registry's argument list, as ``run_op`` takes it) and cache the fastest
    for that shape bucket. Returns the winning Plan. Candidates that raise
    are recorded as infeasible and skipped."""
    return default_planner.autotune(op, *example_args, repeats=repeats,
                                    candidates=candidates)


def _gather(perm, values):
    return tree_map(lambda v: v[perm], values)


def sort(x, *, descending: bool = True, values=None, stable: bool = False,
         nan: Optional[str] = None, plan: Optional[Plan] = None,
         variant: Optional[str] = None, device=None):
    """Full sort of a 1-D tensor.

    ``values=`` carries a payload (a tensor or a dict/list/tuple of tensors
    shaped like ``x``) and returns ``(sorted_keys, sorted_values)``;
    ``stable=True`` asks for ties in input order. Either routes through the
    stable ``argsort``, so ``plan=``/``variant=`` then name an argsort
    variant. ``nan=`` is the NaN policy (``"raise"`` | ``"sort_last"`` |
    ``"unsafe"``).
    """
    x = _tensor(x, device)
    values = _payload(values, x)
    _validate.check_lane_width(x.shape[-1], "sort")
    ik = _nan_keys("sort", x, nan)
    if ik is not None or values is not None or stable:
        perm = argsort(x if ik is None else ik, descending=descending,
                       plan=plan, variant=variant)
        keys = x[perm]
        if ik is not None and _verify.verify_enabled():
            _verify.check_sorted(ik[perm], descending=descending, op="sort")
            _verify.check_permutation(x, keys, op="sort")
        return keys if values is None else (keys, _gather(perm, values))
    plan = _resolve("sort", plan, variant, x)
    out = _gcall("sort", plan, x)
    out = out if descending else torch.flip(out, [0])
    if _verify.verify_enabled():
        _verify.check_sorted(out, descending=descending, op="sort")
        _verify.check_permutation(x, out, op="sort")
    return out


def argsort(keys, *, descending: bool = True, nan: Optional[str] = None,
            plan: Optional[Plan] = None, variant: Optional[str] = None,
            device=None):
    """Stable argsort (int32) of 1-D keys, or row-wise over a 2-D batch;
    ties keep their input order in every variant."""
    keys = _tensor(keys, device)
    _validate.check_lane_width(keys.shape[-1], "argsort")
    ik = _nan_keys("argsort", keys, nan)
    if ik is not None:
        keys = ik
    plan = _resolve("argsort", plan, variant, keys)
    perm = _gcall("argsort", plan, keys, descending=descending)
    if _verify.verify_enabled():
        _verify.check_permutation(
            torch.arange(keys.shape[-1], dtype=torch.int32,
                         device=keys.device).expand(keys.shape), perm,
            op="argsort")
    return perm


def merge(a, b, *, descending: bool = True, values=None,
          stable: bool = False, tie: Optional[str] = None,
          nan: Optional[str] = None, plan: Optional[Plan] = None,
          variant: Optional[str] = None, device=None):
    """Merge two sorted 1-D tensors into one.

    ``values=(vals_a, vals_b)`` carries payloads and returns ``(keys,
    values)``; with ``stable=True`` (or any payload) ties order A-first,
    then by position (algorithm 3), through rank lanes in the ``cuda``
    variant. ``tie='skew'`` is algorithm 2 on the key-only ``ref`` /
    ``banked`` variants; the ``cuda`` kernel's key output is tie-invariant,
    so it ignores the policy. ``nan="sort_last"`` merges the monotone int32
    transforms with the float keys riding the payload (each input ordered
    under the same policy).
    """
    a = _tensor(a, device)
    b = _tensor(b, a.device)
    if values is not None:
        values = (_payload(values[0], a), _payload(values[1], a))
    ik_a = _nan_keys("merge", a, nan)
    if ik_a is not None:
        if tie == "skew":
            raise _validate.EngineInputError(
                "merge", 'tie="skew" is key-only and cannot combine with '
                'nan="sort_last"', tie="skew", nan="sort_last")
        pay_a = {"k": a} if values is None else {"k": a, "v": values[0]}
        pay_b = {"k": b} if values is None else {"k": b, "v": values[1]}
        _, mv = merge(ik_a, _validate.total_order_key(b),
                      values=(pay_a, pay_b), descending=descending,
                      plan=plan, variant=variant)
        return mv["k"] if values is None else (mv["k"], mv["v"])
    if values is not None or stable:
        if tie == "skew":
            raise _validate.EngineInputError(
                "merge", "tie='skew' is key-only (stable order has no ties)",
                tie="skew")
        return _merge_kv(a, b, values, descending, plan, variant)
    if not descending:
        out = merge(torch.flip(a, [0]), torch.flip(b, [0]), tie=tie,
                    plan=plan, variant=variant)
        return torch.flip(out, [0])
    plan = _resolve("merge", plan, variant, a, b)
    if tie is not None and tie != plan.tie:
        plan = plan.replace(tie=tie)
    out = _gcall("merge", plan, a, b)
    if _verify.verify_enabled():
        _verify.check_sorted(out, descending=True, op="merge")
        _verify.check_permutation(torch.cat([a, b]), out, op="merge")
    return out


def _merge_kv(a, b, values, descending, plan, variant):
    rev = lambda t: tree_map(lambda x: torch.flip(x, [0]), t)
    if not descending:
        # mirror with the operands swapped: the descending merge puts its
        # first operand's ties first, so reversing (B', A') keeps A first
        out = _merge_kv(torch.flip(b, [0]), torch.flip(a, [0]),
                        (rev(values[1]), rev(values[0]))
                        if values is not None else None,
                        True, plan, variant)
        if values is None:
            return torch.flip(out, [0])
        return torch.flip(out[0], [0]), rev(out[1])
    plan = _resolve("merge", plan, variant, a, b)
    nA = a.shape[0]
    ra = torch.arange(nA, dtype=torch.int32, device=a.device)
    rb = nA + torch.arange(b.shape[0], dtype=torch.int32, device=a.device)
    keys, ranks = _gcall("merge", plan, a, b, ranks=(ra, rb))
    if values is None:
        return keys
    return keys, tree_map(lambda x, y: torch.cat([x, y])[ranks.long()],
                          values[0], values[1])


def merge_runs(keys, run_offsets, *, descending: bool = True, values=None,
               stable: bool = False, tie: Optional[str] = None,
               nan: Optional[str] = None, plan: Optional[Plan] = None,
               variant: Optional[str] = None, device=None):
    """Merge K sorted runs into one (the paper's §2.1 merge tree as an op).

    ``keys`` is the flat concatenation of K runs, each sorted in the call's
    direction, with boundaries ``run_offsets`` ((K+1,), ``[0] == 0``,
    ``[-1] == len(keys)``). The plan names a schedule executor (``torch`` |
    ``tree_vmapped`` | ``tree_cuda`` | ``stream_cuda`` | ``stream_torch``)
    and, for the fused tree, the levels a pass (``plan.levels``).
    ``values=`` / ``stable=True`` make the merge stable (run, then position)
    through rank lanes. ``tie='skew'`` applies algorithm 2's selector on the
    key-only ``tree_vmapped`` tree (``None`` keeps the plan's policy); it
    cannot combine with ``values=`` / ``stable`` or ``nan="sort_last"``.
    """
    keys = _tensor(keys, device)
    values = _payload(values, keys)
    _validate.check_lane_width(keys.shape[0], "merge_runs")
    ik = _nan_keys("merge_runs", keys, nan)
    if ik is not None:
        if tie == "skew":
            raise _validate.EngineInputError(
                "merge_runs", 'tie="skew" is key-only and cannot combine '
                'with nan="sort_last"', tie="skew", nan="sort_last")
        pay = {"k": keys} if values is None else {"k": keys, "v": values}
        _, pv = merge_runs(ik, run_offsets, descending=descending,
                           values=pay, plan=plan, variant=variant)
        return pv["k"] if values is None else (pv["k"], pv["v"])
    segments.validate_offsets(run_offsets, keys.shape[0])
    run_offsets = _tensor(run_offsets, keys.device).to(torch.int32)
    plan = _resolve("merge_runs", plan, variant, keys, run_offsets)
    if tie is not None and tie != plan.tie:
        plan = plan.replace(tie=tie)
    if values is None and not stable:
        out = _gcall("merge_runs", plan, keys, run_offsets,
                     descending=descending)
        if _verify.verify_enabled():
            _verify.check_sorted(out, descending=descending, op="merge_runs")
            _verify.check_permutation(keys, out, op="merge_runs")
        return out
    if tie == "skew":
        raise _validate.EngineInputError(
            "merge_runs", "tie='skew' is key-only (stable order has no ties)",
            tie="skew")
    # rank lanes leave no ties for skew to balance: the stable policy
    plan = plan.replace(tie="b")
    ranks = torch.arange(keys.shape[0], dtype=torch.int32, device=keys.device)
    mk, mr = _gcall("merge_runs", plan, keys, run_offsets,
                    descending=descending, ranks=ranks)
    if values is None:
        return mk
    # a sentinel run's rank (tree_vmapped, where NaN keys under nan="unsafe"
    # break the order) gathers the last payload, as JAX's clamped gather does
    return mk, _gather(mr.clamp(max=max(keys.shape[0] - 1, 0)), values)


def topk(x, k: int, *, values=None, nan: Optional[str] = None,
         plan: Optional[Plan] = None, variant: Optional[str] = None,
         device=None):
    """``(values, indices)`` of the ``k`` largest along the trailing axis,
    values descending, ties to the lower index (``lax.top_k``'s order);
    indices int32. With ``values=`` (a payload of ``x``-shaped tensors)
    returns ``(vals, indices, payload_topk)``. ``nan="sort_last"`` selects
    by the monotone total-order transform (NaN above every real).
    """
    x = _tensor(x, device)
    values = _payload(values, x)
    _validate.check_lane_width(x.shape[-1], "topk")
    ik = _nan_keys("topk", x, nan)
    if ik is not None:
        pay = {"k": x} if values is None else {"k": x, "v": values}
        _, idx, pv = topk(ik, k, values=pay, plan=plan, variant=variant)
        return (pv["k"], idx) if values is None else (pv["k"], idx, pv["v"])
    plan = _resolve("topk", plan, variant, x)
    return _gcall("topk", plan, x, k, values=values)


def _sample_sorted(op: str, generator, logits, knob: float, temperature,
                   plan, variant, device, u):
    if not 0.0 < knob <= 1.0:
        name = "p" if op == "sample_topp" else "min_p"
        raise ValueError(f"{op}: {name}={knob} outside (0, 1]")
    logits = _tensor(logits, device)
    squeeze = logits.ndim == 1
    if squeeze:
        logits = logits[None]
        u = None if u is None else u[None]
    if logits.ndim != 2:
        raise ValueError(f"{op} expects (V,) or (B, V) logits, got shape "
                         f"{tuple(logits.shape)}")
    plan = _resolve(op, plan, variant, generator, logits)
    out = _gcall(op, plan, generator, logits, float(knob),
                 temperature=float(temperature), u=u)
    return out[0] if squeeze else out


def sample_topp(generator, logits, p: float, *, temperature: float = 1.0,
                u=None, plan: Optional[Plan] = None,
                variant: Optional[str] = None, device=None):
    """Nucleus (top-p) sampling: one int32 token id per row of ``logits``
    ((V,) or (B, V)).

    The row's stable descending argsort (``flims``, the reference sorter
    reducing on K9, or ``torch``: the same permutation, so the variants
    agree bit for bit) orders the candidates; the softmax prefix sum cuts
    the smallest set whose mass reaches ``p`` (the argmax always stays) and
    a Gumbel-max draw picks within it. ``temperature <= 0`` is greedy.
    ``generator`` (a ``torch.Generator`` on the logits' device, or None for
    the default) stands where the JAX op takes a PRNG key; ``u`` (uniforms
    in [1e-9, 1) shaped like ``logits``) replaces its draw.
    """
    return _sample_sorted("sample_topp", generator, logits, p, temperature,
                          plan, variant, device, u)


def sample_minp(generator, logits, min_p: float, *,
                temperature: float = 1.0, u=None,
                plan: Optional[Plan] = None, variant: Optional[str] = None,
                device=None):
    """Min-p sampling: one int32 token id per row of ``logits``. The same
    sorted-prefix formulation as :func:`sample_topp`, the cut keeping the
    candidates whose probability is at least ``min_p`` times the row
    maximum's."""
    return _sample_sorted("sample_minp", generator, logits, min_p,
                          temperature, plan, variant, device, u)


def external_sort(keys, *, descending: bool = True, values=None,
                  stable: bool = False, tile_elems: int = 0, fan_in: int = 0,
                  nan: Optional[str] = None, plan: Optional[Plan] = None,
                  variant: Optional[str] = None, device=None):
    """Sort a 1-D tensor tile by tile: the two-phase out-of-core sort.

    Phase 1 forms ``ceil(n / tile_elems)`` sorted runs; phase 2 reduces
    them with ``ceil(log_fan_in(runs))`` streamed merge passes over
    device-resident runs (``stream_cuda``: the streaming kernel K8;
    ``torch``: binary-search pair merges). An input of at most one tile is
    handed to ``sort`` untouched.

    ``tile_elems`` / ``fan_in`` override the plan's (both clamp to powers
    of two; defaults 2^20 and 8). ``values=`` carries a payload (a tensor
    or a dict/list/tuple of tensors) and returns ``(sorted_keys,
    sorted_values)``; ``stable=True`` (or any payload) orders ties by input
    position, bit-for-bit ``torch.argsort(stable=True)``. ``nan=`` is the
    NaN policy. Sizes past the int32 lanes (``n >= 2**31``) raise.
    """
    keys = _tensor(keys, device)
    if keys.ndim != 1:
        raise _validate.EngineInputError(
            "external_sort", f"expects a 1-D key tensor, got shape "
            f"{tuple(keys.shape)}", shape=tuple(keys.shape))
    n = keys.shape[0]
    _validate.check_lane_width(n, "external_sort")
    values = _payload(values, keys)
    ik = _nan_keys("external_sort", keys, nan)
    if ik is not None:
        pay = {"k": keys} if values is None else {"k": keys, "v": values}
        _, pv = external_sort(ik, descending=descending, values=pay,
                              tile_elems=tile_elems, fan_in=fan_in,
                              plan=plan, variant=variant)
        return pv["k"] if values is None else (pv["k"], pv["v"])
    from repro_torch.engine.external import resolve_dofs
    plan = _resolve("external_sort", plan, variant, keys)
    plan = resolve_dofs(plan, n, tile_elems=tile_elems, fan_in=fan_in)
    if n <= plan.tile_elems:
        # one tile holds the whole input: the direct path, no copy
        obs.event("external.delegate", n=int(n), tile=int(plan.tile_elems))
        return sort(keys, descending=descending, values=values,
                    stable=stable)
    if values is None and not stable:
        out = _gcall("external_sort", plan, keys, descending=descending)
        if _verify.verify_enabled():
            _verify.check_sorted(out, descending=descending,
                                 op="external_sort")
            _verify.check_permutation(keys, out, op="external_sort")
        return out
    ranks = torch.arange(n, dtype=torch.int32, device=keys.device)
    mk, mr = _gcall("external_sort", plan, keys, descending=descending,
                    ranks=ranks)
    return mk if values is None else (mk, _gather(mr, values))


def _segment_plan(op, plan, variant, keys, offsets, cap):
    """Resolve a segment op's plan and fix its ``cap``: the caller's (rounded
    up to a power of two), else the plan's, else the tight
    ``next_pow2(longest segment)``; a cap below the longest segment is
    refused."""
    plan = _resolve(op, plan, variant, keys, offsets)
    if cap or not plan.cap:
        cap = (next_pow2(cap) if cap
               else segments.static_cap(offsets, keys.shape[0]))
        plan = plan.replace(cap=cap)
    segments.validate_cap(offsets, plan.cap)
    return plan


def segment_sort(keys, offsets, *, descending: bool = True, values=None,
                 stable: bool = False, cap: int = 0,
                 nan: Optional[str] = None, plan: Optional[Plan] = None,
                 variant: Optional[str] = None, device=None):
    """Sort every segment of a ragged batch independently.

    ``keys`` is the flat (N,) concatenation of S segments with boundaries
    ``offsets`` ((S+1,), ``offsets[0] == 0``, ``offsets[-1] == N``; empty
    segments allowed). ``cap`` bounds the longest segment (rounded up to a
    power of two); by default it is the tight ``next_pow2`` of the longest
    segment. ``values=`` carries a payload (a tensor or a dict/list/tuple of
    (N,) tensors) and returns ``(sorted_keys, sorted_values)``; with
    ``stable=True`` (or any payload) ties keep input order. Both route
    through ``segment_argsort``. ``nan="sort_last"`` sorts each segment by
    the monotone total-order transform.
    """
    keys = _tensor(keys, device)
    values = _payload(values, keys)
    _validate.check_lane_width(keys.shape[0], "segment_sort")
    ik = _nan_keys("segment_sort", keys, nan)
    if ik is not None:
        pay = {"k": keys} if values is None else {"k": keys, "v": values}
        _, pv = segment_sort(ik, offsets, descending=descending, values=pay,
                             cap=cap, plan=plan, variant=variant)
        return pv["k"] if values is None else (pv["k"], pv["v"])
    if values is not None or stable:
        offsets = _tensor(offsets, keys.device).to(torch.int32)
        perm = segment_argsort(keys, offsets, descending=descending, cap=cap,
                               plan=plan, variant=variant)
        seg = segments.segment_ids(offsets, keys.shape[0])
        src = offsets.long()[seg] + perm.long()
        out = keys[src]
        return out if values is None else (out, _gather(src, values))
    segments.validate_offsets(offsets, keys.shape[0])
    offsets = _tensor(offsets, keys.device).to(torch.int32)
    plan = _segment_plan("segment_sort", plan, variant, keys, offsets, cap)
    out = _gcall("segment_sort", plan, keys, offsets)
    if not descending:
        out = segments.reverse_segments(out, offsets, keys.shape[0])
    if _verify.verify_enabled():
        _verify.check_segments(out, offsets, descending=descending,
                               op="segment_sort")
        _verify.check_permutation(keys, out, op="segment_sort")
    return out


def segment_argsort(keys, offsets, *, descending: bool = True, cap: int = 0,
                    nan: Optional[str] = None, plan: Optional[Plan] = None,
                    variant: Optional[str] = None, device=None):
    """Stable argsort of every segment of a ragged batch.

    Returns a flat int32 tensor of segment-local source positions: for
    segment ``s``, ``keys[offsets[s] + perm[offsets[s]:offsets[s+1]]]`` is
    its sort, and equal keys keep their input order in every variant and
    either direction. ``nan="sort_last"`` orders each segment by the
    monotone total-order transform.
    """
    keys = _tensor(keys, device)
    _validate.check_lane_width(keys.shape[0], "segment_argsort")
    ik = _nan_keys("segment_argsort", keys, nan)
    if ik is not None:
        keys = ik
    segments.validate_offsets(offsets, keys.shape[0])
    offsets = _tensor(offsets, keys.device).to(torch.int32)
    plan = _segment_plan("segment_argsort", plan, variant, keys, offsets,
                         cap)
    return _gcall("segment_argsort", plan, keys, offsets,
                  descending=descending)


def segment_merge(a, a_offsets, b, b_offsets, *, descending: bool = True,
                  plan: Optional[Plan] = None, variant: Optional[str] = None,
                  device=None):
    """Merge S segment pairs of two ragged batches: segment s of the result
    is the sorted union of a-segment s and b-segment s, each sorted in the
    call's direction; its offsets are ``a_offsets + b_offsets``."""
    a = _tensor(a, device)
    b = _tensor(b, a.device)
    segments.validate_offsets(a_offsets, a.shape[0])
    segments.validate_offsets(b_offsets, b.shape[0])
    a_offsets = _tensor(a_offsets, a.device).to(torch.int32)
    b_offsets = _tensor(b_offsets, a.device).to(torch.int32)
    if not descending:
        ar = segments.reverse_segments(a, a_offsets, a.shape[0])
        br = segments.reverse_segments(b, b_offsets, b.shape[0])
        out = segment_merge(ar, a_offsets, br, b_offsets, plan=plan,
                            variant=variant)
        return segments.reverse_segments(out, a_offsets + b_offsets,
                                         a.shape[0] + b.shape[0])
    plan = _resolve("segment_merge", plan, variant, a, a_offsets, b,
                    b_offsets)
    return _gcall("segment_merge", plan, a, a_offsets, b, b_offsets)


class RouteResult(NamedTuple):
    """One routed token chunk, every lane in stable sorted pair order
    (expert ascending, then the pair's position ``t*k + j``)."""
    experts: torch.Tensor  # (..., T*k) int32 expert of each routed pair
    tokens: torch.Tensor   # (..., T*k) int32 source token within the chunk
    perm: torch.Tensor     # (..., T*k) int32 stable pair permutation t*k + j
    weights: torch.Tensor  # (..., T*k) float32 combine weight (top-k softmax)
    slabs: torch.Tensor    # (..., T*k) int32 e*cap + rank, E*cap if dropped
    keep: torch.Tensor     # (..., T*k) bool, False = over capacity (dropped)


def moe_route(logits, k: int, capacity: int, *, values=None,
              plan: Optional[Plan] = None, variant: Optional[str] = None,
              device=None):
    """Route a chunk of tokens to expert capacity slabs in one planned op.

    ``logits`` are (T, E), or (G, T, E) for G independent groups, router
    logits (computed in float32); ``k`` experts activate per token and each
    expert keeps its first ``capacity`` pairs in stable order (GShard drop
    semantics). Returns a :class:`RouteResult` of (G, T*k) lanes in sorted
    pair order: scattering ``x[tokens]`` to ``slabs`` builds the (E,
    capacity, d) expert slabs, and ``weights * keep`` are the combine
    coefficients. The ``fused`` variant is one K7 call (its launches spread
    each group over the card); ``torch`` is the unfused reference
    pipeline. ``values=``
    (tensors shaped like one logit column, (G, T)) gathers a payload by
    ``tokens`` and returns ``(RouteResult, routed_values)``.
    """
    logits = _tensor(logits, device)
    if logits.ndim == 2:
        vv = None if values is None else tree_map(lambda v: v[None], values)
        out = moe_route(logits[None], k, capacity, values=vv, plan=plan,
                        variant=variant)
        squeeze = lambda r: RouteResult(*(x[0] for x in r))
        if values is None:
            return squeeze(out)
        return squeeze(out[0]), tree_map(lambda v: v[0], out[1])
    if logits.ndim != 3:
        raise ValueError(f"moe_route expects (T, E) or (G, T, E) logits, "
                         f"got shape {tuple(logits.shape)}")
    G, T, E = logits.shape
    if not 1 <= k <= E:
        raise ValueError(f"moe_route: k={k} outside [1, E={E}]")
    if capacity < 1:
        raise ValueError(f"moe_route: capacity={capacity} must be >= 1")
    _validate.check_lane_width(T * k, "moe_route")
    logits = logits.to(torch.float32)
    plan = _resolve("moe_route", plan, variant, logits, k)
    plan = plan.replace(cap=int(capacity))
    obs.event("moe.route", groups=G, tokens=T, experts=E, k=k,
              capacity=int(capacity), n_pairs=G * T * k,
              variant=plan.variant)
    e_s, t_s, perm, w_s, slab, keep = _gcall("moe_route", plan, logits, k,
                                             int(capacity))
    keep = keep.to(torch.bool)
    if obs.enabled():
        # reads the keep mask back from the device: only while recording
        obs.inc("moe.dropped_tokens", int(keep.numel() - keep.sum()))
    res = RouteResult(e_s, t_s, perm, w_s, slab, keep)
    if values is None:
        return res
    idx = t_s.long()
    return res, tree_map(lambda v: torch.gather(_tensor(v, logits.device),
                                                -1, idx), values)


def _check_shard(op: str, x, mesh, axis: str):
    if axis not in mesh.axis_names:
        raise _validate.EngineInputError(
            op, f"axis {axis!r} not in the mesh's {mesh.axis_names}",
            axis=axis)
    if x.ndim != 1:
        raise _validate.EngineInputError(
            op, f"expects this rank's 1-D shard, got shape "
            f"{tuple(x.shape)}", shape=tuple(x.shape))


def sharded_sort(x, mesh, axis: str = "data", *, payload=None,
                 plan: Optional[Plan] = None, variant: Optional[str] = None):
    """Sort a 1-D array split over ``axis`` of ``mesh``. Descending. Every
    rank calls it with its own shard ``x``.

    The planned distributed sample sort: local FLiMS sorts, splitter
    selection, one ``all_to_all`` bucket exchange, and a K-way reduction of
    the received runs through the plan's ``MergeSchedule`` executor (the
    variant: ``torch`` | ``tree_vmapped`` | ``tree_cuda``). The plan also
    carries ``splitter`` (``'hist'``, oversampled and refined by exact
    global rank, by default; ``'regular'``), ``cap_factor`` and
    ``retries``, the rungs of cap escalation: a result is flagged
    ``overflow`` only when the last rung's cap cannot hold the largest
    bucket, and a ladder reaching ``n_local`` cannot overflow (true when
    ``cap_factor * 2**retries >= P``). Every rank adopts rank 0's resolved
    plan.

    Returns this rank's ``ShardedSort``: ``values`` (its padded run; the
    runs in axis order concatenate to the global order), ``count`` and
    ``overflow`` (``parallel.sharding.collect_sorted`` gathers them). With
    ``payload=`` returns ``(ShardedSort, payload)`` permuted identically
    and stably.
    """
    x = _tensor(x)
    _check_shard("sharded_sort", x, mesh, axis)
    payload = _payload(payload, x)
    plan = _resolve("sharded_sort", plan, variant, x, mesh, axis)
    return _gcall("sharded_sort", plan, x, mesh, axis, payload=payload)


def sharded_topk(x, k: int, mesh, axis: str = "data", *, payload=None,
                 plan: Optional[Plan] = None, variant: Optional[str] = None):
    """``(values, global indices)`` of the k largest elements of a 1-D
    array split over ``axis``, bit for bit ``lax.top_k`` of the gathered
    array (ties to the lower global index), the same on every rank.

    Local top-k candidates (``variant``: ``'flims'`` or ``'torch'``) are
    all_gathered and stable-merged. With ``payload=`` returns ``(values,
    indices, payload_topk)``, the payload riding the lanes.
    """
    x = _tensor(x)
    _check_shard("sharded_topk", x, mesh, axis)
    payload = _payload(payload, x)
    plan = _resolve("sharded_topk", plan, variant, x, k, mesh, axis)
    return _gcall("sharded_topk", plan, x, k, mesh, axis, payload=payload)


def moe_route_ep(logits, k: int, capacity: int, mesh, axis: str = "data", *,
                 plan: Optional[Plan] = None, variant: Optional[str] = None):
    """Expert-parallel routing across a mesh axis: every rank passes its
    (T_loc, E) rows of the router logits (tokens split over the P ranks in
    axis order) and owns E/P experts (rank d the band ``[d*E/P,
    (d+1)*E/P)``).

    Each rank routes its tokens with the local route (the variant:
    ``fused``, K7, or ``torch``), whose per-expert capacity cut doubles as
    ``sharded_topk``'s union-of-local-top-k prefilter; one ``all_to_all``
    sends the candidates to their expert's owner, which merges the P runs
    and re-cuts at ``capacity`` by global stable rank. Returns this rank's
    :class:`~repro_torch.engine.sharded.RouteShard`: bit for bit
    :func:`moe_route` on the gathered logits, restricted to its experts.
    """
    logits = _tensor(logits)
    if logits.ndim != 2:
        raise ValueError(f"moe_route_ep expects (T_loc, E) logits, got shape "
                         f"{tuple(logits.shape)}")
    if not 1 <= k <= logits.shape[1]:
        raise ValueError(f"moe_route_ep: k={k} outside [1, E="
                         f"{logits.shape[1]}]")
    plan = _resolve("moe_route_ep", plan, variant, logits, k, capacity,
                    mesh, axis)
    plan = plan.replace(cap=int(capacity))
    return _gcall("moe_route_ep", plan, logits, k, int(capacity), mesh,
                  axis)


def save_plans(path: str) -> None:
    default_planner.save(path)


def load_plans(path: str) -> None:
    """Load a plan table written by this port or by the JAX package's
    ``engine.save_plans`` (names mapped by ``planner.plans_from_jax``)."""
    default_planner.load(path)


def clear_plans() -> None:
    default_planner.clear()
