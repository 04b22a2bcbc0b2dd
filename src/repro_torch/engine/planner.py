"""Plan selection for the engine: explicit plan, cache, table, heuristic.

Counterpart of ``repro/engine/planner.py``. A ``Plan`` fixes the variant and
tile parameters of one op. Keys bucket shapes to powers of two and carry the
backend of the input tensor's device (``cuda`` or ``cpu``). For CUDA
tensors of the kernels' key types the heuristic serves ``sort`` /
``argsort`` / ``merge`` / ``segment_merge`` from the CUDA kernels,
``merge_runs`` from the ``tree_cuda`` schedule, ``segment_sort`` /
``segment_argsort`` from the two-phase compositions, ``moe_route`` from
the fused kernel K7, ``external_sort`` from the ``stream_cuda`` passes
(K8), and ``topk`` / ``sample_topp`` / ``sample_minp`` from the ``flims``
reference sorters (the JAX TPU table's choice; their argsort reduces on
K9); everything else from the torch reference variants.

Plan tables round-trip through JSON, and :func:`plans_from_jax` reads the
tables the JAX package's ``engine.save_plans`` writes: backends ``tpu`` /
``gpu`` become ``cuda``, and variant names map through :data:`VARIANT_MAP`.

``Planner.autotune(op, *example_args)`` times every candidate of
:func:`candidate_plans` (each registered variant crossed with a small
parameter grid) on the example workload, with CUDA events on the card and
the host clock on the CPU, installs the fastest in the cache and returns
it. A candidate that raises is recorded as infeasible for the shape bucket
and skipped, then and in later tunes. The fallback ladder's quarantine
(``guard/fallback.py``) is a record of its own: autotune skips a
quarantined plan too, but an infeasible candidate never takes a rung off
the ladder.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.flims import next_pow2

#: JAX variant name -> the port's
VARIANT_MAP = {"pallas": "cuda", "tree_pallas": "tree_cuda", "xla": "torch",
               "pallas_fused": "cuda_fused",
               "pallas_two_phase": "cuda_two_phase", "fused": "fused",
               "stream_pallas": "stream_cuda", "stream_xla": "stream_torch",
               "tree_vmapped": "tree_vmapped", "ref": "ref",
               "flims": "flims"}
#: JAX backend name -> the port's
BACKEND_MAP = {"tpu": "cuda", "gpu": "cuda", "cuda": "cuda", "cpu": "cpu"}
#: key dtypes the CUDA kernels take
KERNEL_DTYPES = ("int32", "float32")


@dataclasses.dataclass(frozen=True)
class Plan:
    variant: str
    w: int = 32
    block_out: int = 1024
    chunk: int = 256
    cap: int = 0           # per-segment capacity; 0 = derive from the offsets
    levels: int = 1        # tree levels fused per pass (MergeSchedule)
    tie: str = "b"         # selector tie policy: 'b' (alg. 1) | 'skew' (alg. 2)
    # external (out-of-core) sort only: engine/external.py
    tile_elems: int = 0    # phase-1 run length; 0 = default (2^20)
    fan_in: int = 0        # runs merged per phase-2 pass; 0 = default (8)
    # sharded (cross-rank) ops only: engine/sharded.py
    cap_factor: int = 4    # base bucket cap = cap_factor * n_local / P
    splitter: str = "hist"  # splitter policy: 'regular' | 'hist'
    retries: int = 2       # cap-doubling rungs of the overflow ladder

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Plan":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})

    def replace(self, **kw) -> "Plan":
        return dataclasses.replace(self, **kw)


Key = Tuple[str, str, str, int, int, str]


def backend_of(device) -> str:
    return "cuda" if torch.device(device).type == "cuda" else "cpu"


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def plan_key(op: str, *, n: int, dtype, backend: str, segments: int = 0,
             axis: str = "") -> Key:
    """Bucketed cache key: op, backend, dtype, pow2(n), pow2(segments),
    and for the sharded ops the mesh axis name (``segments`` then carries
    the rank count P along it)."""
    return (op, backend, dtype_name(dtype), next_pow2(n),
            next_pow2(segments) if segments else 0, axis)


def _key_str(key: Key) -> str:
    op, backend, dtype, n, s, axis = key
    base = f"{op}|{backend}|{dtype}|n{n}|s{s}"
    return base + (f"|a{axis}" if axis else "")


def _key_parse(s: str) -> Key:
    parts = s.split("|")
    op, backend, dtype, n, seg = parts[:5]
    axis = parts[5][1:] if len(parts) > 5 else ""
    return (op, backend, dtype, int(n[1:]), int(seg[1:]), axis)


def heuristic_plan(op: str, key: Key) -> Plan:
    _, backend, dtype, n, _, _ = key
    w = max(8, min(128, next_pow2(max(n, 1) // 64)))
    block_out = max(w, min(4096, next_pow2(max(n, 1)) // 8 or w))
    if backend == "cuda" and dtype in KERNEL_DTYPES:
        table = {"sort": "cuda", "argsort": "cuda", "merge": "cuda",
                 "merge_runs": "tree_cuda", "segment_merge": "cuda",
                 "segment_sort": "cuda_two_phase",
                 "segment_argsort": "cuda_two_phase", "moe_route": "fused",
                 "external_sort": "stream_cuda", "topk": "flims",
                 "sample_topp": "flims", "sample_minp": "flims",
                 "sharded_sort": "tree_cuda", "sharded_topk": "flims",
                 "moe_route_ep": "fused"}
        levels = 2 if op in ("merge_runs", "sharded_sort",
                             "external_sort") else 1
    else:
        # other key types, and CPU tensors: the torch reference variants
        table = {"sort": "torch", "argsort": "torch", "merge": "banked",
                 "merge_runs": "torch", "segment_merge": "torch",
                 "segment_sort": "torch", "segment_argsort": "torch",
                 "moe_route": "torch", "external_sort": "torch",
                 "topk": "torch", "sample_topp": "torch",
                 "sample_minp": "torch", "sharded_sort": "torch",
                 "sharded_topk": "torch", "moe_route_ep": "torch"}
        levels = 1
    return Plan(variant=table[op], w=w, block_out=block_out, chunk=256,
                levels=levels)


def plans_from_jax(table: dict) -> Dict[str, dict]:
    """A plan table in the port's names from one the JAX package wrote:
    either ``save_plans``' whole document or its ``"plans"`` mapping.
    Entries for ops or variants this port does not serve are dropped."""
    from repro_torch.engine import registry
    plans = table.get("plans", table)
    out = {}
    for ks, pd in plans.items():
        op, backend, dtype, n, s, axis = _key_parse(ks)
        variant = VARIANT_MAP.get(pd.get("variant"), pd.get("variant"))
        if backend not in BACKEND_MAP or variant not in registry.variants(op):
            continue
        key = (op, BACKEND_MAP[backend], dtype, n, s, axis)
        out[_key_str(key)] = Plan.from_dict(dict(pd, variant=variant)
                                            ).to_dict()
    return out


class Planner:
    """The in-process plan cache with JSON persistence, the autotuner's
    infeasible record, the fallback ladder's quarantine and the
    autotuner."""

    def __init__(self):
        self._plans: Dict[Key, Plan] = {}
        self._infeasible: Dict[Key, set] = {}
        self._quarantined: Dict[Key, set] = {}

    def lookup(self, key: Key) -> Optional[Plan]:
        return self._plans.get(key)

    def put(self, key: Key, plan: Plan) -> None:
        self._plans[key] = plan

    def clear(self) -> None:
        self._plans.clear()
        self._infeasible.clear()
        self._quarantined.clear()

    def infeasible_for(self, key: Key) -> frozenset:
        """Candidate plans autotune recorded as unable to serve this shape
        bucket."""
        return frozenset(self._infeasible.get(key, ()))

    # -- quarantine (guard.fallback): demoted plans sit out the process -----
    def quarantine(self, key: Key, plan: Plan) -> None:
        """Record ``plan`` as having run out of memory on ``key`` in this
        process: the fallback ladder skips its rung, the autotuner skips
        it as a candidate."""
        self._quarantined.setdefault(key, set()).add(plan)

    def is_quarantined(self, key: Key, plan: Plan) -> bool:
        return plan in self._quarantined.get(key, ())

    def clear_quarantine(self, variant: Optional[str] = None) -> None:
        """Drop the quarantine and infeasible records, all of them or only
        those of ``variant`` (a chaos stub leaving)."""
        for book in (self._quarantined, self._infeasible):
            for plans in book.values():
                for plan in [p for p in plans
                             if variant is None or p.variant == variant]:
                    plans.discard(plan)

    # -- persistence --------------------------------------------------------
    def to_table(self) -> dict:
        return {_key_str(k): p.to_dict() for k, p in self._plans.items()}

    def from_table(self, table: dict) -> None:
        for ks, pd in table.items():
            self._plans[_key_parse(ks)] = Plan.from_dict(pd)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"version": 1, "plans": self.to_table()}, f, indent=2,
                      sort_keys=True)

    def load(self, path: str) -> None:
        """Load a table written by this port or by the JAX package."""
        with open(path) as f:
            doc = json.load(f)
        self.from_table(plans_from_jax(doc))

    # -- autotune -----------------------------------------------------------
    def autotune(self, op: str, *example_args, repeats: int = 3,
                 candidates=None) -> Plan:
        """Time candidate plans on an example workload (the registry's
        argument list, run by ``api.run_op``); cache the winner. Candidates
        default to :func:`candidate_plans`. The ``autotune.*`` events and
        counters are the JAX planner's.

        A collective op (``api.COLLECTIVE_OPS``) is tuned by every rank of
        its axis together: each runs every candidate the same number of
        times, a candidate that raised on any rank is infeasible on all
        (one ``pmax`` of a flag after it), and rank 0's fastest is the
        winner every rank installs (one broadcast)."""
        from repro_torch import obs
        from repro_torch.engine import api
        key = api.infer_key(op, *example_args)
        ma = api.mesh_axis_of(op, example_args)
        if candidates is None:
            candidates = candidate_plans(op, key)
        candidates = list(candidates)
        bad = self._infeasible.setdefault(key, set())
        best, best_t = None, float("inf")
        with obs.span(f"autotune.{op}"):
            for plan in candidates:
                if plan in bad or self.is_quarantined(key, plan):
                    # known-infeasible: skip, don't retry
                    obs.event("autotune.candidate", op=op, key=_key_str(key),
                              variant=plan.variant, status="known_infeasible")
                    continue
                err = None
                try:
                    t = _time(lambda: api.run_op(op, plan, *example_args),
                              cuda=key[1] == "cuda", repeats=repeats)
                except Exception as e:
                    err = f"{type(e).__name__}: {e}"[:200]
                if ma is not None:
                    from repro_torch.parallel import comm
                    if comm.agree_flag(err is not None, ma[1], ma[0]) \
                            and err is None:
                        err = "raised on another rank"
                if err is not None:
                    # a raising candidate (a shape past a kernel's limits, a
                    # failed build) is recorded as infeasible; the tune goes
                    # on with the other candidates
                    bad.add(plan)
                    obs.inc("autotune.infeasible")
                    obs.event("autotune.candidate", op=op, key=_key_str(key),
                              variant=plan.variant, status="infeasible",
                              plan=plan.to_dict(), error=err)
                    continue
                obs.inc("autotune.measured")
                obs.event("autotune.candidate", op=op, key=_key_str(key),
                          variant=plan.variant, status="ok", us=t * 1e6,
                          plan=plan.to_dict())
                if t < best_t:
                    best, best_t = plan, t
        if ma is not None:
            # rank 0 decides, every rank installs the same plan
            from repro_torch.parallel import comm
            idx = torch.tensor([-1 if best is None else
                                candidates.index(best)], dtype=torch.int32)
            idx = int(comm.broadcast(idx, ma[1], 0, ma[0])[0])
            best = None if idx < 0 else candidates[idx]
        if best is None:
            best = heuristic_plan(op, key)
            obs.event("autotune.winner", op=op, key=_key_str(key),
                      variant=best.variant, source="heuristic_fallback")
        else:
            obs.event("autotune.winner", op=op, key=_key_str(key),
                      variant=best.variant, us=best_t * 1e6,
                      plan=best.to_dict())
        obs.inc("autotune.runs")
        self._plans[key] = best
        return best


def candidate_plans(op: str, key: Key):
    """The per-op search grid over the registered variants (the JAX
    planner's, in the port's variant names; K7 has no chunk parameter, so
    ``moe_route`` and ``moe_route_ep`` have one candidate a variant)."""
    from repro_torch.engine import registry
    _, _, _, n, _, _ = key
    out = []
    for variant in registry.variants(op):
        if op == "merge_runs":
            # the MergeSchedule grid: fused-pass depth is the key dof
            if variant == "tree_cuda":
                out.extend(Plan(variant, w=32, levels=lv) for lv in (1, 2, 3))
            else:
                out.append(Plan(variant, w=32))
        elif op == "sharded_sort":
            # the local reduction's executor (and fused depth) crossed with
            # the splitter policy; cap_factor / retries keep their defaults
            for splitter in ("regular", "hist"):
                if variant == "tree_cuda":
                    out.extend(Plan(variant, w=32, levels=lv,
                                    splitter=splitter) for lv in (1, 2))
                else:
                    out.append(Plan(variant, w=32, splitter=splitter))
        elif op == "external_sort":
            # phase-1 tile size x phase-2 fan-in
            n2 = next_pow2(max(n, 4))
            for tile in sorted({max(1024, n2 // 16), max(1024, n2 // 4)}):
                for fan in (4, 16):
                    out.append(Plan(variant, w=32, tile_elems=tile,
                                    fan_in=fan))
        elif op in ("merge", "segment_merge"):
            for w in (32, 128):
                for block_out in (1024, 4096):
                    out.append(Plan(variant, w=min(w, max(8, n)),
                                    block_out=block_out))
        elif op in ("sort", "argsort", "segment_sort", "segment_argsort"):
            for chunk in (256, 512):
                out.append(Plan(variant, w=32, chunk=chunk))
            if variant.endswith("two_phase"):
                # phase 2 is a MergeSchedule: also sweep the fused depth
                out.append(Plan(variant, w=32, chunk=256, levels=2))
        elif op in ("moe_route", "moe_route_ep"):
            out.append(Plan(variant, w=32))
        else:
            out.append(Plan(variant))
    return out


def _time(thunk: Callable[[], object], *, cuda: bool, repeats: int = 3,
          warmup: int = 1) -> float:
    """Median seconds of ``repeats`` runs after ``warmup``: CUDA events
    around each run on the card, the host clock on the CPU."""
    for _ in range(warmup):
        thunk()
    if cuda:
        torch.cuda.synchronize()
    ts = []
    for _ in range(repeats):
        if cuda:
            s, e = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            s.record()
            thunk()
            e.record()
            e.synchronize()
            ts.append(s.elapsed_time(e) / 1e3)
        else:
            t0 = time.perf_counter()
            thunk()
            ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


#: the process-wide plan cache the engine api resolves through
default_planner = Planner()
