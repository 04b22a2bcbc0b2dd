"""``repro_torch.engine`` — the port's entry point for sorting workloads.

``sort`` / ``argsort`` / ``merge`` / ``merge_runs``, ``topk``, the
samplers ``sample_topp`` / ``sample_minp``, the ragged
``segment_sort`` / ``segment_argsort`` / ``segment_merge``, ``moe_route``,
the out-of-core ``external_sort`` and, across a mesh axis,
``sharded_sort`` / ``sharded_topk`` / ``moe_route_ep`` (``ShardedSort``,
``RouteShard``) on the input's device, planned
through the variant/plan cache and dispatched under the fallback ladder;
``autotune`` / ``run_op`` time and run the variants under explicit plans
(counterpart of ``repro.engine``).
"""
from repro_torch.engine.api import (MergeSchedule, Plan, RouteResult,
                                    argsort, autotune, clear_plans,
                                    external_sort, infer_key, load_plans,
                                    merge, merge_runs, moe_route, run_op,
                                    sample_minp, sample_topp, save_plans,
                                    segment_argsort, segment_merge,
                                    segment_sort, sharded_sort,
                                    sharded_topk, moe_route_ep, sort, topk)
from repro_torch.engine.sharded import RouteShard, ShardedSort
from repro_torch.engine.segments import segment_sort_oracle
from repro_torch.engine.planner import (Planner, candidate_plans,
                                        default_planner, heuristic_plan,
                                        plan_key, plans_from_jax)
from repro_torch.engine import registry, schedule, segments

__all__ = [
    "MergeSchedule", "Plan", "Planner", "RouteResult", "argsort",
    "autotune", "candidate_plans", "clear_plans", "default_planner",
    "external_sort", "heuristic_plan", "infer_key", "load_plans", "merge",
    "merge_runs", "moe_route", "moe_route_ep", "plan_key", "plans_from_jax", "registry",
    "run_op", "sample_minp", "sample_topp",
    "save_plans", "schedule", "segment_argsort", "segment_merge",
    "segment_sort", "segment_sort_oracle", "segments", "sharded_sort",
    "sharded_topk", "ShardedSort", "RouteShard", "sort", "topk",
]
