"""``repro_torch.engine`` — the port's entry point for sorting workloads.

``sort`` / ``argsort`` / ``merge`` / ``merge_runs`` on the input's device,
planned through the variant/plan cache (counterpart of ``repro.engine``).
"""
from repro_torch.engine.api import (MergeSchedule, Plan, argsort,
                                    clear_plans, load_plans, merge,
                                    merge_runs, save_plans, sort)
from repro_torch.engine.planner import (Planner, default_planner,
                                        heuristic_plan, plan_key,
                                        plans_from_jax)
from repro_torch.engine import registry, schedule

__all__ = [
    "MergeSchedule", "Plan", "Planner", "argsort", "clear_plans",
    "default_planner", "heuristic_plan", "load_plans", "merge", "merge_runs",
    "plan_key", "plans_from_jax", "registry", "save_plans", "schedule",
    "sort",
]
