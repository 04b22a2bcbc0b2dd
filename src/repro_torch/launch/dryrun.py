"""Multi-pod dry run: count every (arch × shape × mesh) cell's step from
one process (counterpart of ``repro/launch/dryrun.py``).

The JAX dry run lowers and compiles each cell's step with full shardings
on 512 forced host devices, and records XLA's memory and cost analyses and
collective schedule. Torch has no compiler to lower to. Here one process
plays rank 0 of the production mesh, (data 16, model 16) or (pod 2, data
16, model 16): ``cell_shardings`` gives the cell's ``meta`` stand-ins and
their specs, rank 0's blocks are cut from them (still ``meta``: shapes,
no data), and the step of the cell's kind runs on them eagerly on a
counting mesh under ``launch/op_cost.py``'s counting modes:

- train: ``make_train_step(cfg, tcfg, mesh, sc)``, the ZeRO-3 mesh step
  (parameters gathered at use, gradients reduced and scattered, AdamW on
  the optimizer blocks);
- prefill: ``make_prefill_step``'s ``model.prefill`` on rank 0's batch
  block, every parameter gathered at use as the mesh step gathers it;
- decode: ``make_decode_step(cfg, mesh, kv_shard_axis)`` on rank 0's
  blocks of the cache (cut along the batch and, for ``long_500k``, the
  sequence, whole along ``model``, where the gathered parameters compute
  every head), the tokens and the positions, parameters gathered at use.

The record has the JAX one's keys: ``memory`` (arguments, outputs, the
peak of the step's live temporaries, ``peak_ok`` against the H100's 80
GB), ``collectives`` (bytes by kind), ``roofline`` (``launch/roofline.py``
at the H100's rates) and ``status``. The counts are counts, not timings.
A full-attention arch's ``long_500k`` is ``SKIP`` with its reason, as in
JAX.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3_1p7b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both --out results.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.op_cost import count, counting_mesh
from repro_torch.launch.roofline import (DEVICE_BYTES, analyse,
                                         collective_bytes,
                                         model_flops_estimate)
from repro_torch.launch.steps import (SHAPES, MeshLayout, cell_shardings,
                                      long_500k_applicable, make_decode_step,
                                      make_prefill_step, make_train_step)
from repro_torch.models.config import ShardingConfig, TrainConfig
from repro_torch.parallel import act
from repro_torch.parallel.sharding import (shard_leaf, spec_axes,
                                           tree_map_like)

# per-cell winning configs of the JAX package's §Perf, applied with --opt
OPT_OVERRIDES = {
    ("gemma2_27b", "train_4k"): {"sharding": {
        "model_axis": "", "fsdp_axis": ("data", "model"),
        "data_axes": ("pod", "data", "model")}},
}


def production_mesh(multi_pod: bool) -> Mesh:
    """Rank 0 of the JAX package's production layout (``make_production_
    mesh``): (data 16, model 16), or (pod 2, data 16, model 16)."""
    if multi_pod:
        return counting_mesh((2, 16, 16), ("pod", "data", "model"))
    return counting_mesh((16, 16), ("data", "model"))


def _blocks(pair, mesh, drop: str = ""):
    """Rank 0's blocks of a ``cell_shardings`` entry (``meta``), not cut
    along the axis ``drop``."""
    def spec(ns):
        keep = [tuple(a for a in spec_axes(e) if a != drop) for e in ns.spec]
        return tuple(None if not e else e[0] if len(e) == 1 else e
                     for e in keep)
    tree, shardings = pair
    return tree_map_like(lambda t, ns: shard_leaf(t, spec(ns), mesh), tree,
                         shardings)


def count_cell(cfg, shape: str, mesh, sc: ShardingConfig):
    """Rank 0's counted cost (``op_cost.Cost``) of the cell's step."""
    s = SHAPES[shape]
    kind = s["kind"]
    tcfg = TrainConfig(global_batch=s["global_batch"], seq_len=s["seq_len"])
    sh = cell_shardings(cfg, shape, mesh, sc)
    params = _blocks(sh["params"], mesh)
    if kind == "train":
        _, step = make_train_step(cfg, tcfg, mesh, sc)
        opt = step.layout.opt_init(params)
        batch = _blocks(sh["batch"], mesh)
        with mesh:
            return count(step, params, opt, batch)[1]
    layout = MeshLayout(cfg, tcfg, mesh, sc)
    view = layout._view(params)
    with mesh, act.context(mesh, sc.data_axes, sc.model_axis):
        if kind == "prefill":
            _, step = make_prefill_step(cfg)
            batch = _blocks(sh["batch"], mesh)
            return count(step, view, batch)[1]
        kv_axis = "data" if sc.shard_kv_seq else ""
        _, step = make_decode_step(cfg, mesh=mesh, kv_shard_axis=kv_axis)
        # whole along the model axis, as the gathered parameters compute
        cache = _blocks(sh["cache"], mesh, drop=sc.model_axis)
        tok, pos = (shard_leaf(t, ns.spec, mesh)
                    for t, ns in (sh["token"], sh["pos"]))
        return count(step, view, tok, pos, cache, None)[1]


def run_cell(arch: str, shape: str, multi_pod: bool,
             sharding_overrides=None, verbose: bool = True,
             config_overrides=None, opt: bool = False):
    cfg = get_config(arch)
    if config_overrides:
        cfg = dataclasses.replace(cfg, **config_overrides)
    if opt:
        ovr = OPT_OVERRIDES.get((arch, shape), {})
        if "sharding" in ovr:
            sharding_overrides = dict(ovr["sharding"],
                                      **(sharding_overrides or {}))
        if "config" in ovr:
            cfg = dataclasses.replace(cfg, **ovr["config"])
    s = SHAPES[shape]
    kind = s["kind"]
    head = {"arch": arch, "shape": shape,
            "mesh": "multi" if multi_pod else "single"}
    if shape == "long_500k" and not long_500k_applicable(cfg):
        return dict(head, status="SKIP",
                    reason="full-attention arch: 500k decode is quadratic "
                           "(documented in DESIGN.md §Arch-applicability)")
    mesh = production_mesh(multi_pod)
    sc = ShardingConfig(
        shard_kv_seq=(shape == "long_500k" and cfg.arch_kind != "xlstm"))
    if sharding_overrides:
        sc = dataclasses.replace(sc, **sharding_overrides)
    t0 = time.time()
    cost = count_cell(cfg, shape, mesh, sc)
    mf = model_flops_estimate(cfg, kind, s["seq_len"], s["global_batch"])
    roof = analyse(cost, model_flops=mf, n_chips=mesh.size)
    rec = dict(head, status="OK",
               seconds_to_count=round(time.time() - t0, 1),
               memory={
                   "args_gb": cost.args_bytes / 1e9,
                   "output_gb": cost.output_bytes / 1e9,
                   "temp_gb": cost.temp_bytes / 1e9,
                   "peak_ok": cost.args_bytes + cost.temp_bytes
                   < DEVICE_BYTES},
               collectives=collective_bytes(cost),
               roofline=roof.to_dict())
    if verbose:
        print(json.dumps(rec, indent=1), flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--moe-path", default=None,
                    help="override MoE dispatch path (dense|grouped|ep)")
    ap.add_argument("--no-tp", action="store_true",
                    help="pure-FSDP sharding: no tensor-parallel axis")
    # taken for the JAX CLI's sake; no config reads it there either
    ap.add_argument("--attn-chunk", type=int, default=0)
    ap.add_argument("--opt", action="store_true",
                    help="apply the per-cell winning configs")
    args = ap.parse_args(argv)
    cfg_ovr = {}
    if args.moe_path:
        cfg_ovr["moe_path"] = args.moe_path
    sh_ovr = {}
    if args.no_tp:
        sh_ovr = {"model_axis": "", "fsdp_axis": ("data", "model"),
                  "data_axes": ("pod", "data", "model")}
    archs = ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    results = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    results.append(run_cell(arch, shape, mp,
                                            sharding_overrides=sh_ovr or None,
                                            config_overrides=cfg_ovr or None,
                                            opt=args.opt))
                except Exception as e:
                    traceback.print_exc()
                    results.append({"arch": arch, "shape": shape,
                                    "mesh": "multi" if mp else "single",
                                    "status": "FAIL", "error": str(e)[:500]})
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    n_fail = sum(r["status"] == "FAIL" for r in results)
    print(f"\n{len(results)} cells: "
          f"{sum(r['status'] == 'OK' for r in results)} OK, "
          f"{sum(r['status'] == 'SKIP' for r in results)} SKIP, "
          f"{n_fail} FAIL")
    return 1 if n_fail else 0


if __name__ == "__main__":
    torch.set_grad_enabled(True)
    sys.exit(main())
