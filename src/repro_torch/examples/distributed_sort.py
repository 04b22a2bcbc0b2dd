"""Sharded sort across ranks (the paper's §8.2 scaled to a mesh), on the
port (counterpart of ``examples/distributed_sort.py``).

Spawns ``--ranks`` processes (4 by default; the JAX example forces 8 host
devices) joined by gloo through ``launch.mesh.make_mesh`` over a
``("data",)`` axis; on the card every rank runs on ``cuda:0`` (gloo
stages the exchange through the host). The engine op plans the splitter
policy and the merge executor and recovers bucket overflow: the
zipf-skewed half of the demo overflows the base cap.

    PYTHONPATH=src python -m repro_torch.examples.distributed_sort \\
        [--device cpu] [--ranks 4]
"""
import argparse
import os
import sys
import tempfile

import numpy as np
import torch


def _rank(rank: int, world: int, store: str, device: str) -> None:
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.set_num_threads(1)
    try:
        from repro_torch import engine
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.parallel import comm
        from repro_torch.parallel.sharding import collect_sorted, data_shard_1d
        # on the card make_mesh places rank r on cuda:{r % cards}
        mesh = make_mesh((world,), ("data",), backend="gloo", rank=rank,
                         world_size=world, store_dir=store,
                         device=None if device == "cuda" else device)
        rng = np.random.default_rng(0)
        n = world * 4096
        with mesh:
            for name, x in [
                ("uniform", rng.integers(-10**6, 10**6, n).astype(np.int32)),
                ("zipf-skewed",
                 np.minimum(rng.zipf(2.0, n), 10**6).astype(np.int32)),
            ]:
                xg = torch.from_numpy(x).to(mesh.device)
                xs = data_shard_1d(xg, mesh)
                res = engine.sharded_sort(xs, mesh)
                out = collect_sorted(res, mesh=mesh)
                counts = comm.all_gather(res.count, "data", mesh)
                over = bool(comm.all_gather(res.overflow, "data",
                                            mesh).any())
                ok = torch.equal(out, torch.sort(xg, descending=True).values)
                if rank == 0:
                    print(f"{name:12s} | elements: {n} | per-rank counts:",
                          counts.reshape(-1).tolist())
                    print(f"{name:12s} | overflow: {over}",
                          "| globally sorted:", ok, flush=True)
            # global top-k with the element ids riding the payload lanes
            v, i = engine.sharded_topk(xs, 8, mesh)
            if rank == 0:
                print("top-8 of the zipf input:", v.tolist(),
                      "== torch.topk:",
                      v.tolist() == torch.topk(xg, 8).values.tolist(),
                      flush=True)
    except Exception:
        import traceback
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    sys.stdout.flush()
    os._exit(0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=4)
    args = ap.parse_args(argv)
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as store:
        procs = [ctx.Process(target=_rank, args=(r, args.ranks, store,
                                                 args.device))
                 for r in range(args.ranks)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(300)
        codes = [p.exitcode for p in procs]
        for p in procs:
            if p.is_alive():
                p.kill()
    if codes != [0] * args.ranks:
        raise SystemExit(f"distributed_sort: rank exit codes {codes}")


if __name__ == "__main__":
    main()
