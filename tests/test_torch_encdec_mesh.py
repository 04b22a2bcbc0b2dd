"""The encoder-decoder (``whisper_large_v3.reduced()``) through the port's
mesh step and dry run on the CPU, no JAX:

- ``make_train_step(cfg, tcfg, mesh)`` on 4 gloo ranks of a (2, 2)
  ``("data", "model")`` mesh, 2 steps at global batch 8 (64 frames, 8 text
  positions), from ``MeshLayout.init``'s blocks of the one-process seeded
  init: both losses, both gradient norms (relative; AdamW and the clip
  cancel a constant factor on a leaf's gradient, the norm does not) and
  every gathered parameter leaf within ``PORT_TOL``
  = 1e-5 of the port's one-process step on the same init and batches (the
  bound of ``tests/test_torch_distributed_train.py``'s decoder cases), the
  loss bits equal on every rank;
- the dry run's collective bytes by kind for that step on rank 0 of a
  counting (2, 2) mesh equal, exactly, the gloo run's
  ``comm.wire_bytes_by_kind()`` on rank 0 (as
  ``tests/test_torch_dryrun.py`` holds the decoder's);
- the dry run counts Whisper's train, prefill and decode cells on a (2, 4)
  mesh: FLOPs, bytes and collective bytes above 0.
"""
import json
import os
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch.op_cost import counting_mesh  # noqa: E402
from repro_torch.models.config import ShardingConfig, TrainConfig  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "whisper_large_v3"
BATCH, SEQ, STEPS = 8, 64, 2
PORT_TOL = 1e-5
TINY = {"tiny_train": dict(kind="train", seq_len=SEQ, global_batch=BATCH),
        "tiny_prefill": dict(kind="prefill", seq_len=SEQ, global_batch=BATCH),
        "tiny_decode": dict(kind="decode", seq_len=SEQ, global_batch=BATCH)}


def _tcfg():
    return TrainConfig(global_batch=BATCH, seq_len=SEQ, total_steps=10,
                       warmup_steps=2)


def _batches(cfg):
    """``STEPS`` seeded global batches of the encoder-decoder's inputs."""
    from repro_torch.data.pipeline import make_batch_specs
    gen = torch.Generator().manual_seed(7)
    out = []
    for _ in range(STEPS):
        b = {}
        for k, v in make_batch_specs(cfg, SEQ, BATCH).items():
            if k == "frames":
                b[k] = torch.randn(v.shape, generator=gen)
            elif k == "mask":
                b[k] = (torch.rand(v.shape, generator=gen) < 0.9).float()
            else:
                b[k] = torch.randint(0, cfg.vocab_size, v.shape,
                                     generator=gen).to(v.dtype)
        out.append(b)
    return out


def _rank(rank: int, d: str) -> None:
    """One rank of the (2, 2) gloo run: two mesh steps; rank 0 writes the
    losses, the gathered parameters and the first step's wire bytes."""
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    torch.set_num_threads(1)
    sys.path.insert(0, os.path.join(REPO, "src"))
    try:
        from repro_torch.core.butterfly import tree_leaves
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.launch.steps import make_train_step
        from repro_torch.parallel import comm
        from repro_torch.parallel.sharding import gather_leaf
        mesh = make_mesh((2, 2), ("data", "model"), backend="gloo",
                         rank=rank, world_size=4,
                         store_dir=os.path.join(d, "store"), device="cpu",
                         timeout_s=120.0)
        cfg = get_config(ARCH).reduced()
        _, step = make_train_step(cfg, _tcfg(), mesh, ShardingConfig())
        lay = step.layout
        params = lay.init(torch.Generator().manual_seed(0), device="cpu")
        opt = lay.opt_init(params)
        losses, norms, wire = [], [], {}
        for s, batch in enumerate(_batches(cfg)):
            before = comm.wire_bytes_by_kind()
            with mesh:
                params, opt, m = step(params, opt, lay.batch_block(batch))
            if s == 0:
                wire = {k: v - before.get(k, 0)
                        for k, v in comm.wire_bytes_by_kind().items()}
            losses.append(m["loss"].reshape(1))
            norms.append(m["grad_norm"].reshape(1))
        losses = torch.cat(losses)
        every = [torch.empty_like(losses) for _ in range(4)]
        torch.distributed.all_gather(every, losses)
        plans = lay.plans(params)
        leaves = [gather_leaf(b, lf.pspec, mesh)
                  for b, lf in zip(tree_leaves(params), plans)]
        if rank == 0:
            out = {f"p_{'/'.join(lf.path)}": t.numpy()
                   for lf, t in zip(plans, leaves)}
            out["loss"] = losses.numpy()
            out["grad_norm"] = torch.cat(norms).numpy()
            out["loss_every_rank"] = torch.stack(every).numpy()
            np.savez(os.path.join(d, "mesh.npz"), **out)
            with open(os.path.join(d, "wire.json"), "w") as f:
                json.dump({k: v for k, v in wire.items() if v}, f)
    except Exception:
        import traceback
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    os._exit(0)


def _one_process(cfg):
    """The port's one-process step from the same seeded init and batches:
    ``(losses, grad norms, params by leaf path)``."""
    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.optim.adamw import adamw_init
    model, step = TS.make_train_step(cfg, _tcfg())
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    opt = adamw_init(params)
    losses, norms = [], []
    for batch in _batches(cfg):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return (np.array(losses), np.array(norms),
            {n: t.numpy() for n, t in _flatten(params)})


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("encdec_mesh"))
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, d)) for r in range(4)]
    for p in procs:
        p.start()
    cfg = get_config(ARCH).reduced()
    TS.SHAPES.update(TINY)
    # one thread, as the ranks run: the same reductions whatever the load
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cost = DR.count_cell(cfg, "tiny_train",
                             counting_mesh((2, 2), ("data", "model")),
                             ShardingConfig())
        ref = _one_process(cfg)
    finally:
        torch.set_num_threads(threads)
        for k in TINY:
            TS.SHAPES.pop(k, None)
    deadline = time.monotonic() + 240
    for p in procs:
        p.join(max(deadline - time.monotonic(), 1))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive, "gloo ranks hung"
    assert [p.exitcode for p in procs] == [0] * 4
    mesh = dict(np.load(os.path.join(d, "mesh.npz")))
    with open(os.path.join(d, "wire.json")) as f:
        wire = json.load(f)
    return {"cost": cost, "ref": ref, "mesh": mesh, "wire": wire}


def test_encdec_mesh_step_matches_one_process(run):
    losses, norms, ref = run["ref"]
    mesh = run["mesh"]
    np.testing.assert_allclose(mesh["loss"], losses, rtol=PORT_TOL,
                               atol=PORT_TOL)
    np.testing.assert_allclose(mesh["grad_norm"], norms, rtol=PORT_TOL)
    assert (mesh["loss_every_rank"] == mesh["loss"][None]).all()
    names = {k[2:] for k in mesh if k.startswith("p_")}
    assert names == set(ref)
    for n, want in ref.items():
        np.testing.assert_allclose(mesh["p_" + n], want, rtol=PORT_TOL,
                                   atol=PORT_TOL, err_msg=n)


def test_encdec_collectives_match_a_gloo_run(run):
    assert run["wire"] and run["cost"].coll == run["wire"]


@pytest.mark.parametrize("shape", sorted(TINY))
def test_encdec_dryrun_counts(monkeypatch, shape):
    for k, v in TINY.items():
        monkeypatch.setitem(TS.SHAPES, k, v)
    cost = DR.count_cell(get_config(ARCH).reduced(), shape,
                         counting_mesh((2, 4), ("data", "model")),
                         ShardingConfig())
    assert cost.flops > 0 and cost.bytes > 0 and cost.coll_total > 0
