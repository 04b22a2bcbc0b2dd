"""The port's dry run (``launch/dryrun.py``, ``launch/op_cost.py``) on the
CPU, no JAX:

- ``test_dryrun_machinery_small_mesh`` mirrors
  ``tests/test_system.py::test_dryrun_machinery_small_mesh``: reduced
  Qwen3's train step on rank 0 of a (2, 4) ``(data, model)`` mesh, counted
  on ``meta`` tensors: FLOPs, bytes, collective bytes and temporaries all
  above 0; prefill and decode cells count too, and the CLI's record keys
  and ``SKIP`` reason are the JAX dry run's;
- ``test_collectives_match_a_gloo_run``: the dry run's collective bytes by
  kind equal, exactly, ``comm.wire_bytes_by_kind()`` of rank 0 of a real
  4-rank gloo run of the same step on a (2, 2) mesh (on CPU tensors gloo
  stages nothing through the host, so ``host_staged_bytes_by_kind()`` is
  empty there; the wire count is the same count, kept on any device);
- ``test_train_flops_against_model_flops``: the counted train FLOPs summed
  over the ranks lie between 1x and 2x ``model_flops_estimate`` on a
  data-parallel mesh; on a (2, 4) mesh, where the port replicates the
  dense compute along ``model`` (``launch/steps.py``), between 1x and the
  model axis times the data-parallel sum.
"""
import json
import os
import sys
import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch.op_cost import counting_mesh  # noqa: E402
from repro_torch.launch.roofline import model_flops_estimate  # noqa: E402
from repro_torch.models.config import ShardingConfig  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen3_1p7b"
TINY = {"tiny_train": dict(kind="train", seq_len=64, global_batch=8),
        "tiny_prefill": dict(kind="prefill", seq_len=64, global_batch=8),
        "tiny_decode": dict(kind="decode", seq_len=64, global_batch=8)}


@pytest.fixture
def tiny(monkeypatch):
    for k, v in TINY.items():
        monkeypatch.setitem(TS.SHAPES, k, v)
    return get_config(ARCH).reduced()


def _count(cfg, shape, sizes):
    return DR.count_cell(cfg, shape, counting_mesh(sizes, ("data", "model")),
                         ShardingConfig())


def test_dryrun_machinery_small_mesh(tiny):
    cost = _count(tiny, "tiny_train", (2, 4))
    assert cost.flops > 0 and cost.bytes > 0
    assert cost.coll_total > 0          # sharded training must communicate
    assert cost.temp_bytes > 0
    assert {"all_gather", "reduce_scatter", "psum"} <= set(cost.coll)
    for shape in ("tiny_prefill", "tiny_decode"):
        c = _count(tiny, shape, (2, 4))
        assert c.flops > 0 and c.bytes > 0 and c.coll_total > 0, shape


def test_dryrun_records(monkeypatch, tiny):
    """``run_cell``'s record has the JAX record's keys; a full-attention
    arch's ``long_500k`` is ``SKIP`` with its reason, and the
    encoder-decoder's cells count, as in JAX."""
    monkeypatch.setattr(DR, "get_config", lambda a: get_config(a).reduced())
    monkeypatch.setattr(DR, "production_mesh", lambda multi_pod: counting_mesh(
        (2, 2, 2) if multi_pod else (2, 4),
        ("pod", "data", "model") if multi_pod else ("data", "model")))
    rec = DR.run_cell(ARCH, "tiny_train", True, verbose=False)
    assert rec["status"] == "OK" and rec["mesh"] == "multi"
    assert {"memory", "collectives", "roofline"} <= set(rec)
    assert {"args_gb", "output_gb", "temp_gb", "peak_ok"} <= \
        set(rec["memory"])
    assert rec["roofline"]["flops"] > 0 and rec["roofline"]["coll_bytes"] > 0
    skip = DR.run_cell(ARCH, "long_500k", False, verbose=False)
    assert skip["status"] == "SKIP" and "quadratic" in skip["reason"]
    enc = DR.run_cell("whisper_large_v3", "tiny_train", False, verbose=False)
    assert enc["status"] == "OK" and enc["roofline"]["flops"] > 0


def _rank(rank: int, d: str) -> None:
    """One rank of the (2, 2) gloo run: the reduced train step once, its
    wire bytes by kind to ``rank<r>.json``."""
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    torch.set_num_threads(1)
    sys.path.insert(0, os.path.join(REPO, "src"))
    try:
        from repro_torch.data.pipeline import make_batch_specs
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.launch.steps import make_train_step
        from repro_torch.models.config import TrainConfig
        from repro_torch.parallel import comm
        mesh = make_mesh((2, 2), ("data", "model"), backend="gloo",
                         rank=rank, world_size=4,
                         store_dir=os.path.join(d, "store"), device="cpu",
                         timeout_s=120.0)
        cfg = get_config(ARCH).reduced()
        s = TINY["tiny_train"]
        _, step = make_train_step(cfg, TrainConfig(
            global_batch=s["global_batch"], seq_len=s["seq_len"]), mesh,
            ShardingConfig())
        lay = step.layout
        gen = torch.Generator().manual_seed(0)
        params = lay.init(gen, device="cpu")
        opt = lay.opt_init(params)
        spec = make_batch_specs(cfg, s["seq_len"], s["global_batch"])
        batch = {k: torch.randint(0, cfg.vocab_size, v.shape,
                                  generator=gen).to(v.dtype)
                 for k, v in spec.items()}
        before = comm.wire_bytes_by_kind()
        with mesh:
            step(params, opt, lay.batch_block(batch))
        wire = {k: v - before.get(k, 0)
                for k, v in comm.wire_bytes_by_kind().items()}
        with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
            json.dump({k: v for k, v in wire.items() if v}, f)
    except Exception:
        import traceback
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    os._exit(0)


def test_collectives_match_a_gloo_run(tmp_path, tiny):
    d = str(tmp_path)
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, d)) for r in range(4)]
    for p in procs:
        p.start()
    cost = _count(tiny, "tiny_train", (2, 2))
    deadline = time.monotonic() + 240
    for p in procs:
        p.join(max(deadline - time.monotonic(), 1))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive, "gloo ranks hung"
    assert [p.exitcode for p in procs] == [0] * 4
    with open(os.path.join(d, "rank0.json")) as f:
        real = json.load(f)
    assert real and cost.coll == real


def test_train_flops_against_model_flops(tiny):
    """The counted train FLOPs summed over the ranks against
    ``model_flops_estimate``: within 1x-2x on the data-parallel (4, 1)
    mesh. On (2, 4) the sum is at least 1x and at most the model axis (4)
    times the data-parallel sum: the port replicates the dense compute
    along ``model`` (ROADMAP queue 2, "The mesh"), and any compute
    duplicated further, or lost, fails."""
    s = TINY["tiny_train"]
    mf = model_flops_estimate(tiny, "train", s["seq_len"],
                              s["global_batch"])
    ratio = {}
    for sizes in ((4, 1), (2, 4)):
        cost = _count(tiny, "tiny_train", sizes)
        ratio[sizes] = cost.flops * sizes[0] * sizes[1] / mf
    assert 1.0 <= ratio[4, 1] <= 2.0, ratio
    assert 1.0 <= ratio[2, 4] <= 4 * ratio[4, 1], ratio
