"""The port's mesh layer on 4 ranks against the JAX package on 4 devices.

One spawn of 4 gloo ranks on the CPU (``torch.multiprocessing``, a
``FileStore`` rendezvous under the test's temporary directory,
``GLOO_SOCKET_IFNAME=lo``) runs every case, and one JAX subprocess on 4
forced host devices runs the same cases on the same seeded inputs
(``tests/_mesh_cases.py``), both writing ``.npz`` files. Each rank's
outputs are compared with the JAX per-device slice:

- ``core.distributed.sample_sort`` (int32 key-only, KV with
  sentinel-valued keys, float32 KV, a zipf input at ``retries=0`` that
  overflows and at the default that recovers, shards of 1, 2 and 4 keys)
  and ``engine.sharded_sort`` (the heuristic plan and ``tree_vmapped``
  with regular splitters on the zipf input, all-equal keys filling one
  bucket to its cap, heavy ties with a payload): values, payload, count
  and overflow bit for bit, padding included;
- ``engine.sharded_topk`` with a payload at k 1 to 1000 (past one shard),
  both local variants: bit for bit, on every rank;
- ``engine.moe_route_ep`` (``torch`` and ``fused``, capacities 5, 1 and
  slack): the lanes bit for bit but the weights, within ``WEIGHT_ULPS``
  (float32 softmax in torch against XLA's, as ``test_torch_moe.py``);
- ``models.moe.moe_apply_ep`` on a ``model`` axis of 4 (8 experts, 2 a
  rank, the weights cut by ``convert.shard_params_for_rank``) against JAX
  ``moe_apply_ep`` on the same float32 weights: within 1e-5 relative;
- ``attention.attn_decode(kv_shard_axis="data")`` (``_sharded_flash_decode``)
  against JAX's: the output within 1e-5 relative, each rank's cache block
  bit for bit but the row written this step (a float32 projection, within
  1e-5 relative);
- plan agreement: a rank holding another plan in its cache runs rank 0's;
  ``engine.autotune`` on the mesh installs one plan on every rank;
- a fault injected on one rank only (``guard.inject.failing_variant``
  shadowing the pinned variant of rank 1): every rank raises, rank 1 its
  ``InjectedFault``, the others within the mesh's timeout; none hangs.
"""
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
sys.path.insert(0, TESTS)

import _mesh_cases as mc  # noqa: E402

P = mc.P
FAULT_TIMEOUT_S = 3.0
MOE_RTOL = 1e-5
DECODE_RTOL = 1e-5
WEIGHT_ULPS = 4

JAX_PROG = textwrap.dedent("""
    import dataclasses, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, {src!r}); sys.path.insert(0, {tests!r})
    import numpy as np, jax, jax.numpy as jnp
    import _mesh_cases as mc
    from repro import engine
    from repro.configs import get_config
    from repro.core.distributed import sample_sort
    from repro.models import moe as jmoe
    from repro.models.attention import attn_decode
    from repro.parallel import act
    from repro.parallel.sharding import data_shard_1d
    NAMES = {{"torch": "xla", "tree_vmapped": "tree_vmapped",
              "fused": "fused", "flims": "flims"}}
    auto = (jax.sharding.AxisType.Auto,)
    mesh = jax.make_mesh((4,), ("data",), axis_types=auto)
    out = {{}}

    def put(pre, res, pay=None):
        out[pre + "values"] = np.asarray(res.values)
        out[pre + "count"] = np.asarray(res.count)
        out[pre + "overflow"] = np.asarray(res.overflow)
        if pay is not None:
            out[pre + "pay"] = np.asarray(pay)

    sh = lambda a: data_shard_1d(jnp.asarray(a), mesh)
    for name, (x, pay, kw) in mc.sort_cases().items():
        if pay is None:
            put(f"ss_{{name}}_", sample_sort(sh(x), mesh, "data", **kw))
        else:
            put(f"ss_{{name}}_", *sample_sort(sh(x), mesh, "data",
                                              payload=sh(pay), **kw))
    for name, (x, pay, plan) in mc.engine_sort_cases().items():
        kw = {{}} if plan is None else {{"plan": engine.Plan(
            **dict(plan, variant=NAMES[plan["variant"]]))}}
        if pay is None:
            put(f"es_{{name}}_", engine.sharded_sort(sh(x), mesh, **kw))
        else:
            put(f"es_{{name}}_", *engine.sharded_sort(sh(x), mesh,
                                                      payload=sh(pay), **kw))
    x, pay, ks = mc.topk_case()
    for k in ks:
        v, i, p = engine.sharded_topk(sh(x), k, mesh, payload=sh(pay))
        out[f"tk_{{k}}"] = np.stack([np.asarray(v), np.asarray(i),
                                     np.asarray(p)])
    logits, k, caps = mc.route_case()
    for cap in caps:
        r = engine.moe_route_ep(jnp.asarray(logits), k, cap, mesh, "data",
                                variant="xla")
        for f in r._fields:
            out[f"re_{{cap}}_{{f}}"] = np.asarray(getattr(r, f))
    cfg = dataclasses.replace(get_config("moonshot_v1_16b_a3b").reduced(),
                              n_experts=mc.MOE_EXPERTS)
    router, wi, wg, wo, x = mc.moe_case(cfg.d_model, cfg.moe_d_ff)
    mmesh = jax.make_mesh((4,), ("model",), axis_types=auto)
    act.set_context(mmesh)
    p = {{"router": jnp.asarray(router), "wi": jnp.asarray(wi),
         "wg": jnp.asarray(wg), "wo": jnp.asarray(wo)}}
    with jax.set_mesh(mmesh):
        out["moe_y"] = np.asarray(jax.jit(
            lambda p, x: jmoe.moe_apply_ep(p, x, cfg))(p, jnp.asarray(x)))
    act.clear_context()
    cfg = get_config("qwen3_1p7b").reduced()
    p, kc, vc, x, pos = mc.decode_case(cfg.d_model, cfg.n_heads,
                                       cfg.n_kv_heads, cfg.hd)
    p = {{k_: jnp.asarray(v_) for k_, v_ in p.items()}}
    with jax.set_mesh(mesh):
        y, (kc2, vc2) = jax.jit(lambda x, kc, vc, pos: attn_decode(
            p, x, (kc, vc), pos, cfg, mesh=mesh, kv_shard_axis="data"))(
                jnp.asarray(x), jnp.asarray(kc), jnp.asarray(vc),
                jnp.asarray(pos))
    out["dec_y"], out["dec_k"], out["dec_v"] = (np.asarray(y),
                                                np.asarray(kc2),
                                                np.asarray(vc2))
    np.savez(sys.argv[1], **out)
""")


def _rank(rank: int, store: str, out_dir: str) -> None:
    """One rank: every case on a 4-rank gloo mesh; outputs to an .npz."""
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    torch.set_num_threads(1)
    sys.path.insert(0, os.path.join(REPO, "src"))
    import dataclasses
    from repro_torch import engine
    from repro_torch.configs import get_config
    from repro_torch.core.distributed import sample_sort
    from repro_torch.engine import api
    from repro_torch.guard import inject
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    from repro_torch.models.attention import attn_decode
    from repro_torch.models.convert import shard_params_for_rank
    from repro_torch.parallel import act
    from repro_torch.parallel.sharding import data_shard_1d

    out = {}
    mesh = make_mesh((P,), ("data",), backend="gloo", rank=rank,
                     world_size=P, store_dir=store, device="cpu",
                     timeout_s=120.0)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    sh = lambda a: data_shard_1d(T(a), mesh)

    def put(pre, res, pay=None):
        out[pre + "values"] = res.values.numpy()
        out[pre + "count"] = res.count.numpy()
        out[pre + "overflow"] = res.overflow.numpy()
        if pay is not None:
            out[pre + "pay"] = pay.numpy()

    for name, (x, pay, kw) in mc.sort_cases().items():
        if pay is None:
            put(f"ss_{name}_", sample_sort(sh(x), mesh, "data", **kw))
        else:
            put(f"ss_{name}_", *sample_sort(sh(x), mesh, "data",
                                            payload=sh(pay), **kw))
    for name, (x, pay, plan) in mc.engine_sort_cases().items():
        kw = {} if plan is None else {"plan": engine.Plan(**plan)}
        if pay is None:
            put(f"es_{name}_", engine.sharded_sort(sh(x), mesh, **kw))
        else:
            put(f"es_{name}_", *engine.sharded_sort(sh(x), mesh,
                                                    payload=sh(pay), **kw))
    x, pay, ks = mc.topk_case()
    for k in ks:
        for variant in ("torch", "flims"):
            v, i, p = engine.sharded_topk(sh(x), k, mesh, payload=sh(pay),
                                          variant=variant)
            out[f"tk_{k}_{variant}"] = torch.stack([v, i, p]).numpy()
    logits, k, caps = mc.route_case()
    for cap in caps:
        for variant in ("torch", "fused"):
            r = engine.moe_route_ep(data_shard_1d(T(logits), mesh), k, cap,
                                    mesh, "data", variant=variant)
            for f in r._fields:
                t = getattr(r, f)
                out[f"re_{cap}_{variant}_{f}"] = t.numpy()

    # plan agreement: rank 2 holds another plan for the key; all run rank 0's
    x = sh(mc.sort_cases()["int"][0])
    key = api.infer_key("sharded_sort", x, mesh, "data")
    engine.clear_plans()
    if rank == 2:
        engine.default_planner.put(key, engine.Plan("tree_vmapped",
                                                    splitter="regular"))
    out["agree_plan"] = np.array(
        [api._resolve("sharded_sort", None, None, x, mesh, "data").variant])
    engine.clear_plans()
    tuned = engine.autotune("sharded_sort", x, mesh, "data", repeats=1,
                            candidates=[engine.Plan("torch", w=16),
                                        engine.Plan("tree_vmapped", w=16,
                                                    splitter="regular")])
    out["tuned"] = np.array([str(engine.default_planner.lookup(key)),
                             str(tuned)])
    engine.clear_plans()

    # expert parallelism over a model axis of 4
    mmesh = make_mesh((P,), ("model",), device="cpu")
    cfg = dataclasses.replace(get_config("moonshot_v1_16b_a3b").reduced(),
                              n_experts=mc.MOE_EXPERTS)
    router, wi, wg, wo, x = mc.moe_case(cfg.d_model, cfg.moe_d_ff)
    full = {"blocks": {"moe": {"router": T(router), "wi": T(wi),
                               "wg": T(wg), "wo": T(wo)}}}
    mine = shard_params_for_rank(full, mmesh)["blocks"]["moe"]
    out["moe_wi_rows"] = np.array([mine["wi"].shape[0]])
    act.set_context(mmesh)
    out["moe_y"] = moe.moe_apply(mine, T(x), cfg, mode="ep").numpy()
    act.clear_context()

    # sequence-sharded decode
    cfg = get_config("qwen3_1p7b").reduced()
    p, kc, vc, x, pos = mc.decode_case(cfg.d_model, cfg.n_heads,
                                       cfg.n_kv_heads, cfg.hd)
    p = {k_: T(v_) for k_, v_ in p.items()}
    W_loc = kc.shape[1] // P
    blk = slice(rank * W_loc, (rank + 1) * W_loc)
    y, (kc2, vc2) = attn_decode(p, T(x), (T(kc[:, blk]), T(vc[:, blk])),
                                T(pos), cfg, mesh=mesh, kv_shard_axis="data")
    out["dec_y"], out["dec_k"], out["dec_v"] = (y.numpy(), kc2.numpy(),
                                                vc2.numpy())
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)

    # last: a fault on rank 1 only, on a mesh with a short timeout
    fmesh = make_mesh((P,), ("data",), device="cpu",
                      timeout_s=FAULT_TIMEOUT_S)
    x = sh(mc.sort_cases()["int"][0])
    arm = inject.failing_variant("sharded_sort", name="torch") \
        if rank == 1 else None
    t0 = time.perf_counter()
    try:
        if arm is not None:
            arm.__enter__()
        engine.sharded_sort(x, fmesh, variant="torch")
        raised = ""
    except Exception as e:      # what each rank raised is the result
        raised = f"{type(e).__name__}: {e}"[:300]
    finally:
        if arm is not None:
            arm.__exit__(None, None, None)
    np.savez(os.path.join(out_dir, f"fault{rank}.npz"),
             raised=np.array([raised]),
             seconds=np.array([time.perf_counter() - t0]))
    sys.stdout.flush()
    # the fault left the groups' collectives out of step: leave at once
    os._exit(0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    jax_out = str(d / "jax.npz")
    jproc = subprocess.Popen(
        [sys.executable, "-c", JAX_PROG.format(src=os.path.join(REPO, "src"),
                                               tests=TESTS), jax_out],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, str(d / "store"), str(d)))
             for r in range(P)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + 240
    for p in procs:
        p.join(max(deadline - time.monotonic(), 1))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    codes = [p.exitcode for p in procs]
    try:
        _, err = jproc.communicate(timeout=max(deadline - time.monotonic(),
                                               1))
    except subprocess.TimeoutExpired:
        jproc.kill()
        raise
    assert not alive, f"ranks {[procs.index(p) for p in alive]} hung"
    assert codes == [0] * P, f"rank exit codes {codes}"
    assert jproc.returncode == 0, err[-3000:]
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(P)]
    faults = [dict(np.load(d / f"fault{r}.npz")) for r in range(P)]
    return dict(np.load(jax_out)), ranks, faults


def _per_device(a):
    return np.asarray(a).reshape(P, -1)


def _same_sort(jx, ranks, pre):
    for r, got in enumerate(ranks):
        for f in ("values", "count", "overflow", "pay"):
            if pre + f not in jx:
                continue
            want = _per_device(jx[pre + f])[r]
            g = got[pre + f].reshape(-1)
            assert g.dtype == want.dtype or f == "overflow", (pre, f)
            assert np.array_equal(g.view(np.uint8) if g.dtype == np.float32
                                  else g, want.view(np.uint8)
                                  if want.dtype == np.float32 else want), \
                (pre, f, r)


@pytest.mark.parametrize("name", list(mc.sort_cases()))
def test_sample_sort_matches_jax(runs, name):
    jx, ranks, _ = runs
    _same_sort(jx, ranks, f"ss_{name}_")
    x = mc.sort_cases()[name][0]
    counts = [int(r[f"ss_{name}_count"][0]) for r in ranks]
    if name == "zipf_r0":
        # the cap truncates: the flag is up and keys are lost
        assert ranks[0]["ss_zipf_r0_overflow"].all() and sum(counts) < x.size
    else:
        assert sum(counts) == x.size
        assert not any(r[f"ss_{name}_overflow"].any() for r in ranks)
        keys = np.concatenate([r[f"ss_{name}_values"][:c]
                               for r, c in zip(ranks, counts)])
        assert np.array_equal(keys, np.sort(x)[::-1])


@pytest.mark.parametrize("name", list(mc.engine_sort_cases()))
def test_engine_sharded_sort_matches_jax(runs, name):
    jx, ranks, _ = runs
    _same_sort(jx, ranks, f"es_{name}_")
    x, pay, _ = mc.engine_sort_cases()[name]
    counts = [int(r[f"es_{name}_count"][0]) for r in ranks]
    if name == "equal":
        # every key in one bucket, its row filled to exactly the cap
        assert counts == [x.size] + [0] * (P - 1)
    if pay is not None:
        perm = np.concatenate([r[f"es_{name}_pay"][:c]
                               for r, c in zip(ranks, counts)])
        assert np.array_equal(perm, np.argsort(-x, kind="stable"))


@pytest.mark.parametrize("k", mc.topk_case()[2])
def test_sharded_topk_matches_jax(runs, k):
    jx, ranks, _ = runs
    for r in ranks:
        for variant in ("torch", "flims"):
            assert np.array_equal(r[f"tk_{k}_{variant}"], jx[f"tk_{k}"]), \
                (k, variant)


@pytest.mark.parametrize("cap", mc.route_case()[2])
def test_moe_route_ep_matches_jax(runs, cap):
    jx, ranks, _ = runs
    fields = ("experts", "tokens", "perm", "weights", "slabs", "keep",
              "count")
    for r, got in enumerate(ranks):
        for variant in ("torch", "fused"):
            for f in fields:
                want = _per_device(jx[f"re_{cap}_{f}"])[r]
                g = got[f"re_{cap}_{variant}_{f}"].reshape(-1)
                if f == "weights":
                    assert _ulps(g, want) <= WEIGHT_ULPS, (cap, variant, r)
                else:
                    assert np.array_equal(g, want), (cap, variant, f, r)


def _ulps(a, b) -> int:
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max()) if a.size else 0


def test_moe_apply_ep_matches_jax(runs):
    jx, ranks, _ = runs
    want = jx["moe_y"]
    for r in ranks:
        assert r["moe_wi_rows"][0] == mc.MOE_EXPERTS // P
        err = np.linalg.norm(r["moe_y"] - want) / np.linalg.norm(want)
        assert err <= MOE_RTOL, err
    # every rank holds the same bits after the psum
    for r in ranks[1:]:
        assert np.array_equal(r["moe_y"], ranks[0]["moe_y"])


def test_sharded_flash_decode_matches_jax(runs):
    jx, ranks, _ = runs
    want = jx["dec_y"]
    W = jx["dec_k"].shape[1]
    W_loc = W // P
    pos = mc.decode_case(1, 1, 1, 1)[-1]
    written = np.arange(W)[None, :] == pos[:, None]          # (B, W)
    for i, r in enumerate(ranks):
        err = np.linalg.norm(r["dec_y"] - want) / np.linalg.norm(want)
        assert err <= DECODE_RTOL, err
        blk = slice(i * W_loc, (i + 1) * W_loc)
        for f in ("dec_k", "dec_v"):
            got, exp, new = r[f], jx[f][:, blk], written[:, blk]
            assert np.array_equal(got[~new], exp[~new]), (f, i)
            if new.any():
                d = np.linalg.norm(got[new] - exp[new])
                assert d <= DECODE_RTOL * np.linalg.norm(exp[new]), (f, i)


def test_plan_agreement_and_autotune_on_mesh(runs):
    _, ranks, _ = runs
    agreed = {str(r["agree_plan"][0]) for r in ranks}
    assert agreed == {"torch"}                  # rank 0's heuristic plan
    tuned = {tuple(r["tuned"]) for r in ranks}
    assert len(tuned) == 1                      # one plan on every rank
    cached, winner = tuned.pop()
    assert cached == winner


def test_fault_on_one_rank_raises_on_every_rank(runs):
    _, _, faults = runs
    for r, f in enumerate(faults):
        raised = str(f["raised"][0])
        assert raised, f"rank {r} did not raise"
        assert f["seconds"][0] < FAULT_TIMEOUT_S + 20, (r, f["seconds"])
    assert str(faults[1]["raised"][0]).startswith("InjectedFault")
