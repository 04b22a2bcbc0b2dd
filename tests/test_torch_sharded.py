"""The port's sharded ops in one process, a world of 1 (gloo on the CPU),
against the JAX package in-process on a 1-device mesh.

- ``cap_ladder`` against JAX's; plan keys carrying the axis and P (the
  global length in ``n``) equal to JAX ``infer_key``'s, their JSON round
  trip and a JAX-written table read in the port's names; the heuristics
  and the candidate grids in the port's variant names;
- ``engine.sharded_sort`` per executor and splitter, key-only and with a
  payload; ``core.distributed.sample_sort``; ``engine.sharded_topk`` per
  local variant; ``engine.moe_route_ep`` per local route: values,
  payloads, counts, overflow flags and lanes bit for bit (the route's
  weights within 4 ulps, torch's float32 softmax against XLA's);
- ``engine.autotune`` on the mesh installing its winner;
- the mesh layer: ``make_production_mesh`` refusing a small world with
  the size it needs, a mesh's coordinates, the collectives on one rank,
  ``parallel.act``, ``convert.shard_params_for_rank``'s expert band,
  ``moe_apply_ep`` falling back to ``grouped`` without a context and
  ``attn_decode(kv_shard_axis=)`` on one rank equal to the unsharded
  decode within 1e-5 relative.

The 4-rank cases are ``tests/test_torch_distributed.py``.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import engine as JE  # noqa: E402
from repro.engine import planner as jplanner  # noqa: E402
from repro.engine.sharded import cap_ladder as jcap_ladder  # noqa: E402
from repro_torch import engine as TE  # noqa: E402
from repro_torch.engine import planner as tplanner  # noqa: E402
from repro_torch.engine.sharded import cap_ladder  # noqa: E402

RNG = np.random.default_rng(24)
WEIGHT_ULPS = 4
DECODE_RTOL = 1e-5
#: port variant -> the JAX package's
JAX_NAME = {"torch": "xla", "tree_vmapped": "tree_vmapped",
            "tree_cuda": "tree_pallas", "flims": "flims", "fused": "fused"}


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    old = os.environ.get("GLOO_SOCKET_IFNAME")
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    m = make_mesh((1,), ("data",), backend="gloo", rank=0, world_size=1,
                  store_dir=str(tmp_path_factory.mktemp("store")),
                  device="cpu")
    yield m
    dist.destroy_process_group()
    if old is None:
        os.environ.pop("GLOO_SOCKET_IFNAME", None)
    else:
        os.environ["GLOO_SOCKET_IFNAME"] = old


@pytest.fixture(scope="module")
def jmesh():
    return jax.make_mesh((1,), ("data",),
                         axis_types=(jax.sharding.AxisType.Auto,),
                         devices=jax.devices()[:1])


# --------------------------------------------------------------------------
# cap ladder, plan keys, heuristics, candidates
# --------------------------------------------------------------------------

@pytest.mark.parametrize("args", [(2048, 8, 4, 2), (2048, 8, 1, 8),
                                  (4096, 64, 1, 2), (2048, 8, 4, 0),
                                  (4, 8, 4, 2), (1 << 24, 4, 1, 2),
                                  (1 << 24, 4, 4, 2), (100, 3, 2, 5)])
def test_cap_ladder_matches_jax(args):
    assert cap_ladder(*args) == jcap_ladder(*args)


def _keys(op, mesh, jmesh):
    """The port's and JAX's keys for one op's example arguments."""
    x = RNG.integers(-99, 99, 1000).astype(np.int32)
    if op == "sharded_sort":
        targs = (torch.from_numpy(x), mesh, "data")
        jargs = (jnp.asarray(x), jmesh, "data")
    elif op == "sharded_topk":
        targs = (torch.from_numpy(x), 5, mesh, "data")
        jargs = (jnp.asarray(x), 5, jmesh, "data")
    else:
        lg = RNG.standard_normal((24, 8)).astype(np.float32)
        targs = (torch.from_numpy(lg), 2, 7, mesh, "data")
        jargs = (jnp.asarray(lg), 2, 7, jmesh, "data")
    from repro.engine.api import infer_key as jinfer_key
    return TE.infer_key(op, *targs), jinfer_key(op, *jargs)


@pytest.mark.parametrize("op", ["sharded_sort", "sharded_topk",
                                "moe_route_ep"])
def test_plan_keys_match_jax(op, mesh, jmesh):
    tk, jk = _keys(op, mesh, jmesh)
    assert tk == jk
    assert tk[4] == 1 and tk[5] == "data"        # P and the axis
    assert tplanner._key_parse(tplanner._key_str(tk)) == tk


def test_plan_key_global_length_and_axis():
    k1 = tplanner.plan_key("sharded_sort", n=1 << 14, dtype=torch.int32,
                           backend="cuda", segments=4, axis="data")
    k2 = tplanner.plan_key("sharded_sort", n=1 << 14, dtype=torch.int32,
                           backend="cuda", segments=4, axis="model")
    k3 = tplanner.plan_key("sharded_sort", n=1 << 14, dtype=torch.int32,
                           backend="cuda", segments=8, axis="data")
    assert len({k1, k2, k3}) == 3
    assert tplanner._key_str(k1) == "sharded_sort|cuda|int32|n16384|s4|adata"


def test_sharded_plan_json_roundtrip(tmp_path):
    pl = tplanner.Planner()
    key = tplanner.plan_key("sharded_sort", n=1 << 15, dtype=torch.float32,
                            backend="cuda", segments=4, axis="data")
    plan = tplanner.Plan("tree_cuda", w=64, levels=2, splitter="regular",
                         cap_factor=8, retries=3)
    pl.put(key, plan)
    path = tmp_path / "plans.json"
    pl.save(str(path))
    fresh = tplanner.Planner()
    fresh.load(str(path))
    assert fresh.lookup(key) == plan
    # a table the JAX package wrote, read in the port's names
    jpl = jplanner.Planner()
    jkey = jplanner.plan_key("sharded_sort", n=1 << 15, dtype=jnp.float32,
                             backend="tpu", segments=4, axis="data")
    jpl.put(jkey, jplanner.Plan("tree_pallas", w=64, levels=2,
                                splitter="regular", cap_factor=8,
                                retries=3))
    jpath = tmp_path / "jax_plans.json"
    jpl.save(str(jpath))
    fresh = tplanner.Planner()
    fresh.load(str(jpath))
    assert fresh.lookup(key) == plan
    assert json.loads(jpath.read_text())["plans"]


@pytest.mark.parametrize("op", ["sharded_sort", "sharded_topk",
                                "moe_route_ep"])
def test_sharded_heuristics_and_candidates(op):
    for tb, jb in (("cpu", "cpu"), ("cuda", "tpu")):
        tk = tplanner.plan_key(op, n=1 << 14, dtype=torch.float32,
                               backend=tb, segments=4, axis="data")
        jk = jplanner.plan_key(op, n=1 << 14, dtype=np.float32, backend=jb,
                               segments=4, axis="data")
        tp, jp = tplanner.heuristic_plan(op, tk), \
            jplanner.heuristic_plan(op, jk)
        assert JAX_NAME[tp.variant] == jp.variant, (op, tb)
        assert (tp.levels, tp.w, tp.splitter, tp.cap_factor, tp.retries) \
            == (jp.levels, jp.w, jp.splitter, jp.cap_factor, jp.retries)
    cands = tplanner.candidate_plans(op, tk)
    assert {p.variant for p in cands} == set(TE.registry.variants(op))
    if op == "sharded_sort":
        jc = jplanner.candidate_plans(op, jk)
        assert sorted((JAX_NAME[p.variant], p.levels, p.splitter)
                      for p in cands) == sorted(
            (p.variant, p.levels, p.splitter) for p in jc)


# --------------------------------------------------------------------------
# the ops on a world of 1 against JAX on one device
# --------------------------------------------------------------------------

def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("payload", [False, True])
@pytest.mark.parametrize("splitter", ["regular", "hist"])
@pytest.mark.parametrize("variant", ["torch", "tree_vmapped"])
def test_sharded_sort_matches_jax(mesh, jmesh, variant, splitter, payload):
    x = RNG.integers(-50, 50, 512).astype(np.int32)
    if variant == "tree_vmapped":
        x = RNG.standard_normal(512).astype(np.float32)
    plan = dict(w=16, splitter=splitter)
    tpay = torch.arange(512, dtype=torch.int32) * 3 if payload else None
    jpay = jnp.arange(512, dtype=jnp.int32) * 3 if payload else None
    got = TE.sharded_sort(torch.from_numpy(x), mesh, payload=tpay,
                          plan=TE.Plan(variant, **plan))
    want = JE.sharded_sort(jnp.asarray(x), jmesh, payload=jpay,
                           plan=JE.Plan(JAX_NAME[variant], **plan))
    if payload:
        (got, gp), (want, wp) = got, want
        assert np.array_equal(gp.numpy(), np.asarray(wp))
    assert np.array_equal(_bits(got.values.numpy()), _bits(want.values))
    assert np.array_equal(got.count.numpy(), np.asarray(want.count))
    assert np.array_equal(got.overflow.numpy(), np.asarray(want.overflow))
    assert int(got.count[0]) == 512


@pytest.mark.parametrize("retries", [0, 2])
def test_sample_sort_matches_jax(mesh, jmesh, retries):
    from repro.core.distributed import sample_sort as jsample_sort
    from repro_torch.core.distributed import sample_sort
    x = RNG.integers(-9, 9, 256).astype(np.int32)
    got, gp = sample_sort(torch.from_numpy(x), mesh, w=8, retries=retries,
                          payload=torch.arange(256, dtype=torch.int32))
    want, wp = jsample_sort(jnp.asarray(x), jmesh, w=8, retries=retries,
                            payload=jnp.arange(256, dtype=jnp.int32))
    for g, w in ((got.values, want.values), (got.count, want.count),
                 (got.overflow, want.overflow), (gp, wp)):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("k", [1, 7, 300])
@pytest.mark.parametrize("variant", ["torch", "flims"])
def test_sharded_topk_matches_jax(mesh, jmesh, variant, k):
    x = RNG.integers(-20, 20, 300).astype(np.float32)
    pay = np.arange(300, dtype=np.int32) * 7
    v, i, p = TE.sharded_topk(torch.from_numpy(x), k, mesh,
                              payload=torch.from_numpy(pay), variant=variant)
    jv, ji, jp = JE.sharded_topk(jnp.asarray(x), k, jmesh,
                                 payload=jnp.asarray(pay),
                                 variant=JAX_NAME[variant])
    assert np.array_equal(_bits(v.numpy()), _bits(jv))
    assert np.array_equal(i.numpy(), np.asarray(ji))
    assert np.array_equal(p.numpy(), np.asarray(jp))


@pytest.mark.parametrize("cap", [1, 5, 64])
@pytest.mark.parametrize("variant", ["torch", "fused"])
def test_moe_route_ep_matches_jax(mesh, jmesh, variant, cap):
    lg = RNG.standard_normal((32, 8)).astype(np.float32)
    got = TE.moe_route_ep(torch.from_numpy(lg), 2, cap, mesh, "data",
                          variant=variant)
    want = JE.moe_route_ep(jnp.asarray(lg), 2, cap, jmesh, "data",
                           variant="xla")
    for f in got._fields:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        if f == "weights":
            d = np.abs(g.view(np.int32).astype(np.int64)
                       - w.view(np.int32).astype(np.int64)).max()
            assert d <= WEIGHT_ULPS, (f, d)
        else:
            assert np.array_equal(g.reshape(w.shape), w), f


def test_sharded_autotune_installs_plan(mesh):
    x = torch.from_numpy(RNG.integers(-999, 999, 1024).astype(np.int32))
    TE.clear_plans()
    try:
        plan = TE.autotune("sharded_sort", x, mesh, "data", repeats=1,
                           candidates=[TE.Plan("torch", splitter="hist"),
                                       TE.Plan("tree_vmapped", w=16)])
        assert plan.variant in ("torch", "tree_vmapped")
        key = TE.infer_key("sharded_sort", x, mesh, "data")
        assert TE.default_planner.lookup(key) == plan
        res = TE.sharded_sort(x, mesh)
        assert int(res.count[0]) == 1024
        assert torch.equal(res.values[:1024],
                           torch.sort(x, descending=True).values)
    finally:
        TE.clear_plans()


# --------------------------------------------------------------------------
# the mesh layer
# --------------------------------------------------------------------------

def test_production_mesh_names_the_world_it_needs(mesh):
    from repro_torch.launch.mesh import make_production_mesh
    with pytest.raises(ValueError, match="256"):
        make_production_mesh()
    with pytest.raises(ValueError, match="512"):
        make_production_mesh(multi_pod=True)


def _fake_mesh(sizes, axes, rank):
    from repro_torch.launch.mesh import Mesh
    return Mesh(axes, sizes, rank, {}, "gloo", torch.device("cpu"), 1.0)


def test_mesh_coords_row_major():
    m = _fake_mesh((2, 4), ("data", "model"), 6)
    assert m.coords == {"data": 1, "model": 2}
    assert m.axis_size("model") == 4 and m.size == 8


def test_collectives_on_one_rank(mesh):
    from repro_torch.parallel import comm
    x = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    with mesh:
        assert torch.equal(comm.all_to_all(x, "data"), x)
        assert torch.equal(comm.all_gather(x, "data"), x[None])
        assert torch.equal(comm.psum(x, "data"), x)
        assert torch.equal(comm.pmax(x, "data"), x)
        assert torch.equal(comm.broadcast(x, "data"), x)
        assert comm.axis_index("data") == 0 and comm.axis_size("data") == 1
    with pytest.raises(RuntimeError, match="no mesh"):
        comm.psum(x, "data")


def test_act_context_and_group_count():
    from repro_torch.parallel import act
    m = _fake_mesh((2, 4), ("data", "model"), 0)
    x = torch.ones(3)
    act.set_context(m)
    try:
        assert act.context_mesh() is m and act.model_axis() == "model"
        assert act.group_count(8) == 2 and act.group_count(3) == 1
        assert act.constrain(x, "dp") is x
        assert act.constrain_expert_hidden(x) is x
    finally:
        act.clear_context()
    assert act.context_mesh() is None and act.group_count(8) == 1


@pytest.mark.parametrize("rank", [0, 3])
def test_shard_params_for_rank_cuts_the_expert_band(rank):
    from repro_torch.models.convert import shard_params_for_rank
    L, E, d, f = 2, 8, 3, 5
    wi = torch.arange(L * E * d * f, dtype=torch.float32).reshape(L, E, d, f)
    params = {"embed": torch.ones(4, d),
              "blocks": {"moe": {"router": torch.ones(L, d, E), "wi": wi,
                                 "wg": wi + 1, "wo": wi.transpose(-1, -2)},
                         "attn": {"wq": torch.ones(L, d, d)}}}
    m = _fake_mesh((4,), ("model",), rank)
    got = shard_params_for_rank(params, m)
    band = slice(2 * rank, 2 * rank + 2)
    assert torch.equal(got["blocks"]["moe"]["wi"], wi[:, band])
    assert torch.equal(got["blocks"]["moe"]["wo"],
                       wi.transpose(-1, -2)[:, band])
    assert got["blocks"]["moe"]["router"] is params["blocks"]["moe"]["router"]
    assert got["embed"] is params["embed"]


def test_moe_apply_ep_without_context_is_grouped():
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config("moonshot_v1_16b_a3b").reduced()
    gen = torch.Generator().manual_seed(0)
    p = moe.moe_init(gen, cfg, device="cpu")
    x = torch.randn(2, 8, cfg.d_model, generator=gen)
    assert torch.equal(moe.moe_apply(p, x, cfg, mode="ep"),
                       moe.moe_apply_grouped(p, x, cfg))


def test_sharded_decode_on_one_rank_matches_unsharded(mesh):
    from repro_torch.configs import get_config
    from repro_torch.models.attention import attn_decode, attn_init
    cfg = get_config("qwen3_1p7b").reduced()
    gen = torch.Generator().manual_seed(1)
    p = attn_init(gen, cfg, device="cpu")
    B, W = 2, 32
    kc = torch.randn(B, W, cfg.n_kv_heads, cfg.hd, generator=gen)
    vc = torch.randn(B, W, cfg.n_kv_heads, cfg.hd, generator=gen)
    x = torch.randn(B, 1, cfg.d_model, generator=gen)
    pos = torch.tensor([5, 20])
    y1, (k1, v1) = attn_decode(p, x, (kc, vc), pos, cfg)
    y2, (k2, v2) = attn_decode(p, x, (kc, vc), pos, cfg, mesh=mesh,
                               kv_shard_axis="data")
    assert torch.equal(k1, k2) and torch.equal(v1, v2)
    assert float(torch.linalg.norm(y1 - y2) / torch.linalg.norm(y1)) \
        <= DECODE_RTOL


def test_decode_step_passes_the_mesh(mesh):
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_decode_step
    cfg = dataclasses.replace(get_config("qwen3_1p7b").reduced(), n_layers=2)
    model, step = make_decode_step(cfg, mesh=mesh, kv_shard_axis="data")
    params = model.init(torch.Generator().manual_seed(2), device="cpu")
    cache = model.init_cache(2, 16, device="cpu")
    tok = torch.tensor([3, 4], dtype=torch.int32)
    pos = torch.tensor([0, 0])
    l1, _ = model.decode_step(params, tok, pos, cache)
    l2, _ = model.decode_step(params, tok, pos, cache, mesh=mesh,
                              kv_shard_axis="data")
    assert float(torch.linalg.norm(l1 - l2) / torch.linalg.norm(l1)) \
        <= DECODE_RTOL
    nxt, _ = step(params, tok, pos, cache, torch.Generator().manual_seed(0))
    assert nxt.shape == (2,)
