"""The training half of the port's mesh layer on 8 gloo ranks on the CPU.

One spawn of 8 ranks (``torch.multiprocessing``, a ``FileStore``
rendezvous under the test's temporary directory, ``GLOO_SOCKET_IFNAME=lo``)
runs every case; one JAX subprocess on 8 forced host devices runs the
collective ones on the same inputs, and the JAX one-device train steps run
in this process meanwhile. Tolerances:

- ``make_train_step(cfg, tcfg, mesh)`` on a (2, 4) ``("data", "model")``
  mesh, 2 steps at global batch 8, seq 64, from the JAX init
  (``tests/test_distributed.py``'s set-up): ``qwen3_1p7b.reduced()`` and
  ``moonshot_v1_16b_a3b.reduced()`` (E 4: one expert a rank, through
  ``moe_apply_ep`` and its gradient). Every gathered leaf and the losses
  within ``JAX_TOL`` = 5e-3 of the JAX one-device step (the JAX package's
  own bound for its sharded step) and within ``PORT_TOL`` = 1e-5 of the
  port's one-process step; the loss bits equal on every rank. The first
  step's gradient (each leaf's optimizer-layout blocks, gathered) within
  ``PORT_TOL`` of the one-process ``loss_and_grads``, and every step's
  ``grad_norm`` within ``PORT_TOL`` relative of the one process's and
  ``JAX_TOL`` of JAX's: AdamW's update and the global clip cancel a
  constant factor on a leaf's gradient, so only these see a backward that
  sums where it should slice. The MoE capacity is cut per data shard on a
  mesh (as JAX's ``moe_apply_ep`` does), so the Moonlight step is held at
  1e-5 to the one-process step under an ``AbstractMesh`` of the same
  shape, whose MoE layer routes each data shard's rows as one group -- the
  same function -- and at 5e-3 to the plain one-process step and to JAX,
  whose one group drops other pairs;
- each differentiable collective's backward on the (2, 4) mesh, float64:
  ``all_gather_dim`` summing over ``data`` and over ``model`` and slicing
  along ``model``, ``psum_entry``, ``psum_exit``, ``ppermute`` (a shift
  that leaves one rank without a sender) and ``reduce_scatter``'s forward,
  each rank's gradient against autograd through the whole tensor, within
  ``COLL_TOL`` = 1e-12;
- ``MeshLayout.init``: every rank's blocks bit for bit its slice of the
  one-process init from the same generator;
- ``parallel.pipeline.gpipe`` (S 4, M 6, a float32 ``tanh(x @ W)`` stage)
  on a (2, 4) ``("rep", "stage")`` mesh: within 1e-5 of JAX ``gpipe``;
- ``optim.compress.compressed_psum_int8`` over a ``pod`` axis of 8, two
  rounds with the residual carried: each member's int8 payload and
  residual bit for bit JAX's, the mean within 1e-6 relative;
- ``CheckpointManager`` on meshes: a tree saved from 4 ranks restores onto
  8 and onto 2 bit for bit (worlds of those sizes made in turn in the same
  processes); a directory the JAX manager wrote restores onto the (2, 4)
  mesh as every rank's blocks, bit for bit;
- ``TrainLoop(mesh=)``: 3 steps and a checkpoint, then a fresh loop
  resuming to step 4: the losses bit for bit those of 4 uninterrupted
  steps.
"""
import os
import pickle
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
ARCHS = ("qwen3_1p7b", "moonshot_v1_16b_a3b")
BATCH, SEQ, STEPS = 8, 64, 2
JAX_TOL = 5e-3
PORT_TOL = 1e-5
GPIPE_TOL = 1e-5
MEAN_RTOL = 1e-6
GP_S, GP_M, GP_BM, GP_D = 4, 6, 8, 32
COLL_TOL = 1e-12
COLLECTIVES = ("gather_sum_data", "gather_sum_model", "gather_slice_model",
               "psum_entry", "psum_exit", "ppermute", "reduce_scatter")

JAX_PROG = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, {src!r})
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.optim.compress import _quant, compressed_psum_int8
    from repro.parallel.pipeline import gpipe
    inp = pickle.load(open(sys.argv[1], "rb"))
    auto = (jax.sharding.AxisType.Auto,)
    out = {{}}
    smesh = jax.make_mesh((4,), ("stage",), axis_types=auto,
                          devices=jax.devices()[:4])
    out["gp"] = np.asarray(gpipe(lambda w, x: jnp.tanh(x @ w),
                                 jnp.asarray(inp["gp_w"]),
                                 jnp.asarray(inp["gp_x"]), smesh))
    pmesh = jax.make_mesh((8,), ("pod",), axis_types=auto)

    def local(gw, gv, ew, ev):
        mean, ef = compressed_psum_int8({{"w": gw[0], "v": gv[0]}},
                                        {{"w": ew[0], "v": ev[0]}}, "pod")
        return (mean["w"][None], mean["v"][None], ef["w"][None],
                ef["v"][None])

    spec = P("pod")
    f = jax.jit(jax.shard_map(local, mesh=pmesh, in_specs=(spec,) * 4,
                              out_specs=(spec,) * 4, check_vma=False))
    ef = {{k: np.zeros_like(inp["cp_" + k][0]) for k in ("w", "v")}}
    for r in range(2):
        g = {{k: inp["cp_" + k][r] for k in ("w", "v")}}
        for k in ("w", "v"):
            out[f"cp{{r}}_q_{{k}}"] = np.stack([
                np.asarray(_quant(jnp.asarray(g[k][m] + ef[k][m]))[0])
                for m in range(8)])
        mw, mv, ew, ev = f(g["w"], g["v"], ef["w"], ef["v"])
        ef = {{"w": np.asarray(ew), "v": np.asarray(ev)}}
        out[f"cp{{r}}_mean_w"], out[f"cp{{r}}_mean_v"] = (np.asarray(mw),
                                                        np.asarray(mv))
        out[f"cp{{r}}_ef_w"], out[f"cp{{r}}_ef_v"] = ef["w"], ef["v"]
    np.savez(sys.argv[2], **out)
""")


# --------------------------------------------------------------------------
# the ranks
# --------------------------------------------------------------------------

def _cases(rank, inp, mesh, out):
    """The (2, 4) train steps and the seeded block init."""
    from repro_torch.configs import get_config
    from repro_torch.core.butterfly import tree_leaves
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.config import TrainConfig
    from repro_torch.models.convert import decoder_params_from_jax
    from repro_torch.parallel import act
    from repro_torch.parallel.sharding import gather_leaf, param_blocks
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        tcfg = TrainConfig(global_batch=BATCH, seq_len=SEQ, total_steps=10,
                           warmup_steps=2)
        _, step = make_train_step(cfg, tcfg, mesh)
        lay = step.layout
        params = param_blocks(decoder_params_from_jax(
            inp[arch]["params"], device="cpu"), lay.pspec, mesh)
        opt = lay.opt_init(params)
        losses, norms = [], []
        for s in range(STEPS):
            batch = lay.batch_block({
                k: torch.from_numpy(np.array(v)) for k, v in
                inp[arch]["batches"][s].items()})
            if s == 0:
                # the first step's gradient, each leaf's optimizer blocks
                # gathered whole
                with act.context(mesh, lay.sc.data_axes, lay.sc.model_axis):
                    _, _, grads = lay.loss_and_grads(params, batch)
                for lf, g in zip(lay.plans(params), grads):
                    g = gather_leaf(g, lf.ospec, mesh)
                    if rank == 0:
                        out[f"{arch}_g_{'/'.join(lf.path)}"] = g.numpy()
            params, opt, m = step(params, opt, batch)
            losses.append(m["loss"].reshape(1))
            norms.append(m["grad_norm"].reshape(1))
        out[f"{arch}_loss"] = torch.cat(losses).numpy()
        out[f"{arch}_grad_norm"] = torch.cat(norms).numpy()
        plans = lay.plans(params)
        leaves = [gather_leaf(b, lf.pspec, mesh)
                  for b, lf in zip(tree_leaves(params), plans)]
        if rank == 0:
            for lf, t in zip(plans, leaves):
                out[f"{arch}_p_{'/'.join(lf.path)}"] = t.numpy()
        if cfg.family == "moe":
            out[f"{arch}_band"] = np.array(
                [params["blocks"]["moe"]["wi"].shape[1]])
        # the seeded init, cut leaf by leaf, against the whole init
        model = lay.model
        blocks = lay.init(torch.Generator().manual_seed(5), device="cpu")
        whole = param_blocks(model.init(torch.Generator().manual_seed(5),
                                        device="cpu"), lay.pspec, mesh)
        out[f"{arch}_init_equal"] = np.array([all(
            torch.equal(a, b) for a, b in zip(tree_leaves(blocks),
                                              tree_leaves(whole)))])


def _collectives(mesh, out):
    """Each differentiable collective's gradient on this rank against
    autograd through the whole tensor, both in float64. Every rank draws
    the same seeded tensors: the whole leaf ``W``, each rank's own inputs
    ``X[r]`` and the loss weights ``C``; a rank of data index ``dr`` and
    model index ``mr`` works on ``C[dr]`` where its data shard's tokens
    differ, on ``C[mr]`` where its part of a split region does."""
    from repro_torch.parallel import comm
    rng = np.random.default_rng(31)
    f64 = lambda *shape: torch.from_numpy(rng.standard_normal(shape))
    W, X, C, R = f64(8, 6), f64(4, 5, 3), f64(4, 8, 6), f64(4, 3, 8)
    dr, mr = mesh.axis_index("data"), mesh.axis_index("model")

    def grad_of(f, x):
        x = x.clone().requires_grad_(True)
        y = f(x)
        return y, torch.autograd.grad(y.sum(), x)[0]

    def gather(axis, rule):
        P, me = mesh.axis_size(axis), mesh.axis_index(axis)
        n = W.shape[0] // P
        c = C[me] if rule == "sum" else C[dr]
        _, got = grad_of(lambda b: c * torch.tanh(
            comm.all_gather_dim(b, 0, axis, mesh, grad=rule)),
            W[me * n:(me + 1) * n])
        # the loss the axis's ranks make together: their own losses summed
        # where they saw other tokens, the one they share where they did not
        whole = sum(C[:P]) if rule == "sum" else c
        _, want = grad_of(lambda w: whole * torch.tanh(w), W)
        return got, want[me * n:(me + 1) * n]

    res = {"gather_sum_data": gather("data", "sum"),
           "gather_sum_model": gather("model", "sum"),
           "gather_slice_model": gather("model", "slice")}
    _, got = grad_of(lambda t: C[mr, :5, :3] * torch.sin(
        comm.psum_entry(t, "model", mesh)), X[0])
    _, want = grad_of(lambda t: sum(C[i, :5, :3] * torch.sin(t)
                                    for i in range(4)), X[0])
    res["psum_entry"] = (got, want)
    _, got = grad_of(lambda t: C[dr, :5, :3] * torch.tanh(
        comm.psum_exit(t * t, "model", mesh)), X[mr])
    _, want = grad_of(lambda t: C[dr, :5, :3] * torch.tanh(
        (t * t).sum(0)), X)
    res["psum_exit"] = (got, want[mr])
    perm = [(0, 1), (1, 2), (2, 3)]          # rank 0 receives nothing
    y, got = grad_of(lambda t: C[mr, :5, :3] * comm.ppermute(
        t, "model", perm, mesh) ** 2, X[mr])

    def shifted(t):
        ys = [torch.zeros_like(t[0])] + [t[s_] for s_ in range(3)]
        return torch.stack([C[i, :5, :3] * ys[i] ** 2 for i in range(4)])
    ref_y, want = grad_of(shifted, X)
    res["ppermute"] = (torch.cat([y.flatten(), got.flatten()]),
                       torch.cat([ref_y[mr].flatten(), want[mr].flatten()]))
    got = comm.reduce_scatter(R[mr] * (dr + 1), 1, "model", mesh)
    res["reduce_scatter"] = (got, (R * (dr + 1)).sum(0)[:, 2 * mr:2 * mr + 2])
    for name, (g, w) in res.items():
        out[f"coll_{name}"] = np.stack([g.detach().numpy().ravel(),
                                        w.detach().numpy().ravel()])


def _gpipe(inp, out):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.pipeline import gpipe
    mesh = make_mesh((2, GP_S), ("rep", "stage"), device="cpu")
    w, x = torch.from_numpy(inp["gp_w"]), torch.from_numpy(inp["gp_x"])
    out["gp"] = gpipe(lambda w_, x_: torch.tanh(x_ @ w_), w, x, mesh).numpy()
    seq = x
    for s in range(GP_S):
        seq = torch.tanh(seq @ w[s])
    out["gp_seq"] = seq.numpy()


def _compress(rank, inp, out):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.compress import (_quant, compressed_psum_int8,
                                            ef_state_init)
    mesh = make_mesh((WORLD,), ("pod",), device="cpu")
    ef = None
    for r in range(2):
        g = {k: torch.from_numpy(inp["cp_" + k][r][rank]) for k in "wv"}
        ef = ef_state_init(g) if ef is None else ef
        for k in "wv":
            out[f"cp{r}_q_{k}"] = _quant(g[k].float() + ef[k])[0].numpy()
        mean, ef = compressed_psum_int8(g, ef, "pod", mesh)
        for k in "wv":
            out[f"cp{r}_mean_{k}"] = mean[k].numpy()
            out[f"cp{r}_ef_{k}"] = ef[k].numpy()


def _jax_dir(inp, mesh, out):
    """The JAX-written (params, opt) restored onto the (2, 4) mesh."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.config import TrainConfig
    from repro_torch.parallel.sharding import shard_leaf
    cfg = get_config("qwen3_1p7b").reduced()
    lay = make_train_step(cfg, TrainConfig(global_batch=BATCH, seq_len=SEQ),
                          mesh)[1].layout
    params = lay.init(torch.Generator().manual_seed(0), device="cpu")
    like = (params, lay.opt_init(params))
    mgr = CheckpointManager(inp["jax_dir"], async_save=False)
    (p, o), _ = mgr.restore(1, like, (lay.param_shardings(),
                                      lay.opt_shardings()))
    ok = []
    wp = inp["jax_state"]
    for tree, got_tree in (("params", p), ("m", o.m), ("v", o.v),
                           ("master", o.master)):
        for name, got in _flatten(got_tree):
            lf = lay.by_path[tuple(name.split("/"))]
            spec = lf.pspec if tree == "params" else lf.ospec
            want = shard_leaf(torch.from_numpy(wp[tree][name]), spec, mesh)
            ok.append(torch.equal(got, want))
    ok.append(int(o.step) == int(wp["step"]))
    out["jax_dir_blocks_equal"] = np.array(ok)


def _train_loop(rank, mesh, d, out):
    """4 uninterrupted steps; 3 steps and a checkpoint, then a resume."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import TrainLoop
    from repro_torch.models.config import TrainConfig
    cfg = get_config("qwen3_1p7b").reduced()

    def loop(path, every):
        tcfg = TrainConfig(global_batch=BATCH, seq_len=SEQ, total_steps=4,
                           warmup_steps=2, checkpoint_every=every,
                           checkpoint_dir=path)
        return TrainLoop(cfg, tcfg, mesh=mesh)
    _, _, straight = loop(os.path.join(d, "straight"), 100).run(
        resume="no")
    first = loop(os.path.join(d, "resumed"), 3)
    _, _, a = first.run(resume="no", max_steps=3)
    again = loop(os.path.join(d, "resumed"), 3)
    _, _, b = again.run(resume="auto")
    out["loop_straight"] = np.array(straight)
    out["loop_resumed"] = np.array(a + b)
    out["loop_steps"] = np.array(first.ckpt.all_steps())


def _elastic(rank, d, out):
    """Worlds of 4, 8 and 2 in turn: save from 4 ranks, restore on 8, 2."""
    import torch.distributed as dist
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sharding import NamedSharding, shard_leaf
    tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8) - 20.5,
            "b": (torch.arange(48, dtype=torch.float32) / 7).to(
                torch.bfloat16).reshape(16, 3),
            "n": torch.arange(8, dtype=torch.int32)}
    specs = {"w": ("data", None), "b": ("data", None), "n": (None,)}
    ck = os.path.join(d, "elastic")
    dist.destroy_process_group()

    def world(n, tag):
        return make_mesh((n,), ("data",), backend="gloo", rank=rank,
                         world_size=n, store_dir=os.path.join(d, tag),
                         device="cpu", timeout_s=120.0)

    def shard(mesh):
        return {k: NamedSharding(mesh, s) for k, s in specs.items()}
    if rank < 4:
        m4 = world(4, "w4")
        blocks = {k: shard_leaf(v, specs[k], m4) for k, v in tree.items()}
        mgr = CheckpointManager(ck, async_save=True)
        mgr.save(5, blocks, {"next_step": 5}, shardings=shard(m4))
        mgr.wait()
        dist.destroy_process_group()
    for n in (WORLD, 2):
        if rank >= n:
            continue
        m = world(n, f"w{n}")
        like = {k: shard_leaf(torch.zeros_like(v), specs[k], m)
                for k, v in tree.items()}
        got, extra = CheckpointManager(ck).restore(5, like, shard(m))
        out[f"elastic_{n}"] = np.array(
            [torch.equal(got[k], shard_leaf(v, specs[k], m)) and
             got[k].dtype == v.dtype for k, v in tree.items()]
            + [extra["next_step"] == 5])
        dist.destroy_process_group()


def _rank(rank: int, d: str) -> None:
    """One rank: every case, its results to ``rank<r>.npz``; the elastic
    worlds last (they replace the world of 8)."""
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    torch.set_num_threads(1)
    sys.path.insert(0, os.path.join(REPO, "src"))
    out = {}
    try:
        from repro_torch.launch.mesh import make_mesh
        inp = pickle.load(open(os.path.join(d, "inputs.pkl"), "rb"))
        mesh = make_mesh((2, 4), ("data", "model"), backend="gloo",
                         rank=rank, world_size=WORLD,
                         store_dir=os.path.join(d, "store"), device="cpu",
                         timeout_s=120.0)
        t = {}
        for name, fn in (("steps", lambda: _cases(rank, inp, mesh, out)),
                         ("collectives", lambda: _collectives(mesh, out)),
                         ("gpipe", lambda: _gpipe(inp, out)),
                         ("compress", lambda: _compress(rank, inp, out)),
                         ("jax_dir", lambda: _jax_dir(inp, mesh, out)),
                         ("loop", lambda: _train_loop(rank, mesh, d, out)),
                         ("elastic", lambda: _elastic(rank, d, out))):
            t0 = time.perf_counter()
            fn()
            t[name] = time.perf_counter() - t0
        out["seconds"] = np.array([t[k] for k in sorted(t)])
        np.savez(os.path.join(d, f"rank{rank}.npz"), **out)
    except Exception:
        import traceback
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    sys.stdout.flush()
    os._exit(0)


# --------------------------------------------------------------------------
# the references, in this process
# --------------------------------------------------------------------------

def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _inputs(d):
    """JAX inits and batches of both configs, the gpipe and compressed-psum
    inputs, and a JAX-written checkpoint directory."""
    from repro.checkpoint import CheckpointManager as JCM
    from repro.configs import get_config as jget
    from repro.data.pipeline import SyntheticLM as JSyn
    from repro.optim.adamw import adamw_init as jinit
    rng = np.random.default_rng(25)
    inp = {}
    for arch in ARCHS:
        cfg = jget(arch).reduced()
        from repro.models.model import build_model
        params = build_model(cfg).init(jax.random.PRNGKey(0))
        data = JSyn(cfg.vocab_size, SEQ, BATCH)
        inp[arch] = {"params": _np_tree(params),
                     "batches": [_np_tree(data.batch(s))
                                 for s in range(STEPS)]}
    inp["gp_w"] = (rng.standard_normal((GP_S, GP_D, GP_D)) /
                   np.sqrt(GP_D)).astype(np.float32)
    inp["gp_x"] = rng.standard_normal((GP_M, GP_BM, GP_D)).astype(np.float32)
    inp["cp_w"] = rng.standard_normal((2, WORLD, 16, 32)).astype(np.float32)
    inp["cp_v"] = (rng.standard_normal((2, WORLD, 5, 3)) *
                   np.array([1e-3, 1.0, 40.0])).astype(np.float32)
    # a (params, opt) tree written by the JAX manager
    jd = os.path.join(d, "jax_ckpt")
    params = jax.tree.map(jnp.asarray, inp["qwen3_1p7b"]["params"])
    opt = jinit(params)
    opt = opt._replace(
        step=jnp.asarray(3, jnp.int32),
        m=jax.tree.map(lambda x: x + 0.25, opt.m),
        v=jax.tree.map(lambda x: x + 0.5, opt.v))
    JCM(jd, async_save=False).save(1, (params, opt), {"next_step": 1})
    flat = lambda t: {n: np.asarray(x) for n, x in _jax_named(t).items()}
    inp["jax_dir"] = jd
    inp["jax_state"] = {"params": flat(params), "m": flat(opt.m),
                        "v": flat(opt.v), "master": flat(opt.master),
                        "step": 3}
    return inp


def _jax_steps(inp, arch):
    from repro.configs import get_config as jget
    from repro.launch.steps import make_train_step
    from repro.models.config import TrainConfig
    from repro.optim.adamw import adamw_init
    cfg = jget(arch).reduced()
    tcfg = TrainConfig(global_batch=BATCH, seq_len=SEQ, total_steps=10,
                       warmup_steps=2)
    _, step = make_train_step(cfg, tcfg)
    params = jax.tree.map(jnp.asarray, inp[arch]["params"])
    opt = adamw_init(params)
    step = jax.jit(step)
    losses, norms = [], []
    for s in range(STEPS):
        params, opt, m = step(params, opt, jax.tree.map(
            jnp.asarray, inp[arch]["batches"][s]))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return np.array(losses), _np_tree(params), np.array(norms)


def _port_steps(inp, arch, per_shard: bool):
    """The port's one-process step: ``(losses, params, grad norms, the
    first step's gradient)``, the last two by leaf name. ``per_shard``:
    under an ``AbstractMesh`` of the mesh's shape, where the MoE layer
    routes each data shard's rows (half the batch) as one group, the
    mesh's capacity groups."""
    import contextlib
    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.configs import get_config
    from repro_torch.core.butterfly import tree_leaves
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.models.config import TrainConfig
    from repro_torch.models.convert import decoder_params_from_jax
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.parallel import act
    cfg = get_config(arch).reduced()
    tcfg = TrainConfig(global_batch=BATCH, seq_len=SEQ, total_steps=10,
                       warmup_steps=2)
    model, step = make_train_step(cfg, tcfg)
    params = decoder_params_from_jax(inp[arch]["params"], device="cpu")
    opt = adamw_init(params)
    losses, norms, grads = [], [], {}
    with (act.context(AbstractMesh((2, 4), ("data", "model")))
          if per_shard else contextlib.nullcontext()):
        for s in range(STEPS):
            batch = {k: torch.from_numpy(np.array(v)) for k, v in
                     inp[arch]["batches"][s].items()}
            if s == 0:
                _, _, g = loss_and_grads(model, params, batch)
                by_leaf = dict(zip(map(id, tree_leaves(params)), g))
                grads = {n: by_leaf[id(t)].numpy()
                         for n, t in _flatten(params)}
            params, opt, m = step(params, opt, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    return (np.array(losses), {n: t.numpy() for n, t in _flatten(params)},
            np.array(norms), grads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("train_mesh"))
    inp = _inputs(d)
    with open(os.path.join(d, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    jproc = subprocess.Popen(
        [sys.executable, "-c", JAX_PROG.format(src=os.path.join(REPO, "src")),
         os.path.join(d, "inputs.pkl"), os.path.join(d, "jax.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, d)) for r in range(WORLD)]
    for p in procs:
        p.start()
    refs = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for arch in ARCHS:
            refs[arch] = {"jax": _jax_steps(inp, arch),
                          "port": _port_steps(inp, arch, per_shard=False)}
            if arch == "moonshot_v1_16b_a3b":
                refs[arch]["port_per_shard"] = _port_steps(inp, arch,
                                                           per_shard=True)
    finally:
        torch.set_num_threads(threads)
    deadline = time.monotonic() + 300
    for p in procs:
        p.join(max(deadline - time.monotonic(), 1))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    try:
        _, err = jproc.communicate(timeout=max(deadline - time.monotonic(),
                                               1))
    except subprocess.TimeoutExpired:
        jproc.kill()
        raise
    assert not alive, f"ranks {[procs.index(p) for p in alive]} hung"
    assert [p.exitcode for p in procs] == [0] * WORLD, \
        f"rank exit codes {[p.exitcode for p in procs]}"
    assert jproc.returncode == 0, err[-3000:]
    ranks = [dict(np.load(os.path.join(d, f"rank{r}.npz")))
             for r in range(WORLD)]
    return inp, refs, dict(np.load(os.path.join(d, "jax.npz"))), ranks


# --------------------------------------------------------------------------
# the checks
# --------------------------------------------------------------------------

def _max_diff(mesh_params, ref):
    return max(float(np.max(np.abs(mesh_params[n].astype(np.float64) -
                                   np.asarray(r).astype(np.float64))))
               for n, r in ref.items())


def _mesh_params(ranks, arch):
    pre = f"{arch}_p_"
    return {k[len(pre):]: v for k, v in ranks[0].items()
            if k.startswith(pre)}


def _jax_named(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in p): x for p, x in flat}


def _one_process(refs, arch):
    """The port's one-process step computing the mesh's function."""
    return refs[arch]["port_per_shard" if arch == "moonshot_v1_16b_a3b"
                      else "port"]


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_step_matches_jax(runs, arch):
    _, refs, _, ranks = runs
    losses, params, norms = refs[arch]["jax"]
    got = ranks[0][f"{arch}_loss"]
    assert np.max(np.abs(got - losses)) < JAX_TOL, (got, losses)
    if arch == "qwen3_1p7b":
        # (Moonlight's mesh cuts capacity per data shard, JAX's one device
        # over the whole batch: other pairs drop, and the gradient's norm
        # differs by 1.5-3.5%, though the steps stay within the bound)
        gn = ranks[0][f"{arch}_grad_norm"]
        assert np.max(np.abs(gn - norms)) < JAX_TOL, (gn, norms)
    mp = _mesh_params(ranks, arch)
    named = _jax_named(params)
    assert set(mp) == set(named)
    assert _max_diff(mp, named) < JAX_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_gradient_matches_one_process(runs, arch):
    """The first step's gradient, leaf by leaf, and every step's global
    norm on every rank: a backward that sums where it should slice (or the
    reverse) scales a leaf's gradient by the axis size, which AdamW's
    update and the clip do not show."""
    _, refs, _, ranks = runs
    _, _, norms, grads = _one_process(refs, arch)
    pre = f"{arch}_g_"
    got = {k[len(pre):]: v for k, v in ranks[0].items() if k.startswith(pre)}
    assert set(got) == set(grads)
    bad = {n: float(np.max(np.abs(got[n] - g))) for n, g in grads.items()
           if not np.max(np.abs(got[n] - g)) <= PORT_TOL}
    assert not bad, bad
    for r in ranks:
        gn = r[f"{arch}_grad_norm"]
        assert np.max(np.abs(gn - norms) / norms) <= PORT_TOL, (gn, norms)


@pytest.mark.parametrize("name", COLLECTIVES)
def test_collective_backward_matches_whole_tensor_autograd(runs, name):
    _, _, _, ranks = runs
    for i, r in enumerate(ranks):
        got, want = r[f"coll_{name}"]
        assert np.max(np.abs(got - want)) <= COLL_TOL, (i, got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_step_matches_one_process(runs, arch):
    _, refs, _, ranks = runs
    losses, params, _, _ = _one_process(refs, arch)
    got = ranks[0][f"{arch}_loss"]
    assert np.max(np.abs(got - losses)) <= PORT_TOL, (got, losses)
    mp = _mesh_params(ranks, arch)
    assert set(mp) == set(params)
    assert _max_diff(mp, params) <= PORT_TOL
    # the loss bits, the same on every rank
    for r in ranks[1:]:
        assert np.array_equal(r[f"{arch}_loss"].view(np.int32),
                              got.view(np.int32))


def test_moonlight_mesh_step_near_the_one_group_step(runs):
    """The plain one-process step routes the whole batch as one group: its
    capacity cut drops other pairs than the mesh's per-shard groups, so
    the two differ, but within the JAX sharded step's own bound."""
    _, refs, _, ranks = runs
    arch = "moonshot_v1_16b_a3b"
    losses, params, _, _ = refs[arch]["port"]
    assert np.max(np.abs(ranks[0][f"{arch}_loss"] - losses)) < JAX_TOL
    assert _max_diff(_mesh_params(ranks, arch), params) < JAX_TOL
    # one expert a rank: expert parallelism ran on the model axis
    assert all(int(r[f"{arch}_band"][0]) == 1 for r in ranks)


@pytest.mark.parametrize("arch", ARCHS)
def test_seeded_block_init_is_the_whole_init_cut(runs, arch):
    _, _, _, ranks = runs
    assert all(bool(r[f"{arch}_init_equal"][0]) for r in ranks)


def test_gpipe_matches_jax(runs):
    _, _, jx, ranks = runs
    for r in ranks:
        assert np.max(np.abs(r["gp"] - jx["gp"])) <= GPIPE_TOL
        assert np.max(np.abs(r["gp"] - r["gp_seq"])) <= GPIPE_TOL


@pytest.mark.parametrize("rnd", [0, 1])
def test_compressed_psum_int8_matches_jax(runs, rnd):
    inp, _, jx, ranks = runs
    for m, r in enumerate(ranks):
        for k in "wv":
            assert np.array_equal(r[f"cp{rnd}_q_{k}"],
                                  jx[f"cp{rnd}_q_{k}"][m]), (m, k)
            assert np.array_equal(r[f"cp{rnd}_ef_{k}"].view(np.int32),
                                  jx[f"cp{rnd}_ef_{k}"][m].view(np.int32)), \
                (m, k)
            want = jx[f"cp{rnd}_mean_{k}"][m]
            err = np.max(np.abs(r[f"cp{rnd}_mean_{k}"] - want))
            assert err <= MEAN_RTOL * np.max(np.abs(want)), (m, k, err)
    # and within 1.5 quantisation steps of the float32 mean (the JAX
    # test's bound) in the first round
    if rnd == 0:
        g = inp["cp_w"][0]
        tol = np.abs(g).max(axis=(1, 2)).mean() / 127
        assert np.max(np.abs(ranks[0]["cp0_mean_w"] - g.mean(0))) \
            <= 1.5 * tol


def test_jax_written_dir_restores_onto_mesh(runs):
    _, _, _, ranks = runs
    for r in ranks:
        assert r["jax_dir_blocks_equal"].all()


@pytest.mark.parametrize("n", [WORLD, 2])
def test_elastic_restore_from_four_ranks(runs, n):
    _, _, _, ranks = runs
    for r in ranks[:n]:
        assert r[f"elastic_{n}"].all()


def test_train_loop_on_mesh_resumes_exactly(runs):
    _, _, _, ranks = runs
    for r in ranks:
        assert r["loop_straight"].shape == (4,)
        assert np.array_equal(r["loop_resumed"], r["loop_straight"])
        assert np.isfinite(r["loop_straight"]).all()
        assert list(r["loop_steps"]) == [3, 4]
