"""Parity of the port's training step with the JAX package's, on reduced
float32 configs.

The JAX side initialises a model from a key; ``models.convert`` carries its
parameters (``decoder_params_from_jax`` / ``encdec_params_from_jax``) and
its AdamW state (``opt_state_from_jax``) across bit for bit, and both
sides run the same numpy batch. Cases and tolerances:

- ``_chunked_ce`` over three chunks of 512 and ``train_loss`` of reduced
  Qwen3 and Whisper: ce and z-loss within rtol 2e-5 (only the order of
  float32 sums differs: the head's product, logsumexp, the chunk sums);
- one ``make_train_step`` step of reduced Qwen3-1.7B and of reduced
  Moonlight-16B-A3B (4 experts top-2, grouped routing through
  ``engine.moe_route``), from the state after one JAX step: the loss
  within rtol 2e-5, every gradient leaf within ``GRAD_REL_FROB`` = 1e-4
  relative Frobenius (float32 backward passes summed in other orders),
  ``grad_norm`` within rtol 1e-5, and the updated parameters and moments
  within ``UPDATE_TOL`` (Adam divides by sqrt(v): a gradient element near
  0 moves its update by a relative amount the float32 noise of the
  gradient sets, so the parameters are held to 5e-6 of their scale);
- ``lr_schedule`` at warm-up, mid and end, and ``adamw_update`` on a random
  tree with a bf16 leaf: rtol 1e-6 (float32 elementwise, the same order of
  operations; the bf16 leaf within one bf16 ulp);
- remat on against remat off: losses and gradients bit for bit (the same
  ops recomputed in the same order);
- ``sample_topk`` and the prefill / decode step factories.

The routing gradient is ``tests/test_torch_route_grad.py``'s; the trainer
end to end is ``tests/test_torch_system.py``'s.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import model as JMOD  # noqa: E402
from repro.models.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.butterfly import tree_leaves  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import model as TMOD  # noqa: E402
from repro_torch.models.config import TrainConfig  # noqa: E402
from repro_torch.models.convert import (decoder_params_from_jax,  # noqa: E402
                                        encdec_params_from_jax,
                                        opt_state_from_jax, tensor_from_numpy)
from repro_torch.optim import adamw as TA  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for this file's many small ops: under the
    parallel test run the default (a thread a core in each worker) spins
    against the other workers and ran the 60-step loop ~40x slower."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)

GRAD_REL_FROB = 1e-4
UPDATE_TOL = dict(rtol=5e-6, atol=5e-6)
LOSS_TOL = dict(rtol=2e-5, atol=0)
TRAIN = dict(lr=1e-3, warmup_steps=2, total_steps=10, weight_decay=0.1,
             grad_clip=1.0)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return tensor_from_numpy(x, "cpu")


def _rel_frob(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    den = np.linalg.norm(ref)
    return np.linalg.norm(got - ref) / (den if den else 1.0)


def _batch(cfg, B, S, seed):
    """A numpy batch: tokens, targets, a mask with zeros, and the frames of
    the encoder-decoder."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                 np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                 np.int32),
             "mask": (rng.random((B, S)) < 0.9).astype(np.float32)}
    if cfg.arch_kind == "encdec":
        batch["frames"] = (0.5 * rng.standard_normal(
            (B, 24, cfg.d_model))).astype(np.float32)
    return batch


def _port_params(cfg, jp):
    conv = (encdec_params_from_jax if cfg.arch_kind == "encdec"
            else decoder_params_from_jax)
    return conv(_np(jp), "cpu")


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# --------------------------------------------------------------------------
# the loss
# --------------------------------------------------------------------------

def test_chunked_ce_matches_jax():
    """Three chunks of 512 (S = 1536), a soft-capped head (Gemma-2's 30) and
    a mask with zeros."""
    jcfg = jget_config("gemma2_9b").reduced()
    cfg = get_config("gemma2_9b").reduced()
    rng = np.random.default_rng(5)
    B, S, d = 2, 1536, cfg.d_model
    emb = (0.2 * rng.standard_normal((cfg.vocab_size, d))).astype(np.float32)
    h = rng.standard_normal((B, S, d)).astype(np.float32)
    tg = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.8).astype(np.float32)
    jce, jz = JMOD._chunked_ce({"embed": jnp.asarray(emb)}, jnp.asarray(h),
                               jnp.asarray(tg), jnp.asarray(mask), jcfg)
    ce, z = TMOD._chunked_ce({"embed": _t(emb)}, _t(h), _t(tg), _t(mask), cfg)
    np.testing.assert_allclose(float(ce), float(jce), **LOSS_TOL)
    np.testing.assert_allclose(float(z), float(jz), **LOSS_TOL)


@pytest.mark.parametrize("arch", ["qwen3_1p7b", "whisper_large_v3"])
def test_train_loss_matches_jax(arch):
    jcfg = jget_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jm, tm = JMOD.build_model(jcfg), TMOD.build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(1))
    batch = _batch(cfg, 2, 40, seed=7)
    jl, jaux = jm.train_loss(jp, jax.tree.map(jnp.asarray, batch))
    tl, taux = tm.train_loss(_port_params(cfg, jp), _tb(batch))
    np.testing.assert_allclose(float(tl), float(jl), **LOSS_TOL)
    np.testing.assert_allclose(float(taux["ce"]), float(jaux["ce"]),
                               **LOSS_TOL)


# --------------------------------------------------------------------------
# one training step against the JAX step
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["qwen3_1p7b", "moonshot_v1_16b_a3b"])
def step_case(request):
    """The JAX state after one train step, the gradients and the outputs
    of the second step on a second batch: computed once."""
    arch = request.param
    jcfg = jget_config(arch).reduced()
    cfg = get_config(arch).reduced()
    tcfg = dict(TRAIN, global_batch=2, seq_len=48)
    jmodel, jstep = JS.make_train_step(jcfg, JTrainConfig(**tcfg))
    jstep = jax.jit(jstep)
    jp = jmodel.init(jax.random.PRNGKey(2))
    jo = JA.adamw_init(jp)
    b0, b1 = _batch(cfg, 2, 48, seed=11), _batch(cfg, 2, 48, seed=12)
    jp, jo, _ = jstep(jp, jo, jax.tree.map(jnp.asarray, b0))
    jb1 = jax.tree.map(jnp.asarray, b1)
    (jl, _), jg = jax.value_and_grad(jmodel.train_loss, has_aux=True)(
        jp, jb1)
    p_np, o_np = _np(jp), _np(jo)
    jp2, jo2, jmet = jstep(jp, jo, jb1)
    return dict(cfg=cfg, tcfg=TrainConfig(**tcfg), p_np=p_np, o_np=o_np,
                batch=b1, loss=float(jl), grads=_np(jg), p2=_np(jp2),
                o2=_np(jo2), metrics=_np(jmet))


def test_train_step_gradients_match_jax(step_case):
    c = step_case
    model = TMOD.build_model(c["cfg"])
    params = _port_params(c["cfg"], c["p_np"])
    loss, aux, grads = TS.loss_and_grads(model, params, _tb(c["batch"]))
    np.testing.assert_allclose(float(loss), c["loss"], **LOSS_TOL)
    jg = jax.tree.leaves(c["grads"])      # the same order: sorted keys
    assert len(grads) == len(jg)
    worst = max(_rel_frob(g.numpy(), r) for g, r in zip(grads, jg))
    assert worst <= GRAD_REL_FROB, worst
    assert not any(p.requires_grad for p in tree_leaves(params))


def test_train_step_update_matches_jax(step_case):
    c = step_case
    _, step = TS.make_train_step(c["cfg"], c["tcfg"])
    params = _port_params(c["cfg"], c["p_np"])
    opt = opt_state_from_jax(c["o_np"], "cpu")
    assert int(opt.step) == 1
    params, opt, met = step(params, opt, _tb(c["batch"]))
    jm = c["metrics"]
    np.testing.assert_allclose(float(met["loss"]), float(jm["loss"]),
                               **LOSS_TOL)
    np.testing.assert_allclose(float(met["ce"]), float(jm["ce"]), **LOSS_TOL)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    np.testing.assert_allclose(float(met["lr"]), float(jm["lr"]), rtol=1e-7)
    assert int(opt.step) == int(c["o2"].step) == 2
    for got, ref in ((params, c["p2"]), (opt.m, c["o2"].m),
                     (opt.master, c["o2"].master)):
        for g, r in zip(tree_leaves(got), jax.tree.leaves(ref)):
            np.testing.assert_allclose(g.numpy(), r, **UPDATE_TOL)
    for g, r in zip(tree_leaves(opt.v), jax.tree.leaves(c["o2"].v)):
        assert _rel_frob(g.numpy(), r) <= 2 * GRAD_REL_FROB


# --------------------------------------------------------------------------
# the optimizer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 3, 50, 99, 150])
def test_lr_schedule_matches_jax(step):
    got = TA.lr_schedule(torch.tensor(step, dtype=torch.int32), 3e-4, 10, 100)
    ref = JA.lr_schedule(jnp.int32(step), 3e-4, 10, 100)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_adamw_update_matches_jax():
    rng = np.random.default_rng(3)
    shapes = {"w": (7, 5), "b": (5,), "deep": {"u": (3, 4, 2)}}
    mk = lambda s: rng.standard_normal(s).astype(np.float32)
    params = jax.tree.map(lambda s: jnp.asarray(mk(s)), shapes,
                          is_leaf=lambda x: isinstance(x, tuple))
    params["h"] = jnp.asarray(mk((6,)), jnp.bfloat16)
    grads = jax.tree.map(lambda p: jnp.asarray(3 * mk(p.shape), p.dtype),
                         params)
    state = JA.adamw_init(params)
    kw = dict(lr=jnp.float32(1e-2), b1=0.9, b2=0.95, weight_decay=0.1,
              grad_clip=1.0)
    jp, js, _ = JA.adamw_update(grads, state, params, **kw)  # moments != 0
    jp2, js2, jm = JA.adamw_update(grads, js, jp, **kw)
    tp = decoder_params_from_jax(_np(jp), "cpu")
    ts = opt_state_from_jax(_np(js), "cpu")
    tg = decoder_params_from_jax(_np(grads), "cpu")
    kw["lr"] = torch.tensor(1e-2)
    tp2, ts2, tm = TA.adamw_update(tg, ts, tp, **kw)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-6)
    for got, ref in ((tp2, jp2), (ts2.m, js2.m), (ts2.v, js2.v),
                     (ts2.master, js2.master)):
        for g, r in zip(tree_leaves(got), jax.tree.leaves(_np(ref))):
            if g.dtype == torch.bfloat16:
                g, r = g.float().numpy(), np.asarray(r, np.float32)
                np.testing.assert_allclose(g, r, rtol=2 ** -7)
            else:
                np.testing.assert_allclose(g.numpy(), r, rtol=1e-6,
                                           atol=1e-7)
    assert int(ts2.step) == 2 and tp2["h"].dtype == torch.bfloat16


def test_clip_by_global_norm_matches_jax():
    rng = np.random.default_rng(4)
    tree = {"a": rng.standard_normal((5, 3)).astype(np.float32),
            "b": 4 * rng.standard_normal(9).astype(np.float32)}
    jc, jn = JA.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), 1.0)
    tc, tn = TA.clip_by_global_norm({k: _t(v) for k, v in tree.items()},
                                    1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for k in tree:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=1e-6)


# --------------------------------------------------------------------------
# remat
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["moonshot_v1_16b_a3b", "whisper_large_v3",
                                  "zamba2_2p7b", "gemma2_9b"])
def test_remat_gradients_equal(arch):
    base = get_config(arch).reduced()
    batch = _tb(_batch(base, 2, 40, seed=21))
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(base, remat=remat)
        model = TMOD.build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        out.append(TS.loss_and_grads(model, params, batch))
    (l0, _, g0), (l1, _, g1) = out
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_sample_topk_and_decode_step():
    """``sample_topk``: greedy is the argmax (ties to the lower id), a draw
    stays inside the top k; ``make_decode_step`` / ``make_prefill_step``
    run a reduced model."""
    rng = np.random.default_rng(6)
    logits = torch.from_numpy(rng.standard_normal((4, 300)).astype(
        np.float32))
    logits[1, 7] = logits[1, 9] = logits[1].max() + 1
    gen = torch.Generator().manual_seed(0)
    for use_flims in (None, True, False):
        greedy = TMOD.sample_topk(gen, logits, k=8, temperature=0.0,
                                  use_flims=use_flims)
        assert greedy.dtype == torch.int32
        assert greedy.tolist() == torch.argmax(logits, -1).tolist()
        drawn = TMOD.sample_topk(gen, logits, k=5, use_flims=use_flims)
        top5 = torch.topk(logits, 5).indices
        assert all(int(d) in top5[i].tolist() for i, d in enumerate(drawn))
    cfg = get_config("qwen3_1p7b").reduced()
    model, decode = TS.make_decode_step(cfg)
    _, prefill = TS.make_prefill_step(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 6), generator=gen,
                         dtype=torch.int32)
    last = prefill(params, {"tokens": toks})
    assert last.shape == (2, cfg.vocab_size)
    cache = model.init_cache(2, 8, device="cpu")
    nxt, cache = decode(params, toks[:, 0], torch.zeros(2, dtype=torch.int32),
                        cache, gen)
    assert nxt.shape == (2,) and ((nxt >= 0) & (nxt < cfg.vocab_size)).all()


