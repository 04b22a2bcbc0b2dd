"""Parity of the port's samplers with the JAX package's, on the CPU.

``repro_torch.serve.sampler`` (``prefix_keep_mask``, ``sorted_prefix_sample``,
``RaggedSampler``, ``SamplingState``) and ``engine.sample_topp`` /
``sample_minp`` against ``repro.serve.sampler`` and the JAX engine. Logits
are numpy arrays from a seeded generator (normal, and heavy ties). The
Gumbel noise ``u`` is drawn on the JAX side (``jax.random.uniform(key,
shape, minval=1e-9, maxval=1.0)``, what the JAX sampler draws) and injected
into the port, since torch's generator cannot give threefry's bits.

Tolerance. The sorted values, indices and scaled logits ``z`` are equal bit
for bit. The softmax probabilities ``p`` are held to a relative
``(V + 4) * 2**-24`` and their exclusive prefix sums to an absolute
``(2 V + 4) * 2**-24``, V the prefix width: both sides compute exp(z - max)
over its sum, with XLA's and torch's ``exp`` (each within 2 ulps) and a
V-term float32 sum in two orders (each within ``(V - 1) * 2**-24`` relative
of the exact sum), then the division's rounding; the prefix sums add V
roundings more. So a keep mask, and then a token id, may differ where a
candidate sits within that bound of the cut. Where a mask differs, the test
asserts that the JAX side's prefix sum (top-p) or probability (min-p) lies
within the bound of the cut; token ids are compared bit for bit on every row
whose mask agrees.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import engine as JE  # noqa: E402
from repro.serve import sampler as JS  # noqa: E402
from repro.serve.request import SamplingParams  # noqa: E402
from repro_torch import engine as TE  # noqa: E402
from repro_torch.engine.api import infer_key  # noqa: E402
from repro_torch.engine.planner import heuristic_plan, plan_key  # noqa: E402
from repro_torch.serve import sampler as TS  # noqa: E402

RNG = np.random.default_rng(53)
EPS = 2.0 ** -24


def logits_of(B, V, kind):
    if kind == "ties":
        return (RNG.integers(0, 8, (B, V)) * 0.5).astype(np.float32)
    return (RNG.standard_normal((B, V)) * 2.0).astype(np.float32)


def uniform(seed, shape):
    return np.array(jax.random.uniform(jax.random.PRNGKey(seed), shape,
                                       minval=1e-9, maxval=1.0))


def states(B):
    """(JAX state, port state) pairs: nucleus, min-p, and mixed rows."""
    def both(**kw):
        return JS.SamplingState.full(B, **kw), TS.SamplingState.full(B, **kw)
    mixed_j, mixed_t = both(top_p=0.9)
    for slot, p in ((0, SamplingParams(temperature=0.0)),
                    (1, SamplingParams(top_k=5, top_p=0.8)),
                    (2, SamplingParams(temperature=0.6, min_p=0.05)),
                    (3, SamplingParams(temperature=1.7, top_k=3))):
        mixed_j, mixed_t = mixed_j.set_row(slot, p), mixed_t.set_row(slot, p)
    return {"topp": both(top_p=0.6), "minp": both(min_p=0.05),
            "mixed": (mixed_j, mixed_t)}


def check_masks(svals, sj, st):
    """Bitwise z, p and the prefix sums within the bound, and every mask
    difference within the bound of its cut. Returns the rows whose masks
    agree."""
    kj, zj = JS.prefix_keep_mask(jnp.array(svals), sj)
    kt, zt = TS.prefix_keep_mask(torch.from_numpy(svals), st)
    zj, kj, kt = np.asarray(zj), np.asarray(kj), kt.numpy()
    np.testing.assert_array_equal(zj.view(np.int32), zt.numpy().view(np.int32))
    V = svals.shape[1]
    pj = np.asarray(jax.nn.softmax(jnp.array(zj), axis=-1))
    cj = np.asarray(jnp.cumsum(jnp.array(pj), axis=-1)) - pj
    pt, ct = (x.numpy() for x in TS.prefix_probs(zt))
    p_rel, c_abs = (V + 4) * EPS, (2 * V + 4) * EPS
    assert (np.abs(pt - pj) <= p_rel * pj).all()
    assert (np.abs(ct - cj) <= c_abs).all()
    for b, i in zip(*np.nonzero(kj != kt)):
        top_p, min_p = float(sj.top_p[b]), float(sj.min_p[b])
        near_p = top_p < 1.0 and abs(cj[b, i] - top_p) <= c_abs
        near_m = abs(pj[b, i] - min_p * pj[b, 0]) <= \
            p_rel * (pj[b, i] + min_p * pj[b, 0])
        assert near_p or near_m, (b, i, cj[b, i], pj[b, i])
    agree = (kj == kt).all(axis=1)
    assert agree.sum() * 2 >= agree.size, "most rows' masks agree"
    return agree


@pytest.mark.parametrize("kind", ["normal", "ties"])
@pytest.mark.parametrize("which", ["topp", "minp", "mixed"])
def test_sorted_prefix_sample_matches_jax(kind, which):
    """The keep mask and the token ids over a sorted prefix, the JAX side's
    noise injected."""
    B, K = 6, 300
    lg = logits_of(B, K, kind)
    perm = np.argsort(-lg, axis=1, kind="stable").astype(np.int32)
    svals = np.take_along_axis(lg, perm, axis=1)
    sj, st = states(B)[which]
    agree = check_masks(svals, sj, st)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        got = TS.sorted_prefix_sample(None, torch.from_numpy(svals),
                                      torch.from_numpy(perm), st,
                                      u=torch.from_numpy(uniform(seed,
                                                                 (B, K))))
        exp = np.asarray(JS.sorted_prefix_sample(key, jnp.array(svals),
                                                 jnp.array(perm), sj))
        np.testing.assert_array_equal(exp[agree], got.numpy()[agree])


@pytest.mark.parametrize("op", ["sample_topp", "sample_minp"])
@pytest.mark.parametrize("variant", ["flims", "torch"])
@pytest.mark.parametrize("kind", ["normal", "ties"])
def test_engine_sampling_matches_jax(op, variant, kind):
    """Both port variants against the JAX ``flims`` variant: the same
    permutation, the same masks up to the bound, the same ids."""
    B, V = 6, 300
    lg = logits_of(B, V, kind)
    knob = 0.5 if op == "sample_topp" else 0.1
    perm = np.argsort(-lg, axis=1, kind="stable")
    svals = np.take_along_axis(lg, perm, axis=1)
    full = dict(top_p=knob) if op == "sample_topp" else dict(min_p=knob)
    agree = check_masks(svals, JS.SamplingState.full(B, **full),
                        TS.SamplingState.full(B, **full))
    for seed in range(3):
        exp = np.asarray(getattr(JE, op)(jax.random.PRNGKey(seed),
                                         jnp.array(lg), knob,
                                         variant="flims"))
        got = getattr(TE, op)(None, lg, knob, variant=variant,
                              u=torch.from_numpy(uniform(seed, (B, V))),
                              device="cpu")
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(exp[agree], got.numpy()[agree])


def test_1d_promotion_validation_and_generator():
    lg = logits_of(1, 65, "normal")[0]
    u = uniform(0, (1, 65))
    exp = JE.sample_topp(jax.random.PRNGKey(0), jnp.array(lg), 0.8)
    got = TE.sample_topp(None, lg, 0.8, u=torch.from_numpy(u[0]),
                         device="cpu")
    assert got.shape == () and got.dtype == torch.int32
    assert int(got) == int(exp)
    for bad in (0.0, -0.1, 1.5):
        with pytest.raises(ValueError):
            TE.sample_topp(None, lg, bad, device="cpu")
        with pytest.raises(ValueError):
            TE.sample_minp(None, lg, bad, device="cpu")
    with pytest.raises(ValueError):
        TE.sample_topp(None, np.zeros((2, 2, 2), np.float32), 0.5,
                       device="cpu")
    # one generator seed, one draw: the variants agree
    L = torch.from_numpy(logits_of(4, 257, "ties"))
    ids = [TE.sample_topp(torch.Generator().manual_seed(7), L, 0.9,
                          variant=v) for v in ("flims", "torch")]
    assert torch.equal(ids[0], ids[1])
    greedy = TE.sample_minp(None, L, 0.5, temperature=0.0, variant="flims")
    assert torch.equal(greedy.long(), torch.argmax(L, -1))


def test_plan_keys_and_heuristics():
    lg = torch.zeros((4, 1000))
    assert infer_key("sample_topp", lg) == plan_key(
        "sample_topp", n=1000, dtype=torch.float32, backend="cpu")
    for op in ("topk", "sample_topp", "sample_minp"):
        for dtype in (torch.float32, torch.int32, torch.bfloat16,
                      torch.float16, torch.int16, torch.int8):
            cpu = plan_key(op, n=1024, dtype=dtype, backend="cpu")
            assert heuristic_plan(op, cpu).variant == "torch"
            card = plan_key(op, n=1024, dtype=dtype, backend="cuda")
            assert heuristic_plan(op, card).variant == "flims"
        # 64-bit keys: no kernel takes them
        other = plan_key(op, n=1024, dtype=torch.int64, backend="cuda")
        assert heuristic_plan(op, other).variant == "torch"


@pytest.mark.parametrize("variant", ["flims", "torch"])
def test_ragged_sampler_matches_jax(variant, monkeypatch):
    """One ``engine.topk`` call a step, and the JAX sampler's ids, on heavy
    ties (the stable tie order must survive the batch) and normal logits."""
    import repro_torch.engine as engine_mod
    calls = []
    orig = engine_mod.topk

    def counting(*a, **k):
        calls.append(k.get("variant"))
        return orig(*a, **k)
    monkeypatch.setattr(engine_mod, "topk", counting)
    B, V, K = 8, 512, 16
    for kind in ("ties", "normal"):
        lg = logits_of(B, V, kind)
        sj, st = states(B)["mixed"]
        exp = np.asarray(JS.RaggedSampler(K, "flims").sample(
            jax.random.PRNGKey(3), jnp.array(lg), sj))
        calls.clear()
        got = TS.RaggedSampler(K, variant).sample(
            None, torch.from_numpy(lg), st,
            u=torch.from_numpy(uniform(3, (B, K))))
        assert calls == [variant]
        jv, ji = JE.topk(jnp.array(lg), K, variant="flims")
        agree = check_masks(np.asarray(jv), sj, st)
        np.testing.assert_array_equal(exp[agree], got.numpy()[agree])


def test_ragged_sampler_per_slot_params_and_greedy():
    """Greedy, top-k 1, a tiny nucleus and a min-p near 1 are all argmax;
    ``set_row`` leaves the state it copies unchanged."""
    B, V = 4, 256
    lg = torch.from_numpy(logits_of(B, V, "normal"))
    base = TS.SamplingState.full(B)
    state = base.set_row(0, SamplingParams(temperature=0.0))
    state = state.set_row(1, SamplingParams(top_k=1))
    state = state.set_row(2, SamplingParams(top_p=1e-9))
    state = state.set_row(3, SamplingParams(min_p=0.999999))
    assert float(base.temperature[0]) == 1.0
    toks = TS.RaggedSampler(32).sample(torch.Generator().manual_seed(6), lg,
                                       state)
    assert torch.equal(toks.long(), torch.argmax(lg, -1))
    svals = torch.tensor([[3.0, 2.0, 1.0], [9.0, 9.0, 0.0]])
    sidx = torch.tensor([[7, 8, 9], [4, 5, 6]], dtype=torch.int32)
    out = TS.sorted_prefix_sample(None, svals, sidx,
                                  TS.SamplingState.full(2, temperature=0.0))
    assert out.tolist() == [7, 4]
    with pytest.raises(ValueError):
        TS.RaggedSampler(0)
