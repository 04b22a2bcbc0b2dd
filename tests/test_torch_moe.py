"""Parity of the port's MoE routing (K7) and MoE layer with the JAX package.

``moe_route``: the port's ``torch`` reference (``moe_route_torch``) and the
kernel's plain version (``moe_route_plain``, what K7's wrapper runs on a
CPU tensor) against JAX's ``moe_route_xla`` and ``moe_route_pallas`` (in
interpret mode) over ``tests/test_moe_route.py``'s SHAPES, tied (heavy ties
and +0.0/-0.0) and untied. Then ``engine.moe_route`` (2-D logits,
``values=``, argument checks, obs), and the MoE layer ``moe_apply`` on the
dense, sorted and grouped paths of reduced float32 configs, with the JAX
package's weights carried across by ``models.convert.moe_params_from_jax``.

Tolerances:
- experts, tokens, perm, slabs and keep: exact (bit for bit);
- weights: at most ``WEIGHT_ULPS`` = 4 units in the last place of float32.
  Each weight is ``exp(v - max) / sum(exp)``: XLA's CPU ``exp`` and torch's
  may each round differently by an ulp, and for k >= 3 the k-term sum is
  taken in another order, so the quotient can move by a few ulps (3 is the
  largest seen over these shapes). A bf16 weight would miss by ~2^15 ulps;
- the layer output (float32): |port - JAX| <= 1e-5 * max|JAX| + 1e-6. The
  routing is identical, the products are float32 in both, and only the
  order of the float32 sums differs (einsum contraction, the combine).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.kernels.route_fuse import moe_route_pallas, moe_route_xla  # noqa: E402,E501
from repro.models import moe as JM  # noqa: E402
from repro_torch import engine as TE  # noqa: E402
from repro_torch import kernels as TK  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import route_fuse as TR  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models.convert import moe_params_from_jax  # noqa: E402

WEIGHT_ULPS = 4
LANES = ("experts", "tokens", "perm", "weights", "slabs", "keep")

SHAPES = [
    # (G, T, E, k, cap), as tests/test_moe_route.py
    (1, 64, 8, 2, 10),
    (2, 64, 8, 2, 10),
    (1, 100, 6, 3, 5),      # non-pow2 T*k and E
    (1, 16, 4, 1, 2),       # k=1
    (3, 33, 5, 2, 1),       # cap=1: every expert keeps exactly one pair
    (1, 32, 8, 4, 1000),    # cap >= T*k: nothing dropped
    (2, 128, 16, 6, 20),    # moonshot-shaped top-6
]


def _logits(G, T, E, seed=0, tied=False):
    rng = np.random.default_rng(seed)
    lg = rng.standard_normal((G, T, E)).astype(np.float32)
    if tied:
        lg = np.round(lg * 2) / 2
        lg[lg == 0.0] = np.where(rng.random((lg == 0.0).sum()) < 0.5,
                                 -0.0, 0.0)
    return lg


def ulps(a, b):
    a = np.asarray(a).view(np.int32).astype(np.int64)
    b = np.asarray(b).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


def check_route(got, ref, what):
    for name, g, r in zip(LANES, got, ref):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        r = np.asarray(r)
        assert g.shape == r.shape, (what, name, g.shape, r.shape)
        if name == "weights":
            assert ulps(g, r) <= WEIGHT_ULPS, (what, ulps(g, r))
        else:
            np.testing.assert_array_equal(g, r.astype(g.dtype),
                                          err_msg=f"{what}: {name}")


@pytest.fixture(autouse=True)
def clean_state():
    TE.clear_plans()
    obs.disable()
    obs.reset()
    yield
    TE.clear_plans()
    obs.disable()
    obs.reset()


@pytest.mark.parametrize("G,T,E,k,cap", SHAPES)
@pytest.mark.parametrize("tied", [False, True])
def test_route_matches_jax(G, T, E, k, cap, tied):
    lg = _logits(G, T, E, seed=G * T + E + k, tied=tied)
    refs = {"xla": moe_route_xla(jnp.asarray(lg), k, cap),
            "fused": moe_route_pallas(jnp.asarray(lg), k, cap)}
    for name, fn in (("torch", TR.moe_route_torch),
                     ("plain", TR.moe_route_plain),
                     ("wrapper", TR.moe_route)):
        got = fn(torch.from_numpy(lg), k, cap)
        for rname, ref in refs.items():
            check_route(got, ref, f"{name} vs {rname}")


# logits whose monotone int32 key is INT32_MIN: the float bits 0xFFFFFFFF
INT_MIN_BITS = np.int32(-1)


def int_min_logits(G, T, E, per_row, seed):
    """Random logits with ``per_row`` entries of each row set to the bits
    0xFFFFFFFF (a negative NaN with a full payload), at random experts."""
    rng = np.random.default_rng(seed)
    lg = rng.standard_normal((G, T, E)).astype(np.float32)
    bits = lg.view(np.int32)
    for g in range(G):
        for t in range(T):
            bits[g, t, rng.choice(E, per_row, replace=False)] = INT_MIN_BITS
    return lg


# (G, T, E, k, cap, INT32_MIN keys a row): the four-expert row of the
# repair, then rows with several such experts and k up to E
INT_MIN_CASES = [(1, 1, 4, 4, 8, None), (2, 16, 8, 6, 5, 3),
                 (1, 24, 8, 8, 7, 5), (3, 9, 5, 5, 2, 4), (1, 32, 16, 6, 9, 12)]


def check_route_nan(got, ref, what):
    """``check_route`` where a weight may be NaN: NaN at the same places,
    the others within WEIGHT_ULPS."""
    for name, g, r in zip(LANES, got, ref):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        r = np.asarray(r)
        assert g.shape == r.shape, (what, name, g.shape, r.shape)
        if name == "weights":
            nan = np.isnan(g)
            np.testing.assert_array_equal(nan, np.isnan(r),
                                          err_msg=f"{what}: NaN weights")
            assert ulps(g[~nan], r[~nan]) <= WEIGHT_ULPS, what
        else:
            np.testing.assert_array_equal(g, r.astype(g.dtype),
                                          err_msg=f"{what}: {name}")


@pytest.mark.parametrize("G,T,E,k,cap,per_row", INT_MIN_CASES)
def test_route_int_min_logits_match_jax(G, T, E, k, cap, per_row):
    """Logits whose monotone key is INT32_MIN. ``_topk_softmax`` masks a
    picked expert's key to INT32_MIN and takes the lowest index among the
    maximum, so once every expert not yet picked reads INT32_MIN it picks
    expert 0 again (the row ``[1.0, 0xFFFFFFFF, 2.0, 0xFFFFFFFF]`` at k = 4
    gives the experts ``[0, 0, 0, 2]``); ``moe_route_plain`` (K7's plain
    version, what the CUDA kernel is held to) must do the same. The XLA
    pipeline ``moe_route_xla`` (``lax.top_k``), and so the port's ``torch``
    variant, never picks an expert twice and gives ``[0, 1, 2, 3]`` there:
    a property of the reference, so ``test_route_matches_jax`` keeps inputs
    without these keys."""
    if per_row is None:
        lg = np.array([[[1.0, 0.0, 2.0, 0.0]]], np.float32)
        lg.view(np.int32)[0, 0, [1, 3]] = INT_MIN_BITS
    else:
        lg = int_min_logits(G, T, E, per_row, seed=G * T + E + k)
    ref = moe_route_pallas(jnp.asarray(lg), k, cap)
    for name, fn in (("plain", TR.moe_route_plain), ("wrapper", TR.moe_route)):
        check_route_nan(fn(torch.from_numpy(lg), k, cap), ref,
                        f"{name} vs fused")
    if per_row is None:
        np.testing.assert_array_equal(np.asarray(ref[0])[0], [0, 0, 0, 2])
        np.testing.assert_array_equal(
            TR.moe_route_torch(torch.from_numpy(lg), k, cap)[0][0].numpy(),
            [0, 1, 2, 3])


def test_topk_softmax_is_lax_top_k():
    lg = _logits(1, 50, 7, seed=3, tied=True)[0]
    w, idx = TR.topk_softmax(torch.from_numpy(lg), 3)
    jv, ji = jax.lax.top_k(jnp.asarray(lg), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    assert ulps(w.numpy(), jax.nn.softmax(jv, axis=-1)) <= WEIGHT_ULPS


def test_engine_moe_route_2d_values_and_checks():
    lg = _logits(1, 40, 6, seed=5)[0]
    tok = np.arange(40, dtype=np.int32) * 3
    for v in ("fused", "torch"):
        r = TE.moe_route(lg, 2, 9, variant=v, device="cpu")
        assert isinstance(r, TE.RouteResult) and r.keep.dtype == torch.bool
        ref = moe_route_xla(jnp.asarray(lg[None]), 2, 9)
        check_route(tuple(x[None] for x in r[:5]) + (r.keep[None].int(),),
                    ref, v)
        r2, routed = TE.moe_route(lg, 2, 9, values=tok, variant=v,
                                  device="cpu")
        assert torch.equal(routed, torch.from_numpy(tok)[r2.tokens.long()])
    with pytest.raises(ValueError):
        TE.moe_route(lg, 7, 9, device="cpu")               # k > E
    with pytest.raises(ValueError):
        TE.moe_route(lg, 2, 0, device="cpu")               # capacity < 1
    with pytest.raises(ValueError):
        TE.moe_route(lg[None, None], 2, 9, device="cpu")   # 4-D


def test_engine_moe_route_obs_and_planning():
    lg = _logits(2, 33, 5, seed=9)
    obs.enable()
    r = TE.moe_route(lg, 2, 1, device="cpu")
    snap = obs.snapshot()
    ev = [e for e in snap["events"] if e["kind"] == "moe.route"]
    assert ev and ev[-1]["data"]["variant"] == "torch"
    assert ev[-1]["data"]["n_pairs"] == 2 * 33 * 2
    assert snap["counters"]["moe.dropped_tokens"] == \
        int((~r.keep).sum())
    obs.disable()
    TK.reset_launches()
    TE.moe_route(lg, 2, 1, variant="fused", device="cpu")
    assert TK.launch_counts() == {}


def test_moe_route_guards():
    with pytest.raises(TK.KernelError, match="overflows int32"):
        TR.moe_route_plain(torch.zeros(1, 4, 2 ** 29), 1, 1)


# --------------------------------------------------------------------------
# the MoE layer, float32, weights from the JAX package
# --------------------------------------------------------------------------

def _layer_pair(name, E, k, B=2, S=64):
    jcfg = jget_config(name).reduced(n_experts=E, n_experts_active=k)
    tcfg = get_config(name).reduced(n_experts=E, n_experts_active=k)
    assert jcfg.param_dtype == tcfg.param_dtype == "float32"
    jp = JM.moe_init(jax.random.PRNGKey(0), jcfg)
    tp = moe_params_from_jax({n: np.asarray(v) for n, v in jp.items()},
                             device="cpu")
    x = np.random.default_rng(E + k).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


def close(j, t):
    j = np.asarray(j)
    t = t.numpy()
    assert j.shape == t.shape
    tol = 1e-5 * np.abs(j).max() + 1e-6
    assert np.abs(j - t).max() <= tol, (np.abs(j - t).max(), tol)


@pytest.mark.parametrize("name,E,k", [("mixtral_8x22b", 8, 2),
                                      ("moonshot_v1_16b_a3b", 16, 6)])
@pytest.mark.parametrize("mode", ["dense", "sorted", "grouped", "ep"])
def test_moe_apply_matches_jax(name, E, k, mode):
    jcfg, tcfg, jp, tp, x = _layer_pair(name, E, k)
    close(JM.moe_apply(jp, jnp.asarray(x), jcfg, mode=mode),
          TM.moe_apply(tp, torch.from_numpy(x), tcfg, mode=mode))


def test_moe_grouped_chunks_and_capacity():
    """Several sequence chunks, a capacity that drops pairs, and one large
    enough that nothing drops, where grouped equals dense."""
    jcfg, tcfg, jp, tp, x = _layer_pair("mixtral_8x22b", 8, 2, B=2, S=128)
    for cf in (0.5, 4.0):
        close(JM.moe_apply_grouped(jp, jnp.asarray(x), jcfg,
                                   capacity_factor=cf, seq_chunk=32),
              TM.moe_apply_grouped(tp, torch.from_numpy(x), tcfg,
                                   capacity_factor=cf, seq_chunk=32))
    xt = torch.from_numpy(x)
    dense = TM.moe_apply_dense(tp, xt, tcfg)
    grouped = TM.moe_apply_grouped(tp, xt, tcfg, capacity_factor=4.0,
                                   seq_chunk=32)
    close(dense.numpy(), grouped)
    assert TM.expert_capacity(1.25, 2048, 2, 8) == 641


def test_moe_params_from_jax_bf16_bits():
    """bf16 weights cross as bits: numpy's ml_dtypes bf16 through uint16."""
    cfg = jget_config("mixtral_8x22b").reduced(
        n_experts=4, n_experts_active=2, param_dtype="bfloat16")
    jp = JM.moe_init(jax.random.PRNGKey(1), cfg)
    p_np = {n: np.asarray(v) for n, v in jp.items()}
    assert p_np["wi"].dtype.name == "bfloat16"
    tp = moe_params_from_jax(p_np, device="cpu")
    assert tp["wi"].dtype == torch.bfloat16 and tp["router"].dtype == \
        torch.float32
    for n in ("wi", "wg", "wo"):
        np.testing.assert_array_equal(tp[n].view(torch.int16).numpy(),
                                      p_np[n].view(np.int16))
    np.testing.assert_array_equal(tp["router"].numpy(), p_np["router"])


def test_moe_init_shapes_and_configs():
    cfg = get_config("moonshot-v1-16b-a3b")
    assert (cfg.d_model, cfg.moe_d_ff, cfg.n_experts,
            cfg.n_experts_active) == (2048, 1408, 64, 6)
    small = cfg.reduced(n_experts=8, n_experts_active=2)
    p = TM.moe_init(torch.Generator().manual_seed(0), small, device="cpu")
    assert p["wi"].shape == (8, small.d_model, small.moe_d_ff)
    assert p["wo"].shape == (8, small.moe_d_ff, small.d_model)
    assert p["router"].dtype == torch.float32
