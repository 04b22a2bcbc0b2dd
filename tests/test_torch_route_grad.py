"""The gradient of the port's MoE routing against JAX's.

``moe_route`` and ``moe_route_plain`` are one ``torch.autograd.Function``
(K7 on the card, its plain version on the CPU) whose backward maps the
weights lane's gradient to the (G, T, E) logits. On the CPU:

- ``moe_route_plain``, the wrapper (the plain version here) and the
  ``torch`` route against ``jax.grad`` of ``moe_route_xla``'s weights lane
  over ``tests/test_moe_route.py``'s shapes: rtol 1e-5 / atol 1e-7 (the
  softmax's gradient ``w * (g - sum w g)`` in float32 on both sides, the
  weights themselves within a few ulps);
- logits whose monotone key is INT32_MIN, where the fused rule picks an
  expert again: against ``jax.grad`` of the softmax over the fused rule's
  picks (NaN at the same logits, 0 where nothing was picked);
- ``route_backward`` on finite lanes that pick one expert two and three
  times: against the JAX gradient of a softmax over gathered logits,
  every pair's share added.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.route_fuse import moe_route_pallas, moe_route_xla  # noqa: E402,E501
from repro_torch.kernels import route_fuse as TR  # noqa: E402

INT_MIN_BITS = np.int32(-1)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


ROUTE_GRAD = [(1, 64, 8, 2, 10), (2, 33, 5, 2, 1), (2, 128, 16, 6, 20),
              (1, 32, 8, 4, 1000)]


def _route_grad_port(fn, lg, k, cap, g_w):
    x = torch.from_numpy(lg).requires_grad_(True)
    out = fn(x, k, cap)
    gx, = torch.autograd.grad((out[3] * torch.from_numpy(g_w)).sum(), x)
    return gx.numpy(), out


@pytest.mark.parametrize("G,T,E,k,cap", ROUTE_GRAD)
def test_route_gradient_matches_jax(G, T, E, k, cap):
    rng = np.random.default_rng(G * T + E)
    lg = rng.standard_normal((G, T, E)).astype(np.float32)
    g_w = rng.standard_normal((G, T * k)).astype(np.float32)
    ref = jax.grad(lambda x: jnp.sum(moe_route_xla(x, k, cap)[3] * g_w))(
        jnp.asarray(lg))
    for fn in (TR.moe_route_plain, TR.moe_route, TR.moe_route_torch):
        got, _ = _route_grad_port(fn, lg, k, cap, g_w)
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5,
                                   atol=1e-7, err_msg=fn.__name__)


@pytest.mark.parametrize("G,T,E,k,cap,per_row",
                         [(1, 1, 4, 4, 8, None), (2, 16, 8, 6, 5, 3),
                          (1, 24, 8, 8, 7, 5)])
def test_route_gradient_int_min_logits(G, T, E, k, cap, per_row):
    """Logits whose monotone key is INT32_MIN (the bits 0xFFFFFFFF): the
    fused rule picks expert 0 again once every unpicked key reads INT32_MIN,
    and such a repeated pick's value is those bits, a NaN. The reference is
    ``jax.grad`` of the softmax over the fused rule's picks
    (``moe_route_pallas``' lanes in interpret mode, un-sorted by ``perm``):
    a first pick gathers its logit, a repeated one is the NaN constant. NaN
    at the same logits, 0 where nothing was picked, the rest within rtol
    1e-5."""
    rng = np.random.default_rng(G * T + E + k)
    lg = rng.standard_normal((G, T, E)).astype(np.float32)
    if per_row is None:
        lg = np.array([[[1.0, 0.0, 2.0, 0.0]]], np.float32)
        lg.view(np.int32)[0, 0, [1, 3]] = INT_MIN_BITS
    else:
        for g in range(G):
            for t in range(T):
                lg.view(np.int32)[g, t, rng.choice(E, per_row,
                                                   replace=False)] = \
                    INT_MIN_BITS
    g_w = rng.standard_normal((G, T * k)).astype(np.float32)
    e_s, _, perm, *_ = (np.asarray(x) for x in moe_route_pallas(
        jnp.asarray(lg), k, cap))
    idx = np.empty_like(e_s)
    np.put_along_axis(idx, perm, e_s, axis=-1)          # (G, T*k) by t*k+j
    g_tk = np.empty_like(g_w)
    np.put_along_axis(g_tk, perm, g_w, axis=-1)
    idx, g_tk = idx.reshape(G, T, k), g_tk.reshape(G, T, k)

    repeat = np.zeros(idx.shape, bool)
    for j in range(1, k):
        repeat[..., j] = (idx[..., :j] == idx[..., j:j + 1]).any(-1)
    nan = np.array(INT_MIN_BITS).view(np.float32)

    def fused_weights(x):
        vals = jnp.take_along_axis(x, jnp.asarray(idx), -1)
        return jax.nn.softmax(jnp.where(repeat, nan, vals), axis=-1)

    ref = np.asarray(jax.grad(lambda x: jnp.sum(fused_weights(x) * g_tk))(
        jnp.asarray(lg)))
    got, out = _route_grad_port(TR.moe_route_plain, lg, k, cap, g_w)
    np.testing.assert_array_equal(out[0].numpy(), e_s)
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(ref),
                               rtol=1e-5, atol=1e-7)
    picked = np.zeros(lg.shape, bool)
    np.put_along_axis(picked, idx, True, axis=-1)
    assert (got[~picked] == 0).all()
    if per_row is None:
        np.testing.assert_array_equal(e_s[0], [0, 0, 0, 2])


def test_route_backward_adds_an_expert_picked_twice():
    """``route_backward`` on finite lanes where token 0 picks expert 1 twice
    and token 1 picks expert 3 three times: the scatter adds every pair's
    share, as the JAX gradient of a softmax over gathered logits does."""
    rng = np.random.default_rng(9)
    G, T, E, k = 1, 3, 5, 3
    lg = rng.standard_normal((G, T, E)).astype(np.float32)
    idx = np.array([[[1, 4, 1], [3, 3, 3], [0, 2, 4]]], np.int32)
    g_tk = rng.standard_normal((G, T, k)).astype(np.float32)

    def weights(x):
        return jax.nn.softmax(jnp.take_along_axis(x, jnp.asarray(idx), -1),
                              axis=-1)

    ref = jax.grad(lambda x: jnp.sum(weights(x) * g_tk))(jnp.asarray(lg))
    w_tk = np.asarray(weights(jnp.asarray(lg)))
    # the lanes in sorted pair order (expert, then position t*k + j)
    flat_e = idx.reshape(G, T * k)
    perm = np.argsort(flat_e, axis=-1, kind="stable").astype(np.int32)
    take = lambda a: np.take_along_axis(a.reshape(G, T * k), perm, -1)
    got = TR.route_backward(_t(take(g_tk)), _t(take(flat_e)), _t(perm),
                            _t(take(w_tk)), (G, T, E), k)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-7)
