"""Parity of the port's encoder-decoder (Whisper) with the JAX package's,
on the reduced float32 ``whisper_large_v3`` config (2 encoder and 4
decoder layers, d 128) and the JAX package's own weights, carried across
by ``models.convert.encdec_params_from_jax``.

Seeded frame embeddings (the audio front end is a stub on both sides) and
tokens go through ``encode``, ``decode_train`` (teacher forcing with cross
attention), ``prefill`` (the last logits and the cross caches it fills),
and 6 ``decode_step`` calls from the prefilled cache; each against JAX
within rtol 1e-4 / atol 1e-4: only the order of float32 sums differs. The
port's own invariant beside them: token-by-token decode from an empty
self-attention cache equals ``decode_train``, within 2e-3.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import encdec as JED  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.models.transformer import lm_logits as jlm_logits  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.butterfly import tree_leaves  # noqa: E402
from repro_torch.models import encdec as TED  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.convert import encdec_params_from_jax  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
INVARIANT_TOL = dict(rtol=2e-3, atol=2e-3)
B, T_ENC, S, STEPS, MAX_SEQ = 2, 24, 5, 6, 16


@pytest.fixture(scope="module")
def ref():
    """The JAX model's weights (numpy), seeded inputs, and its encoder
    states, teacher-forced logits, prefill logits and cache, and the
    logits of 6 decode steps after the prefill: computed once."""
    rng = np.random.default_rng(23)
    jcfg = jget_config("whisper_large_v3").reduced()
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    frames = (0.5 * rng.standard_normal((B, T_ENC, jcfg.d_model))).astype(
        np.float32)
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    steps = rng.integers(0, jcfg.vocab_size, (B, STEPS)).astype(np.int32)
    enc = JED.encode(jp, jnp.array(frames), jcfg)
    h = JED.decode_train(jp, enc, jnp.array(toks), jcfg)
    batch = {"frames": jnp.array(frames), "tokens": jnp.array(toks)}
    pre, pre_cache = jm.prefill(jp, batch, MAX_SEQ)
    cache = pre_cache
    step = jax.jit(jm.decode_step)
    dec = []
    for t in range(STEPS):
        logits, cache = step(jp, jnp.array(steps[:, t]),
                             jnp.full((B,), S + t, jnp.int32), cache)
        dec.append(np.asarray(logits))
    return dict(p_np=jax.tree.map(np.asarray, jp), frames=frames, toks=toks,
                steps=steps, enc=np.asarray(enc),
                train=np.asarray(jlm_logits(jp, h, jcfg)),
                prefill=np.asarray(pre),
                cache=jax.tree.map(np.asarray, pre_cache), dec=dec)


@pytest.fixture(scope="module")
def port(ref):
    cfg = get_config("whisper_large_v3").reduced()
    return (cfg, build_model(cfg), encdec_params_from_jax(ref["p_np"],
                                                          "cpu"))


def _batch(ref):
    return {"frames": torch.from_numpy(ref["frames"]),
            "tokens": torch.from_numpy(ref["toks"])}


def test_params_carry_over_bit_for_bit(ref, port):
    cfg, model, params = port
    flat = jax.tree_util.tree_flatten_with_path(ref["p_np"])[0]
    for path, leaf in flat:
        t = params
        for k in path:
            t = t[k.key]
        np.testing.assert_array_equal(t.numpy(), leaf)
    assert len(flat) == len(tree_leaves(params))
    assert params["enc_blocks"]["attn_norm"].shape[0] == \
        cfg.n_encoder_layers == 2
    assert params["dec_blocks"]["self_norm"].shape[0] == cfg.n_layers == 4
    with pytest.raises(ValueError, match="enc_blocks"):
        encdec_params_from_jax({"embed": ref["p_np"]["embed"]}, "cpu")


def test_init_shapes_match_jax(ref, port):
    cfg, model, _ = port
    params = model.init(torch.Generator().manual_seed(0))
    flat = jax.tree_util.tree_flatten_with_path(ref["p_np"])[0]
    for path, leaf in flat:
        t = params
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).replace("torch.", "") == str(leaf.dtype), path
    assert len(flat) == len(tree_leaves(params))


def test_encode_and_decode_train_match_jax(ref, port):
    cfg, model, params = port
    enc = TED.encode(params, torch.from_numpy(ref["frames"]), cfg)
    np.testing.assert_allclose(enc.numpy(), ref["enc"], **TOL)
    h = TED.decode_train(params, enc, torch.from_numpy(ref["toks"]), cfg)
    np.testing.assert_allclose(TT.lm_logits(params, h, cfg).numpy(),
                               ref["train"], **TOL)
    h = model.forward(params, _batch(ref))
    np.testing.assert_allclose(TT.lm_logits(params, h, cfg).numpy(),
                               ref["train"], **TOL)


def test_prefill_matches_jax(ref, port):
    """The last logits, and the cache: cross keys / values (L, B, T, K,
    hd) projected from the encoder states, self caches zeros."""
    cfg, model, params = port
    logits, cache = model.prefill(params, _batch(ref), MAX_SEQ)
    np.testing.assert_allclose(logits.numpy(), ref["prefill"], **TOL)
    assert cache["cross"][0].shape == (cfg.n_layers, B, T_ENC,
                                       cfg.n_kv_heads, cfg.hd)
    for part in ("self", "cross"):
        for got, exp in zip(cache[part], ref["cache"][part]):
            assert tuple(got.shape) == exp.shape
            np.testing.assert_allclose(got.numpy(), exp, **TOL)
    assert all(int(t.abs().sum()) == 0 for t in cache["self"])


def test_decode_steps_match_jax(ref, port):
    cfg, model, params = port
    _, cache = model.prefill(params, _batch(ref), MAX_SEQ)
    for t in range(STEPS):
        logits, cache = model.decode_step(
            params, torch.from_numpy(ref["steps"][:, t]),
            torch.full((B,), S + t, dtype=torch.int32), cache)
        assert logits.shape == (B, cfg.vocab_size)
        np.testing.assert_allclose(logits.numpy(), ref["dec"][t],
                                   err_msg=f"step {t}", **TOL)


def test_decode_matches_decode_train(ref, port):
    """Token by token from position 0, over the filled cross caches, the
    logits equal the teacher-forced decoder's."""
    cfg, model, params = port
    _, cache = model.prefill(params, _batch(ref), MAX_SEQ)
    cache = {"self": model.init_cache(B, MAX_SEQ, enc_len=T_ENC,
                                      device="cpu")["self"],
             "cross": cache["cross"]}
    toks = torch.from_numpy(ref["toks"])
    for t in range(S):
        logits, cache = model.decode_step(
            params, toks[:, t], torch.full((B,), t, dtype=torch.int32),
            cache)
        np.testing.assert_allclose(logits.numpy(), ref["train"][:, t],
                                   err_msg=f"step {t}", **INVARIANT_TOL)
