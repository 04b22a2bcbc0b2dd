"""Parity of the port's decoder stack with the JAX package's, on reduced
float32 configs and the JAX package's own weights.

The JAX side builds ``repro.models.model.build_model(cfg)``, initialises it
from a key and decodes seeded tokens; ``models.convert.
decoder_params_from_jax`` carries its parameter tree across bit for bit, and
the port decodes the same tokens. Cases:

- ``decode_step`` logits, step by step: reduced Moonlight-16B-A3B (64 -> 4
  experts, top-2, the ``ep`` path, which runs ``grouped`` on one device on
  both sides, so every decode step routes through ``engine.moe_route``),
  reduced Mixtral-8x22B with ``sliding_window=8`` over 20 steps, so the
  rolling buffer wraps twice, reduced Zamba2 (12 Mamba2 layers, the shared
  attention block at two applications), xLSTM (two groups of 7 mLSTM and
  1 sLSTM), Gemma-2-9B with ``sliding_window=8`` over 20 steps (the local
  buffer wraps, the global one does not), Qwen1.5-110B (QKV bias) and
  InternVL2 (a 16-patch vision prefix in ``forward`` / ``prefill``);
  within rtol 1e-4 / atol 1e-4. The routing is the same on both sides
  (lanes bit for bit, ``tests/test_torch_moe.py``), and only the order of
  float32 sums differs (matrix products, the streaming softmax, the MoE
  combine, the SSD and mLSTM einsums);
- ``forward`` and ``prefill`` logits of the same configs, within the same
  bound;
- the port's own invariants, as ``tests/test_models.py`` holds the JAX
  package's: token-by-token decode equals the teacher-forced forward
  (Qwen3 dense with qk-norm and GQA; Mixtral's and Gemma-2's rolling
  windows; Zamba2; xLSTM), within the JAX test's 2e-3; the Mamba2 and
  mLSTM chunked scans do not depend on the chunk (1e-4) and equal their
  decode steps (1e-3), and so does the sLSTM loop; every architecture
  decodes three greedy steps to finite logits;
- the layers (rmsnorm, layernorm, RoPE, SwiGLU / GeGLU, soft cap) against
  the JAX functions, within 1e-6;
- routing at the decode step's shapes: ``moe_route`` at (1, 8, 64) and
  (1, 1, 64), k 6, capacity 1 (``expert_capacity(1.25, 8, 6, 64)``), where
  most of a step's pairs drop: the port's ``torch`` variant and K7's plain
  version against JAX ``moe_route_xla`` and ``moe_route_pallas`` in
  interpret mode, every lane bit for bit and the weights within
  ``WEIGHT_ULPS`` (``tests/test_torch_moe.py``'s bound).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.kernels.route_fuse import moe_route_pallas, moe_route_xla  # noqa: E402,E501
from repro.models import layers as JL  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.models.transformer import lm_logits as jlm_logits  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.core.butterfly import tree_leaves  # noqa: E402
from repro_torch.kernels import route_fuse as TR  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models import xlstm as TX  # noqa: E402
from repro_torch.models.convert import decoder_params_from_jax  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
INVARIANT_TOL = dict(rtol=2e-3, atol=2e-3)
WEIGHT_ULPS = 4
RNG = np.random.default_rng(17)

CASES = {
    # name: (config, kwargs of reduced(), batch, steps)
    "moonlight": ("moonshot_v1_16b_a3b", {}, 3, 6),
    "mixtral_swa": ("mixtral_8x22b", dict(sliding_window=8, n_experts=2,
                                          n_experts_active=1), 1, 20),
    "zamba2": ("zamba2_2p7b", {}, 2, 8),
    "xlstm": ("xlstm_1p3b", {}, 2, 8),
    "gemma2_swa": ("gemma2_9b", dict(sliding_window=8), 1, 20),
    "qwen1p5": ("qwen1p5_110b", {}, 2, 6),
    "internvl2": ("internvl2_76b", {}, 2, 6),
}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(case, lib):
    """The forward batch: the tokens, and the vision prefix where the
    config has one (InternVL2), as ``lib`` (torch or jnp) arrays."""
    conv = torch.from_numpy if lib is torch else jnp.array
    batch = {"tokens": conv(case["toks"])}
    if case["vision"] is not None:
        batch["vision"] = conv(case["vision"])
    return batch


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """The JAX model, its weights (numpy), seeded tokens (and vision
    prefix), the JAX decode logits of every step and the JAX forward
    logits: computed once."""
    arch, kw, B, S = CASES[request.param]
    jcfg = jget_config(arch).reduced(**kw)
    cfg = get_config(arch).reduced(**kw)
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    toks = RNG.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    vision = (0.5 * RNG.standard_normal((B, cfg.n_vision_tokens,
                                         cfg.d_model)).astype(np.float32)
              if cfg.n_vision_tokens else None)
    cache = jm.init_cache(B, S)
    step = jax.jit(jm.decode_step)
    steps = []
    for t in range(S):
        logits, cache = step(jp, jnp.array(toks[:, t]),
                             jnp.full((B,), t, jnp.int32), cache)
        steps.append(np.asarray(logits))
    out = dict(name=request.param, cfg=cfg, p_np=_np_tree(jp), toks=toks,
               vision=vision, steps=steps)
    h = jm.forward(jp, _batch(out, jnp))
    out["fwd"] = np.asarray(jlm_logits(jp, h, jcfg))
    return out


def test_decode_step_matches_jax(case):
    cfg, toks = case["cfg"], case["toks"]
    B, S = toks.shape
    model = build_model(cfg)
    params = decoder_params_from_jax(case["p_np"], "cpu")
    cache = model.init_cache(B, S, device="cpu")
    for t in range(S):
        logits, cache = model.decode_step(
            params, torch.from_numpy(toks[:, t]),
            torch.full((B,), t, dtype=torch.int32), cache)
        assert logits.dtype == torch.float32 and logits.shape == (
            B, cfg.vocab_size)
        np.testing.assert_allclose(logits.numpy(), case["steps"][t],
                                   err_msg=f"{case['name']} step {t}", **TOL)


def test_forward_matches_jax(case):
    cfg = case["cfg"]
    model = build_model(cfg)
    params = decoder_params_from_jax(case["p_np"], "cpu")
    h = model.forward(params, _batch(case, torch))
    got = TT.lm_logits(params, h, cfg).numpy()
    B, S = case["toks"].shape
    assert got.shape == (B, cfg.n_vision_tokens + S, cfg.vocab_size)
    np.testing.assert_allclose(got, case["fwd"], **TOL)


def test_prefill_matches_jax(case):
    """``prefill``: the last position's logits of the prompt."""
    cfg = case["cfg"]
    params = decoder_params_from_jax(case["p_np"], "cpu")
    got = build_model(cfg).prefill(params, _batch(case, torch), 32)
    np.testing.assert_allclose(got.numpy(), case["fwd"][:, -1], **TOL)


def test_params_carry_over_bit_for_bit(case):
    params = decoder_params_from_jax(case["p_np"], "cpu")
    flat = jax.tree_util.tree_flatten_with_path(case["p_np"])[0]
    for path, leaf in flat:
        t = params
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape
        np.testing.assert_array_equal(t.numpy(), leaf)
    cfg = case["cfg"]
    for name, lead in _stacks(cfg).items():
        assert all(tuple(t.shape[:len(lead)]) == lead
                   for t in tree_leaves(params[name])), name


def _stacks(cfg):
    """Each stack of a family's parameters and its leading layer axes."""
    L = cfg.n_layers
    if cfg.arch_kind == "mamba_hybrid":
        return {"blocks": (L,)}
    if cfg.arch_kind == "xlstm":
        k = cfg.slstm_every
        return {"mlstm": (L // k, k - 1), "slstm": (L // k,)}
    if cfg.local_global_alternate:
        return {"local": (L // 2,), "global": (L // 2,)}
    return {"blocks": (L,)}


def test_init_shapes_match_jax(case):
    """The port's random init builds JAX's tree: same keys, shapes and
    dtypes (the numbers differ: another generator)."""
    cfg = case["cfg"]
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    flat = jax.tree_util.tree_flatten_with_path(case["p_np"])[0]
    n = 0
    for path, leaf in flat:
        t = params
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).replace("torch.", "") == str(leaf.dtype), path
        n += 1
    assert n == len(tree_leaves(params))


# --------------------------------------------------------------------------
# the port's own invariants (tests/test_models.py's)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kw,B,S", [
    ("qwen3_1p7b", {}, 2, 12),
    ("mixtral_8x22b", dict(sliding_window=8, n_experts=2,
                           n_experts_active=1), 1, 20),
    ("zamba2_2p7b", {}, 2, 16),
    ("xlstm_1p3b", {}, 2, 16),
    ("gemma2_27b", dict(sliding_window=8), 1, 20),
], ids=["qwen3_dense", "mixtral_swa", "zamba2", "xlstm", "gemma2_swa"])
def test_decode_matches_forward(arch, kw, B, S):
    """Token-by-token decode logits equal the teacher-forced forward's; the
    rolling-buffer caches (window 8 over 20 tokens: Mixtral's, Gemma-2's
    local layers beside its global ones) equal windowed full attention, and
    the Mamba2 / xLSTM recurrences their chunked forms."""
    cfg = get_config(arch).reduced(**kw)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(1))
    toks = torch.from_numpy(RNG.integers(0, cfg.vocab_size, (B, S))
                            .astype(np.int32))
    full = TT.lm_logits(params, model.forward(params, {"tokens": toks}), cfg)
    cache = model.init_cache(B, S, device="cpu")
    if cfg.sliding_window:
        kc = cache["local"][0] if cfg.local_global_alternate else cache[0]
        assert kc.shape[2] == cfg.sliding_window < S
    if cfg.local_global_alternate:
        assert cache["global"][0].shape[2] == S
    for t in range(S):
        logits, cache = model.decode_step(
            params, toks[:, t], torch.full((B,), t, dtype=torch.int32), cache)
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                   err_msg=f"{arch} step {t}",
                                   **INVARIANT_TOL)


def test_decode_leaves_its_input_cache_alone():
    cfg = get_config("qwen3_1p7b").reduced(n_layers=2)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(2))
    cache = model.init_cache(2, 8, device="cpu")
    _, new = model.decode_step(params, torch.tensor([3, 4]),
                               torch.tensor([0, 5]), cache)
    assert all(int(c.abs().sum()) == 0 for c in cache)
    assert new[0].shape == cache[0].shape == (2, 2, 8, cfg.n_kv_heads, 32)
    assert bool((new[0][:, 0, 0] != 0).any()) and \
        bool((new[0][:, 1, 5] != 0).any())


@pytest.mark.parametrize("window,cache_len", [(0, 16), (4, 16), (0, 0)],
                         ids=["padded", "rolled", "exact"])
def test_attn_prefill_matches_jax(window, cache_len):
    """``attn_prefill``: the output and the caches, padded to ``cache_len``
    or rolled to the window's last positions at slot ``pos mod W``."""
    from repro.models import attention as JA
    from repro_torch.models import attention as TA
    cfg = get_config("qwen3_1p7b").reduced()
    jp = JA.attn_init(jax.random.PRNGKey(3), jget_config(
        "qwen3_1p7b").reduced())
    p = {k: torch.from_numpy(np.asarray(v)) for k, v in jp.items()}
    B, S = 2, 10
    x = RNG.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    jy, (jk, jv) = JA.attn_prefill(jp, jnp.array(x), jget_config(
        "qwen3_1p7b").reduced(), positions=jnp.array(pos), window=window,
        cache_len=cache_len)
    ty, (tk, tv) = TA.attn_prefill(p, torch.from_numpy(x), cfg,
                                   positions=torch.from_numpy(pos),
                                   window=window, cache_len=cache_len)
    for j, t in ((jy, ty), (jk, tk), (jv, tv)):
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_decode(arch):
    """Every architecture builds, inits and decodes three greedy steps to
    finite logits (``tests/test_models.py::test_smoke_decode``)."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    B = 2
    if cfg.arch_kind == "encdec":
        cache = model.init_cache(B, 16, enc_len=8, device="cpu")
    else:
        cache = model.init_cache(B, 16, device="cpu")
    tok = torch.tensor([3, 5], dtype=torch.int32)
    for t in range(3):
        logits, cache = model.decode_step(
            params, tok, torch.full((B,), t, dtype=torch.int32), cache)
        assert logits.shape == (B, cfg.vocab_size)
        assert bool(torch.isfinite(logits).all()), (arch, t)
        tok = logits.argmax(-1).to(torch.int32)


# --------------------------------------------------------------------------
# the recurrent mixers' invariants (tests/test_models.py's, at its bounds)
# --------------------------------------------------------------------------

def _x(B, S, d, scale=1.0):
    return torch.from_numpy(
        (scale * RNG.standard_normal((B, S, d))).astype(np.float32))


def _decode_all(step, p, x, state, cfg):
    outs = []
    for t in range(x.shape[1]):
        y, state = step(p, x[:, t:t + 1], state, cfg)
        outs.append(y)
    return torch.cat(outs, dim=1)


def test_mamba_chunk_invariance():
    """The SSD chunked scan does not depend on the chunk size."""
    cfg = get_config("zamba2_2p7b").reduced()
    p = TS.mamba2_init(torch.Generator().manual_seed(3), cfg, device="cpu")
    x = _x(2, 64, cfg.d_model)
    np.testing.assert_allclose(TS.mamba2_apply(p, x, cfg, chunk=8).numpy(),
                               TS.mamba2_apply(p, x, cfg, chunk=64).numpy(),
                               rtol=1e-4, atol=1e-4)


def test_mamba_decode_matches_train():
    cfg = get_config("zamba2_2p7b").reduced()
    p = TS.mamba2_init(torch.Generator().manual_seed(4), cfg, device="cpu")
    x = _x(1, 16, cfg.d_model)
    y_dec = _decode_all(TS.mamba2_decode, p, x,
                        TS.mamba2_decode_init(cfg, 1, device="cpu"), cfg)
    np.testing.assert_allclose(TS.mamba2_apply(p, x, cfg, chunk=8).numpy(),
                               y_dec.numpy(), rtol=1e-3, atol=1e-3)


def test_mlstm_chunk_invariance_and_decode():
    cfg = get_config("xlstm_1p3b").reduced()
    p = TX.mlstm_init(torch.Generator().manual_seed(5), cfg, device="cpu")
    x = _x(2, 32, cfg.d_model, 0.5)
    y1 = TX.mlstm_apply(p, x, cfg, chunk=4)
    np.testing.assert_allclose(y1.numpy(),
                               TX.mlstm_apply(p, x, cfg, chunk=32).numpy(),
                               rtol=1e-4, atol=1e-4)
    y_dec = _decode_all(TX.mlstm_decode, p, x,
                        TX.mlstm_decode_init(cfg, 2, device="cpu"), cfg)
    np.testing.assert_allclose(y1.numpy(), y_dec.numpy(), rtol=1e-3,
                               atol=1e-3)


def test_slstm_apply_matches_decode():
    """The whole-sequence sLSTM equals its one-token steps."""
    cfg = get_config("xlstm_1p3b").reduced()
    p = TX.slstm_init(torch.Generator().manual_seed(6), cfg, device="cpu")
    x = _x(2, 24, cfg.d_model, 0.5)
    y_dec = _decode_all(TX.slstm_decode, p, x,
                        TX.slstm_decode_init(cfg, 2, device="cpu"), cfg)
    np.testing.assert_allclose(TX.slstm_apply(p, x, cfg).numpy(),
                               y_dec.numpy(), rtol=1e-3, atol=1e-3)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

def test_layers_match_jax():
    x = RNG.standard_normal((2, 5, 4, 32)).astype(np.float32)
    w = RNG.standard_normal(32).astype(np.float32)
    b = RNG.standard_normal(32).astype(np.float32)
    T = torch.from_numpy
    close = lambda j, t: np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                                    rtol=1e-6, atol=1e-6)
    close(JL.rmsnorm(jnp.array(x), jnp.array(w)), TL.rmsnorm(T(x), T(w)))
    close(JL.layernorm(jnp.array(x), {"w": jnp.array(w), "b": jnp.array(b)}),
          TL.layernorm(T(x), {"w": T(w), "b": T(b)}))
    pos = RNG.integers(0, 300, (2, 5)).astype(np.int32)
    close(JL.apply_rope(jnp.array(x), jnp.array(pos), 1e6),
          TL.apply_rope(T(x), T(pos), 1e6))
    close(JL.softcap(jnp.array(x) * 40, 30.0), TL.softcap(T(x) * 40, 30.0))
    h = RNG.standard_normal((3, 16)).astype(np.float32)
    p = {n: RNG.standard_normal(s).astype(np.float32) * 0.2 for n, s in
         (("wi", (16, 24)), ("wg", (16, 24)), ("wo", (24, 16)))}
    jp = {n: jnp.array(v) for n, v in p.items()}
    tp = {n: T(v) for n, v in p.items()}
    close(JL.mlp_swiglu(jnp.array(h), jp), TL.mlp_swiglu(T(h), tp))
    close(JL.mlp_geglu(jnp.array(h), jp), TL.mlp_geglu(T(h), tp))
    table = RNG.standard_normal((50, 8)).astype(np.float32)
    ids = RNG.integers(0, 50, (2, 3)).astype(np.int32)
    close(JL.embed_lookup(jnp.array(table), jnp.array(ids), True),
          TL.embed_lookup(T(table), T(ids), True))


# --------------------------------------------------------------------------
# routing at the decode step's shapes
# --------------------------------------------------------------------------

def _ulps(a, b):
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


@pytest.mark.parametrize("T_", [8, 1], ids=["step", "prefill_token"])
def test_decode_route_shapes_match_jax(T_):
    E, k = 64, 6
    cap = TT.moe_mod.expert_capacity(1.25, T_, k, E)
    assert cap == 1
    lg = RNG.standard_normal((1, T_, E)).astype(np.float32)
    refs = [moe_route_xla(jnp.array(lg), k, cap),
            moe_route_pallas(jnp.array(lg), k, cap, interpret=True)]
    for got in (TR.moe_route_torch(torch.from_numpy(lg), k, cap),
                TR.moe_route_plain(torch.from_numpy(lg), k, cap)):
        for ref in refs:
            for i, (g, r) in enumerate(zip(got, ref)):
                g, r = g.numpy(), np.asarray(r)
                if i == 3:                      # weights
                    assert _ulps(g, r.astype(np.float32)) <= WEIGHT_ULPS
                else:
                    np.testing.assert_array_equal(g.astype(np.int64),
                                                  r.astype(np.int64))
    keep = np.asarray(refs[0][5]).astype(bool)
    assert keep.sum() <= E * cap and (not keep.all() or T_ == 1)
