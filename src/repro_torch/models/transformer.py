"""Decoder-only LM assembly for every decoder family (counterpart of
``repro/models/transformer.py``).

Families, by ``cfg.arch_kind`` and ``cfg.local_global_alternate``:

- ``decoder``: uniform [attention, MLP] (dense, the vision backbone) or
  [attention, MoE] blocks (Mixtral with its sliding window, Moonlight);
- ``decoder`` with ``local_global_alternate`` (Gemma-2): pairs of a local
  block (sliding window) and a global one, GeGLU MLPs;
- ``mamba_hybrid`` (Zamba2): Mamba2 blocks, and one shared [attention,
  MLP] block applied before each group of ``hybrid_attn_every``, with a KV
  cache of its own at each application;
- ``xlstm``: groups of ``slstm_every - 1`` mLSTM blocks and one sLSTM.

The parameters keep the JAX package's layout, stacked over the layers
(``blocks``, ``local`` / ``global``, ``mlstm`` (groups, k - 1, ...) and
``slstm``), so carrying JAX weights across is a copy and a layer is a
slice; the layer loops are Python loops over those slices. Every leaf of a
decode cache has its batch on one axis, which ``serve.kv_cache`` finds by
itself: axis 1 of the attention caches (layers, B, W, K, hd) and of the
Mamba2 and sLSTM states, axis 2 of the mLSTM states (groups, k - 1, B,
...).

Remat: under ``cfg.remat``, while a gradient is taken (grad mode on and
the parameters require grad), each unit the JAX package wraps in
``jax.checkpoint`` (a block; a Zamba2, xLSTM or Gemma-2 group) runs under
``torch.utils.checkpoint`` (:func:`remat`): only its input is kept, and the
backward recomputes its activations. Decode, prefill and inference run as
they are.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.butterfly import tree_map
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm, xlstm
from repro_torch.models.config import torch_dtype
from repro_torch.models.layers import (embed_init, mlp_geglu, mlp_init,
                                       mlp_swiglu, rmsnorm, rmsnorm_init,
                                       softcap)


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _stack(trees):
    """Trees of one structure stacked leaf by leaf on a new axis 0."""
    return tree_map(lambda *ts: torch.stack(ts), trees[0], *trees[1:])


def _stacked(init_fn, n: int, cut=None, path=()):
    """``n`` draws of ``init_fn()`` stacked leaf by leaf on a new axis 0.
    With ``cut``, each draw's leaves are cut as soon as they are drawn:
    ``cut(path, leaf, n)`` keeps a part of one layer's ``leaf`` of the
    stack of ``n`` at ``path``."""
    if cut is None:
        return _stack([init_fn() for _ in range(n)])
    return _stack([_with_paths(lambda p, t: cut(path + p, t, n), init_fn())
                   for _ in range(n)])


def _with_paths(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _with_paths(fn, v, path + (str(k),))
                for k, v in tree.items()}
    return fn(path, tree)


def _at(tree, i: int):
    """Entry ``i`` of every leaf of a stacked tree: views."""
    return tree_map(lambda t: t[i], tree)


def _block_init(gen: torch.Generator, cfg, kind: str, device):
    dtype = torch_dtype(cfg.param_dtype)
    if kind != "attn":              # "mamba", "mlstm" or "slstm"
        mixer = {"mamba": ssm.mamba2_init, "mlstm": xlstm.mlstm_init,
                 "slstm": xlstm.slstm_init}[kind]
        return {kind: mixer(gen, cfg, device=device),
                "norm": rmsnorm_init(cfg.d_model, dtype, device)}
    p = {"attn": attn.attn_init(gen, cfg, device=device),
         "attn_norm": rmsnorm_init(cfg.d_model, dtype, device)}
    if cfg.family == "moe":
        p["moe"] = moe_mod.moe_init(gen, cfg, device=device)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device)
    p["mlp_norm"] = rmsnorm_init(cfg.d_model, dtype, device)
    return p


def decoder_init(gen: torch.Generator, cfg, device="cuda",
                 cut=None) -> Dict[str, Any]:
    """Random weights from ``gen`` (a generator on ``device``): the token
    embedding (tied with the output head), the final norm, and the layers'
    blocks, stacked as the family lays them out.

    ``cut(path, leaf, n)`` (a rank's block of a sharded tree) is applied
    to every leaf as soon as it is drawn, to one layer's part of a stacked
    leaf (``n`` the layers of its stack; ``None`` for an unstacked one):
    the draws are the same, so the kept parts are those of the whole tree,
    and no more than one layer's leaves is ever whole."""
    dtype = torch_dtype(cfg.param_dtype)
    c = (lambda path, t: t) if cut is None else \
        (lambda path, t: _with_paths(lambda p, x: cut(path + p, x, None),
                                     t))
    params: Dict[str, Any] = {
        "embed": c(("embed",), embed_init(gen, cfg.vocab_size, cfg.d_model,
                                          dtype, device)),
        "final_norm": c(("final_norm",),
                        rmsnorm_init(cfg.d_model, dtype, device))}
    block = lambda kind: (lambda: _block_init(gen, cfg, kind, device))
    L = cfg.n_layers
    if cfg.arch_kind == "mamba_hybrid":
        params["blocks"] = _stacked(block("mamba"), L, cut, ("blocks",))
        params["shared_attn"] = c(("shared_attn",), block("attn")())
    elif cfg.arch_kind == "xlstm":
        k = cfg.slstm_every
        params["mlstm"] = _stacked(lambda: _stacked(block("mlstm"), k - 1),
                                   L // k, cut, ("mlstm",))
        params["slstm"] = _stacked(block("slstm"), L // k, cut, ("slstm",))
    elif cfg.local_global_alternate:
        params["local"] = _stacked(block("attn"), L // 2, cut, ("local",))
        params["global"] = _stacked(block("attn"), L // 2, cut, ("global",))
    else:
        params["blocks"] = _stacked(block("attn"), L, cut, ("blocks",))
    return params


def layer(params, i: int):
    """The parameters of layer ``i`` of a uniform stack: views into the
    stacked blocks."""
    return _at(params["blocks"], i)


# --------------------------------------------------------------------------
# forward over a whole sequence
# --------------------------------------------------------------------------

def _ffn(p, h, cfg):
    if "moe" in p:
        return moe_mod.moe_apply(p["moe"], h, cfg)
    mlp = mlp_geglu if cfg.attn_softcap else mlp_swiglu     # gemma: gelu
    return mlp(h, p["mlp"])


def _apply_attn_block(p, x, cfg, positions, window):
    h = rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    x = x + attn.attn_apply(p["attn"], h, cfg, positions=positions,
                            window=window)
    return x + _ffn(p, rmsnorm(x, p["mlp_norm"], cfg.norm_eps), cfg)


def _apply_mixer_block(p, x, cfg, kind: str):
    mixer = {"mamba": ssm.mamba2_apply, "mlstm": xlstm.mlstm_apply,
             "slstm": xlstm.slstm_apply}[kind]
    return x + mixer(p[kind], rmsnorm(x, p["norm"], cfg.norm_eps), cfg)


def remat(fn, params, cfg):
    """``fn`` as it is, or under ``torch.utils.checkpoint`` when
    ``cfg.remat`` is set and a gradient is being taken (grad mode on, the
    parameters requiring grad)."""
    if not (cfg.remat and torch.is_grad_enabled()
            and params["final_norm"].requires_grad):
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def decoder_forward(params, x, cfg, positions):
    """Backbone over embedded input x: (B, S, d) -> (B, S, d) normalised."""
    L = cfg.n_layers
    if cfg.arch_kind == "mamba_hybrid":
        k = cfg.hybrid_attn_every

        def group(x, g):
            x = _apply_attn_block(params["shared_attn"], x, cfg, positions, 0)
            for i in range(g * k, (g + 1) * k):
                x = _apply_mixer_block(layer(params, i), x, cfg, "mamba")
            return x

        n, unit = L // k, group
    elif cfg.arch_kind == "xlstm":
        def group(x, g):
            mp = _at(params["mlstm"], g)
            for j in range(cfg.slstm_every - 1):
                x = _apply_mixer_block(_at(mp, j), x, cfg, "mlstm")
            return _apply_mixer_block(_at(params["slstm"], g), x, cfg,
                                      "slstm")

        n, unit = L // cfg.slstm_every, group
    elif cfg.local_global_alternate:
        def group(x, g):
            x = _apply_attn_block(_at(params["local"], g), x, cfg, positions,
                                  cfg.sliding_window)
            return _apply_attn_block(_at(params["global"], g), x, cfg,
                                     positions, 0)

        n, unit = L // 2, group
    else:
        def block(x, i):
            return _apply_attn_block(layer(params, i), x, cfg, positions,
                                     cfg.sliding_window)

        n, unit = L, block
    unit = remat(unit, params, cfg)
    for i in range(n):
        x = unit(x, i)
    return rmsnorm(x, params["final_norm"], cfg.norm_eps)


def lm_logits(params, h, cfg):
    """float32 logits of the tied head."""
    return softcap((h @ params["embed"].T).float(), cfg.logit_softcap)


# --------------------------------------------------------------------------
# decode caches and the decode step
# --------------------------------------------------------------------------

def _attn_cache_init(cfg, batch: int, cache_len: int, dtype, device):
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.hd)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def _bcast(tree, n: int):
    """Every leaf repeated ``n`` times on a new axis 0 (a copy, so a slot
    can be written in place)."""
    return tree_map(lambda t: t[None].repeat((n,) + (1,) * t.dim()), tree)


def decoder_cache_init(cfg, batch: int, max_seq: int, device="cuda"):
    """Zeros of the family's decode cache (the mLSTM / sLSTM stabilisers
    at -30), attention caches in the compute dtype:

    - uniform blocks: ``(k, v)``, each (L, batch, W, K, hd); W is
      ``max_seq``, or the sliding window when that is shorter (a rolling
      buffer);
    - Gemma-2: ``{"local": (k, v), "global": (k, v)}`` of L / 2 layers, the
      local ones a rolling buffer of ``min(max_seq, sliding_window)``;
    - Zamba2: ``{"mamba": {"S", "conv"}, "attn": (k, v)}``, the Mamba2
      states of all L layers and one KV cache per application of the
      shared block;
    - xLSTM: ``{"mlstm": {"C", "n", "m"}, "slstm": {"c", "n", "h",
      "m"}}``, stacked (groups, k - 1, batch, ...) and (groups, batch,
      ...)."""
    dtype = torch_dtype(cfg.compute_dtype)
    L = cfg.n_layers
    kv = lambda n, W: _bcast(_attn_cache_init(cfg, batch, W, dtype, device),
                             n)
    if cfg.arch_kind == "mamba_hybrid":
        return {"mamba": _bcast(ssm.mamba2_decode_init(cfg, batch, dtype,
                                                       device), L),
                "attn": kv(L // cfg.hybrid_attn_every, max_seq)}
    if cfg.arch_kind == "xlstm":
        k = cfg.slstm_every
        ml = xlstm.mlstm_decode_init(cfg, batch, device)
        return {"mlstm": _bcast(_bcast(ml, k - 1), L // k),
                "slstm": _bcast(xlstm.slstm_decode_init(cfg, batch, device),
                                L // k)}
    if cfg.local_global_alternate:
        return {"local": kv(L // 2, min(max_seq, cfg.sliding_window)),
                "global": kv(L // 2, max_seq)}
    return kv(L, min(max_seq, cfg.sliding_window) if cfg.sliding_window
              else max_seq)


def _attn_block_decode(p, x, cache, pos, cfg, window, mesh=None,
                       kv_shard_axis=""):
    h = rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    y, cache = attn.attn_decode(p["attn"], h, cache, pos, cfg, window=window,
                                mesh=mesh, kv_shard_axis=kv_shard_axis)
    x = x + y
    return x + _ffn(p, rmsnorm(x, p["mlp_norm"], cfg.norm_eps), cfg), cache


def _mixer_block_decode(p, x, state, cfg, kind: str):
    step = {"mamba": ssm.mamba2_decode, "mlstm": xlstm.mlstm_decode,
            "slstm": xlstm.slstm_decode}[kind]
    y, state = step(p[kind], rmsnorm(x, p["norm"], cfg.norm_eps), state, cfg)
    return x + y, state


def decoder_decode_step(params, x, cache, pos, cfg, mesh=None,
                        kv_shard_axis=""):
    """x: (B, 1, d) embedded token; pos: (B,), read by the attention caches
    only (a recurrent state has no position). Returns ``(h, new_cache)``;
    the cache passed in is left unchanged. With ``mesh`` and
    ``kv_shard_axis`` the full-attention caches are this rank's blocks of
    sequence-sharded caches (``attention.attn_decode``); sliding-window
    caches stay whole, as in the JAX package."""
    L = cfg.n_layers
    if cfg.arch_kind == "mamba_hybrid":
        k = cfg.hybrid_attn_every
        kvs, states = [], []
        for g in range(L // k):
            x, c = _attn_block_decode(params["shared_attn"], x,
                                      _at(cache["attn"], g), pos, cfg, 0,
                                      mesh, kv_shard_axis)
            kvs.append(c)
            for i in range(g * k, (g + 1) * k):
                x, st = _mixer_block_decode(layer(params, i), x,
                                            _at(cache["mamba"], i), cfg,
                                            "mamba")
                states.append(st)
        new_cache = {"mamba": _stack(states), "attn": _stack(kvs)}
    elif cfg.arch_kind == "xlstm":
        groups, slstm = [], []
        for g in range(L // cfg.slstm_every):
            mp, mc = _at(params["mlstm"], g), _at(cache["mlstm"], g)
            inner = []
            for j in range(cfg.slstm_every - 1):
                x, st = _mixer_block_decode(_at(mp, j), x, _at(mc, j), cfg,
                                            "mlstm")
                inner.append(st)
            groups.append(_stack(inner))
            x, st = _mixer_block_decode(_at(params["slstm"], g), x,
                                        _at(cache["slstm"], g), cfg, "slstm")
            slstm.append(st)
        new_cache = {"mlstm": _stack(groups), "slstm": _stack(slstm)}
    elif cfg.local_global_alternate:
        loc, glo = [], []
        for g in range(L // 2):
            x, c = _attn_block_decode(_at(params["local"], g), x,
                                      _at(cache["local"], g), pos, cfg,
                                      cfg.sliding_window)
            loc.append(c)
            x, c = _attn_block_decode(_at(params["global"], g), x,
                                      _at(cache["global"], g), pos, cfg, 0,
                                      mesh, kv_shard_axis)
            glo.append(c)
        new_cache = {"local": _stack(loc), "global": _stack(glo)}
    else:
        kvs = []
        for i in range(L):
            x, c = _attn_block_decode(layer(params, i), x, _at(cache, i),
                                      pos, cfg, cfg.sliding_window, mesh,
                                      kv_shard_axis)
            kvs.append(c)
        new_cache = _stack(kvs)
    return rmsnorm(x, params["final_norm"], cfg.norm_eps), new_cache
