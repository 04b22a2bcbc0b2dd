"""Decoder-only LM assembly (counterpart of ``repro/models/transformer.py``
for ``arch_kind == "decoder"`` with uniform attention blocks).

Blocks are [attention, MLP] (dense) or [attention, MoE] (Mixtral with its
sliding window, Moonlight). The parameters keep the JAX package's layout,
stacked over the layers (every leaf of ``params["blocks"]`` has a leading
``n_layers`` axis), so carrying JAX weights across is a copy and a layer is
a slice; the layer loop is a Python loop over those slices. The decode
cache is ``(k, v)``, each (L, B, W, K, hd), the batch on axis 1.

Mamba-hybrid, xLSTM and Gemma-2's local / global alternation wait for a
later slice (ROADMAP queue 1 item 2) and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core.butterfly import tree_map
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.config import torch_dtype
from repro_torch.models.layers import (embed_init, mlp_geglu, mlp_init,
                                       mlp_swiglu, rmsnorm, rmsnorm_init,
                                       softcap)

#: the batch axis of every leaf of a decode cache
CACHE_BATCH_AXIS = 1


def check_arch(cfg) -> None:
    """Refuse the decoder kinds this port does not run yet."""
    if cfg.n_vision_tokens:
        raise NotImplementedError(
            f"{cfg.name}: the vision prefix is not ported yet (ROADMAP queue "
            "1 item 2: internvl2_76b)")
    if cfg.arch_kind != "decoder" or cfg.local_global_alternate:
        kind = ("local / global alternation" if cfg.local_global_alternate
                else cfg.arch_kind)
        raise NotImplementedError(
            f"{cfg.name}: {kind} is not ported yet (ROADMAP queue 1 item 2: "
            "ssm.py, xlstm.py, encdec.py and the local / global decoder); "
            "the port runs uniform attention decoders")


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _stacked(init_fn, n: int):
    """``n`` draws of ``init_fn()`` stacked leaf by leaf on a new axis 0."""
    layers = [init_fn() for _ in range(n)]
    return tree_map(lambda *ts: torch.stack(ts), layers[0], *layers[1:])


def _block_init(gen: torch.Generator, cfg, device):
    dtype = torch_dtype(cfg.param_dtype)
    p = {"attn": attn.attn_init(gen, cfg, device=device),
         "attn_norm": rmsnorm_init(cfg.d_model, dtype, device)}
    if cfg.family == "moe":
        p["moe"] = moe_mod.moe_init(gen, cfg, device=device)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device)
    p["mlp_norm"] = rmsnorm_init(cfg.d_model, dtype, device)
    return p


def decoder_init(gen: torch.Generator, cfg, device="cuda") -> Dict[str, Any]:
    """Random weights from ``gen`` (a generator on ``device``): the token
    embedding (tied with the output head), the final norm, and the layers'
    blocks stacked over ``n_layers``."""
    check_arch(cfg)
    dtype = torch_dtype(cfg.param_dtype)
    return {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype,
                                device),
            "final_norm": rmsnorm_init(cfg.d_model, dtype, device),
            "blocks": _stacked(lambda: _block_init(gen, cfg, device),
                               cfg.n_layers)}


def layer(params, i: int):
    """The parameters of layer ``i``: views into the stacked blocks."""
    return tree_map(lambda t: t[i], params["blocks"])


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


def decoder_forward(params, x, cfg, positions):
    """Backbone over embedded input x: (B, S, d) -> (B, S, d) normalised."""
    check_arch(cfg)
    for i in range(cfg.n_layers):
        x = _apply_attn_block(layer(params, i), x, cfg, positions,
                              cfg.sliding_window)
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


def decoder_cache_init(cfg, batch: int, max_seq: int, device="cuda"):
    """``(k, v)``, each (L, batch, W, K, hd) zeros in the compute dtype; W is
    ``max_seq``, or the sliding window when that is shorter (a rolling
    buffer)."""
    check_arch(cfg)
    W = min(max_seq, cfg.sliding_window) if cfg.sliding_window else max_seq
    k, v = _attn_cache_init(cfg, batch, W, torch_dtype(cfg.compute_dtype),
                            device)
    L = cfg.n_layers
    return (k[None].repeat(L, 1, 1, 1, 1), v[None].repeat(L, 1, 1, 1, 1))


def _attn_block_decode(p, x, cache, pos, cfg, window):
    h = rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    y, cache = attn.attn_decode(p["attn"], h, cache, pos, cfg, window=window)
    x = x + y
    return x + _ffn(p, rmsnorm(x, p["mlp_norm"], cfg.norm_eps), cfg), cache


def decoder_decode_step(params, x, cache, pos, cfg):
    """x: (B, 1, d) embedded token; pos: (B,). Returns ``(h, new_cache)``;
    the cache passed in is left unchanged."""
    check_arch(cfg)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, (k, v) = _attn_block_decode(layer(params, i), x,
                                       (cache[0][i], cache[1][i]), pos, cfg,
                                       cfg.sliding_window)
        ks.append(k)
        vs.append(v)
    return (rmsnorm(x, params["final_norm"], cfg.norm_eps),
            (torch.stack(ks), torch.stack(vs)))
