"""Whisper-style encoder-decoder backbone (counterpart of
``repro/models/encdec.py``).

The audio front end is a stub, as in the JAX package: the encoder takes
precomputed frame embeddings (B, S_frames, d_model). Positions use RoPE
where Whisper has learned / sinusoidal absolute embeddings. The encoder
attends without a mask; each decoder block is causal self attention, cross
attention over the encoder states (no mask, no RoPE) and a GeGLU MLP.
Decoding reads the cross keys and values from a cache filled once per
prompt (``encdec_fill_cross_cache``), its queries at position 0. Each
encoder and decoder block runs under ``transformer.remat`` (recomputed in
the backward under ``cfg.remat`` while a gradient is taken).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import attention as attn
from repro_torch.models.config import torch_dtype
from repro_torch.models.layers import (embed_init, mlp_geglu, mlp_init,
                                       rmsnorm, rmsnorm_init)
from repro_torch.models.transformer import (_at, _attn_cache_init, _bcast,
                                            _stack, _stacked, remat)


def _enc_block_init(gen, cfg, device):
    dtype = torch_dtype(cfg.param_dtype)
    return {"attn": attn.attn_init(gen, cfg, device),
            "attn_norm": rmsnorm_init(cfg.d_model, dtype, device),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device),
            "mlp_norm": rmsnorm_init(cfg.d_model, dtype, device)}


def _dec_block_init(gen, cfg, device):
    dtype = torch_dtype(cfg.param_dtype)
    return {"self": attn.attn_init(gen, cfg, device),
            "self_norm": rmsnorm_init(cfg.d_model, dtype, device),
            "cross": attn.cross_attn_init(gen, cfg, device),
            "cross_norm": rmsnorm_init(cfg.d_model, dtype, device),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device),
            "mlp_norm": rmsnorm_init(cfg.d_model, dtype, device)}


def encdec_init(gen: torch.Generator, cfg, device="cuda") -> Dict[str, Any]:
    """Random weights from ``gen`` (a generator on ``device``): the token
    embedding (tied head), ``enc_blocks`` and ``dec_blocks`` stacked over
    their layers, and the two final norms."""
    dtype = torch_dtype(cfg.param_dtype)
    n_enc = cfg.n_encoder_layers or cfg.n_layers
    return {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype, device),
        "enc_blocks": _stacked(lambda: _enc_block_init(gen, cfg, device),
                               n_enc),
        "dec_blocks": _stacked(lambda: _dec_block_init(gen, cfg, device),
                               cfg.n_layers),
        "enc_norm": rmsnorm_init(cfg.d_model, dtype, device),
        "final_norm": rmsnorm_init(cfg.d_model, dtype, device),
    }


def _positions(B: int, S: int, device):
    return torch.arange(S, device=device)[None].expand(B, S)


def encode(params, frames, cfg):
    """frames: (B, Sf, d) stub embeddings -> the encoder states."""
    B, Sf, _ = frames.shape
    pos = _positions(B, Sf, frames.device)
    x = frames.to(torch_dtype(cfg.compute_dtype))

    def block(x, i):
        bp = _at(params["enc_blocks"], i)
        h = rmsnorm(x, bp["attn_norm"], cfg.norm_eps)
        x = x + attn.attn_apply(bp["attn"], h, cfg, positions=pos,
                                causal=False)
        h = rmsnorm(x, bp["mlp_norm"], cfg.norm_eps)
        return x + mlp_geglu(h, bp["mlp"])

    block = remat(block, params, cfg)
    for i in range(cfg.n_encoder_layers or cfg.n_layers):
        x = block(x, i)
    return rmsnorm(x, params["enc_norm"], cfg.norm_eps)


def decode_train(params, enc_out, tokens, cfg):
    """Teacher-forced decoder forward -> hidden states (B, St, d)."""
    B, St = tokens.shape
    x = params["embed"][tokens.long()].to(torch_dtype(cfg.compute_dtype))
    pos = _positions(B, St, tokens.device)

    def block(x, i):
        bp = _at(params["dec_blocks"], i)
        h = rmsnorm(x, bp["self_norm"], cfg.norm_eps)
        x = x + attn.attn_apply(bp["self"], h, cfg, positions=pos)
        h = rmsnorm(x, bp["cross_norm"], cfg.norm_eps)
        x = x + attn.cross_attn_apply(bp["cross"], h, enc_out, cfg)
        h = rmsnorm(x, bp["mlp_norm"], cfg.norm_eps)
        return x + mlp_geglu(h, bp["mlp"])

    block = remat(block, params, cfg)
    for i in range(cfg.n_layers):
        x = block(x, i)
    return rmsnorm(x, params["final_norm"], cfg.norm_eps)


def encdec_cache_init(cfg, batch: int, max_seq: int, enc_len: int,
                      device="cuda"):
    """``{"self": (k, v), "cross": (k, v)}``: the self-attention caches
    (L, batch, max_seq, K, hd) and the cross caches (L, batch, enc_len, K,
    hd), zeros in the compute dtype."""
    dtype = torch_dtype(cfg.compute_dtype)
    L = cfg.n_layers
    return {"self": _bcast(_attn_cache_init(cfg, batch, max_seq, dtype,
                                            device), L),
            "cross": _bcast(_attn_cache_init(cfg, batch, enc_len, dtype,
                                             device), L)}


def encdec_fill_cross_cache(params, enc_out, cfg, cache):
    """The encoder states projected into every layer's cross keys and
    values, once a prompt. Returns a new cache; ``self`` is kept."""
    B, T, _ = enc_out.shape
    K, hd = cfg.n_kv_heads, cfg.hd
    wk, wv = params["dec_blocks"]["cross"]["wk"], \
        params["dec_blocks"]["cross"]["wv"]
    kc = torch.stack([(enc_out @ wk[i]).reshape(B, T, K, hd)
                      for i in range(cfg.n_layers)])
    vc = torch.stack([(enc_out @ wv[i]).reshape(B, T, K, hd)
                      for i in range(cfg.n_layers)])
    return {"self": cache["self"], "cross": (kc, vc)}


def encdec_decode_step(params, tok_emb, cache, pos, cfg):
    """tok_emb: (B, 1, d); pos: (B,). Returns ``(h, new_cache)``; the cache
    passed in is left unchanged."""
    B = tok_emb.shape[0]
    H, hd = cfg.n_heads, cfg.hd
    x = tok_emb
    ck, cv = cache["cross"]
    T = ck.shape[2]
    pq = torch.zeros((B, 1), dtype=torch.int32, device=x.device)
    pk = _positions(B, T, x.device)
    self_c = []
    for i in range(cfg.n_layers):
        bp = _at(params["dec_blocks"], i)
        h = rmsnorm(x, bp["self_norm"], cfg.norm_eps)
        y, sc = attn.attn_decode(bp["self"], h, _at(cache["self"], i), pos,
                                 cfg)
        self_c.append(sc)
        x = x + y
        h = rmsnorm(x, bp["cross_norm"], cfg.norm_eps)
        q = (h @ bp["cross"]["wq"]).reshape(B, 1, H, hd)
        y = attn._flash_over_kv(q, ck[i], cv[i], cfg, causal=False, window=0,
                                q_positions=pq, kv_positions=pk)
        x = x + y.reshape(B, 1, -1) @ bp["cross"]["wo"]
        h = rmsnorm(x, bp["mlp_norm"], cfg.norm_eps)
        x = x + mlp_geglu(h, bp["mlp"])
    return (rmsnorm(x, params["final_norm"], cfg.norm_eps),
            {"self": _stack(self_c), "cross": cache["cross"]})
