"""GQA attention: training / prefill over the whole sequence and the
one-token decode step on a KV cache (counterpart of
``repro/models/attention.py``).

Plain torch, as the JAX package computes attention outside any Pallas
kernel, and op for op its arithmetic: the query heads grouped over the KV
heads, scores and the streaming softmax in float32 accumulators over KV
chunks, the causal and sliding-window masks, the rolling-buffer cache
(slot ``pos mod W``) with its ``kv_pos`` arithmetic, and the guard for a
row with every key masked. ``scaled_dot_product_attention`` masks and
accumulates otherwise, so it is not used. Feature flags: GQA, qk-norm
(Qwen3), QKV bias (Qwen1.5), attention soft cap (Gemma-2), sliding window
(Mixtral, Gemma-2's local layers), cross attention (Whisper: no mask, no
RoPE). The sequence-sharded decode waits for the sharded ops.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import torch_dtype
from repro_torch.models.layers import apply_rope, dense_init, rmsnorm, softcap


def attn_init(gen: torch.Generator, cfg, device="cuda"):
    d = cfg.d_model
    hd, H, K = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    dtype = torch_dtype(cfg.param_dtype)
    p = {"wq": dense_init(gen, d, H * hd, dtype, device),
         "wk": dense_init(gen, d, K * hd, dtype, device),
         "wv": dense_init(gen, d, K * hd, dtype, device),
         "wo": dense_init(gen, H * hd, d, dtype, device)}
    if cfg.qkv_bias:
        for name, n in (("bq", H * hd), ("bk", K * hd), ("bv", K * hd)):
            p[name] = torch.zeros((n,), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
    return p


def _qkv(p, x, cfg, positions):
    B, S, _ = x.shape
    hd, H, K = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, K, hd)
    v = v.reshape(B, S, K, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


#: keys a streaming-softmax block takes (halved until it divides the length)
KV_CHUNK = 1024


def _flash_over_kv(q, k, v, cfg, *, causal: bool, window: int,
                   q_positions, kv_positions):
    """Streaming-softmax attention over KV chunks, float32 accumulators.

    q: (B, S, H, hd); k / v: (B, T, K, hd); positions (B, S) / (B, T). GQA
    through the (K, G) head-group reshape."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qg = (q * hd ** -0.5).reshape(B, S, K, G, hd).float()
    chunk = min(KV_CHUNK, T)
    while T % chunk:
        chunk //= 2
    qp = q_positions[:, :, None, None, None]
    m = torch.full((B, S, K, G), float("-inf"), device=q.device)
    l = torch.zeros((B, S, K, G), device=q.device)
    acc = torch.zeros((B, S, K, G, hd), device=q.device)
    for c0 in range(0, T, chunk):
        kb, vb = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        pb = kv_positions[:, None, None, None, c0:c0 + chunk]
        s = torch.einsum("bskgd,btkd->bskgt", qg, kb.float())
        if cfg.attn_softcap:
            s = softcap(s, cfg.attn_softcap)
        mask = torch.ones((B, S, 1, 1, kb.shape[1]), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask = mask & (qp >= pb)
        if window:
            mask = mask & ((qp - pb) < window)
        s = torch.where(mask, s, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        # a row with every key masked so far keeps a zero exponent base
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        pexp = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + pexp.sum(-1)
        pv = torch.einsum("bskgt,btkd->bskgd", pexp.to(vb.dtype).float(),
                          vb.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-37)
    return out.reshape(B, S, H, hd).to(q.dtype)


def attn_apply(p, x, cfg, *, positions, window: int = 0,
               causal: bool = True):
    """Training / prefill attention over the whole sequence, causal unless
    ``causal=False`` (the encoder). x: (B, S, d)."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions)
    out = _flash_over_kv(q, k, v, cfg, causal=causal, window=window,
                         q_positions=positions, kv_positions=positions)
    return out.reshape(B, S, -1) @ p["wo"]


def attn_prefill(p, x, cfg, *, positions, window: int = 0,
                 cache_len: int = 0):
    """Prefill: ``(y, (k_cache, v_cache))``, the caches padded, or rolled
    to the last ``W`` positions at slot ``pos mod W``, to ``cache_len``."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions)
    y = _flash_over_kv(q, k, v, cfg, causal=True, window=window,
                       q_positions=positions, kv_positions=positions)
    y = y.reshape(B, S, -1) @ p["wo"]
    W = cache_len or S
    if window and W > window:
        W = window
    if W >= S:
        pad = (0, 0, 0, 0, 0, W - S)
        return y, (torch.nn.functional.pad(k, pad),
                   torch.nn.functional.pad(v, pad))
    roll = S % W
    return y, (torch.roll(k[:, -W:], roll, dims=1),
               torch.roll(v[:, -W:], roll, dims=1))


def _kv_positions(pos, W: int, window: int):
    """The absolute position each cache slot holds, (B, W): a slot not yet
    written gets ``pos + 1``, which the causal mask refuses."""
    j = torch.arange(W, device=pos.device)[None, :]
    if not window:
        return j.expand(pos.shape[0], W)
    kv_pos = pos[:, None] - torch.remainder(pos[:, None] - j, W)
    return torch.where(kv_pos < 0, pos[:, None] + 1, kv_pos)


def attn_decode(p, x, cache, pos, cfg, *, window: int = 0):
    """One-token decode. x: (B, 1, d); cache: (k, v) of (B, W, K, hd); pos:
    (B,). Returns ``(y, (k, v))``, the caches new tensors with this token's
    key and value at slot ``pos mod W`` (rolling) or ``min(pos, W - 1)``."""
    B = x.shape[0]
    kc, vc = cache
    W = kc.shape[1]
    q, k, v = _qkv(p, x, cfg, pos[:, None])
    slot = torch.remainder(pos, W) if window else torch.clamp(pos, max=W - 1)
    kc = _scatter_slot(kc, k[:, 0], slot)
    vc = _scatter_slot(vc, v[:, 0], slot)
    y = _flash_over_kv(q, kc, vc, cfg, causal=True, window=window,
                       q_positions=pos[:, None],
                       kv_positions=_kv_positions(pos, W, window))
    return y.reshape(B, 1, -1) @ p["wo"], (kc, vc)


def _scatter_slot(cache, new, slot):
    """cache: (B, W, K, hd); new: (B, K, hd); slot: (B,). A copy of the
    cache with row ``slot[b]`` of batch ``b`` replaced."""
    out = cache.clone()
    out[torch.arange(cache.shape[0], device=cache.device),
        slot.long()] = new.to(cache.dtype)
    return out


def cross_attn_init(gen: torch.Generator, cfg, device="cuda"):
    return attn_init(gen, cfg, device)


def cross_attn_apply(p, x, kv_src, cfg):
    """Encoder-decoder cross attention, no mask and no RoPE. x: (B, S, d)
    queries; kv_src: (B, T, d) encoder states."""
    B, S, _ = x.shape
    T = kv_src.shape[1]
    hd, H, K = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (kv_src @ p["wk"]).reshape(B, T, K, hd)
    v = (kv_src @ p["wv"]).reshape(B, T, K, hd)
    arange = lambda n: torch.arange(n, device=x.device)[None].expand(B, n)
    y = _flash_over_kv(q, k, v, cfg, causal=False, window=0,
                       q_positions=arange(S), kv_positions=arange(T))
    return y.reshape(B, S, -1) @ p["wo"]
