"""The model API: ``init`` / ``forward`` / ``train_loss`` / ``init_cache`` /
``prefill`` / ``decode_step`` of every architecture of
``repro_torch.configs`` (counterpart of ``repro/models/model.py``), and the
serving sampler ``sample_topk``.

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    model = build_model(get_config("zamba2_2p7b"))
    params = model.init(torch.Generator("cuda").manual_seed(0))
    cache = model.init_cache(8, 256)
    logits, cache = model.decode_step(params, tokens, positions, cache)

``init`` takes an explicit ``torch.Generator`` and builds the weights on
its device (or ``device=``); everything else runs where its inputs are.
A decoder's batch may carry ``"vision"`` (B, P, d) patch embeddings, put
before the tokens when the config has ``n_vision_tokens``; the
encoder-decoder's carries ``"frames"`` (B, S_frames, d).

``train_loss(params, batch)`` returns ``(ce + 1e-4 * z_loss, {"ce": ce})``
over ``batch["targets"]`` and ``batch["mask"]``: the cross-entropy of the
tied head with a z-loss, by ``_chunked_ce`` over sequence chunks of 512, so
that only one chunk's (B, c, V) float32 logits is held; under
``cfg.remat`` each chunk (and each block, ``transformer.remat``) is
recomputed in the backward.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict

import torch

from repro_torch.models import encdec as ed
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig, torch_dtype
from repro_torch.models.layers import embed_lookup, softcap


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------

def _chunked_ce(params, h, targets, mask, cfg, chunk: int = 512):
    """Cross-entropy and z-loss of the tied head, summed over sequence
    chunks (S halved from ``chunk`` until it divides) in order, then
    divided by the mask's total. h: (B, S, d); targets / mask: (B, S).
    Returns ``(ce, z_loss)`` float32 scalars."""
    B, S, _ = h.shape
    c = min(chunk, S)
    while S % c:
        c //= 2
    mask = mask.float()

    def one(hc, tc, mc):
        logits = softcap((hc @ params["embed"].T).float(), cfg.logit_softcap)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, tc.long()[..., None])[..., 0]
        return ((lse - gold) * mc).sum(), (lse.square() * mc).sum(), mc.sum()

    one = tf.remat(one, params, cfg)
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    loss, zsum, cnt = zero, zero, zero
    for i in range(S // c):
        sl = slice(i * c, (i + 1) * c)
        dl, dz, dc = one(h[:, sl], targets[:, sl], mask[:, sl])
        loss, zsum, cnt = loss + dl, zsum + dz, cnt + dc
    cnt = torch.clamp(cnt, min=1.0)
    return loss / cnt, zsum / cnt


def _loss(params, h, batch, cfg):
    targets = batch["targets"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=targets.device)
    ce, zl = _chunked_ce(params, h, targets, mask, cfg)
    return ce + 1e-4 * zl, {"ce": ce}


def build_model(cfg: ModelConfig) -> SimpleNamespace:
    if cfg.arch_kind == "encdec":
        return _build_encdec(cfg)
    return _build_decoder(cfg)


def _embed_inputs(params, batch: Dict[str, Any], cfg):
    """Token embedding, after the vision prefix where the config has one
    and the batch carries it. Returns ``(x, positions)``."""
    x = embed_lookup(params["embed"], batch["tokens"], cfg.embed_scale)
    x = x.to(torch_dtype(cfg.compute_dtype))
    if cfg.n_vision_tokens and "vision" in batch:
        x = torch.cat([batch["vision"].to(x.dtype), x], dim=1)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    return x, positions


def _token_embedding(params, token, cfg):
    x = embed_lookup(params["embed"], token[:, None], cfg.embed_scale)
    return x.to(torch_dtype(cfg.compute_dtype))


def _build_decoder(cfg: ModelConfig) -> SimpleNamespace:
    def init(gen: torch.Generator, device=None, cut=None):
        """``cut``: keep a part of each leaf as it is drawn
        (``transformer.decoder_init``)."""
        return tf.decoder_init(gen, cfg, device=device or gen.device,
                               cut=cut)

    def forward(params, batch):
        x, pos = _embed_inputs(params, batch, cfg)
        return tf.decoder_forward(params, x, cfg, pos)

    def train_loss(params, batch):
        """Next-token loss over the text positions (the vision prefix's
        hidden states are dropped)."""
        h = forward(params, batch)
        P = cfg.n_vision_tokens if "vision" in batch else 0
        return _loss(params, h[:, P:, :], batch, cfg)

    def init_cache(batch_size: int, max_seq: int, device="cuda"):
        return tf.decoder_cache_init(cfg, batch_size, max_seq, device)

    def prefill(params, batch, max_seq: int, mesh=None, kv_shard_axis=""):
        """The prompt through ``forward``; the last position's logits (the
        mesh arguments are the JAX signature's; the forward reads
        neither)."""
        h = forward(params, batch)
        return tf.lm_logits(params, h[:, -1:, :], cfg)[:, 0, :]

    def decode_step(params, token, pos, cache, mesh=None, kv_shard_axis=""):
        """token: (B,) int32; pos: (B,). Returns ``(logits (B, V) float32,
        new_cache)``. With ``mesh`` and ``kv_shard_axis`` the attention
        caches are this rank's blocks of sequence-sharded caches."""
        h, cache = tf.decoder_decode_step(
            params, _token_embedding(params, token, cfg), cache, pos, cfg,
            mesh=mesh, kv_shard_axis=kv_shard_axis)
        return tf.lm_logits(params, h, cfg)[:, 0, :], cache

    return SimpleNamespace(cfg=cfg, init=init, forward=forward,
                           train_loss=train_loss, init_cache=init_cache,
                           prefill=prefill, decode_step=decode_step)


def _build_encdec(cfg: ModelConfig) -> SimpleNamespace:
    def init(gen: torch.Generator, device=None, cut=None):
        return ed.encdec_init(gen, cfg, device=device or gen.device, cut=cut)

    def forward(params, batch):
        """Decoder hidden states (B, St, d) over the encoded frames."""
        enc = ed.encode(params, batch["frames"], cfg)
        return ed.decode_train(params, enc, batch["tokens"], cfg)

    def train_loss(params, batch):
        return _loss(params, forward(params, batch), batch, cfg)

    def init_cache(batch_size: int, max_seq: int, enc_len: int = 1500,
                   device="cuda"):
        return ed.encdec_cache_init(cfg, batch_size, max_seq, enc_len,
                                    device)

    def prefill(params, batch, max_seq: int, mesh=None, kv_shard_axis=""):
        """Encode the frames, fill the cross caches, run the prompt through
        the decoder (the mesh arguments are the JAX signature's, unread). Returns ``(last logits (B, V), cache)``; the cache's
        self-attention part is zeros, as the JAX package's."""
        enc = ed.encode(params, batch["frames"], cfg)
        cache = ed.encdec_cache_init(cfg, enc.shape[0], max_seq,
                                     enc.shape[1], enc.device)
        cache = ed.encdec_fill_cross_cache(params, enc, cfg, cache)
        h = ed.decode_train(params, enc, batch["tokens"], cfg)
        return tf.lm_logits(params, h[:, -1:, :], cfg)[:, 0, :], cache

    def decode_step(params, token, pos, cache, mesh=None, kv_shard_axis=""):
        """As the decoder's; the mesh arguments are unread, as in the JAX
        package's encoder-decoder."""
        h, cache = ed.encdec_decode_step(
            params, _token_embedding(params, token, cfg), cache, pos, cfg)
        return tf.lm_logits(params, h, cfg)[:, 0, :], cache

    return SimpleNamespace(cfg=cfg, init=init, forward=forward,
                           train_loss=train_loss, init_cache=init_cache,
                           prefill=prefill, decode_step=decode_step)


# --------------------------------------------------------------------------
# sampling
# --------------------------------------------------------------------------

def sample_topk(generator, logits, k: int = 64, temperature: float = 1.0,
                use_flims=None):
    """logits (B, V) -> sampled token ids (B,) int32: one ``engine.topk``
    call, then Gumbel-max over the sorted prefix
    (``serve.sampler.sorted_prefix_sample``); greedy (``temperature <=
    0``) is index 0 of the prefix. ``generator`` (a ``torch.Generator`` on
    the logits' device) stands where the JAX function takes a key;
    ``use_flims`` pins the top-k variant (True -> ``flims``, False ->
    ``torch``, None -> the planner's choice)."""
    from repro_torch import engine
    from repro_torch.serve.sampler import SamplingState, sorted_prefix_sample
    variant = None if use_flims is None else ("flims" if use_flims
                                              else "torch")
    vals, idx = engine.topk(logits, min(k, logits.shape[-1]),
                            variant=variant)
    state = SamplingState.full(logits.shape[0], temperature=temperature,
                               device=logits.device)
    return sorted_prefix_sample(generator, vals, idx.to(torch.int32), state)
