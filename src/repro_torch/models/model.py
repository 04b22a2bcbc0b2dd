"""The model API: ``init`` / ``forward`` / ``init_cache`` / ``prefill`` /
``decode_step`` of every architecture of ``repro_torch.configs``
(counterpart of ``repro/models/model.py``).

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
encoder-decoder's carries ``"frames"`` (B, S_frames, d). ``train_loss``
and the chunked cross-entropy wait for the training slice (ROADMAP queue
1 item 5).
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict

import torch

from repro_torch.models import encdec as ed
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig, torch_dtype
from repro_torch.models.layers import embed_lookup


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
    def init(gen: torch.Generator, device=None):
        return tf.decoder_init(gen, cfg, device=device or gen.device)

    def forward(params, batch):
        x, pos = _embed_inputs(params, batch, cfg)
        return tf.decoder_forward(params, x, cfg, pos)

    def init_cache(batch_size: int, max_seq: int, device="cuda"):
        return tf.decoder_cache_init(cfg, batch_size, max_seq, device)

    def prefill(params, batch, max_seq: int):
        """The prompt through ``forward``; the last position's logits."""
        h = forward(params, batch)
        return tf.lm_logits(params, h[:, -1:, :], cfg)[:, 0, :]

    def decode_step(params, token, pos, cache):
        """token: (B,) int32; pos: (B,). Returns ``(logits (B, V) float32,
        new_cache)``."""
        h, cache = tf.decoder_decode_step(
            params, _token_embedding(params, token, cfg), cache, pos, cfg)
        return tf.lm_logits(params, h, cfg)[:, 0, :], cache

    return SimpleNamespace(cfg=cfg, init=init, forward=forward,
                           init_cache=init_cache, prefill=prefill,
                           decode_step=decode_step)


def _build_encdec(cfg: ModelConfig) -> SimpleNamespace:
    def init(gen: torch.Generator, device=None):
        return ed.encdec_init(gen, cfg, device=device or gen.device)

    def forward(params, batch):
        """Decoder hidden states (B, St, d) over the encoded frames."""
        enc = ed.encode(params, batch["frames"], cfg)
        return ed.decode_train(params, enc, batch["tokens"], cfg)

    def init_cache(batch_size: int, max_seq: int, enc_len: int = 1500,
                   device="cuda"):
        return ed.encdec_cache_init(cfg, batch_size, max_seq, enc_len,
                                    device)

    def prefill(params, batch, max_seq: int):
        """Encode the frames, fill the cross caches, run the prompt through
        the decoder. Returns ``(last logits (B, V), cache)``; the cache's
        self-attention part is zeros, as the JAX package's."""
        enc = ed.encode(params, batch["frames"], cfg)
        cache = ed.encdec_cache_init(cfg, enc.shape[0], max_seq,
                                     enc.shape[1], enc.device)
        cache = ed.encdec_fill_cross_cache(params, enc, cfg, cache)
        h = ed.decode_train(params, enc, batch["tokens"], cfg)
        return tf.lm_logits(params, h[:, -1:, :], cfg)[:, 0, :], cache

    def decode_step(params, token, pos, cache):
        h, cache = ed.encdec_decode_step(
            params, _token_embedding(params, token, cfg), cache, pos, cfg)
        return tf.lm_logits(params, h, cfg)[:, 0, :], cache

    return SimpleNamespace(cfg=cfg, init=init, forward=forward,
                           init_cache=init_cache, prefill=prefill,
                           decode_step=decode_step)
