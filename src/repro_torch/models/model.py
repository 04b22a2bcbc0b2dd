"""The model API: ``init`` / ``forward`` / ``init_cache`` / ``prefill`` /
``decode_step`` of a decoder (counterpart of ``repro/models/model.py``).

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    model = build_model(get_config("moonshot_v1_16b_a3b"))
    params = model.init(torch.Generator("cuda").manual_seed(0))
    cache = model.init_cache(8, 256)
    logits, cache = model.decode_step(params, tokens, positions, cache)

``init`` takes an explicit ``torch.Generator`` and builds the weights on
its device (or ``device=``); everything else runs where its inputs are.
The encoder-decoder, ``train_loss`` and the chunked cross-entropy wait for
later slices (ROADMAP queue 1 items 2 and 5).
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict

import torch

from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig, torch_dtype
from repro_torch.models.layers import embed_lookup


def build_model(cfg: ModelConfig) -> SimpleNamespace:
    if cfg.arch_kind == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder is not ported yet (ROADMAP "
            "queue 1 item 2: encdec.py)")
    tf.check_arch(cfg)
    return _build_decoder(cfg)


def _embed_inputs(params, batch: Dict[str, Any], cfg):
    """Token embedding. Returns ``(x, positions)``."""
    x = embed_lookup(params["embed"], batch["tokens"], cfg.embed_scale)
    x = x.to(torch_dtype(cfg.compute_dtype))
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    return x, positions


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
        x = embed_lookup(params["embed"], token[:, None], cfg.embed_scale)
        x = x.to(torch_dtype(cfg.compute_dtype))
        h, cache = tf.decoder_decode_step(params, x, cache, pos, cfg)
        return tf.lm_logits(params, h, cfg)[:, 0, :], cache

    return SimpleNamespace(cfg=cfg, init=init, forward=forward,
                           init_cache=init_cache, prefill=prefill,
                           decode_step=decode_step,
                           cache_batch_axis=tf.CACHE_BATCH_AXIS)
