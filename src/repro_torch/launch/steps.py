"""Step-function factories: train_step / prefill_step / decode_step, and
``meta``-device stand-ins of a cell's inputs and state (counterpart of
``repro/launch/steps.py``).

The trainer and the server build their steps here. ``make_decode_step``
takes the JAX signature's mesh and sequence-sharding axis; the JAX
module's ``shardings_for`` / ``cell_shardings`` (a train step on a mesh)
are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.core.butterfly import tree_leaves
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.models.config import ModelConfig, TrainConfig
from repro_torch.models.model import build_model, sample_topk
from repro_torch.optim.adamw import adamw_init, adamw_update, lr_schedule

__all__ = ["SHAPES", "LONG_OK", "long_500k_applicable", "make_train_step",
           "make_prefill_step", "make_decode_step", "input_specs",
           "abstract_state", "abstract_cache"]

# ---------------------------------------------------------------------------
# shapes of the assigned input grid
# ---------------------------------------------------------------------------

SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}

# archs whose decode state is sub-quadratic -> long_500k applies
LONG_OK = {"zamba2-2.7b", "xlstm-1.3b", "mixtral-8x22b"}


def long_500k_applicable(cfg: ModelConfig) -> bool:
    return cfg.name in LONG_OK


# ---------------------------------------------------------------------------
# factories
# ---------------------------------------------------------------------------

def loss_and_grads(model, params, batch):
    """``(loss, aux, grads)``: ``model.train_loss`` and its gradient with
    respect to every leaf of ``params`` (a list in ``tree_leaves`` order;
    zeros for a leaf the loss does not reach). The leaves require grad
    only for the call."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, aux = model.train_loss(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """``(model, train_step)``; ``train_step(params, opt, batch)`` takes the
    loss and its gradient, the learning rate of ``opt.step`` and one AdamW
    update (in place), and returns ``(params, opt, metrics)`` with
    ``loss``, ``lr``, ``grad_norm`` and ``ce`` as 0-d device tensors."""
    model = build_model(cfg)

    def train_step(params, opt_state, batch):
        loss, aux, grads = loss_and_grads(model, params, batch)
        lr = lr_schedule(opt_state.step, tcfg.lr, tcfg.warmup_steps,
                         tcfg.total_steps)
        params, opt_state, metrics = adamw_update(
            grads, opt_state, params, lr=lr, b1=tcfg.b1, b2=tcfg.b2,
            weight_decay=tcfg.weight_decay, grad_clip=tcfg.grad_clip)
        metrics = dict(metrics, loss=loss, lr=lr, **aux)
        return params, opt_state, metrics

    return model, train_step


def make_prefill_step(cfg: ModelConfig):
    model = build_model(cfg)

    def prefill_step(params, batch):
        return model.prefill(params, batch, max_seq=0)

    return model, prefill_step


def make_decode_step(cfg: ModelConfig, mesh=None, kv_shard_axis: str = ""):
    """``decode_step(params, token, pos, cache, generator)`` -> ``(next
    tokens, cache)``: one model step, then ``sample_topk(k=64)`` on the
    ``torch`` top-k. With ``mesh`` and ``kv_shard_axis`` the caches are
    this rank's blocks of sequence-sharded caches."""
    model = build_model(cfg)

    def decode_step(params, token, pos, cache, generator):
        logits, cache = model.decode_step(params, token, pos, cache,
                                          mesh=mesh,
                                          kv_shard_axis=kv_shard_axis)
        nxt = sample_topk(generator, logits, k=64, use_flims=False)
        return nxt, cache

    return model, decode_step


# ---------------------------------------------------------------------------
# abstract inputs and state of a (cfg, shape) cell, on the meta device
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape_name: str):
    """``meta`` stand-ins for every model input of the cell."""
    s = SHAPES[shape_name]
    return make_batch_specs(cfg, s["seq_len"], s["global_batch"])


def abstract_state(cfg: ModelConfig, shape_name: str, with_opt: bool = True):
    """``(model, params, opt or None)`` on the ``meta`` device: shapes and
    dtypes, no allocation."""
    model = build_model(cfg)
    params = model.init(torch.Generator(), device="meta")
    if not with_opt:
        return model, params, None
    return model, params, adamw_init(params)


def abstract_cache(cfg: ModelConfig, shape_name: str):
    s = SHAPES[shape_name]
    model = build_model(cfg)
    B, W = s["global_batch"], s["seq_len"]
    if cfg.arch_kind == "encdec":
        return model.init_cache(B, W, enc_len=1500, device="meta")
    return model.init_cache(B, W, device="meta")
