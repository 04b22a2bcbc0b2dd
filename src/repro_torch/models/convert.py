"""Carry the JAX package's weights into the port.

``decoder_params_from_jax`` takes the whole parameter tree of a decoder of
any family (``repro.models.model.build_model(cfg).init(key)``, every leaf
as a numpy array) and returns the port's: the same nesting and stacked
layout, bits kept. ``encdec_params_from_jax`` does the same for the
encoder-decoder. ``moe_params_from_jax`` takes the dict
``repro.models.moe.moe_init`` returns, as numpy arrays (``router`` (d, E)
float32, ``wi`` / ``wg`` (E, d, f), ``wo`` (E, f, d) in the config's
parameter dtype), and returns the port's tensors on ``device``. numpy holds
a bf16 array as ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses:
its bits go through ``uint16`` and are viewed as ``torch.bfloat16``.
``opt_state_from_jax`` carries a JAX ``AdamWState`` (its step, ``m``, ``v``
and ``master`` as numpy) into the port's ``optim.AdamWState``, so a JAX
step and a port step start from the same state.
"""
from __future__ import annotations

import numpy as np
import torch


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """One numpy array as a torch tensor of the same dtype and bits."""
    a = np.ascontiguousarray(np.asarray(a))
    if not a.flags.writeable:        # torch.from_numpy shares the buffer
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def moe_params_from_jax(p_np, device="cuda"):
    """The MoE layer's parameters, JAX layout kept: ``router`` (d, E),
    ``wi`` / ``wg`` (E, d, f), ``wo`` (E, f, d)."""
    return {name: tensor_from_numpy(p_np[name], device)
            for name in ("router", "wi", "wg", "wo")}


def _tree_from_jax(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_from_jax(v, device) for v in tree)
    return tensor_from_numpy(tree, device)


def decoder_params_from_jax(p_np, device="cuda"):
    """A decoder's whole parameter tree, JAX layout kept: ``embed``,
    ``final_norm`` and the family's stacks (``blocks``, and
    ``shared_attn`` for Zamba2; ``mlstm`` (groups, k - 1, ...) and
    ``slstm`` for xLSTM; ``local`` / ``global`` for Gemma-2), the MoE
    sub-trees wherever they sit."""
    return _tree_from_jax(p_np, device)


def encdec_params_from_jax(p_np, device="cuda"):
    """The encoder-decoder's parameter tree, JAX layout kept: ``embed``,
    ``enc_blocks`` and ``dec_blocks`` stacked over their layers,
    ``enc_norm`` and ``final_norm``."""
    missing = {"enc_blocks", "dec_blocks", "enc_norm"} - set(p_np)
    if missing:
        raise ValueError(f"not an encoder-decoder tree: no {sorted(missing)}")
    return _tree_from_jax(p_np, device)


def opt_state_from_jax(state_np, device="cuda"):
    """A JAX ``AdamWState`` (a NamedTuple of ``step``, ``m``, ``v``,
    ``master``; leaves as numpy arrays) as the port's, layout kept."""
    from repro_torch.optim.adamw import AdamWState
    return AdamWState(tensor_from_numpy(state_np.step, device),
                      _tree_from_jax(state_np.m, device),
                      _tree_from_jax(state_np.v, device),
                      _tree_from_jax(state_np.master, device))
