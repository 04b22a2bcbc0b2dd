"""Carry the JAX package's weights into the port.

``decoder_params_from_jax`` takes the whole parameter tree of a decoder
(``repro.models.model.build_model(cfg).init(key)``, every leaf as a numpy
array) and returns the port's: the same nesting and stacked (L, ...)
layout, bits kept. ``moe_params_from_jax`` takes the dict
``repro.models.moe.moe_init`` returns, as numpy arrays (``np.asarray`` of each leaf: ``router`` (d, E)
float32, ``wi`` / ``wg`` (E, d, f), ``wo`` (E, f, d) in the config's
parameter dtype), and returns the port's tensors on ``device``. numpy holds
a bf16 array as ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses:
its bits go through ``uint16`` and are viewed as ``torch.bfloat16``.
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


def decoder_params_from_jax(p_np, device="cuda"):
    """A decoder's whole parameter tree, JAX layout kept: ``embed``,
    ``final_norm`` and ``blocks`` (``attn``, ``attn_norm``, ``mlp`` or
    ``moe``, ``mlp_norm``, each leaf stacked over the layers)."""
    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        return tensor_from_numpy(tree, device)
    out = conv({k: v for k, v in p_np.items() if k != "blocks"})
    blocks = dict(p_np["blocks"])
    moe = blocks.pop("moe", None)
    out["blocks"] = conv(blocks)
    if moe is not None:
        out["blocks"]["moe"] = moe_params_from_jax(moe, device)
    return out
