"""Shared layers and parameter initialisers (counterpart of
``repro/models/layers.py``).

Pure functions of tensors, each op for op the JAX package's: norms and the
Gemma-2 soft cap compute in float32 and return the input's dtype, RoPE
rotates the two halves of the head dimension, and the MLPs are
SwiGLU / GeGLU (tanh GELU). Initialisers draw float32 normals from an
explicit ``torch.Generator`` on the target device; the numbers differ from
``jax.random``'s for the same seed, so a test that needs both sides equal
hands the JAX weights over (``models.convert``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
               device="cuda", scale: float = 1.0) -> torch.Tensor:
    """An (in_dim, out_dim) weight: float32 normals from ``gen`` times
    ``scale / sqrt(in_dim)``, cast to ``dtype``. ``gen`` lives on
    ``device``."""
    std = scale / (in_dim ** 0.5)
    w = torch.randn((in_dim, out_dim), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * std).to(dtype)


def rmsnorm_init(dim: int, dtype, device="cuda") -> torch.Tensor:
    return torch.ones((dim,), dtype=dtype, device=device)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def layernorm_init(dim: int, dtype, device="cuda"):
    return {"w": torch.ones((dim,), dtype=dtype, device=device),
            "b": torch.zeros((dim,), dtype=dtype, device=device)}


def layernorm(x: torch.Tensor, p, eps: float = 1e-6):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["w"].float() + p["b"].float()).to(x.dtype)


def softcap(x: torch.Tensor, cap: float):
    """Gemma-2 logit soft-capping (the identity when ``cap`` is 0)."""
    if not cap:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


# --- RoPE ---------------------------------------------------------------

def rope_freqs(hd: int, theta: float, device="cuda") -> torch.Tensor:
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0):
    """x: (..., S, H, hd); positions: (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)       # (hd/2,)
    ang = positions[..., :, None].float() * freqs         # (..., S, hd/2)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# --- MLP -----------------------------------------------------------------

def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, dtype,
             device="cuda"):
    return {"wi": dense_init(gen, d_model, d_ff, dtype, device),
            "wg": dense_init(gen, d_model, d_ff, dtype, device),
            "wo": dense_init(gen, d_ff, d_model, dtype, device)}


def mlp_swiglu(x: torch.Tensor, p):
    return (F.silu(x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]


def mlp_geglu(x: torch.Tensor, p):
    return (F.gelu(x @ p["wg"], approximate="tanh") * (x @ p["wi"])) @ p["wo"]


# --- embeddings -----------------------------------------------------------

def embed_init(gen: torch.Generator, vocab: int, d_model: int, dtype,
               device="cuda") -> torch.Tensor:
    w = torch.randn((vocab, d_model), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * 0.02).to(dtype)


def embed_lookup(table: torch.Tensor, ids: torch.Tensor, scale: bool = False):
    x = table[ids.long()]
    if scale:
        x = x * torch.tensor(table.shape[1] ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x
