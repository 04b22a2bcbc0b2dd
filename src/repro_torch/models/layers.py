"""Parameter initialisers (counterpart of part of ``repro/models/layers.py``)."""
from __future__ import annotations

import torch


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
               device="cuda") -> torch.Tensor:
    """An (in_dim, out_dim) weight: float32 normals from ``gen`` times
    ``1 / sqrt(in_dim)``, cast to ``dtype``. ``gen`` lives on
    ``device``. The numbers differ from ``jax.random``'s for the same seed;
    a test that needs both hands the JAX weights over (``models.convert``)."""
    std = 1.0 / (in_dim ** 0.5)
    w = torch.randn((in_dim, out_dim), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * std).to(dtype)
