"""Plain torch oracles for the kernels (counterpart of ``repro/kernels/ref.py``)."""
from __future__ import annotations

import torch


def stable_sort_values(x: torch.Tensor, *, descending: bool = True,
                       dim: int = -1) -> torch.Tensor:
    """Sorted values in XLA's order: the stable ascending sort, reversed
    when descending. Keys that compare equal with unequal bits (+0.0 and
    -0.0) then come out in ``jnp.sort``'s order, which
    ``torch.sort(descending=True, stable=True)`` reverses."""
    out = torch.sort(x, dim=dim, stable=True).values
    return torch.flip(out, [dim]) if descending else out


def merge_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Descending merge oracle."""
    return torch.sort(torch.cat([a, b]), descending=True).values


def sort_rows_ref(x: torch.Tensor) -> torch.Tensor:
    """Descending per-row sort oracle for (m, c) tensors."""
    return torch.sort(x, dim=-1, descending=True).values
