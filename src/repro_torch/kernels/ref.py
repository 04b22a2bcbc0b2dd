"""Plain torch oracles for the kernels (counterpart of ``repro/kernels/ref.py``)."""
from __future__ import annotations

import torch


def merge_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Descending merge oracle."""
    return torch.sort(torch.cat([a, b]), descending=True).values


def sort_rows_ref(x: torch.Tensor) -> torch.Tensor:
    """Descending per-row sort oracle for (m, c) tensors."""
    return torch.sort(x, dim=-1, descending=True).values
