"""Streaming-traffic models and the memory rate they are priced against.

Counterpart of the traffic models in ``repro/launch/roofline.py``: a merge
pass reads and writes every element once, so the least traffic of a pass
is ``2 · n · itemsize`` bytes, and the out-of-core sort moves one
run-formation pass plus ``external_passes`` run-merge passes. ``mem_bw`` is
the ceiling those bytes are divided by.
"""
from __future__ import annotations

import os
from typing import Optional

#: streaming-memory rate per backend (bytes/s): the H100 SXM's HBM3 from
#: NVIDIA's data sheet, the yardstick of every bound ``chip_smoke.py``
#: reports (it reads this entry, so no override moves those bounds). Other
#: backends have no figure: set ``REPRO_MEM_BW_GBPS`` to a measured rate.
MEM_BW_BY_BACKEND = {"cuda": 3.35e12}


def mem_bw(backend: Optional[str] = None) -> float:
    """The memory-rate ceiling (bytes/s) of ``backend`` (the current one,
    ``cuda`` when a card is present, by default). ``REPRO_MEM_BW_GBPS``
    (GB/s, decimal) overrides the table."""
    env = os.environ.get("REPRO_MEM_BW_GBPS")
    if env:
        return float(env) * 1e9
    if backend is None:
        import torch
        backend = "cuda" if torch.cuda.is_available() else "cpu"
    if backend not in MEM_BW_BY_BACKEND:
        raise ValueError(f"no memory rate known for backend {backend!r}; "
                         "set REPRO_MEM_BW_GBPS")
    return MEM_BW_BY_BACKEND[backend]


def stream_bytes(n_elems: int, itemsize: int, passes: int = 1) -> int:
    """Bytes moved by ``passes`` read+write streaming passes over the data."""
    return 2 * n_elems * itemsize * passes


def external_passes(n_runs: int, fan_in: int) -> int:
    """Phase-2 passes of the out-of-core sort: ``n_runs`` runs merged
    ``fan_in`` per group per pass reduce in ``ceil(log_fan_in(n_runs))``
    passes (a per-pass ``ceil(runs / fan_in)``, as ``run_external_sort``
    takes them)."""
    f = max(fan_in, 2)
    passes, r = 0, max(n_runs, 1)
    while r > 1:
        r = -(-r // f)
        passes += 1
    return passes


def external_sort_bytes(n: int, itemsize: int, tile: int,
                        fan_in: int) -> int:
    """Least traffic of the two-phase out-of-core sort: one run-formation
    pass plus ``external_passes`` run-merge passes."""
    runs = max(-(-n // max(tile, 1)), 1)
    return stream_bytes(n, itemsize, 1 + external_passes(runs, fan_in))
