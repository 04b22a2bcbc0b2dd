"""Roofline terms and streaming-traffic models (counterpart of
``repro/launch/roofline.py``).

Hardware model, one NVIDIA H100 SXM (NVIDIA's data sheet):
  peak dense bf16 : 989 TFLOP/s (tensor cores, no sparsity)
  HBM3            : 3.35 TB/s
  NVLink 4        : 450 GB/s each way to the other cards of the host

Terms (seconds, one rank: the counted cost is rank 0's program):
  compute    = FLOPs / PEAK_FLOPS
  memory     = bytes / HBM_BW
  collective = collective bytes / LINK_BW

The JAX module reads FLOPs, bytes and collective bytes from XLA's compiled
HLO; torch compiles nothing, so :func:`analyse` and
:func:`collective_bytes` take the dry run's counted cost
(``launch/op_cost.py``) instead. The traffic models are the JAX module's,
formula for formula: a merge pass reads and writes every element once, so
the least traffic of a pass is ``2 · n · itemsize`` bytes.
"""
from __future__ import annotations

import math
import os
from dataclasses import asdict, dataclass
from typing import Dict, Optional

#: dense bf16 tensor-core rate of one H100 SXM (FLOP/s)
PEAK_FLOPS = 989e12
#: HBM3 rate of one H100 SXM (bytes/s)
HBM_BW = 3.35e12
#: NVLink 4 of one H100 SXM, each way (bytes/s; 900 GB/s both ways)
LINK_BW = 450e9
#: device memory of one H100 SXM (bytes): ``peak_ok``'s limit
DEVICE_BYTES = 80e9

#: streaming-memory rate per backend (bytes/s): the H100's HBM3, the
#: yardstick of every bound ``chip_smoke.py`` reports (it reads this entry,
#: so no override moves those bounds). Other backends have no figure: set
#: ``REPRO_MEM_BW_GBPS`` to a measured rate.
MEM_BW_BY_BACKEND = {"cuda": HBM_BW}

#: the collective kinds the dry run counts, as ``parallel/comm.py`` names
#: them (the JAX module's ``all-reduce`` is ``psum`` / ``pmax`` here)
COLLECTIVES = ("all_gather", "all_to_all", "psum", "pmax", "reduce_scatter",
               "broadcast", "ppermute")


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


# --------------------------------------------------------------------------
# streaming-traffic models of the sort / merge / routing paths
# --------------------------------------------------------------------------

def stream_bytes(n_elems: int, itemsize: int, passes: int = 1) -> int:
    """Bytes moved by ``passes`` read+write streaming passes over the data."""
    return 2 * n_elems * itemsize * passes


def merge_tree_passes(n_runs: int, levels_per_pass: int = 1) -> int:
    """Round trips through device memory to reduce ``n_runs`` sorted runs:
    ``ceil(log2 K)`` tree levels, ``levels_per_pass`` of them fused a
    pass. One-shot executors (``torch``) count as one pass."""
    if n_runs <= 1:
        return 0
    levels = math.ceil(math.log2(n_runs))
    return -(-levels // max(levels_per_pass, 1))


def sort_stream_bytes(n: int, itemsize: int, chunk: int,
                      levels_per_pass: int = 1) -> int:
    """Least streaming traffic of a two-level sort: one chunk-sort pass
    plus the merge-tree reduction of ``n / chunk`` runs."""
    runs = max(-(-n // max(chunk, 1)), 1)
    return stream_bytes(n, itemsize,
                        1 + merge_tree_passes(runs, levels_per_pass))


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


def moe_route_bytes(T: int, E: int, k: int, fused: bool = True) -> int:
    """Least traffic of routing a chunk of ``T`` tokens, ``k`` of ``E``
    experts each, every lane float32 / int32. ``fused`` (K7): the logits
    read once and the six routed lanes written once. Unfused: every stage
    reads and writes its intermediates as well (top-k values and indices,
    the softmax, the three sorted lanes, the rank / keep / slab scan)."""
    lane = T * k * 4
    logits = T * E * 4
    out_lanes = 6 * lane
    if fused:
        return logits + out_lanes
    return (logits + 2 * lane          # top-k: read logits, write vals+idx
            + 2 * lane                 # softmax over the top-k values
            + 2 * 3 * lane             # stable KV sort: 3 lanes in + out
            + 2 * 3 * lane             # rank scan + keep + slab select
            + out_lanes)


def moe_dispatch_bytes(T: int, E: int, k: int, d: int, cap: int,
                       itemsize: int = 4, fused: bool = True) -> int:
    """Traffic of one whole dispatch: route, scatter the tokens into the
    (E, cap, d) slabs, the slabs through the experts once (read in, write
    out), and the combine back to (T, d)."""
    io = 2 * T * d * itemsize          # read x, write y
    slab = E * cap * d * itemsize
    return io + 4 * slab + moe_route_bytes(T, E, k, fused)


def bound_us(n_bytes: float, backend: Optional[str] = None) -> float:
    """The least time (µs) to move ``n_bytes`` at the backend's streaming
    rate."""
    return n_bytes / mem_bw(backend) * 1e6


# --------------------------------------------------------------------------
# roofline terms of a dry-run cell
# --------------------------------------------------------------------------

def collective_bytes(cost) -> Dict[str, int]:
    """Bytes per collective kind of a counted cost (``op_cost.Cost``), in
    ``comm.host_staged_bytes_by_kind()``'s convention: what each collective
    hands to the transport and gets back."""
    return {k: int(cost.coll.get(k, 0)) for k in COLLECTIVES}


@dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    coll_bytes: float
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float
    useful_ratio: float
    mem_per_device_gb: float

    def to_dict(self):
        return asdict(self)


def analyse(cost, *, model_flops: float, n_chips: int) -> Roofline:
    """The roofline terms of rank 0's counted cost (``op_cost.Cost``: its
    FLOPs, bytes, collective bytes and memory), beside the model's FLOPs
    shared over ``n_chips``. The counts come from an eager run, which
    visits every layer, so no loop multiplicity is missing."""
    flops, hbm, coll = cost.flops, cost.bytes, cost.coll_total
    t_c = flops / PEAK_FLOPS
    t_m = hbm / HBM_BW
    t_x = coll / LINK_BW
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    bottleneck = max(terms, key=terms.get)
    mem_gb = (cost.args_bytes + cost.output_bytes + cost.temp_bytes) / 1e9
    per_dev_model_flops = model_flops / n_chips
    return Roofline(flops, hbm, coll, t_c, t_m, t_x, bottleneck,
                    model_flops,
                    per_dev_model_flops / flops if flops else 0.0,
                    mem_gb)


def model_flops_estimate(cfg, shape_kind: str, seq_len: int,
                         global_batch: int) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE) for training,
    2·N·D for a forward; a decode step's D is the batch."""
    n_active = param_count_active(cfg)
    if shape_kind == "train":
        tokens = seq_len * global_batch
        return 6.0 * n_active * tokens
    if shape_kind == "prefill":
        tokens = seq_len * global_batch
        return 2.0 * n_active * tokens          # forward only
    tokens = global_batch                        # one token per request
    return 2.0 * n_active * tokens


def param_count_active(cfg) -> float:
    """Active-parameter count (MoE counts the top-k experts only)."""
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab_size
    hd, H, K = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    attn = d * hd * (H + 2 * K) + H * hd * d
    if cfg.family == "moe":
        f = cfg.moe_d_ff or cfg.d_ff
        ffn = 3 * d * f * cfg.n_experts_active + d * cfg.n_experts
    else:
        ffn = 3 * d * cfg.d_ff
    if cfg.arch_kind == "mamba_hybrid":
        d_in = cfg.ssm_expand * d
        N = cfg.ssm_state
        mamba = d * (2 * d_in + 2 * N + d_in // cfg.ssm_head_dim) + d_in * d
        n_attn = L // cfg.hybrid_attn_every
        return L * mamba + n_attn * (attn + ffn) + V * d
    if cfg.arch_kind == "xlstm":
        mlstm = 3 * d * H * hd + d * 2 * H + H * hd * d
        slstm = 8 * d * d + d * d
        k = cfg.slstm_every
        ng = L // k
        return ng * ((k - 1) * mlstm + slstm) + V * d
    if cfg.arch_kind == "encdec":
        enc = (cfg.n_encoder_layers or L) * (attn + ffn)
        cross = L * attn
        return enc + L * (attn + ffn) + cross + V * d
    return L * (attn + ffn) + V * d
