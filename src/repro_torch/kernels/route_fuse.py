"""K7: fused MoE routing, router logits -> capacity slabs in one call.

Counterpart of ``repro/kernels/route_fuse.py``. Per token group: ``k``
arg-max sweeps over the monotone int32 transform of the logits' bits
(``lax.top_k``'s order: ties to the lower expert, -0.0 below +0.0; a picked
expert's key masked to INT32_MIN, as ``_topk_softmax`` does), the softmax
of the ``k`` picks, the pairs in the ascending order of the distinct
compound keys ``e * Np + p`` (``p = t * k + j`` the pair's position) and
the GShard capacity cut by first-occurrence rank. On the card
(``csrc/route_fuse.cu``) the sweeps run a CTA per tile of ``ROUTE_TILE``
tokens and the sort is a counting sort (tile counts, one scan, a
scatter), three launches behind one C call.

``moe_route`` launches the kernel for a CUDA tensor and runs
``moe_route_plain`` (a torch transcription of ``_route_kernel``: the same
sweeps, ``torch.softmax``, ``_bitonic_rows_kv`` over the padded keys and
the one-hot first-occurrence cut) for a CPU tensor. ``moe_route_torch`` is
the unfused reference pipeline, op for op ``moe_route_xla``: the engine's
``torch`` variant.

All three return six (G, T*k) lanes in stable sorted pair order (expert
ascending, then pair position): experts, tokens, perm (int32), weights
(float32), slabs (``e * cap + rank``, or ``E * cap`` when dropped) and keep
(int32). The integer lanes are exact; the weights differ between the three
only by the ulps of their ``exp`` and of the order of the softmax sum.

Gradient: ``moe_route`` and ``moe_route_plain`` are one
``torch.autograd.Function`` (:class:`RouteFn`), whose forward is K7 on the
card and the plain version elsewhere, and whose backward maps the gradient
of the weights lane to the (G, T, E) logits; the integer lanes take none.
It is the JAX gradient of ``softmax(top_k(logits))``: for the k picks
``e_j`` of a token, ``dlogit[t, e_j] += w_j * (g_j - sum_i w_i g_i)``,
and 0 for every logit not picked. The backward is plain torch over the
T*k pairs, as the JAX package's is XLA autodiff of plain ops (it has no
backward kernel). It scatter-adds by expert id, since the fused rule can
pick one expert more than once (only where every unpicked key is
INT32_MIN, NaN logits); two addends give the same float32 sum in either
order, more than two may add in a run-dependent order on the card.
``moe_route_torch`` differentiates through autograd of its own ops.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.core.flims import next_pow2
from repro_torch.core.lanes import INVALID_RANK
from repro_torch.kernels import _build
from repro_torch.kernels.bitonic_sort import _bitonic_rows_kv

__all__ = ["moe_route", "moe_route_plain", "moe_route_torch", "topk_softmax",
           "untwist", "route_backward", "RouteFn", "MAX_PAIRS"]

#: the most (padded) pairs a token group may have on the card, the limit of
#: the JAX kernel's VMEM-resident sort (a larger group needs the multi-CTA
#: K7 of ROADMAP queue 2)
MAX_PAIRS = 16384
#: tokens per tile of the card's top-k and scatter launches (``kTile`` of
#: ``csrc/route_fuse.cu``)
ROUTE_TILE = 16

_I32_MAX = 2 ** 31 - 1
_I32_MIN = -2 ** 31


def untwist(bits: torch.Tensor) -> torch.Tensor:
    """The monotone int32 transform of float32 bits (its own inverse):
    int32 order is the IEEE total order, -0.0 below +0.0."""
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def _geometry(logits, k: int, capacity: int):
    if logits.ndim != 3 or logits.dtype != torch.float32:
        raise ValueError(f"moe_route: (G, T, E) float32 logits, got "
                         f"{tuple(logits.shape)} {logits.dtype}")
    G, T, E = logits.shape
    if not 1 <= k <= E or capacity < 1:
        raise ValueError(f"moe_route: k={k} outside [1, E={E}] or "
                         f"capacity={capacity} < 1")
    N = T * k
    Np = next_pow2(max(N, 8))
    if E * Np >= 2 ** 31:
        raise _build.KernelError(
            f"moe_route: the compound key e*{Np}+p overflows int32 at "
            f"E={E} (E*Np = {E * Np}); shrink the token group")
    return G, T, E, N, Np


def _route_cuda(logits, k, cap, G, T, E, N, Np):
    if Np > MAX_PAIRS:
        raise _build.KernelError(
            f"moe_route: T*k = {N} pairs pad to Np = {Np}, whose keys and "
            f"weights take {Np * 8} bytes of shared memory; one CTA holds "
            f"Np <= {MAX_PAIRS}; shrink the token group")
    logits = logits.contiguous()
    _build.check_cuda("moe_route", logits)
    dev = logits.device
    # one allocation: the six lanes, then the scratch (pair experts, pair
    # weights, per-(expert, tile) counts, first[e])
    tiles = -(-T // ROUTE_TILE)
    buf = torch.empty(G * (8 * N + E * tiles + E), dtype=torch.int32,
                      device=dev)
    base, size = buf.data_ptr(), G * N * 4
    _build.launch("moe_route", "flims_moe_route", _build.ptr(logits), G, T,
                  E, k, cap, *(base + i * size for i in range(7)),
                  _build.stream(dev))
    outs = buf[:6 * G * N].view(6, G, N).unbind(0)
    return outs[:3] + (outs[3].view(torch.float32),) + outs[4:]


def _route_plain(logits, k, cap, G, T, E, N, Np):
    dev = logits.device
    iota_e = torch.arange(E, dtype=torch.int32, device=dev)
    lanes = untwist(logits.contiguous().view(torch.int32))
    vals, idxs = [], []
    for _ in range(k):
        m = lanes.amax(-1, keepdim=True)
        ij = torch.where(lanes == m, iota_e, E).amin(-1)
        vals.append(untwist(m[..., 0]).view(torch.float32))
        idxs.append(ij)
        lanes = torch.where(iota_e == ij[..., None], _I32_MIN, lanes)
    wgt = torch.softmax(torch.stack(vals, -1), dim=-1)        # (G, T, k)
    eix = torch.stack(idxs, -1).to(torch.int32)
    pair = torch.arange(N, dtype=torch.int32, device=dev).reshape(T, k)
    kf = (eix * Np + pair).reshape(G, N)
    rf = wgt.view(torch.int32).reshape(G, N)
    kf = torch.cat([kf, kf.new_full((G, Np - N), _I32_MAX)], dim=1)
    rf = torch.cat([rf, rf.new_full((G, Np - N), INVALID_RANK)], dim=1)
    ks, rs = _bitonic_rows_kv(kf, rf, descending=False)
    iota_n = torch.arange(Np, dtype=torch.int32, device=dev)
    valid = iota_n < N
    e_s = torch.where(valid, ks // Np, E)
    p_s = torch.where(valid, ks % Np, 0)
    w_s = torch.where(valid, rs.view(torch.float32), 0.0)
    onehot = e_s[..., None] == iota_e                         # (G, Np, E)
    counts = onehot.sum(1, dtype=torch.int32)
    first = torch.cumsum(counts, -1, dtype=torch.int32) - counts
    pos = iota_n - torch.where(onehot, first[:, None, :], 0).sum(
        -1, dtype=torch.int32)
    keep = valid & (pos < cap)
    slab = torch.where(keep, e_s * cap + pos, E * cap)
    return tuple(x[:, :N].contiguous() for x in (
        e_s, p_s // k, p_s, w_s, slab, keep.to(torch.int32)))


def _moe_route(logits, k, capacity, cuda):
    G, T, E, N, Np = _geometry(logits, k, int(capacity))
    if cuda:
        return _route_cuda(logits, k, int(capacity), G, T, E, N, Np)
    return _route_plain(logits, k, int(capacity), G, T, E, N, Np)


def route_backward(g_w, experts, perm, weights, shape, k: int):
    """The (G, T, E) gradient of the logits from the gradient ``g_w`` of
    the (G, T*k) sorted weights lane: un-sort the pairs by ``perm`` into
    (G, T, k), take the softmax's gradient per token and scatter-add it by
    expert id into zeros."""
    G, T, E = shape
    p = perm.long()
    unsort = lambda lane: torch.empty_like(lane).scatter_(-1, p, lane).view(
        G, T, k)
    w, g = unsort(weights), unsort(g_w.to(weights.dtype))
    e = unsort(experts.long())
    d = w * (g - (w * g).sum(-1, keepdim=True))
    return torch.zeros(shape, dtype=weights.dtype,
                       device=weights.device).scatter_add_(-1, e, d)


class RouteFn(torch.autograd.Function):
    """K7 (``cuda=True``) or its plain version, differentiable in the
    weights lane (:func:`route_backward`)."""

    @staticmethod
    def forward(ctx, logits, k: int, capacity: int, cuda: bool):
        outs = _moe_route(logits, k, capacity, cuda)
        experts, _, perm, weights = outs[:4]
        ctx.save_for_backward(experts, perm, weights)
        ctx.shape, ctx.k = tuple(logits.shape), k
        ctx.mark_non_differentiable(*(outs[:3] + outs[4:]))
        return outs

    @staticmethod
    def backward(ctx, *grads):
        g_w = grads[3]
        if g_w is None:
            return None, None, None, None
        experts, perm, weights = ctx.saved_tensors
        return (route_backward(g_w, experts, perm, weights, ctx.shape,
                               ctx.k), None, None, None)


@obs.scoped("kernels.route_fuse")
def moe_route(logits: torch.Tensor, k: int, capacity: int):
    """Fused routing of (G, T, E) float32 router logits (counterpart of
    ``moe_route_pallas``). Returns, each (G, T*k) in stable sorted pair
    order: ``(experts, tokens, perm, weights, slabs, keep)``. On the card
    T*k pads to at most ``MAX_PAIRS``. Differentiable in the weights
    lane."""
    return RouteFn.apply(logits, k, capacity, logits.is_cuda)


def moe_route_plain(logits: torch.Tensor, k: int, capacity: int):
    """``moe_route``' plain version, on any device, with the same
    gradient."""
    return RouteFn.apply(logits, k, capacity, False)


def topk_softmax(logits: torch.Tensor, k: int):
    """``lax.top_k`` then ``jax.nn.softmax`` over the last axis of float32
    logits: the top k by a stable descending sort of the monotone int32
    keys (ties to the lower index, -0.0 below +0.0; ``torch.topk`` promises
    neither), then ``exp(v - max) / sum``. Returns ``(weights, indices)``,
    indices int64."""
    okey = untwist(logits.contiguous().view(torch.int32))
    idx = torch.sort(okey, dim=-1, descending=True, stable=True
                     ).indices[..., :k]
    vals = torch.gather(logits, -1, idx)
    u = torch.exp(vals - vals.amax(-1, keepdim=True))
    return u / u.sum(-1, keepdim=True), idx


@obs.scoped("kernels.route_torch")
def moe_route_torch(logits: torch.Tensor, k: int, capacity: int):
    """The unfused reference pipeline, op for op ``moe_route_xla``:
    ``topk_softmax``, a stable ascending argsort of the expert ids, and
    searchsorted first-occurrence ranks."""
    G, T, E = logits.shape
    N = T * k
    cap = int(capacity)
    wgt, idx = topk_softmax(logits, k)
    e = idx.reshape(G, N).to(torch.int32)
    perm = torch.argsort(e, dim=-1, stable=True)
    e_s = torch.gather(e, -1, perm)
    w_s = torch.gather(wgt.reshape(G, N), -1, perm)
    first = torch.searchsorted(e_s, e_s, side="left", out_int32=True)
    pos = torch.arange(N, dtype=torch.int32, device=logits.device) - first
    keep = pos < cap
    slab = torch.where(keep, e_s * cap + pos, E * cap)
    perm = perm.to(torch.int32)
    return (e_s, perm // k, perm, w_s, slab.to(torch.int32),
            keep.to(torch.int32))
