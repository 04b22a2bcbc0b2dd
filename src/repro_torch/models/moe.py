"""Mixture-of-Experts layer (Mixtral 8 experts top-2, Moonlight 64 top-6).

Counterpart of ``repro/models/moe.py`` on one device. Dispatch paths:

- ``dense``: every expert sees every token, combined by a one-hot weight
  einsum over the expert axis; the reference the sorted paths are held
  against when nothing drops.
- ``sorted``: ``engine.moe_route`` on the raw router logits of all tokens
  returns the permuted lanes, combine weights, slab indices and keep mask
  of the GShard capacity contract in one planned call (one K7 launch on
  the card); the tokens are scattered into (E, cap, d) slabs, the experts
  run as batched products and the contributions are combined.
- ``grouped``: the same over sequence chunks of ``seq_chunk`` tokens per
  row, one route per chunk. With one device there is one group (G = 1),
  and the JAX package's sharding constraints are the identity, so neither
  appears here.
- ``ep``: expert parallelism over the ``model`` axis of the mesh that
  ``parallel.act.set_context`` installs. Every rank of the axis holds E/P
  experts and sees the same tokens; it routes them all (one K7 launch a
  chunk), keeps the pairs of its own expert band, runs its slabs, and
  one ``psum`` over the axis gathers the pairs' weighted outputs, summed
  per token after it. It carries a gradient (``comm.psum_entry`` /
  ``psum_exit`` around the region). Without a mesh or a model axis, or
  when P does not divide E, it runs ``grouped``, as the JAX package does;
  under an ``AbstractMesh`` one process computes the mesh's function.

The expert products are plain batched matrix products outside any kernel
(``torch.einsum``). The slab scatter is an indexed copy (dropped pairs all
land on one overflow row that is cut off). The combine is a fixed-order
sum: each pair's contribution goes to its position ``t*k + j`` (``perm``)
and the k contributions of a token are summed over that axis, where the
JAX package scatter-adds in sorted pair order; for k = 2 the two agree bit
for bit, and ``index_add_`` on the card (atomic, with a run-to-run order)
is avoided.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import engine
from repro_torch.kernels.route_fuse import topk_softmax
from repro_torch.models.config import torch_dtype
from repro_torch.models.layers import dense_init


def moe_init(gen: torch.Generator, cfg, device="cuda"):
    """Router (d, E) float32 and stacked expert weights ``wi`` / ``wg`` (E,
    d, f) and ``wo`` (E, f, d) in ``cfg.param_dtype``, drawn from ``gen``
    (a generator on ``device``)."""
    dtype = torch_dtype(cfg.param_dtype)
    E, d, f = cfg.n_experts, cfg.d_model, (cfg.moe_d_ff or cfg.d_ff)

    def stack(din, dout):
        if torch.device(device).type == "meta":     # shapes only
            return torch.empty((E, din, dout), dtype=dtype, device="meta")
        return torch.stack([dense_init(gen, din, dout, dtype, device=device)
                            for _ in range(E)])

    return {"router": dense_init(gen, d, E, torch.float32, device=device),
            "wi": stack(d, f), "wg": stack(d, f), "wo": stack(f, d)}


def expert_capacity(capacity_factor: float, T: int, k: int, E: int) -> int:
    """GShard per-expert slab capacity for T tokens, k active of E experts;
    the ``+ 1`` keeps tiny chunks from rounding to an empty slab."""
    return int(capacity_factor * T * k / E) + 1


def router_probs(p, x, cfg):
    """x: (B, S, d) -> (weights (B, S, k) in x's dtype, expert ids (B, S, k)
    int64): the softmax over the top k of the float32 router logits."""
    logits = x.float() @ p["router"]
    w, idx = topk_softmax(logits, cfg.n_experts_active)
    return w.to(x.dtype), idx


def _seq_chunk(S: int, candidates) -> int:
    for cand in candidates:
        if cand and S % cand == 0 and S > cand:
            return cand
    return S


def moe_apply_dense(p, x, cfg):
    """Masked dense-compute MoE: every expert sees every token, one sequence
    chunk at a time; FLOP-inflated by E/k against the sorted paths."""
    B, S, d = x.shape
    E = cfg.n_experts
    w, idx = router_probs(p, x, cfg)                          # (B, S, k)
    eye = torch.arange(E, device=x.device)
    comb = ((idx[..., None] == eye) * w[..., None]).sum(2).to(x.dtype)
    Sc = _seq_chunk(S, (512, 256, 128, 64))
    ys = []
    for i in range(S // Sc):
        xc, cc = x[:, i * Sc:(i + 1) * Sc], comb[:, i * Sc:(i + 1) * Sc]
        h = torch.einsum("bsd,edf->ebsf", xc, p["wg"])
        h = F.silu(h) * torch.einsum("bsd,edf->ebsf", xc, p["wi"])
        # weight h first, then contract (e, f) jointly: the (E, B, Sc, d)
        # post-expert tensor is never formed
        hw = h * cc.permute(2, 0, 1)[..., None]
        ys.append(torch.einsum("ebsf,efd->bsd", hw, p["wo"]))
    return torch.cat(ys, dim=1)


def _scatter_slabs(xg, route, E: int, cap: int):
    """(G, T, d) tokens -> (G, E, cap, d) slabs: each kept pair's token at
    its slab; dropped pairs all land on one overflow row that is cut off."""
    G, _, d = xg.shape
    g = torch.arange(G, device=xg.device)[:, None]
    xin = xg.new_zeros((G, E * cap + 1, d))
    xin[g, route.slabs.long()] = xg[g, route.tokens.long()]
    return xin[:, :-1].reshape(G, E, cap, d)


def _experts(p, xin):
    """The SwiGLU experts on (G, E, cap, d) slabs: batched products."""
    h = torch.einsum("gecd,edf->gecf", xin, p["wg"])
    h = F.silu(h) * torch.einsum("gecd,edf->gecf", xin, p["wi"])
    return torch.einsum("gecf,efd->gecd", h, p["wo"])


def _contributions(y, route, T: int, k: int):
    """(G, E, cap, d) expert outputs -> (G, T, k, d): each pair's slab row
    times its weight (zero when dropped) at its position ``perm = t*k +
    j``."""
    G, E, cap, d = y.shape
    g = torch.arange(G, device=y.device)[:, None]
    keep, slab = route.keep, route.slabs.long()
    contrib = y.reshape(G, E * cap, d)[g, torch.where(keep, slab, 0)] * \
        (route.weights.to(y.dtype) * keep)[..., None]
    out = torch.empty_like(contrib)
    out[g, route.perm.long()] = contrib
    return out.reshape(G, T, k, d)


def _combine(y, route, T: int, k: int):
    """(G, E, cap, d) expert outputs -> (G, T, d): the k contributions of
    each token summed in that fixed order."""
    return _contributions(y, route, T, k).sum(2)


def _group_dispatch_batched(p, xg, cfg, cap):
    """Route all G groups of xg (G, T, d) in one ``engine.moe_route`` call
    on the (G, T, E) logits (one K7 launch on the card) and pack the (G, E,
    cap, d) slabs. Returns the slabs and the route's (G, T*k) lanes."""
    logits = xg.float() @ p["router"]                          # (G, T, E)
    route = engine.moe_route(logits, cfg.n_experts_active, cap)
    return _scatter_slabs(xg, route, cfg.n_experts, cap), route


def _routed(p, xg, cfg, cap):
    """Route, scatter, run the experts and combine one (G, T, d) chunk."""
    xin, route = _group_dispatch_batched(p, xg, cfg, cap)
    return _combine(_experts(p, xin), route, xg.shape[1],
                    cfg.n_experts_active)


def moe_apply_sorted(p, x, cfg, capacity_factor: float = 1.25):
    """Capacity dispatch of all B*S tokens through one ``engine.moe_route``
    call: scatter into per-expert slabs, run the experts, combine."""
    B, S, d = x.shape
    T = B * S
    cap = expert_capacity(capacity_factor, T, cfg.n_experts_active,
                          cfg.n_experts)
    return _routed(p, x.reshape(1, T, d), cfg, cap).reshape(B, S, d)


def _grouped(p, x, cfg, capacity_factor: float, Sc: int, G: int):
    """x's rows in ``G`` groups, each chunk of ``Sc`` positions of a group
    routed and dispatched on its own, all groups in one
    ``engine.moe_route`` call a chunk."""
    B, S, d = x.shape
    T = (B // G) * Sc
    cap = expert_capacity(capacity_factor, T, cfg.n_experts_active,
                          cfg.n_experts)
    return torch.cat([
        _routed(p, x[:, i * Sc:(i + 1) * Sc].reshape(G, T, d), cfg,
                cap).reshape(B, Sc, d) for i in range(S // Sc)], dim=1)


def moe_apply_grouped(p, x, cfg, capacity_factor: float = 1.25,
                      seq_chunk: int = 512):
    """FLiMS-sorted capacity dispatch over sequence chunks: each chunk of
    ``B * Sc`` tokens is routed with one ``engine.moe_route`` call (one K7
    launch) and dispatched through per-expert slabs; tokens over capacity
    are dropped (GShard semantics). One group: the JAX package's G is the
    data-shard count of the global batch it sees, and a port rank holds
    one data shard's rows."""
    S = x.shape[1]
    Sc = _seq_chunk(S, (seq_chunk, seq_chunk // 2, seq_chunk // 4))
    return _grouped(p, x, cfg, capacity_factor, Sc, 1)


def _expert_band(w, E: int, E_loc: int, e0: int):
    """This rank's experts of a stacked (E or E_loc, ...) expert weight:
    the band ``[e0, e0 + E_loc)`` of a whole stack, or the rank's own
    shard as it is (``convert.shard_params_for_rank``)."""
    if w.shape[0] == E_loc:
        return w
    if w.shape[0] == E:
        return w[e0:e0 + E_loc]
    raise ValueError(f"expert weights of {w.shape[0]} experts: neither all "
                     f"{E} nor this rank's {E_loc}")


def moe_apply_ep(p, x, cfg, capacity_factor: float = 1.25,
                 seq_chunk: int = 1024):
    """Expert parallelism over the context's model axis (SPMD).

    Every rank of the axis holds E/P experts (``p``'s stacks may hold all
    E; the rank takes its band) and the same tokens ``x`` (B, S, d): its
    block of the batch when the mesh has data axes. Per sequence chunk of
    ``Sc`` positions it routes all ``B * Sc`` tokens with
    ``engine.moe_route`` (one K7 launch), keeps the pairs of its own
    experts, scatters them into its (E/P, cap, d) slabs, runs them,
    combines locally, and one ``psum`` over the axis adds the P partial
    outputs (in rank order: every rank holds the same bits). Falls back to
    ``moe_apply_grouped`` without a mesh or a model axis, or when P does
    not divide E.

    Under an ``AbstractMesh`` context one process stands in for the whole
    mesh: ``x`` is the global batch and ``p`` holds every expert. It then
    computes what the mesh computes, each data shard's rows
    (``act.group_count(B)`` groups) routed as one group a chunk, with no
    collective.

    Under a gradient the tokens and the router logits enter the region
    through ``comm.psum_entry`` and the partial outputs leave it through
    ``comm.psum_exit``: a rank's band of pairs gives its experts their
    whole gradient, and the tokens, the logits (so the router) the sum of
    every band's, the same bits on every rank. K7's forward and its plain
    backward run over the rank's route as they are.
    """
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.parallel import act, comm
    mesh, tp = act.context_mesh(), act.model_axis()
    E = cfg.n_experts
    if mesh is None or tp is None or E % mesh.axis_size(tp):
        return moe_apply_grouped(p, x, cfg, capacity_factor)
    B, S, d = x.shape
    Sc = min(seq_chunk, S)
    while S % Sc:
        Sc //= 2
    if isinstance(mesh, AbstractMesh):
        return _grouped(p, x, cfg, capacity_factor, Sc, act.group_count(B))
    k = cfg.n_experts_active
    E_loc = E // mesh.axis_size(tp)
    e0 = mesh.axis_index(tp) * E_loc
    wl = {n: _expert_band(p[n], E, E_loc, e0) for n in ("wi", "wg", "wo")}
    T = B * Sc
    cap = expert_capacity(capacity_factor, T, k, E)
    outs = []
    for i in range(S // Sc):
        xf = x[:, i * Sc:(i + 1) * Sc].reshape(T, d)
        # the tokens and the logits enter the region where each rank works
        # on its own band: their gradients are summed over the axis
        logits = comm.psum_entry(xf.float() @ p["router"], tp, mesh)
        xf = comm.psum_entry(xf, tp, mesh)
        route = engine.moe_route(logits, k, cap)
        # slabs are e*cap + pos: re-basing to this rank's buffer is one
        # subtraction; pairs of other ranks' experts become drops
        mine = (route.experts >= e0) & (route.experts < e0 + E_loc)
        keep = route.keep & mine
        slab = torch.where(keep, route.slabs - e0 * cap, E_loc * cap)
        local = route._replace(slabs=slab, keep=keep)
        xin = _scatter_slabs(xf[None], _batched(local), E_loc, cap)
        y = _experts(wl, xin)
        # the (T, k, d) contributions cross the axis, each nonzero on one
        # rank only, and a token's k are summed after: the sum of one
        # device, whose rounding does not depend on how E is split
        part = _contributions(y, _batched(local), T, k)[0]
        outs.append(comm.psum_exit(part, tp, mesh).sum(1)
                    .reshape(B, Sc, d))
    return torch.cat(outs, dim=1)


def _batched(route):
    return type(route)(*(t[None] for t in route))


def moe_apply(p, x, cfg, mode: str = None):
    """The MoE layer through the path ``mode`` (default ``cfg.moe_path``):
    ``dense``, ``sorted``, ``grouped``, or ``ep`` (expert parallelism over
    the context's model axis; ``grouped`` without one, as the JAX package
    does)."""
    mode = mode or getattr(cfg, "moe_path", "dense")
    if mode == "sorted":
        return moe_apply_sorted(p, x, cfg)
    if mode == "grouped":
        return moe_apply_grouped(p, x, cfg)
    if mode == "ep":
        return moe_apply_ep(p, x, cfg)
    return moe_apply_dense(p, x, cfg)
