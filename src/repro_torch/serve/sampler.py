"""Ragged sampling: every live request's logits through one engine call.

Counterpart of ``repro/serve/sampler.py``. A decode step samples the whole
super-batch with a single ``engine.topk`` call, whose descending top-``k``
prefix breaks ties to the lower token id (``lax.top_k``'s order). What is
request-specific (greedy, a per-slot top-k cut, nucleus top-p, min-p,
temperature) is elementwise masking of that shared prefix
(:func:`sorted_prefix_sample`); greedy is "index 0 of the prefix". The same
core serves the engine's full-vocabulary ``sample_topp`` / ``sample_minp``,
whose prefix is the stable argsort of the whole row.

Randomness: a ``torch.Generator`` stands where the JAX package takes a PRNG
key, and draws the uniform noise ``u`` of the Gumbel-max step; ``u=`` may
be given instead (the tests inject the JAX side's noise, since torch's
Philox and JAX's threefry give different bits).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

#: the noise's range, as the JAX sampler draws it
U_MIN, U_MAX = 1e-9, 1.0


class SamplingState(NamedTuple):
    """Per-slot sampling parameters, each a (B,) tensor: the rows of the
    static super-batch, rewritten on admission."""
    temperature: torch.Tensor   # float32; <= 0 -> greedy (index 0)
    top_k: torch.Tensor         # int32; 0 -> the sampler's whole prefix
    top_p: torch.Tensor         # float32; >= 1 -> off
    min_p: torch.Tensor         # float32; 0 -> off

    @classmethod
    def full(cls, batch: int, *, temperature: float = 1.0, top_k: int = 0,
             top_p: float = 1.0, min_p: float = 0.0,
             device=None) -> "SamplingState":
        f32 = dict(dtype=torch.float32, device=device)
        return cls(torch.full((batch,), temperature, **f32),
                   torch.full((batch,), top_k, dtype=torch.int32,
                              device=device),
                   torch.full((batch,), top_p, **f32),
                   torch.full((batch,), min_p, **f32))

    def set_row(self, slot: int, p) -> "SamplingState":
        """A copy with one request's parameters (anything with
        ``temperature`` / ``top_k`` / ``top_p`` / ``min_p``) in row
        ``slot``."""
        out = SamplingState(*(t.clone() for t in self))
        out.temperature[slot] = p.temperature
        out.top_k[slot] = p.top_k
        out.top_p[slot] = p.top_p
        out.min_p[slot] = p.min_p
        return out


def prefix_probs(z: torch.Tensor):
    """The softmax of each row of ``z`` (``jax.nn.softmax``'s formula:
    exp(z - max) over its sum) and its exclusive prefix sum."""
    e = torch.exp(z - z.max(dim=-1, keepdim=True).values)
    p = e / e.sum(dim=-1, keepdim=True)
    return p, torch.cumsum(p, dim=-1) - p


def prefix_keep_mask(svals: torch.Tensor, state: SamplingState):
    """Candidate mask over a descending sorted prefix ``svals`` (B, K): the
    per-row top-k cut, nucleus (the exclusive prefix sum of the softmax
    under ``top_p``) and min-p; index 0 is always kept. Returns ``(keep,
    z)``, ``z`` the temperature-scaled logits (-inf outside the cut)."""
    B, K = svals.shape
    dev = svals.device
    j = torch.arange(K, dtype=torch.int32, device=dev)[None, :]
    top_k = state.top_k.to(dev)[:, None]
    kcut = torch.where(top_k > 0, torch.clamp(top_k, max=K), K)
    keep = j < kcut
    t = torch.clamp(state.temperature.to(dev), min=1e-6)[:, None]
    z = torch.where(keep, svals / t, float("-inf"))
    p, cum_excl = prefix_probs(z)
    top_p = state.top_p.to(dev)[:, None]
    # top_p >= 1 turns the cut off exactly (the prefix sum's rounding near
    # 1.0 must not drop the tail)
    keep = keep & ((cum_excl < top_p) | (top_p >= 1.0))
    keep = keep & (p >= state.min_p.to(dev)[:, None] * p[:, :1])
    keep = keep | (j == 0)                 # the argmax always survives
    return keep, z


def uniform_noise(shape, generator: Optional[torch.Generator], device):
    """Uniform float32 noise in ``[U_MIN, U_MAX)``, as
    ``jax.random.uniform(key, shape, minval=1e-9, maxval=1.0)`` draws it."""
    r = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return torch.clamp(r * (U_MAX - U_MIN) + U_MIN, min=U_MIN)


def sorted_prefix_sample(generator: Optional[torch.Generator], svals,
                         sidx, state: SamplingState, *, u=None):
    """One token per row from a descending sorted prefix: ``svals`` /
    ``sidx`` are (B, K) sorted values and their token ids. Gumbel-max over
    the kept candidates, index 0 for greedy rows (``temperature <= 0``).
    ``u`` ((B, K) uniforms) replaces the draw from ``generator``. Returns
    (B,) int32 token ids."""
    keep, z = prefix_keep_mask(svals, state)
    if u is None:
        u = uniform_noise(svals.shape, generator, svals.device)
    gumbel = -torch.log(-torch.log(u.to(svals.device)))
    score = torch.where(keep, z + gumbel, float("-inf"))
    choice = torch.argmax(score, dim=-1)
    choice = torch.where(state.temperature.to(svals.device) <= 0, 0, choice)
    return torch.gather(sidx, 1, choice[:, None].to(sidx.device))[:, 0] \
        .to(torch.int32)


class RaggedSampler:
    """The serve loop's sampler: one ``engine.topk`` call batches every live
    slot's logits, then :func:`sorted_prefix_sample` applies each slot's
    parameters. ``k`` is the static prefix width every request's
    ``top_k`` / ``top_p`` / ``min_p`` works within; ``variant`` pins the
    engine's top-k (``'flims'`` | ``'torch'``; ``None`` lets the planner
    choose by device)."""

    def __init__(self, k: int = 64, variant: Optional[str] = None):
        if k < 1:
            raise ValueError(f"sampler prefix width k must be >= 1, got {k}")
        self.k = int(k)
        self.variant = variant

    def sample(self, generator: Optional[torch.Generator], logits,
               state: SamplingState, *, u=None):
        """logits (B, V) -> (B,) int32 token ids, with exactly one engine
        call. ``u`` ((B, min(k, V)) uniforms) replaces the draw."""
        from repro_torch import engine
        k = min(self.k, logits.shape[-1])
        vals, idx = engine.topk(logits, k, variant=self.variant)
        return sorted_prefix_sample(generator, vals, idx.to(torch.int32),
                                    state, u=u)
