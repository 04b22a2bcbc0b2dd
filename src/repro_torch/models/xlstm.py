"""xLSTM blocks, mLSTM and sLSTM, of the xLSTM-1.3B model (counterpart of
``repro/models/xlstm.py``).

mLSTM is a matrix-memory linear-attention recurrence with an exponential
input gate and a sigmoid forget gate. Training / prefill runs it in chunks:
a quadratic term inside a chunk, the state ``(C, n, m)`` carried across
chunks by a loop. sLSTM is a scalar-memory recurrent block, a loop over
time. Both stabilise their exponential gates with the log-space state
``m`` (the paper's trick): masked log-weights are -inf, ``m`` starts at and
is floored to -30, and a normaliser is at least 1 in magnitude. States and
gates compute in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import torch_dtype
from repro_torch.models.layers import dense_init, rmsnorm

#: the stabiliser's start and floor
M_FLOOR = -30.0


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_init(gen: torch.Generator, cfg, device="cuda"):
    dtype = torch_dtype(cfg.param_dtype)
    d = cfg.d_model
    H, hd = cfg.n_heads, cfg.hd
    return {"wq": dense_init(gen, d, H * hd, dtype, device),
            "wk": dense_init(gen, d, H * hd, dtype, device),
            "wv": dense_init(gen, d, H * hd, dtype, device),
            "wif": dense_init(gen, d, 2 * H, dtype, device),
            "fb": torch.full((H,), 3.0, dtype=torch.float32,
                             device=device),              # forget-gate bias
            "norm": torch.ones((H * hd,), dtype=dtype, device=device),
            "wo": dense_init(gen, H * hd, d, dtype, device)}


def _gates(p, x):
    """The input gate's pre-activation and the forget gate's log sigmoid,
    each (B, S, H) float32."""
    ig, fg = (x @ p["wif"]).float().chunk(2, dim=-1)
    return ig, -F.softplus(-(fg + p["fb"]))


def mlstm_apply(p, x, cfg, *, chunk: int = 128):
    """Chunked parallel mLSTM. x: (B, S, d) -> (B, S, d). ``chunk`` is
    halved until it divides S; the result does not depend on it beyond
    float32 rounding."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.hd
    q = ((x @ p["wq"]).reshape(B, S, H, hd) * hd ** -0.5).float()
    k = ((x @ p["wk"]).reshape(B, S, H, hd) * hd ** -0.5).float()
    v = (x @ p["wv"]).reshape(B, S, H, hd).float()
    ig, logf = _gates(p, x)
    Q = min(chunk, S)
    while S % Q:
        Q //= 2
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    f32 = dict(dtype=torch.float32, device=x.device)
    # C / n are pre-scaled by exp(m): the true state is exp(m) * (C, n)
    C = torch.zeros((B, H, hd, hd), **f32)
    n = torch.zeros((B, H, hd), **f32)
    m = torch.full((B, H), M_FLOOR, **f32)
    ys = []
    for c0 in range(0, S, Q):
        qc, kc, vc = (t[:, c0:c0 + Q] for t in (q, k, v))   # (B, Q, H, hd)
        igc = ig[:, c0:c0 + Q]                               # (B, Q, H)
        cum = torch.cumsum(logf[:, c0:c0 + Q], dim=1)        # log decay
        total = cum[:, -1]                                   # (B, H)
        # log-weights of the pair (i, j <= i) and of the carried state
        logw_intra = (cum[:, :, None, :] - cum[:, None, :, :]
                      + igc[:, None, :, :])                  # (B, Qi, Qj, H)
        logw_intra = torch.where(causal[None, :, :, None], logw_intra,
                                 float("-inf"))
        logw_state = cum + m[:, None, :]                     # (B, Q, H)
        m_q = torch.clamp(torch.maximum(logw_intra.amax(dim=2), logw_state),
                          min=M_FLOOR)                       # per query
        w_intra = torch.exp(logw_intra - m_q[:, :, None, :])
        w_state = torch.exp(logw_state - m_q)
        att = torch.einsum("bihd,bjhd->bijh", qc, kc) * w_intra
        num = (torch.einsum("bijh,bjhd->bihd", att, vc)
               + torch.einsum("bihd,bhde,bih->bihe", qc, C, w_state))
        den = (att.sum(dim=2)
               + torch.einsum("bihd,bhd,bih->bih", qc, n, w_state))
        ys.append(num / torch.clamp(den.abs(), min=1.0)[..., None])
        # the carry, in log space
        m_carry = torch.maximum(m + total, (igc + total[:, None, :]
                                            - cum).amax(dim=1))
        decay = torch.exp(m + total - m_carry)               # (B, H)
        wk_upd = torch.exp(igc + total[:, None, :] - cum
                           - m_carry[:, None, :])            # (B, Q, H)
        C = C * decay[:, :, None, None] + torch.einsum(
            "bjhd,bjhe,bjh->bhde", kc, vc, wk_upd)
        n = n * decay[:, :, None] + torch.einsum("bjhd,bjh->bhd", kc, wk_upd)
        m = m_carry
    y = torch.cat(ys, dim=1).reshape(B, S, H * hd).to(x.dtype)
    return rmsnorm(y, p["norm"], cfg.norm_eps) @ p["wo"]


def mlstm_decode_init(cfg, batch: int, device="cuda"):
    H, hd = cfg.n_heads, cfg.hd
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, H, hd, hd), **f32),
            "n": torch.zeros((batch, H, hd), **f32),
            "m": torch.full((batch, H), M_FLOOR, **f32)}


def mlstm_decode(p, x, state, cfg):
    """One-token recurrent step. x: (B, 1, d). Returns ``(y, new_state)``."""
    B = x.shape[0]
    H, hd = cfg.n_heads, cfg.hd
    q = (x @ p["wq"]).reshape(B, H, hd).float() * hd ** -0.5
    k = (x @ p["wk"]).reshape(B, H, hd).float() * hd ** -0.5
    v = (x @ p["wv"]).reshape(B, H, hd).float()
    ig, logf = (t[:, 0] for t in _gates(p, x))              # (B, H)
    m_new = torch.maximum(state["m"] + logf, ig)
    decay = torch.exp(state["m"] + logf - m_new)
    inw = torch.exp(ig - m_new)
    C = (state["C"] * decay[:, :, None, None]
         + torch.einsum("bhd,bhe,bh->bhde", k, v, inw))
    n = state["n"] * decay[:, :, None] + k * inw[:, :, None]
    num = torch.einsum("bhd,bhde->bhe", q, C)
    den = torch.einsum("bhd,bhd->bh", q, n).abs()[:, :, None]
    y = (num / torch.clamp(den, min=1.0)).reshape(B, 1, H * hd).to(x.dtype)
    y = rmsnorm(y, p["norm"], cfg.norm_eps)
    return y @ p["wo"], {"C": C, "n": n, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_init(gen: torch.Generator, cfg, device="cuda"):
    dtype = torch_dtype(cfg.param_dtype)
    d = cfg.d_model
    return {"wx": dense_init(gen, d, 4 * d, dtype, device),
            "wh": dense_init(gen, d, 4 * d, dtype, device, scale=0.5),
            "b": torch.zeros((4 * d,), dtype=torch.float32, device=device),
            "norm": torch.ones((d,), dtype=dtype, device=device),
            "wo": dense_init(gen, d, d, dtype, device)}


def slstm_step(p, xt, state):
    """xt: (B, d); state: ``(c, n, h, m)``, each (B, d) float32."""
    c, n, h, m = state
    g = (xt @ p["wx"] + h.to(xt.dtype) @ p["wh"]).float() + p["b"]
    i, f, z, o = g.chunk(4, dim=-1)
    m_new = torch.maximum(f + m, i)                       # the stabiliser
    ig = torch.exp(i - m_new)
    fg = torch.exp(f + m - m_new)
    c_new = fg * c + ig * torch.tanh(z)
    n_new = fg * n + ig
    h_new = torch.sigmoid(o) * c_new / torch.clamp(n_new, min=1.0)
    return c_new, n_new, h_new, m_new


def slstm_apply(p, x, cfg):
    """Whole-sequence sLSTM, a loop over time. x: (B, S, d)."""
    B, S, d = x.shape
    z = torch.zeros((B, d), dtype=torch.float32, device=x.device)
    state = (z, z, z, torch.full_like(z, M_FLOOR))
    hs = []
    for t in range(S):
        state = slstm_step(p, x[:, t], state)
        hs.append(state[2])
    y = torch.stack(hs, dim=1).to(x.dtype)
    return rmsnorm(y, p["norm"], cfg.norm_eps) @ p["wo"]


def slstm_decode_init(cfg, batch: int, device="cuda"):
    z = torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device)
    return {"c": z, "n": z.clone(), "h": z.clone(),
            "m": torch.full_like(z, M_FLOOR)}


def slstm_decode(p, x, state, cfg):
    """One-token step. x: (B, 1, d). Returns ``(y, new_state)``."""
    c, n, h, m = slstm_step(p, x[:, 0], (state["c"], state["n"], state["h"],
                                         state["m"]))
    y = rmsnorm(h.to(x.dtype), p["norm"], cfg.norm_eps)[:, None, :]
    return y @ p["wo"], {"c": c, "n": n, "h": h, "m": m}
