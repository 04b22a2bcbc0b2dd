"""Mamba2 (SSD) block of the Zamba2 hybrid (counterpart of
``repro/models/ssm.py``).

Training / prefill runs the chunked state-space-duality form: within a
chunk a quadratic, attention-like term, across chunks a recurrent state
``S`` (B, H, N, hd) carried by a loop over the chunks. Decode is the
one-token recurrence on the same state and on the causal convolution's last
``k - 1`` inputs, so the state does not grow with the sequence. ``S`` and
every gate compute in float32; the convolution state keeps the compute
dtype, as the JAX package keeps it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import torch_dtype
from repro_torch.models.layers import dense_init, rmsnorm

#: the depthwise causal convolution's kernel width
CONV_K = 4


def mamba2_init(gen: torch.Generator, cfg, device="cuda"):
    dtype = torch_dtype(cfg.param_dtype)
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    H = d_in // cfg.ssm_head_dim
    N = cfg.ssm_state
    f32 = dict(dtype=torch.float32, device=device)
    conv_w = torch.randn((CONV_K, d_in + 2 * N), generator=gen, **f32) * 0.1
    return {
        "in_proj": dense_init(gen, d, 2 * d_in + 2 * N + H, dtype, device),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((d_in + 2 * N,), dtype=dtype, device=device),
        "A_log": torch.zeros((H,), **f32),            # A = -exp(A_log) < 0
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.full((H,), -2.0, **f32),     # softplus ~ 0.12
        "norm": torch.ones((d_in,), dtype=dtype, device=device),
        "out_proj": dense_init(gen, d_in, d, dtype, device),
    }


def _split_proj(p, x, cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    N = cfg.ssm_state
    H = d_in // cfg.ssm_head_dim
    z, xbc, dt = torch.split(x @ p["in_proj"], [d_in, d_in + 2 * N, H],
                             dim=-1)
    return z, xbc, dt, d_in, N, H


def _causal_conv(xbc, w, b, state=None):
    """Depthwise causal convolution of width k over (B, S, C); ``state``
    (B, k - 1, C) holds the inputs before the first (decode). Returns the
    activations and the new state."""
    k = w.shape[0]
    S = xbc.shape[1]
    if state is None:
        padded = F.pad(xbc, (0, 0, k - 1, 0))
    else:
        padded = torch.cat([state.to(xbc.dtype), xbc], dim=1)
    out = sum(padded[:, i:i + S, :] * w[i][None, None, :] for i in range(k))
    return F.silu(out + b), padded[:, -(k - 1):, :]


def _dt(p, dt):
    return F.softplus(dt.float() + p["dt_bias"])


def mamba2_apply(p, x, cfg, *, chunk: int = 128):
    """Training / prefill forward. x: (B, S, d) -> (B, S, d). ``chunk`` is
    the SSD chunk (halved until it divides S); the result does not depend
    on it beyond float32 rounding."""
    B, S, _ = x.shape
    z, xbc, dt, d_in, N, H = _split_proj(p, x, cfg)
    hd = cfg.ssm_head_dim
    xbc, _ = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xs, Bm, Cm = torch.split(xbc, [d_in, N, N], dim=-1)
    xs = xs.reshape(B, S, H, hd)
    dt = _dt(p, dt)                                       # (B, S, H)
    la = dt * -torch.exp(p["A_log"])                      # log decay
    Q = min(chunk, S)
    while S % Q:
        Q //= 2
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    S_prev = torch.zeros((B, H, N, hd), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, S, Q):
        xs_q = xs[:, c0:c0 + Q].float()                   # (B, Q, H, hd)
        B_q = Bm[:, c0:c0 + Q].float()                    # (B, Q, N)
        C_q = Cm[:, c0:c0 + Q].float()
        dt_q = dt[:, c0:c0 + Q]                           # (B, Q, H)
        cum = torch.cumsum(la[:, c0:c0 + Q], dim=1)
        total = cum[:, -1, :]                             # (B, H)
        # intra-chunk: L[i, j] = exp(cum_i - cum_j) for i >= j; above the
        # diagonal the difference is positive and may overflow, so the
        # mask selects rather than multiplies
        diff = cum[:, :, None, :] - cum[:, None, :, :]    # (B, Q, Q, H)
        L = torch.where(causal[None, :, :, None], torch.exp(diff), 0.0)
        M = torch.einsum("bin,bjn->bij", C_q, B_q)[..., None] * L
        xdt = xs_q * dt_q[..., None]
        y_intra = torch.einsum("bijh,bjhp->bihp", M, xdt)
        # the carried state's contribution
        y_inter = torch.einsum("bin,bih,bhnp->bihp", C_q, torch.exp(cum),
                               S_prev)
        # S_new = dec * S_prev + sum_j exp(total - cum_j) dt_j B_j x_j
        wgt = torch.exp(total[:, None, :] - cum)          # (B, Q, H)
        ST = torch.einsum("bjn,bjh,bjhp->bhnp", B_q, wgt * dt_q, xs_q)
        S_prev = S_prev * torch.exp(total)[:, :, None, None] + ST
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1) + xs.float() * p["D"][None, None, :, None]
    y = y.reshape(B, S, d_in).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"]


def mamba2_decode_init(cfg, batch: int, dtype=torch.float32, device="cuda"):
    """``S`` (batch, H, N, hd) float32 and ``conv`` (batch, k - 1, C) in
    ``dtype``, zeros."""
    d_in = cfg.ssm_expand * cfg.d_model
    H = d_in // cfg.ssm_head_dim
    N = cfg.ssm_state
    return {"S": torch.zeros((batch, H, N, cfg.ssm_head_dim),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, CONV_K - 1, d_in + 2 * N),
                                dtype=dtype, device=device)}


def mamba2_decode(p, x, state, cfg):
    """One-token decode. x: (B, 1, d); state: ``{"S", "conv"}``. Returns
    ``(y, new_state)``."""
    B = x.shape[0]
    z, xbc, dt, d_in, N, H = _split_proj(p, x, cfg)
    hd = cfg.ssm_head_dim
    xbc, conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], state["conv"])
    xs, Bm, Cm = torch.split(xbc, [d_in, N, N], dim=-1)
    xs = xs.reshape(B, H, hd).float()
    Bm = Bm[:, 0].float()                                 # (B, N)
    Cm = Cm[:, 0].float()
    dt = _dt(p, dt[:, 0])                                 # (B, H)
    dec = torch.exp(dt * -torch.exp(p["A_log"])[None, :])
    S_new = (state["S"] * dec[:, :, None, None]
             + torch.einsum("bn,bh,bhp->bhnp", Bm, dt, xs))
    y = torch.einsum("bn,bhnp->bhp", Cm, S_new) + xs * p["D"][None, :, None]
    y = y.reshape(B, 1, d_in).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"], {"S": S_new, "conv": conv}
