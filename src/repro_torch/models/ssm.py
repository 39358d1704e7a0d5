"""Mamba2-style selective state-space block (diagonal A, per-head scalar
decay, SSD simplification) with O(1)-state decode — the sub-quadratic block
of zamba2 (hybrid).

Structure per block:
    in_proj -> (xin, z); causal depthwise conv(k=4) on xin; data-dependent
    (dt, B, C) projections; recurrence
        h_t[c, n] = a_t[head(c)] * h_{t-1}[c, n] + dt_t[head(c)] * B_t[n] * x_t[c]
        y_t[c]    = sum_n C_t[n] * h_t[c, n] + D_skip[c] * x_t[c]
    gated output: out_proj(y * silu(z)).

Decode (a carried state) and short prefills (S <= 8) run the recurrence on
the flattened (channel, state) pairs through `kernels.ops.ssm_scan` (K5 on
a CUDA tensor, its plain version on the CPU; under autograd K5's forward
and the plain version's gradient); longer prefills take the chunked SSD
form (`_ssd_chunked`), plain torch as in the JAX package.

On a model axis above 1 (`distribution/tensor_parallel.py`) the block
runs on this rank's channels when its heads divide over `model`: in_proj
and bc_proj are column-parallel, gathered whole (their contiguous cut does
not follow the x/z and B/C halves) and the x and z halves cut to the
rank's channels; dt_proj gives the rank's heads; the depthwise conv runs
whole (its cache is whole in `cache_shardings`) and is cut after; the
recurrence, K5 included, runs on the rank's channels, whose state is the
rank's slice of the `ssm_state` cache; out_proj is row-parallel. When the
heads do not divide, every rank runs all channels, and the state is cut to
the cache's layout at the end.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import normal_init
from ..distribution.tensor_parallel import col_whole, model_axis, row
from ..kernels import ops as kops


def ssm_init(generator, cfg: ModelConfig, dtype, device=None):
    D = cfg.d_model
    Din = 2 * D
    N = cfg.ssm_state
    H = max(1, Din // 64)             # heads of 64 channels

    def w(shape, scale=0.02):
        return normal_init(generator, shape, dtype, scale, device=device)

    return {
        "in_proj": w((D, 2 * Din)),
        "conv_w": w((cfg.ssm_conv, Din), 0.1),
        "bc_proj": w((D, 2 * N)),
        "dt_proj": w((D, H), 0.01),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=device),
        "a_log": torch.zeros((H,), dtype=torch.float32, device=device),
        "d_skip": torch.ones((Din,), dtype=torch.float32, device=device),
        "out_proj": w((Din, D)),
    }


def _causal_conv(x, w, cache=None):
    """x (B,T,C), w (k,C) depthwise causal; cache (B,k-1,C) for decode."""
    k = w.shape[0]
    if cache is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([cache, x], dim=1)
    T = x.shape[1]
    out = sum(xp[:, i:i + T, :] * w[i][None, None, :] for i in range(k))
    new_cache = xp[:, -(k - 1):, :] if k > 1 else None
    return F.silu(out), new_cache


def ssm_apply(p, x, cfg: ModelConfig, state=None, conv_cache=None):
    """x (B,S,D) -> (y (B,S,D), (state, conv_cache)).

    state (B, Din, N) carries across calls (decode); None -> zeros. On a
    model axis above 1 the state is this rank's channels of it when Din
    divides over the axis (as `cache_shardings` cuts it).
    """
    B, S, D = x.shape
    Din = 2 * D
    N = cfg.ssm_state
    H = max(1, Din // 64)
    ch_per_h = Din // H
    ax = model_axis()
    local = ax.divides(H)                   # this rank's heads/channels
    state_cut = ax.divides(Din)

    xz = col_whole(x, p["in_proj"], 2 * Din, ax)
    xin, z = torch.chunk(xz, 2, dim=-1)                    # (B,S,Din)
    conv_w = p["conv_w"]
    if conv_w.shape[-1] != Din:
        conv_w = ax.gather(conv_w, -1)
    xin, new_conv = _causal_conv(xin, conv_w, conv_cache)
    bc = col_whole(x, p["bc_proj"], 2 * N, ax)
    if local:       # whole B and C, each rank's channels' use of them
        bc = ax.enter(bc)
    Bmat, Cmat = torch.chunk(bc.float(), 2, dim=-1)        # (B,S,N)
    dt_bias, a_log, d_skip = p["dt_bias"], p["a_log"], p["d_skip"]
    if local:
        xin, z = ax.split(xin, -1), ax.split(z, -1)
        dt_bias, a_log = ax.split(dt_bias, -1), ax.split(a_log, -1)
        d_skip = ax.split(d_skip, -1)
        Din, H = Din // ax.n, H // ax.n
        dt = F.softplus(ax.enter(x.float()) @ p["dt_proj"].float()
                        + dt_bias)
    else:
        dt = F.softplus(col_whole(x.float(), p["dt_proj"].float(), H, ax)
                        + dt_bias)
        if state is not None and state.shape[1] != Din:
            state = ax.all_gather(state, 1)
    a = torch.exp(-dt * torch.exp(a_log))                  # (B,S,H) in (0,1)

    xf = xin.float()
    # broadcast per-head decay to channels, inputs to (c, n) pairs
    a_c = torch.repeat_interleave(a, ch_per_h, dim=-1)     # (B,S,Din)
    drive = torch.repeat_interleave(dt, ch_per_h, dim=-1) * xf
    # flattened (c, n) scan: decay same for all n of a channel
    a_cn = a_c[..., None].expand(B, S, Din, N).reshape(B, S, -1)
    x_cn = (drive[..., None] * Bmat[:, :, None, :]).reshape(B, S, -1)

    if state is not None or S <= 8:
        # decode / short-sequence path: explicit recurrence on the
        # flattened (channel, state) pairs, the carry seeded from the
        # decode state through K5's h0 operand
        h0 = None if state is None else state.reshape(B, Din * N)
        ys = kops.ssm_scan(a_cn, x_cn, h0)
        h = ys.reshape(B, S, Din, N)
        y = torch.einsum("bscn,bsn->bsc", h, Cmat) + d_skip * xf
        new_state = h[:, -1]                               # (B, Din, N)
    else:
        # prefill: the Mamba2 SSD chunked form (per-head (c x c) masked
        # matmuls over (B,S,N) + (B,S,Din) streams)
        y, h_fin = _ssd_chunked(a, dt, Bmat, Cmat, xf, H, ch_per_h)
        y = y + d_skip * xf
        new_state = h_fin.reshape(B, Din, N)
    if state_cut and not local:
        new_state = ax.local(new_state, 1)
    y = (y * F.silu(z.float())).to(x.dtype)
    return row(y, p["out_proj"], 2 * D, ax), (new_state, new_conv)


def _ssd_chunked(a, dt, Bmat, Cmat, xf, H: int, ch: int,
                 chunk: int = 128):
    """Chunked SSD: y_t = sum_{s<=t} prod(a)(s,t] * (C_t.B_s) dt_s x_s
    + carry, computed with per-head (c x c) masked matmuls, one chunk after
    another (the JAX package's `lax.scan`). All decay ratios are exp of
    non-positive log-sums -> bounded in (0, 1].

    a, dt: (B,S,H); Bmat/Cmat: (B,S,N); xf: (B,S,Din=H*ch) f32.
    Returns y (B,S,Din), final state (B,H,ch,N).
    """
    B, S, Hn = a.shape
    N = Bmat.shape[-1]
    c = min(chunk, S)
    Sp = -(-S // c) * c

    def pad(t):
        return F.pad(t, (0, 0, 0, Sp - S))

    # pad decays with a=1 (log 0) so padded steps carry state unchanged,
    # and dt=0 so they inject nothing
    la = pad(torch.log(torch.clamp(a, min=1e-30)))
    dtp, Bp, Cp, xp = pad(dt), pad(Bmat), pad(Cmat), pad(xf)
    mask = torch.tril(torch.ones((c, c), dtype=torch.float32,
                                 device=a.device))
    h = torch.zeros((B, Hn, ch, N), dtype=torch.float32, device=a.device)
    ys = []
    for s0 in range(0, Sp, c):
        sl = slice(s0, s0 + c)
        la_k, dt_k, B_k, C_k = la[:, sl], dtp[:, sl], Bp[:, sl], Cp[:, sl]
        x_k = xp[:, sl].reshape(B, c, Hn, ch)
        l = torch.cumsum(la_k, dim=1)                      # (B,c,H)
        scores = torch.einsum("btn,bsn->bts", C_k, B_k)    # (B,c,c)
        decay = torch.exp(torch.clamp(
            l[:, :, None, :] - l[:, None, :, :], -60.0, 0.0))  # (B,t,s,H)
        M = scores[..., None] * decay * mask[None, :, :, None]
        u = x_k * dt_k[..., None]                          # (B,c,H,ch)
        y = torch.einsum("btsh,bshc->bthc", M, u)
        # inter-chunk: contribution of the carried state
        y = y + torch.einsum("btn,bhcn->bthc", C_k, h) \
            * torch.exp(l)[..., None]
        # state update: h' = exp(l_end) h + sum_s exp(l_end - l_s) B_s (x)
        l_end = l[:, -1]                                   # (B,H)
        w = torch.exp(torch.clamp(l_end[:, None, :] - l, -60.0, 0.0))
        h = h * torch.exp(l_end)[..., None, None]
        h = h + torch.einsum("bsn,bshc->bhcn", B_k, u * w[..., None])
        ys.append(y.reshape(B, c, Hn * ch))
    y = torch.cat(ys, dim=1)[:, :S]
    return y, h


def ssm_decode(p, x, cfg: ModelConfig, state, conv_cache):
    """Single-token step; state (B,Din,N), conv_cache (B,k-1,Din)."""
    return ssm_apply(p, x, cfg, state=state, conv_cache=conv_cache)
