"""RWKV-6 ("Finch") blocks: time-mix with data-dependent per-channel decay
and matrix-valued state, plus squared-ReLU channel-mix. Attention-free;
the decode state is O(H * dk * dv) whatever the context length.

The WKV recurrence per head:
    S_t = diag(w_t) S_{t-1} + k_t^T v_t          (S: (dk, dv))
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

Prefill and decode both use the JAX package's chunked-parallel form
(cumulative decays inside a chunk of 32, a sequential loop across chunks),
in float32 with the same order of operations and the same 1e-30 clamps on
the cumulative decays, so the two packages' chunked forms agree to float32
rounding. Plain torch, as the JAX package's module is plain JAX.

On a model axis above 1 (`distribution/tensor_parallel.py`) the time mix
runs on this rank's heads when they divide over `model` (wr, wk, wv, wg
and w_proj column-parallel, the `wkv` state the rank's heads, as
`cache_shardings` cuts it; u, w_bias and ln_scale taken on the rank's
slice), else on all heads gathered whole; wo and the channel mix's cv are
row-parallel, ck column-parallel, and cr's column-parallel output is
gathered whole.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distribution.tensor_parallel import col, col_whole, model_axis, row
from .config import ModelConfig
from .layers import normal_init


def _heads(cfg: ModelConfig) -> tuple[int, int]:
    D = cfg.d_model
    H = cfg.num_heads if cfg.num_heads > 0 else D // 64
    return H, D // H


def rwkv_init(generator, cfg: ModelConfig, dtype, device=None):
    D = cfg.d_model
    H, dk = _heads(cfg)

    def w(shape, scale=0.02, dt=dtype):
        return normal_init(generator, shape, dt, scale, device=device)

    def full(value, dt=dtype):
        return torch.full((D,), value, dtype=dt, device=device)

    return {
        # time-mix
        "mix_r": full(0.5), "mix_k": full(0.5), "mix_v": full(0.5),
        "mix_w": full(0.5), "mix_g": full(0.5),
        "wr": w((D, D)), "wk": w((D, D)), "wv": w((D, D)), "wg": w((D, D)),
        "wo": w((D, D)),
        "w_proj": w((D, D), 0.01),                    # decay lora
        "w_bias": full(-1.0, torch.float32),
        "u": w((H, dk), 0.1, torch.float32),
        "ln_scale": torch.ones((D,), dtype=dtype, device=device),
        # channel-mix
        "cmix_k": full(0.5), "cmix_r": full(0.5),
        "ck": w((D, cfg.d_ff)), "cv": w((cfg.d_ff, D)), "cr": w((D, D)),
    }


def _token_shift(x, mix, last=None):
    """lerp(x_{t-1}, x_t, mix); `last` (B,1,D) for decode continuity."""
    if last is None:
        prev = F.pad(x, (0, 0, 1, 0))[:, :-1]
    else:
        prev = torch.cat([last, x], dim=1)[:, :-1]
    return prev + mix * (x - prev)


def wkv_chunked(r, k, v, w, u, chunk: int = 32, state=None):
    """r, k (B,H,T,dk), v (B,H,T,dv), w (B,H,T,dk) decays in (0,1).

    Returns y (B,H,T,dv) and the final state (B,H,dk,dv), both float32.
    """
    B, H, T, dk = r.shape
    dv = v.shape[-1]
    c = min(chunk, T)
    Tp = -(-T // c) * c
    pad = (0, 0, 0, Tp - T)
    nc = Tp // c

    def chunks(a, d, value=0.0):
        a = F.pad(a.float(), pad, value=value)
        return a.reshape(B, H, nc, c, d)

    rc, kc, vc = chunks(r, dk), chunks(k, dk), chunks(v, dv)
    wc = chunks(w, dk, 1.0)
    S = (torch.zeros((B, H, dk, dv), dtype=torch.float32, device=r.device)
         if state is None else state.float())
    mask = torch.tril(torch.ones((c, c), dtype=torch.float32,
                                 device=r.device), diagonal=-1)
    uf = u.float()[None, :, None, :]
    ys = []
    for i in range(nc):
        rb, kb, vb, wb = rc[:, :, i], kc[:, :, i], vc[:, :, i], wc[:, :, i]
        Wc = torch.cumprod(wb, dim=2)                       # (B,H,c,dk)
        W_prev = F.pad(Wc, (0, 0, 1, 0), value=1.0)[:, :, :-1]
        r_in = rb * W_prev                                  # decays since 0
        k_out = kb / torch.clamp(Wc, min=1e-30)             # bounded w/ r_in
        y_inter = torch.einsum("bhck,bhkv->bhcv", r_in, S)
        A = torch.einsum("bhik,bhjk->bhij", r_in, k_out) * mask
        y_intra = torch.einsum("bhij,bhjv->bhiv", A, vb)
        bonus = torch.einsum("bhck,bhck->bhc", rb, uf * kb)
        y_diag = bonus[..., None] * vb
        Wend = Wc[:, :, -1]                                 # (B,H,dk)
        k_end = kb * (Wend[:, :, None, :] / torch.clamp(Wc, min=1e-30))
        S = S * Wend[..., None] + torch.einsum("bhck,bhcv->bhkv", k_end, vb)
        ys.append(y_inter + y_intra + y_diag)
    y = torch.stack(ys, dim=2).reshape(B, H, Tp, dv)[:, :, :T]
    return y, S


def rwkv_time_mix(p, x, cfg: ModelConfig, state=None, last=None):
    """x (B,S,D) -> (y, (wkv_state, last_token))."""
    B, S, D = x.shape
    H, dk = _heads(cfg)
    xr = _token_shift(x, p["mix_r"], last)
    xk = _token_shift(x, p["mix_k"], last)
    xv = _token_shift(x, p["mix_v"], last)
    xw = _token_shift(x, p["mix_w"], last)
    xg = _token_shift(x, p["mix_g"], last)
    ax = model_axis()
    local = ax.divides(H)                    # this rank's heads
    proj = col if local else col_whole
    u, w_bias, ln_scale = p["u"], p["w_bias"], p["ln_scale"]
    if local:
        H, D = H // ax.n, D // ax.n
        u, w_bias = ax.split(u, 0), ax.split(w_bias, -1)
        ln_scale = ax.split(ln_scale, -1)
    Dw = cfg.d_model
    r = proj(xr, p["wr"], Dw, ax).reshape(B, S, H, dk).transpose(1, 2)
    k = proj(xk, p["wk"], Dw, ax).reshape(B, S, H, dk).transpose(1, 2)
    v = proj(xv, p["wv"], Dw, ax).reshape(B, S, H, dk).transpose(1, 2)
    g = F.silu(proj(xg, p["wg"], Dw, ax))
    # data-dependent decay (Finch): w in (0,1), near 1
    wdec = torch.exp(-torch.exp(proj(xw.float(), p["w_proj"].float(), Dw,
                                     ax) + w_bias))
    wdec = wdec.reshape(B, S, H, dk).transpose(1, 2)
    y, S_fin = wkv_chunked(r, k, v, wdec, u, state=state)
    y = y.transpose(1, 2).reshape(B, S, D)
    # per-head group norm
    yf = y.float().reshape(B, S, H, dk)
    mu = yf.mean(-1, keepdim=True)
    var = yf.var(-1, keepdim=True, unbiased=False)
    yf = (yf - mu) * torch.rsqrt(var + 64e-5)
    y = (yf.reshape(B, S, D) * ln_scale.float()).to(x.dtype)
    out = row(y * g, p["wo"], Dw, ax)
    return out, (S_fin, x[:, -1:, :])


def rwkv_channel_mix(p, x, cfg: ModelConfig, last=None):
    xk = _token_shift(x, p["cmix_k"], last)
    xr = _token_shift(x, p["cmix_r"], last)
    ax = model_axis()
    k = torch.square(F.relu(col(xk, p["ck"], cfg.d_ff, ax)))
    r = torch.sigmoid(col_whole(xr, p["cr"], cfg.d_model, ax))
    return r * row(k, p["cv"], cfg.d_ff, ax), x[:, -1:, :]
