"""Attention blocks: GQA projections (optional QKV bias), RoPE, sliding
window, and the execution paths of the JAX package's `models/attention.py`:

  * `attend`             — prefill and training; routed by
                           `kernels.ops.resolve_backend` on the tensors'
                           device: a CUDA tensor goes to the K4
                           flash-attention kernel (under autograd through
                           `FlashAttentionFn`: K4 forward, the plain
                           attention's gradient backward), a CPU tensor to
                           `attention_reference`: the direct oracle (short
                           sequences) or the blockwise online-softmax path
                           (long ones; `attention_blockwise`, which is also
                           K4's plain version);
  * `decode_attend`      — one token per row against a fixed-size KV cache
                           with position masking; `pos` is a scalar or one
                           position per batch row (continuous batching);
  * `decode_attend_int8` — the same over an int8 cache with per-position
                           scales, without dequantizing it.

All math in f32, outputs cast back to the activation dtype.

On a model axis above 1 (`distribution/tensor_parallel.py`) q, k and v
are this rank's heads when wq/wk/wv are cut on whole heads, else all
heads (gathered); `local_kv` picks the kv heads of this rank's q heads
(the GQA group of a q head stays h // (Hq / Hkv) whatever the cut), `wo`
is row-parallel, and `decode_attend_cut` and `decode_attend_int8_cut`
attend whole q heads over a cache (float, or int8 with its scales) whose
positions are cut over ranks (`cache_shardings` cuts them when the kv
heads do not divide over `model`).
"""

from __future__ import annotations

import torch

from .config import ModelConfig
from .layers import normal_init
from .rope import apply_rope
from ..distribution.tensor_parallel import (Axis, col_heads, model_axis,
                                            row)
from ..kernels import ops as kops
from ..kernels import ref
from ..kernels.flash_attention import (  # noqa: F401 (re-exported)
    BLOCKWISE_THRESHOLD, attention_blockwise, attention_reference)

_NEG = ref.NEG


def attn_init(generator, cfg: ModelConfig, dtype, device=None):
    D, Hq, Hkv, Hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    p = {"wq": normal_init(generator, (D, Hq * Hd), dtype, device=device),
         "wk": normal_init(generator, (D, Hkv * Hd), dtype, device=device),
         "wv": normal_init(generator, (D, Hkv * Hd), dtype, device=device),
         "wo": normal_init(generator, (Hq * Hd, D), dtype, device=device)}
    if cfg.qkv_bias:
        for name, n in (("bq", Hq * Hd), ("bk", Hkv * Hd), ("bv", Hkv * Hd)):
            p[name] = torch.zeros((n,), dtype=dtype, device=device)
    return p


def qkv_proj(p, x, cfg: ModelConfig, positions):
    """x (B,S,D) -> q (B,Hq,S,hd), k/v (B,Hkv,S,hd), RoPE applied.
    `positions` is (S,), or (B,1,S) for one position row per batch row."""
    B, S, _ = x.shape
    Hq, Hkv, Hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    ax = model_axis()
    q = col_heads(x, p["wq"], Hq, Hd, ax, p.get("bq"))
    k = col_heads(x, p["wk"], Hkv, Hd, ax, p.get("bk"))
    v = col_heads(x, p["wv"], Hkv, Hd, ax, p.get("bv"))
    q = q.reshape(B, S, -1, Hd).transpose(1, 2)
    k = k.reshape(B, S, -1, Hd).transpose(1, 2)
    v = v.reshape(B, S, -1, Hd).transpose(1, 2)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def local_kv(q, k, v, cfg: ModelConfig):
    """The k and v heads that this rank's q heads attend to. q and k
    from `qkv_proj` are both local heads, both whole, or (the kv heads do
    not divide over `model`, the q heads do) local q heads against whole
    kv heads: then q head h of the model takes kv head h // g, a
    contiguous block when the rank's q heads are whole groups, one kv head
    per q head otherwise."""
    hq, hk = q.shape[1], k.shape[1]
    if hq == cfg.num_heads or hk != cfg.num_kv_heads:
        return k, v
    ax = model_axis()
    g = cfg.num_heads // cfg.num_kv_heads
    q0 = ax.index * hq
    k, v = ax.enter(k), ax.enter(v)
    if hq % g == 0 and q0 % g == 0:
        return k[:, q0 // g:(q0 + hq) // g], v[:, q0 // g:(q0 + hq) // g]
    heads = torch.arange(q0, q0 + hq, device=k.device) // g
    return k[:, heads], v[:, heads]


def attend(q, k, v, *, causal=True, window=None,
           blockwise_threshold=BLOCKWISE_THRESHOLD):
    """Dispatch through `kernels.ops.resolve_backend`: the K4 kernel for
    CUDA tensors (through its autograd Function when grad mode is on and
    an input requires grad; launched directly otherwise), the direct
    oracle for short sequences on the CPU, blockwise torch for long
    ones (`blockwise_threshold` picks between the two on the CPU)."""
    if kops.resolve_backend(q) != "ref":
        return kops.flash_attention(q, k, v, causal=causal, window=window)
    return attention_reference(q, k, v, causal=causal, window=window,
                               blockwise_threshold=blockwise_threshold)


def quantize_kv(k):
    """(B,H,S,hd) -> int8 cache + per-position scales (B,H,S): symmetric
    per-(position, head) scaling, round half to even."""
    kf = k.float()
    scale = torch.clamp(kf.abs().amax(dim=-1), min=1e-6) / 127.0
    q = torch.clamp(torch.round(kf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _decode_mask(pos, Smax: int, window, device, start=0):
    """(B or 1, 1, 1, Smax) bool: kv position j is visible to a row whose
    current token sits at `pos` iff j <= pos (and j > pos - window). The
    slab holds positions [start, start + Smax)."""
    p = torch.as_tensor(pos, device=device).reshape(-1, 1, 1, 1)
    kpos = start + torch.arange(Smax, device=device)[None, None, None, :]
    mask = kpos <= p
    if window is not None:
        mask = mask & (kpos > p - window)
    return mask


def decode_attend_int8(q, k_q, k_s, v_q, v_s, pos, *, window=None):
    """Decode attention over an int8 cache WITHOUT dequantizing it: the
    per-position scales factor out of both contractions (logits scaled by
    k_scale, probabilities by v_scale). q and p are rounded to bf16 and
    the int8 cache read as bf16, with f32 accumulation, as in the JAX
    package."""
    B, Hq, _, D = q.shape
    _, Hkv, Smax, _ = k_q.shape
    g = Hq // Hkv
    scale = 1.0 / (D ** 0.5)
    qh = (q.reshape(B, Hkv, g, D) * scale).to(torch.bfloat16).float()
    s = torch.matmul(qh, k_q.float().transpose(-1, -2))      # (B,Hkv,g,S)
    s = s * k_s[:, :, None, :]
    mask = _decode_mask(pos, Smax, window, q.device)
    s = torch.where(mask, s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1)
    p = (p * v_s[:, :, None, :]).to(torch.bfloat16).float()
    out = torch.matmul(p, v_q.float())
    return out.reshape(B, Hq, 1, D).to(q.dtype)


def decode_attend(q, cache_k, cache_v, pos, *, window=None):
    """q (B,Hq,1,D) against cache (B,Hkv,Smax,D); positions > pos masked.

    `pos` (a scalar or (B,) tensor) is the index of each row's *current*
    token (already written to the cache). q is rounded to the cache's
    dtype and the products accumulate in f32, as the JAX package's
    `preferred_element_type=f32` contraction does.
    """
    B, Hq, _, D = q.shape
    _, Hkv, Smax, _ = cache_k.shape
    g = Hq // Hkv
    scale = 1.0 / (D ** 0.5)
    qh = (q.reshape(B, Hkv, g, D) * scale).to(cache_k.dtype).float()
    s = torch.matmul(qh, cache_k.float().transpose(-1, -2))  # (B,Hkv,g,S)
    mask = _decode_mask(pos, Smax, window, q.device)
    s = torch.where(mask, s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1)
    out = torch.matmul(p.to(cache_v.dtype).float(), cache_v.float())
    return out.reshape(B, Hq, 1, D).to(q.dtype)


def _cut_softmax(s, seq: Axis, mask):
    """The masked softmax of logits `s` (..., S_loc) over all the
    positions of a cut: its maximum and its sum are reduced over `seq`,
    so each rank holds its positions' part of the whole softmax."""
    s = torch.where(mask, s, torch.full_like(s, _NEG))
    m = seq.all_reduce(s.amax(dim=-1, keepdim=True), "max")
    e = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    return e / seq.all_reduce(e.sum(dim=-1, keepdim=True))


def decode_attend_cut(q, cache_k, cache_v, pos, seq: Axis, *, window=None):
    """`decode_attend` of whole q heads against this rank's positions of a
    cache cut over `seq` (the rank holds positions [i * S_loc, (i + 1) *
    S_loc)): the softmax's maximum, its sum and the products are summed
    over the ranks, so the result is the whole softmax's."""
    B, Hq, _, D = q.shape
    _, Hkv, S_loc, _ = cache_k.shape
    g = Hq // Hkv
    scale = 1.0 / (D ** 0.5)
    qh = (q.reshape(B, Hkv, g, D) * scale).to(cache_k.dtype).float()
    s = torch.matmul(qh, cache_k.float().transpose(-1, -2))  # (B,Hkv,g,S)
    mask = _decode_mask(pos, S_loc, window, q.device, seq.index * S_loc)
    p = _cut_softmax(s, seq, mask)
    out = seq.all_reduce(torch.matmul(p.to(cache_v.dtype).float(),
                                      cache_v.float()))
    return out.reshape(B, Hq, 1, D).to(q.dtype)


def decode_attend_int8_cut(q, k_q, k_s, v_q, v_s, pos, seq: Axis, *,
                           window=None):
    """`decode_attend_int8` of whole q heads against this rank's positions
    of an int8 cache (and its scales) cut over `seq`: the logits scaled by
    k_s, the softmax reduced over the cut, then p scaled by v_s and
    rounded to bf16, and the products summed over the ranks. q and p are
    rounded where `decode_attend_int8` rounds them, so one rank and the
    cut differ only by the order of the softmax's sum."""
    B, Hq, _, D = q.shape
    _, Hkv, S_loc, _ = k_q.shape
    g = Hq // Hkv
    scale = 1.0 / (D ** 0.5)
    qh = (q.reshape(B, Hkv, g, D) * scale).to(torch.bfloat16).float()
    s = torch.matmul(qh, k_q.float().transpose(-1, -2))      # (B,Hkv,g,S)
    s = s * k_s[:, :, None, :]
    mask = _decode_mask(pos, S_loc, window, q.device, seq.index * S_loc)
    p = _cut_softmax(s, seq, mask)
    p = (p * v_s[:, :, None, :]).to(torch.bfloat16).float()
    out = seq.all_reduce(torch.matmul(p, v_q.float()))
    return out.reshape(B, Hq, 1, D).to(q.dtype)


def attn_out(p, o, cfg: ModelConfig):
    """o (B,Hq,S,hd) (this rank's heads or all) -> (B,S,D)."""
    B, H, S, Hd = o.shape
    return row(o.transpose(1, 2).reshape(B, S, H * Hd), p["wo"],
               cfg.num_heads * cfg.hd, model_axis())
