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
"""

from __future__ import annotations

import torch

from .config import ModelConfig
from .layers import normal_init
from .rope import apply_rope
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
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(B, S, Hq, Hd).transpose(1, 2)
    k = k.reshape(B, S, Hkv, Hd).transpose(1, 2)
    v = v.reshape(B, S, Hkv, Hd).transpose(1, 2)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


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


def _decode_mask(pos, Smax: int, window, device):
    """(B or 1, 1, 1, Smax) bool: kv position j is visible to a row whose
    current token sits at `pos` iff j <= pos (and j > pos - window)."""
    p = torch.as_tensor(pos, device=device).reshape(-1, 1, 1, 1)
    kpos = torch.arange(Smax, device=device)[None, None, None, :]
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


def attn_out(p, o, cfg: ModelConfig):
    """o (B,Hq,S,hd) -> (B,S,D)."""
    B, Hq, S, Hd = o.shape
    return o.transpose(1, 2).reshape(B, S, Hq * Hd) @ p["wo"]
