"""Rotary position embeddings (RoPE): half-split rotation, frequencies and
angles in float32."""

from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: (..., S, D); positions: (S,) or broadcastable to x[..., :, 0]
    (a per-row (B, 1, S) tensor gives each batch row its own positions)."""
    D = x.shape[-1]
    freqs = rope_freqs(D, theta, x.device)                 # (D/2,)
    ang = positions[..., :, None].float() * freqs          # (..., S, D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    y = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return y.to(x.dtype)
