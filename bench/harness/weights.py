"""Weights made from the seed on the device, in the type they are served
in, in a few large calls: both sides of the comparison get these same
tensors."""

from __future__ import annotations

import math

import torch

CHUNK = 1 << 28          # elements per draw: a 1 GiB float32 temporary


def cnn_params(specs: dict, seed: int, device) -> dict:
    """{name: numpy array}: int8 weights uniform in [-64, 64) from one
    draw, and float32 per-channel requant multipliers 0.03 / sqrt(K) x
    U(0.75, 1.25), which keep the int8 activations in range."""
    g = torch.Generator(device).manual_seed(int(seed))
    names = sorted(specs)
    w_names = [n for n in names if specs[n][1] == "w"]
    total = sum(math.prod(specs[n][0]) for n in w_names)
    flat = torch.randint(-64, 64, (total,), generator=g, device=device,
                         dtype=torch.int8).cpu().numpy()
    m_names = [n for n in names if specs[n][1] != "w"]
    m_total = sum(math.prod(specs[n][0]) for n in m_names)
    jitter = (0.75 + 0.5 * torch.rand(m_total, generator=g, device=device)
              ).cpu().numpy()
    out, i, j = {}, 0, 0
    for n in w_names:
        size = math.prod(specs[n][0])
        out[n] = flat[i:i + size].reshape(specs[n][0]).copy()
        i += size
    for n in m_names:
        size = math.prod(specs[n][0])
        K = specs[n][1][1]
        out[n] = (jitter[j:j + size] * (0.03 / math.sqrt(K))).astype(
            "float32").reshape(specs[n][0])
        j += size
    return out
