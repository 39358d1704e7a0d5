"""Plain-torch oracles for the integer kernels of this package.

These define the numerics; the CUDA kernels must match them bit-exactly.
They run on any device (CPU in the tests, the GPU in `chip_smoke.py`'s
kernel checks). Every function takes one sample, exactly as its twin in the
JAX package, and also accepts a leading batch axis where noted.

The float ops (flash attention, SSM scans) arrive with the LM slice.
"""

from __future__ import annotations

import torch

# largest K for which <= K partial sums of int8 products (each <= 2^14)
# stay exactly representable in float32 (K * 2^14 <= 2^24)
F32_EXACT_K = 1024


def matmul_i32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact int8 (M, K) @ (K, N) -> int32 through float32 products.

    Every product of two int8 values is at most 2^14 in magnitude, so any
    partial sum of at most `F32_EXACT_K` of them is an integer below 2^24
    and exactly representable in float32: the summation order of the float
    GEMM cannot change the result. K is cut into chunks of that size, each
    chunk is converted back to int32, and the chunks are summed in int32.
    Non-int8 operands take the integer path (CPU only: CUDA has no general
    integer matmul).
    """
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        return torch.matmul(x.to(torch.int32), w.to(torch.int32))
    if x.is_cuda:
        # TF32 keeps 10 mantissa bits: products and partial sums of int8
        # values would round. Full float32 keeps them exact (see above).
        torch.backends.cuda.matmul.allow_tf32 = False
    K = x.shape[-1]
    xf = x.to(torch.float32)
    wf = w.to(torch.float32)
    if K <= F32_EXACT_K:
        return torch.matmul(xf, wf).to(torch.int32)
    acc = None
    for k0 in range(0, K, F32_EXACT_K):
        k1 = min(K, k0 + F32_EXACT_K)
        part = torch.matmul(xf[..., k0:k1], wf[k0:k1]).to(torch.int32)
        acc = part if acc is None else acc + part
    return acc


def requant(acc: torch.Tensor, mult: torch.Tensor) -> torch.Tensor:
    """int32 -> int8: float32 multiply, round half to even, saturate.

    `torch.round` rounds halves to even, like `jnp.round` and `np.round`,
    so this is the same function as the JAX package's `requant_epilogue`
    and `quantize.requantize`.
    """
    y = torch.round(acc.to(torch.float32) * mult)
    return torch.clamp(y, -128, 127).to(torch.int8)


# -- int8 GEMM (+ optional per-channel requant epilogue) ----------------------

def gemm_int8(x: torch.Tensor, w: torch.Tensor,
              requant_mult=None) -> torch.Tensor:
    """x (M,K) int8 @ w (K,N) int8 -> int32, optionally requantized to int8."""
    acc = matmul_i32(x, w)
    if requant_mult is None:
        return acc
    return requant(acc, channel_mult(requant_mult, w.shape[1], acc.device))


def channel_mult(mult, n: int, device=None) -> torch.Tensor:
    """A scalar or per-channel requant multiplier as a contiguous f32
    vector of 1 or `n` values (both are legal everywhere requant appears,
    mirroring quantize.requantize; both broadcast over the last axis, and
    the kernels index it per column when it has `n`)."""
    m = torch.as_tensor(mult, dtype=torch.float32, device=device)
    m = m.reshape(-1).contiguous()
    if m.numel() not in (1, n):
        raise ValueError(f"requant multiplier has {m.numel()} values, "
                         f"expected 1 or {n}")
    return m


# -- conv2d as im2col GEMM ----------------------------------------------------

def pad_hw(x: torch.Tensor, p: int, value: int = 0) -> torch.Tensor:
    """Pad the two spatial axes of (..., H, W, C) by `p` with `value`."""
    if p == 0:
        return x
    *lead, H, W, C = x.shape
    out = torch.full((*lead, H + 2 * p, W + 2 * p, C), value,
                     dtype=x.dtype, device=x.device)
    out[..., p:p + H, p:p + W, :] = x
    return out


def im2col_patches(x: torch.Tensor, kh: int, kw: int, stride: int = 1,
                   padding: int = 0) -> torch.Tensor:
    """(..., H, W, C) -> (..., oh*ow, kh*kw*C) patch matrix.

    Column order (di*kw + dj)*C + c, matching the (kh*kw*C, N) weight
    layout of the conv kernels and the JAX package's `im2col_patches`.
    """
    xp = pad_hw(x, padding)
    *lead, Hp, Wp, C = xp.shape
    oh = (Hp - kh) // stride + 1
    ow = (Wp - kw) // stride + 1
    nl = len(lead)
    # (..., oh, ow, C, kh, kw) windows -> (..., oh, ow, kh, kw, C)
    win = xp.unfold(nl, kh, stride).unfold(nl + 1, kw, stride)
    win = win.permute(*range(nl), nl, nl + 1, nl + 3, nl + 4, nl + 2)
    return win.reshape(*lead, oh * ow, kh * kw * C)


def conv2d_int8_general(x: torch.Tensor, w: torch.Tensor, kh: int, kw: int,
                        stride: int = 1, padding: int = 0) -> torch.Tensor:
    """Int8 conv with explicit kernel dims: x (..., H, W, C) int8,
    w (kh*kw*C, N) int8 -> (..., oh, ow, N) int32. Integer accumulation
    makes the summation order irrelevant, so this equals the JAX package's
    shift-slice formulation bit for bit."""
    *lead, H, W, C = x.shape
    N = w.shape[1]
    oh = (H + 2 * padding - kh) // stride + 1
    ow = (W + 2 * padding - kw) // stride + 1
    cols = im2col_patches(x, kh, kw, stride, padding)
    acc = matmul_i32(cols.reshape(-1, kh * kw * C), w)
    return acc.reshape(*lead, oh, ow, N)


def conv2d_int8(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                padding: int = 0, requant_mult=None) -> torch.Tensor:
    """NHWC single-image conv with a square kernel inferred from w's rows."""
    H, W, C = x.shape[-3:]
    KKC, N = w.shape
    k = 1
    while k * k * C < KKC:
        k += 1
    if k * k * C != KKC:
        raise ValueError("weights not (kh*kw*C, N)")
    acc = conv2d_int8_general(x, w, k, k, stride, padding)
    if requant_mult is not None:
        acc = requant(acc, channel_mult(requant_mult, N, acc.device))
    return acc


# -- integer-exact round-half-even division -----------------------------------

def round_half_even_div(s: torch.Tensor, n: int) -> torch.Tensor:
    """round-half-even(s / n) for integer s and positive integer n, in
    integer arithmetic with floor division (the remainder is then in
    [0, n) even for negative s, as in the JAX package)."""
    s = s.to(torch.int32)
    q = torch.div(s, n, rounding_mode="floor")
    r = s - q * n
    up = (2 * r > n) | ((2 * r == n) & (q % 2 != 0))
    return q + up.to(torch.int32)
