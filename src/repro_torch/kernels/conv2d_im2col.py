"""K2: NHWC int8 conv2d as an implicit im2col GEMM, with the same optional
fused requant epilogue as K1.

The CUDA kernel is `csrc/conv2d_im2col.cu` (it replaces the JAX package's
`kernels/conv2d_im2col.py::conv2d_int8_pallas`). It reads each patch
straight from the input in device memory, with the padding done by masking;
nothing is padded or materialised. It multiplies on the int8 tensor cores
in 64 x 64 output tiles and splits K over `conv_splits(...)` blocks per
tile, whose int32 partials meet in a cached workspace inside the one
launch. `conv2d_int8_plain` is the plain torch version,
which the wrapper takes for CPU tensors only.
"""

from __future__ import annotations

import math
import threading

import torch

from . import _lib
from .ref import channel_mult, im2col_patches, matmul_i32, requant

__all__ = ["conv2d_int8", "conv2d_int8_plain", "conv_splits",
           "im2col_patches", "split_workspace"]

# the int8 tensor-core tile's output tile and K chunk (csrc/int8_mma.cuh:
# BM, BN, BK), shared with K1's M > 16 route and K3
TILE_M = TILE_N = 64
CHUNK_K = 64
H100_SMS = 132


def conv_splits(M: int, N: int, K: int, sms: int = H100_SMS) -> int:
    """How many ways K2 splits K: the least S for which tiles x S reaches
    `sms` blocks, at most one per 64-deep K chunk (the kernel gives each
    split a balanced, non-empty range of chunks). 1 when the tiles alone
    fill the card. K1's tensor-core route and K3's conv and gemm steps
    split by the same rule (csrc/int8_mma.cuh: split_count)."""
    tiles = math.ceil(M / TILE_M) * math.ceil(N / TILE_N)
    chunks = math.ceil(K / CHUNK_K)
    return max(1, min(chunks, math.ceil(sms / tiles)))


_WS_LOCK = threading.Lock()
_WORKSPACES: dict[tuple[str, str, int], torch.Tensor] = {}


def split_workspace(device: torch.device, kind: str, n: int) -> torch.Tensor:
    """A cached int32 buffer of at least `n` zeros on `device`, one per
    (device, kind, size) with the size rounded up to a power of two: the
    "partials" (one slice per split of a tile, each written before the
    tile's last block reads it), the tiles' ticket "counters" or K3's grid
    "barrier" (zeroed once here; the kernels leave them at zero). Kept for
    the process's life, so a CUDA graph that captured a launch replays
    against live memory, and reused by every launch of K1, K2 and K3 on
    the device (K6 takes kinds of its own, "tiled_partials" and
    "tiled_counters"), which must therefore run on one stream at a
    time."""
    size = 1 << max(0, n - 1).bit_length()
    key = (str(device), kind, size)
    with _WS_LOCK:
        buf = _WORKSPACES.get(key)
        if buf is None:
            buf = torch.zeros(size, dtype=torch.int32, device=device)
            _WORKSPACES[key] = buf
    return buf


def conv2d_int8_plain(x: torch.Tensor, w: torch.Tensor,
                      requant_mult: torch.Tensor | None = None, *,
                      kh: int, kw: int, stride: int = 1,
                      padding: int = 0) -> torch.Tensor:
    """The kernel's function in plain torch: x (..., H, W, C) int8,
    w (kh*kw*C, N) int8 -> (..., oh, ow, N) int32 (int8 with requant)."""
    *lead, H, W, C = x.shape
    N = w.shape[1]
    oh = (H + 2 * padding - kh) // stride + 1
    ow = (W + 2 * padding - kw) // stride + 1
    cols = im2col_patches(x, kh, kw, stride, padding)
    acc = matmul_i32(cols.reshape(-1, kh * kw * C), w)
    if requant_mult is not None:
        acc = requant(acc, channel_mult(requant_mult, N, acc.device))
    return acc.reshape(*lead, oh, ow, N)


def conv2d_int8(x: torch.Tensor, w: torch.Tensor,
                requant_mult: torch.Tensor | None = None, *,
                kh: int, kw: int, stride: int = 1,
                padding: int = 0) -> torch.Tensor:
    """x (H, W, C) or (B, H, W, C) int8, w (kh*kw*C, N) int8 ->
    (..., oh, ow, N) int32, or int8 if `requant_mult` (scalar or (N,) f32)
    is given.

    On a CUDA tensor this launches K2; on a CPU tensor it runs
    `conv2d_int8_plain`. A kernel launch counts one; the plain version
    counts none.
    """
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"conv2d_int8 takes int8 operands, got {x.dtype} "
                        f"and {w.dtype}")
    if x.dim() not in (3, 4) or w.dim() != 2 \
            or w.shape[0] != kh * kw * x.shape[-1]:
        raise ValueError(f"conv2d_int8: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} do not fit a {kh}x{kw} kernel")
    if x.device != w.device:
        raise ValueError(f"conv2d_int8: x on {x.device}, w on {w.device}")
    _lib.refuse_grad("conv2d_int8", x, w, requant_mult)
    if x.device.type == "cpu":
        return conv2d_int8_plain(x, w, requant_mult, kh=kh, kw=kw,
                                 stride=stride, padding=padding)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_int8: no kernel for device {x.device}")
    lead = x.shape[:-3]
    H, W, C = x.shape[-3:]
    N = w.shape[1]
    oh = (H + 2 * padding - kh) // stride + 1
    ow = (W + 2 * padding - kw) // stride + 1
    B = x.numel() // (H * W * C)
    x = x.contiguous()
    w = w.contiguous()
    mult = None if requant_mult is None else channel_mult(
        requant_mult, N, x.device)
    out = torch.empty((*lead, oh, ow, N), device=x.device,
                      dtype=torch.int32 if mult is None else torch.int8)
    M, K = B * oh * ow, kh * kw * C
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    S = conv_splits(M, N, K, sms) if M > 0 else 1
    ws = cnt = None
    if S > 1:
        tiles = math.ceil(M / TILE_M) * math.ceil(N / TILE_N)
        ws = split_workspace(x.device, "partials",
                             tiles * S * TILE_M * TILE_N).data_ptr()
        cnt = split_workspace(x.device, "counters", tiles).data_ptr()
    lib = _lib.load("conv2d_im2col")
    with torch.cuda.device(x.device):
        err = lib.conv2d_int8_launch(
            x.data_ptr(), w.data_ptr(),
            None if mult is None else mult.data_ptr(),
            1 if mult is None else mult.numel(), out.data_ptr(),
            B, H, W, C, N, kh, kw, stride, padding, S, ws, cnt,
            _lib.stream_ptr(x))
    _lib.check(lib, err, "conv2d_int8")
    _lib.count_launch("conv2d_int8")
    return out
