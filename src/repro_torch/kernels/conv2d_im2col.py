"""K2: NHWC int8 conv2d as an implicit im2col GEMM, with the same optional
fused requant epilogue as K1.

The CUDA kernel is `csrc/conv2d_im2col.cu` (it replaces the JAX package's
`kernels/conv2d_im2col.py::conv2d_int8_pallas`). It reads each patch
straight from the input in device memory, with the padding done by masking;
nothing is padded or materialised. `conv2d_int8_plain` is the plain torch
version, which the wrapper takes for CPU tensors only.
"""

from __future__ import annotations

import torch

from . import _lib
from .gemm_int8 import dot_i32_exact, requant_epilogue
from .ref import channel_mult, im2col_patches

__all__ = ["conv2d_int8", "conv2d_int8_plain", "im2col_patches"]


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
    acc = dot_i32_exact(cols.reshape(-1, kh * kw * C), w)
    if requant_mult is not None:
        acc = requant_epilogue(acc, channel_mult(requant_mult, N,
                                                 acc.device))
    return acc.reshape(*lead, oh, ow, N)


def conv2d_int8(x: torch.Tensor, w: torch.Tensor,
                requant_mult: torch.Tensor | None = None, *,
                kh: int, kw: int, stride: int = 1,
                padding: int = 0) -> torch.Tensor:
    """x (H, W, C) or (B, H, W, C) int8, w (kh*kw*C, N) int8 ->
    (..., oh, ow, N) int32, or int8 if `requant_mult` (scalar or (N,) f32)
    is given.

    On a CUDA tensor this launches K2; on a CPU tensor it runs
    `conv2d_int8_plain`. Every call counts one launch.
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
    _lib.count_launch("conv2d_int8")
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
    lib = _lib.load("conv2d_im2col")
    err = lib.conv2d_int8_launch(
        x.data_ptr(), w.data_ptr(),
        None if mult is None else mult.data_ptr(),
        1 if mult is None else mult.numel(), out.data_ptr(),
        B, H, W, C, N, kh, kw, stride, padding, _lib.stream_ptr(x))
    _lib.check(lib, err, "conv2d_int8")
    return out
