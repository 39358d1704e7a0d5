"""K1: int8 x int8 -> int32 GEMM with an optional fused requant epilogue.

The CUDA kernel is `csrc/gemm_int8.cu` (it replaces the JAX package's
`kernels/gemm_int8.py::gemm_int8_pallas`); `gemm_int8_plain` is its plain
torch version, which the wrapper takes for CPU tensors only.

`dot_i32_exact` and `requant_epilogue` are the value-level building blocks
the megakernel's plain version and the "torch" backend share with it.
"""

from __future__ import annotations

import torch

from . import _lib
from .ref import channel_mult, matmul_i32, requant

dot_i32_exact = matmul_i32
requant_epilogue = requant


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"gemm_int8 takes int8 operands, got {x.dtype} and "
                        f"{w.dtype}")
    if w.dim() != 2 or x.dim() < 2 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"gemm_int8: shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)} do not contract")
    if x.device != w.device:
        raise ValueError(f"gemm_int8: x on {x.device}, w on {w.device}")


def gemm_int8_plain(x: torch.Tensor, w: torch.Tensor,
                    requant_mult: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's function in plain torch: (..., M, K) @ (K, N) -> int32,
    or int8 through the requant epilogue when `requant_mult` is given."""
    acc = dot_i32_exact(x, w)
    if requant_mult is None:
        return acc
    return requant_epilogue(acc, channel_mult(requant_mult, w.shape[1],
                                              acc.device))


def gemm_int8(x: torch.Tensor, w: torch.Tensor,
              requant_mult: torch.Tensor | None = None) -> torch.Tensor:
    """x (..., M, K) int8 @ w (K, N) int8 -> (..., M, N) int32, or int8 if
    `requant_mult` (a scalar or per-channel (N,) f32) is given.

    On a CUDA tensor this launches K1 (leading axes fold into M: the weights
    are shared); on a CPU tensor it runs `gemm_int8_plain`. Every call counts
    one launch.
    """
    _check(x, w)
    _lib.count_launch("gemm_int8")
    if x.device.type == "cpu":
        return gemm_int8_plain(x, w, requant_mult)
    if x.device.type != "cuda":
        raise ValueError(f"gemm_int8: no kernel for device {x.device}")
    *lead, M, K = x.shape
    N = w.shape[1]
    x2 = x.reshape(-1, K).contiguous()
    w = w.contiguous()
    mult = None if requant_mult is None else channel_mult(
        requant_mult, N, x.device)
    out = torch.empty((x2.shape[0], N), device=x.device,
                      dtype=torch.int32 if mult is None else torch.int8)
    lib = _lib.load("gemm_int8")
    err = lib.gemm_int8_launch(
        x2.data_ptr(), w.data_ptr(),
        None if mult is None else mult.data_ptr(),
        1 if mult is None else mult.numel(), out.data_ptr(),
        x2.shape[0], K, N, _lib.stream_ptr(x))
    _lib.check(lib, err, "gemm_int8")
    return out.reshape(*lead, M, N)
