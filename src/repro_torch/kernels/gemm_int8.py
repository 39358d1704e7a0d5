"""K1: int8 x int8 -> int32 GEMM with an optional fused requant epilogue.

The CUDA kernel is `csrc/gemm_int8.cu` (it replaces the JAX package's
`kernels/gemm_int8.py::gemm_int8_pallas`); `gemm_int8_plain` is its plain
torch version, which the wrapper takes for CPU tensors only. It has two
routes, which `gemm_splits` chooses with their split of K: at M <= 16 (the
classifier at batch 1 and 8) a skinny split-K product on the CUDA cores
that reads the weights once, at M > 16 the int8 tensor-core tile of K2.
Either way the split partials meet inside the one launch.

`dot_i32_exact` and `requant_epilogue` are the value-level building blocks
the megakernel's plain version and the "torch" backend share with it.
"""

from __future__ import annotations

import math

import torch

from . import _lib
from .conv2d_im2col import (H100_SMS, TILE_M, TILE_N, conv_splits,
                            split_workspace)
from .ref import channel_mult, matmul_i32, requant

dot_i32_exact = matmul_i32
requant_epilogue = requant

# the skinny route (csrc/gemm_int8.cu: SK_M, SK_BN, SK_CHUNK): its largest
# M, its column tile and its K chunk (one block step of 32 lanes x 4 rows)
SKINNY_M = 16
SKINNY_N = 64
SKINNY_CHUNK = 128


def gemm_splits(M: int, N: int, K: int,
                sms: int = H100_SMS) -> tuple[str, int]:
    """K1's route and split count for an (M, K) x (K, N) product: "skinny"
    (M <= 16, CUDA cores) or "mma" (int8 tensor cores), and the least S for
    which the route's tiles x S reach `sms` blocks, at most one split per K
    chunk of the route (at least 1)."""
    if M <= SKINNY_M:
        tiles = math.ceil(N / SKINNY_N)
        chunks = math.ceil(K / SKINNY_CHUNK)
        return "skinny", max(1, min(chunks, math.ceil(sms / tiles)))
    return "mma", conv_splits(M, N, K, sms)


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
    are shared); on a CPU tensor it runs `gemm_int8_plain`. A kernel launch
    counts one; the plain version counts none.
    """
    _check(x, w)
    _lib.refuse_grad("gemm_int8", x, w, requant_mult)
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
    Mf = x2.shape[0]
    out = torch.empty((Mf, N), device=x.device,
                      dtype=torch.int32 if mult is None else torch.int8)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    route, S = gemm_splits(Mf, N, K, sms) if Mf > 0 else ("skinny", 1)
    ws = cnt = None
    if S > 1:
        if route == "skinny":
            tiles = math.ceil(N / SKINNY_N)
            n_ws = tiles * S * SKINNY_M * SKINNY_N
        else:
            tiles = math.ceil(Mf / TILE_M) * math.ceil(N / TILE_N)
            n_ws = tiles * S * TILE_M * TILE_N
        ws = split_workspace(x.device, "partials", n_ws).data_ptr()
        cnt = split_workspace(x.device, "counters", tiles).data_ptr()
    lib = _lib.load("gemm_int8")
    with torch.cuda.device(x.device):
        err = lib.gemm_int8_launch(
            x2.data_ptr(), w.data_ptr(),
            None if mult is None else mult.data_ptr(),
            1 if mult is None else mult.numel(), out.data_ptr(),
            Mf, K, N, S, ws, cnt, _lib.stream_ptr(x))
    _lib.check(lib, err, "gemm_int8")
    _lib.count_launch("gemm_int8")
    return out.reshape(*lead, M, N)
