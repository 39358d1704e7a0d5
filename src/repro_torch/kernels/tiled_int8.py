"""K6: one mesh rank's tiles of an int8 conv or GEMM, in one launch.

The mesh backend (`repro_torch.cluster.mesh`) gives every rank of the
model axis the tiles of its block of the schedule's cores. This kernel
computes those tiles' products into an int32 (B, M, N) partial, zero
elsewhere; an all-reduce over the axis then sums the disjoint partials.
It replaces the JAX package's `cluster/mesh.py::_tiled_partial` (a loop of
`lax.dot_general` over the tile table).

The CUDA kernel is `csrc/tiled_int8.cu`, on `int8_mma.cuh`'s 64 x 64 int8
tensor-core tile with its implicit-im2col loader (a GEMM runs as a 1 x 1
conv). The host merges the rank's tiles that stack in one column band and
cuts the result into 64 x 64 work items (`work_items`), cached per table
and device. `tiled_int8_plain` is the plain torch version, which the
wrapper takes for CPU tensors only.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from . import _lib
from .ref import im2col_patches, matmul_i32

__all__ = ["tiled_int8", "tiled_int8_plain", "work_items", "live_tiles"]

ITEM = 64                        # int8_mma.cuh: BM = BN


def live_tiles(tiles, mask, M: int, N: int) -> np.ndarray:
    """The (T, 4) rows of `tiles` that `mask` enables, as int64, each
    checked to be a non-empty rectangle inside the (M, N) output (the
    kernel writes where they say)."""
    t = np.asarray(tiles, np.int64).reshape(-1, 4)
    t = t[np.asarray(mask, bool).reshape(-1)]
    bad = ((t[:, 0] < 0) | (t[:, 0] >= t[:, 1]) | (t[:, 1] > M)
           | (t[:, 2] < 0) | (t[:, 2] >= t[:, 3]) | (t[:, 3] > N))
    if bad.any():
        raise ValueError(f"tile {t[bad][0].tolist()} is not a non-empty "
                         f"rectangle of the ({M}, {N}) output")
    return t


def _out_hw(H: int, W: int, kh: int, kw: int, stride: int,
            padding: int) -> tuple[int, int]:
    return ((H + 2 * padding - kh) // stride + 1,
            (W + 2 * padding - kw) // stride + 1)


def tiled_int8_plain(x: torch.Tensor, w: torch.Tensor, tiles, mask, *,
                     kh: int = 1, kw: int = 1, stride: int = 1,
                     padding: int = 0) -> torch.Tensor:
    """The kernel's function in plain torch: x (B, H, W, C) int8, w
    (kh*kw*C, N) int8, tiles (T, 4) rows (m0, m1, n0, n1) enabled by mask
    (T,) -> (B, oh*ow, N) int32 holding the product x.w inside each live
    tile and zero elsewhere."""
    B, H, W, C = x.shape
    N = w.shape[1]
    oh, ow = _out_hw(H, W, kh, kw, stride, padding)
    cols = im2col_patches(x, kh, kw, stride, padding)     # (B, M, K)
    out = torch.zeros((B, oh * ow, N), dtype=torch.int32, device=x.device)
    for m0, m1, n0, n1 in live_tiles(tiles, mask, oh * ow, N).tolist():
        part = matmul_i32(cols[:, m0:m1].reshape(-1, cols.shape[-1]),
                          w[:, n0:n1])
        out[:, m0:m1, n0:n1] += part.reshape(B, m1 - m0, n1 - n0)
    return out


def work_items(tiles, mask, M: int, N: int) -> tuple[np.ndarray, int]:
    """The kernel's work list for a tile table over an (M, N) output: the
    live tiles, with tiles of one column band [n0, n1) that meet end to
    end along M merged, cut into sub-blocks of at most 64 x 64. Returns
    the (n_items, 4) int32 rows (m0, m1, n0, n1) and the number of output
    elements they cover."""
    t = live_tiles(tiles, mask, M, N)
    merged: list[list[int]] = []
    for m0, m1, n0, n1 in sorted(t.tolist(), key=lambda r: (r[2], r[3],
                                                           r[0])):
        last = merged[-1] if merged else None
        if last and (last[2], last[3]) == (n0, n1) and last[1] == m0:
            last[1] = m1
        else:
            merged.append([m0, m1, n0, n1])
    items = [(m, min(m + ITEM, m1), n, min(n + ITEM, n1))
             for m0, m1, n0, n1 in merged
             for m in range(m0, m1, ITEM) for n in range(n0, n1, ITEM)]
    area = int(((t[:, 1] - t[:, 0]) * (t[:, 3] - t[:, 2])).sum())
    return np.asarray(items, np.int32).reshape(-1, 4), area


_ITEMS_LOCK = threading.Lock()
_ITEMS: dict[tuple, tuple[torch.Tensor, int]] = {}


def _device_items(tiles, mask, M: int, N: int,
                  device) -> tuple[torch.Tensor, int]:
    """`work_items` on `device`, cached per (table, output shape, device),
    so a launch after the first copies nothing (and can be captured in a
    CUDA graph)."""
    t = np.ascontiguousarray(np.asarray(tiles, np.int64))
    mk = np.ascontiguousarray(np.asarray(mask, bool))
    key = (t.tobytes(), mk.tobytes(), M, N, str(device))
    with _ITEMS_LOCK:
        hit = _ITEMS.get(key)
        if hit is None:
            items, area = work_items(t, mk, M, N)
            hit = _ITEMS[key] = (torch.as_tensor(items).to(device), area)
    return hit


def tiled_int8(x: torch.Tensor, w: torch.Tensor, tiles, mask, *,
               kh: int = 1, kw: int = 1, stride: int = 1,
               padding: int = 0) -> torch.Tensor:
    """x (B, H, W, C) int8, w (kh*kw*C, N) int8, and a tile table (host
    arrays: tiles (T, 4) as `cluster.mesh._stack_tiles` gives one rank's,
    mask (T,)) -> (B, oh*ow, N) int32, the product inside the live tiles
    and zero elsewhere. A GEMM x (B, M, K) passes x.reshape(B, M, 1, K).

    On a CUDA tensor this launches K6 (once, whatever the table's size);
    on a CPU tensor it runs `tiled_int8_plain`. A kernel launch counts
    one; the plain version counts none.
    """
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"tiled_int8 takes int8 operands, got {x.dtype} "
                        f"and {w.dtype}")
    if x.dim() != 4 or w.dim() != 2 or w.shape[0] != kh * kw * x.shape[-1]:
        raise ValueError(f"tiled_int8: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} do not fit a {kh}x{kw} kernel")
    if x.device != w.device:
        raise ValueError(f"tiled_int8: x on {x.device}, w on {w.device}")
    if x.device.type == "cpu":
        return tiled_int8_plain(x, w, tiles, mask, kh=kh, kw=kw,
                                stride=stride, padding=padding)
    if x.device.type != "cuda":
        raise ValueError(f"tiled_int8: no kernel for device {x.device}")
    B, H, W, C = x.shape
    N = w.shape[1]
    oh, ow = _out_hw(H, W, kh, kw, stride, padding)
    items, area = _device_items(tiles, mask, oh * ow, N, x.device)
    full = area == oh * ow * N
    out = (torch.empty if full else torch.zeros)(
        (B, oh * ow, N), dtype=torch.int32, device=x.device)
    if items.shape[0] == 0 or out.numel() == 0:
        return out                   # no tile on this rank: nothing runs
    x = x.contiguous()
    w = w.contiguous()
    lib = _lib.load("tiled_int8")
    err = lib.tiled_int8_launch(
        x.data_ptr(), w.data_ptr(), items.data_ptr(), items.shape[0],
        out.data_ptr(), B, H, W, C, N, kh, kw, stride, padding,
        _lib.stream_ptr(x))
    _lib.check(lib, err, "tiled_int8")
    _lib.count_launch("tiled_int8")
    return out
