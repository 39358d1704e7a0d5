"""K6: one mesh rank's tiles of an int8 conv or GEMM, in one launch.

The mesh backend (`repro_torch.cluster.mesh`) gives every rank of the
model axis the tiles of its block of the schedule's cores. This kernel
computes those tiles' products into an int32 (B, M, N) partial, zero
elsewhere; an all-reduce over the axis then sums the disjoint partials.
It replaces the JAX package's `cluster/mesh.py::_tiled_partial` (a loop of
`lax.dot_general` over the tile table).

The CUDA kernel is `csrc/tiled_int8.cu`: wgmma on Hopper's int8 tensor
cores, operands in 128-byte swizzled shared memory, the weights by TMA
from a K-major (N, Kp) copy made once (`prepare_weights`; the mesh
backend keeps one per op). The host makes its work list (`work_units`):
the rank's tiles merged along M over rows that fold the batch in, cut
into 64-row items (`work_items`), each split over K so that the units
fill the card; a persistent grid walks the units, and an item's splits
meet in a cached int32 workspace inside the one launch. The list is
cached per table, shape, batch and device. `tiled_int8_plain` is the
plain torch version, which the wrapper takes for CPU tensors only.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass

import numpy as np
import torch

from . import _lib
from .conv2d_im2col import H100_SMS, split_workspace
from .ref import im2col_patches, matmul_i32

__all__ = ["tiled_int8", "tiled_int8_plain", "work_items", "work_units",
           "prepare_weights", "live_tiles"]

ITEM = 64                        # rows of an item: wgmma's M (tiled_int8.cu BM)
CHUNK_K = 128                    # K of a chunk: one 128-byte swizzle row (BK)
WIDTHS = (128, 64, 32)           # item widths the kernel takes (wgmma's N)
K_ALIGN = 16                     # TMA's row stride rule: Kp % 16 == 0


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


def work_items(tiles, mask, M: int, N: int, B: int = 1,
               width: int = ITEM) -> tuple[np.ndarray, int]:
    """The kernel's items for a tile table over an (M, N) output at batch
    B: each sample's live tiles as rows b * M + m of the (B * M, N)
    output, the tiles of one column band [n0, n1) that meet end to end
    along those rows merged (ResNet50's 32-row tiles fill whole items; a
    classifier's (B, 1) rows become one (B, K) product), cut into blocks
    of at most 64 rows x `width` columns. Returns the (n_items, 4) int32
    rows (m0, m1, n0, n1) and the number of output elements they
    cover."""
    t = live_tiles(tiles, mask, M, N)
    rects = sorted(((m0 + b * M, m1 + b * M, n0, n1)
                    for b in range(B) for m0, m1, n0, n1 in t.tolist()),
                   key=lambda r: (r[2], r[3], r[0]))
    merged: list[list[int]] = []
    for m0, m1, n0, n1 in rects:
        last = merged[-1] if merged else None
        if last and (last[2], last[3]) == (n0, n1) and last[1] == m0:
            last[1] = m1
        else:
            merged.append([m0, m1, n0, n1])
    items = [(m, min(m + ITEM, m1), n, min(n + width, n1))
             for m0, m1, n0, n1 in merged
             for m in range(m0, m1, ITEM) for n in range(n0, n1, width)]
    area = B * int(((t[:, 1] - t[:, 0]) * (t[:, 3] - t[:, 2])).sum())
    return np.asarray(items, np.int32).reshape(-1, 4), area


@dataclass(frozen=True)
class WorkList:
    """K6's work list for one launch: `units` (n_units, 8) int32 rows
    (m0, m1, n0, n1, c0, c1, item, split), the K chunks [c0, c1) of item
    `item` as split `split` of `splits`; `bn` columns an item (at most);
    `chunks` K chunks in all; `area` output elements covered."""
    units: np.ndarray
    items: int
    splits: int
    bn: int
    chunks: int
    area: int


def _width_cost(n: int, bn: int, chunks: int,
                sms: int) -> tuple[float, int]:
    """(bytes one SM moves, S) for an op cut into `n` items of `bn`
    columns, each split S ways by the rule of `work_units`: the SM's share
    of the units' loads (A and B tiles of each chunk) and stores (the
    tile, or a split's partial), plus the reads of the item's last split
    (the other partials), which one SM does alone."""
    S = max(1, min(chunks, math.ceil(sms / n)))
    tile = ITEM * bn * 4
    unit = math.ceil(chunks / S) * (ITEM + bn) * CHUNK_K + tile
    return max(1.0, n * S / sms) * unit + (S - 1) * tile, S


def work_units(tiles, mask, M: int, N: int, K: int, B: int = 1,
               sms: int = H100_SMS) -> WorkList:
    """The host half of K6: the rank's live tiles as items of 64 rows x
    `bn` columns (`work_items`), then every item split over its
    ceil(K / 128) chunks into S units of a balanced, non-empty range each,
    S the least that brings the units to `sms` where the chunks allow
    (`conv2d_im2col.conv_splits`'s rule). bn (128, 64 or 32: wgmma's N)
    is the width whose units move the fewest bytes through one SM
    (`_width_cost`), the wider on a tie: narrow items need fewer splits,
    and a split costs its partial's write and the last split's reads
    (`PERF.md` §6)."""
    chunks = max(1, math.ceil(K / CHUNK_K))
    best = None
    for bn in WIDTHS:
        items, area = work_items(tiles, mask, M, N, B, width=bn)
        if len(items) == 0:
            return WorkList(np.zeros((0, 8), np.int32), 0, 1, bn, chunks, 0)
        cost, S = _width_cost(len(items), bn, chunks, sms)
        if best is None or cost < best[0]:
            best = (cost, items, area, bn, S)
    _, items, area, bn, S = best
    n = len(items)
    units = np.zeros((n * S, 8), np.int32)
    units[:, :4] = np.repeat(items, S, axis=0)
    split = np.tile(np.arange(S), n)
    units[:, 4] = split * chunks // S
    units[:, 5] = (split + 1) * chunks // S
    units[:, 6] = np.repeat(np.arange(n), S)
    units[:, 7] = split
    return WorkList(units, n, S, bn, chunks, area)


def prepare_weights(w: torch.Tensor) -> torch.Tensor:
    """(K, N) int8 weights -> the (N, Kp) int8 copy K6 reads by TMA: w
    transposed (K-major rows, as int8 wgmma wants both operands) and
    zero-padded to Kp, the least multiple of 16 >= K (TMA's 16-byte row
    stride rule; the stem's K is 147)."""
    K, N = w.shape
    Kp = -(-K // K_ALIGN) * K_ALIGN
    wt = torch.zeros((N, Kp), dtype=torch.int8, device=w.device)
    wt[:, :K] = w.t()
    return wt


@dataclass(frozen=True)
class _Launch:
    """What a launch of K6 takes besides its tensors, for one (table,
    shape, batch, device): the work list, its units on the device, the
    split workspace's pointers (0 without splits) and the SM count."""
    plan: WorkList
    units: torch.Tensor
    ws: int
    counters: int
    sms: int


_LAUNCH_LOCK = threading.Lock()
_LAUNCHES: dict[tuple, _Launch] = {}


def _launch_plan(tiles, mask, M: int, N: int, K: int, B: int,
                 device: torch.device) -> _Launch:
    """`work_units` for `device`'s SM count, its units copied there and its
    split workspace taken, cached per (table, output shape, K, batch,
    device): a launch after the first does one lookup and copies nothing
    (and can be captured in a CUDA graph; `split_workspace`'s buffers live
    as long as the process)."""
    t = np.ascontiguousarray(np.asarray(tiles, np.int64))
    mk = np.ascontiguousarray(np.asarray(mask, bool))
    key = (t.tobytes(), mk.tobytes(), M, N, K, B, str(device))
    with _LAUNCH_LOCK:
        hit = _LAUNCHES.get(key)
        if hit is None:
            sms = torch.cuda.get_device_properties(
                device).multi_processor_count
            plan = work_units(t, mk, M, N, K, B, sms)
            ws = cnt = 0
            if plan.splits > 1:
                ws = split_workspace(device, "tiled_partials",
                                     plan.items * plan.splits * ITEM
                                     * plan.bn).data_ptr()
                cnt = split_workspace(device, "tiled_counters",
                                      plan.items).data_ptr()
            hit = _LAUNCHES[key] = _Launch(
                plan, torch.as_tensor(plan.units).to(device), ws, cnt, sms)
    return hit


def tiled_int8(x: torch.Tensor, w: torch.Tensor, tiles, mask, *,
               kh: int = 1, kw: int = 1, stride: int = 1, padding: int = 0,
               wt: torch.Tensor | None = None) -> torch.Tensor:
    """x (B, H, W, C) int8, w (kh*kw*C, N) int8, and a tile table (host
    arrays: tiles (T, 4) as `cluster.mesh._stack_tiles` gives one rank's,
    mask (T,)) -> (B, oh*ow, N) int32, the product inside the live tiles
    and zero elsewhere. A GEMM x (B, M, K) passes x.reshape(B, M, 1, K).
    `wt` is `prepare_weights(w)`, made once by a caller that calls again
    with the same weights (the mesh backend); without it the wrapper
    makes it, with torch ops, before the launch.

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
    K, N = w.shape
    Kp = -(-K // K_ALIGN) * K_ALIGN
    if wt is not None and (wt.dtype != torch.int8
                           or tuple(wt.shape) != (N, Kp)
                           or wt.device != x.device
                           or not wt.is_contiguous()):
        raise ValueError(f"tiled_int8: wt {wt.dtype} {tuple(wt.shape)} on "
                         f"{wt.device} is not prepare_weights of w "
                         f"{tuple(w.shape)}")
    if x.device.type == "cpu":
        return tiled_int8_plain(x, w, tiles, mask, kh=kh, kw=kw,
                                stride=stride, padding=padding)
    if x.device.type != "cuda":
        raise ValueError(f"tiled_int8: no kernel for device {x.device}")
    B, H, W, C = x.shape
    if wt is None:
        wt = prepare_weights(w)
    oh, ow = _out_hw(H, W, kh, kw, stride, padding)
    run = _launch_plan(tiles, mask, oh * ow, N, K, B, x.device)
    plan = run.plan
    out = (torch.empty if plan.area == B * oh * ow * N else torch.zeros)(
        (B, oh * ow, N), dtype=torch.int32, device=x.device)
    if plan.items == 0 or out.numel() == 0:
        return out                   # no tile on this rank: nothing runs
    x = x.contiguous()
    lib = _lib.load("tiled_int8")
    # the library launches on the current device: make it x's
    with torch.cuda.device(x.device):
        err = lib.tiled_int8_launch(
            x.data_ptr(), wt.data_ptr(), Kp, run.units.data_ptr(),
            run.units.shape[0], plan.items, plan.splits, plan.bn,
            out.data_ptr(), B, H, W, C, N, kh, kw, stride, padding,
            run.ws or None, run.counters or None, run.sms,
            _lib.stream_ptr(x))
    _lib.check(lib, err, "tiled_int8")
    _lib.count_launch("tiled_int8")
    return out
