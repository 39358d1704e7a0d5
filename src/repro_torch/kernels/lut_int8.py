"""lut_int8: a 256-entry int8 table applied elementwise to int8 data,
y = table[x + 128]: the int8 SiLU of a YOLOv5 Conv block, whose table
`core.quantize.silu_table` builds from the op's scales.

The CUDA kernel is `csrc/lut_int8.cu`; it replaces no TPU kernel (the JAX
package has no table op). It is bound by bytes: each int8 is read and
written once, 16 to a thread's load and store, with the table in shared
memory. `lut_int8_plain` is the plain torch version, which the wrapper
takes for CPU tensors only; it indexes with int32, as the kernel does.

Beside its launch counter the kernel has a byte counter
(`_lib.byte_counts()`): each launch adds `lut_bytes(n)`, the bytes it
moves at least.
"""

from __future__ import annotations

import torch

from . import _lib

__all__ = ["lut_int8", "lut_int8_plain", "lut_bytes"]


def lut_bytes(n: int) -> int:
    """The bytes one launch over `n` values moves at least: each value read
    and written once, and the table read once."""
    return 2 * n + 256


def lut_int8_plain(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch: x (...) int8, table (256,)
    int8 -> (...) int8."""
    idx = x.reshape(-1).to(torch.int32) + 128
    return torch.index_select(table, 0, idx).reshape(x.shape)


def lut_int8(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """x (...) int8, table (256,) int8 -> table[x + 128], (...) int8.

    On a CUDA tensor this launches the kernel; on a CPU tensor it runs
    `lut_int8_plain`. A kernel launch counts one launch and
    `lut_bytes(x.numel())` bytes; the plain version counts nothing.
    """
    if x.dtype != torch.int8 or table.dtype != torch.int8:
        raise TypeError(f"lut_int8 takes int8 data and table, got {x.dtype} "
                        f"and {table.dtype}")
    if tuple(table.shape) != (256,):
        raise ValueError(f"lut_int8: the table is {tuple(table.shape)}, "
                         "not (256,)")
    if x.device != table.device:
        raise ValueError(f"lut_int8: x on {x.device}, table on "
                         f"{table.device}")
    if x.device.type == "cpu":
        return lut_int8_plain(x, table)
    if x.device.type != "cuda":
        raise ValueError(f"lut_int8: no kernel for device {x.device}")
    x = x.contiguous()
    table = table.contiguous()
    y = torch.empty_like(x)
    lib = _lib.load("lut_int8")
    with torch.cuda.device(x.device):
        err = lib.lut_int8_launch(x.data_ptr(), table.data_ptr(),
                                  y.data_ptr(), x.numel(),
                                  _lib.stream_ptr(x))
    _lib.check(lib, err, "lut_int8")
    _lib.count_launch("lut_int8")
    _lib.count_bytes("lut_int8", lut_bytes(x.numel()))
    return y
