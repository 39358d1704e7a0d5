"""Hand-written CUDA kernels for Hopper (sm_90a) + plain-torch versions.

Layout per kernel: <name>.py holds the wrapper (checks, launch, launch
counter) and the plain version, csrc/<name>.cu the kernel, ref.py the
plain-torch oracles, ops.py the device dispatch model code calls. The
sources build on first use (`_lib.build_all`); importing this package
builds and loads nothing.
"""

from . import ops, ref
from ._lib import (byte_counts, graph_counts, launch_counts,
                   reset_launch_counts)
from .conv2d_im2col import conv2d_int8, conv2d_int8_plain
from .flash_attention import flash_attention, flash_attention_plain
from .gemm_int8 import gemm_int8, gemm_int8_plain
from .lut_int8 import lut_int8, lut_int8_plain
from .ssm_scan import ssm_scan, ssm_scan_plain
from .tiled_int8 import tiled_int8, tiled_int8_plain

__all__ = ["ops", "ref", "gemm_int8", "gemm_int8_plain", "conv2d_int8",
           "conv2d_int8_plain", "flash_attention", "flash_attention_plain",
           "ssm_scan", "ssm_scan_plain", "tiled_int8", "tiled_int8_plain",
           "lut_int8", "lut_int8_plain", "byte_counts", "graph_counts",
           "launch_counts", "reset_launch_counts"]
