"""Hand-written CUDA kernels for Hopper (sm_90a) + plain-torch versions.

Layout per kernel: <name>.py holds the wrapper (checks, launch, launch
counter) and the plain version, csrc/<name>.cu the kernel, ref.py the
plain-torch oracles. The sources build on first use (`_lib.build_all`);
importing this package builds and loads nothing.
"""

from . import ref
from ._lib import launch_counts, reset_launch_counts
from .conv2d_im2col import conv2d_int8, conv2d_int8_plain
from .gemm_int8 import gemm_int8, gemm_int8_plain

__all__ = ["ref", "gemm_int8", "gemm_int8_plain", "conv2d_int8",
           "conv2d_int8_plain", "launch_counts", "reset_launch_counts"]
