"""Public kernel wrappers for model code, with dispatch on the tensor's
device.

Where the JAX package resolves a backend ("pallas" on a TPU, "ref"
elsewhere, or one forced through a module-level default), the port reads
the device of the tensors: a CUDA tensor goes to the hand-written kernel,
a CPU tensor to the kernel's plain torch version. There is no global
switch and no interpret mode. Model code uses `resolve_backend` to route
whole-layer decisions (attention) the way the JAX package's
`kernels/ops.py::resolve_backend` does.
"""

from __future__ import annotations

import torch

from . import _lib
from .flash_attention import flash_attention
from .ssm_scan import ssm_scan

__all__ = ["resolve_backend", "flash_attention", "ssm_scan"]


def resolve_backend(t: torch.Tensor) -> str:
    """The dispatch target for tensors on `t`'s device: "cuda" (the
    hand-written kernels) for a CUDA tensor, "ref" (the plain torch
    versions and oracles) for a CPU tensor; for a fake tensor, the
    route of `_lib.cost_route` when one is set (the dry run)."""
    return _lib.route_of(t)
