"""K5: the first-order gated linear recurrence h_t = a_t * h_{t-1} + x_t.

The CUDA kernel is `csrc/ssm_scan.cu` (it replaces the JAX package's
`kernels/ssm_scan.py::ssm_scan_pallas`); `ssm_scan_plain` is its plain
torch version, which the wrapper takes for CPU tensors only. `h0` seeds
the carry (the decode path resumes from the cached state); None means 0.
Under autograd the wrapper goes through `SsmScanFn`: K5 forward, the plain
version's autograd backward.

Where a dispatch mode watches (`_lib.seen`: the dry run, the op counter)
the launch is the custom op `torch.ops.repro_torch.ssm_scan` (CUDA only),
with a fake implementation (shapes, no launch) and a FLOP formula for
`torch.utils.flop_counter`: a multiply and an add per element. Otherwise
the wrapper calls the launch directly.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from . import _lib
from .ref import ssm_scan_sequential


def _check(a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor | None):
    if a.dim() != 3 or a.shape != x.shape:
        raise ValueError(f"ssm_scan: a {tuple(a.shape)} and x "
                         f"{tuple(x.shape)} must both be (B, T, D)")
    if h0 is not None and tuple(h0.shape) != (x.shape[0], x.shape[2]):
        raise ValueError(f"ssm_scan: h0 {tuple(h0.shape)} is not (B, D) = "
                         f"{(x.shape[0], x.shape[2])}")
    devs = {a.device, x.device} | ({h0.device} if h0 is not None else set())
    if len(devs) != 1:
        raise ValueError(f"ssm_scan: operands on {sorted(map(str, devs))}")


# The kernel's function in plain torch: the recurrence walked in order over
# T in float32, h = a_t * h + x_t (a multiply and an add, each rounded, as
# in the kernel) -- the step-by-step oracle itself.
ssm_scan_plain = ssm_scan_sequential


def ssm_scan(a: torch.Tensor, x: torch.Tensor,
             h0: torch.Tensor | None = None) -> torch.Tensor:
    """a, x (B, T, D) -> y (B, T, D) f32 with y_t = a_t * y_{t-1} + x_t,
    y_{-1} = h0 (B, D) or 0.

    On a CUDA tensor this launches K5; on a CPU tensor it runs
    `ssm_scan_plain`. A kernel launch counts one; the plain version counts
    none. With grad mode on and an input that requires grad, the call goes
    through `SsmScanFn`, whose backward differentiates `ssm_scan_plain`.
    """
    _check(a, x, h0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (a, x, h0)):
        return SsmScanFn.apply(a, x, h0)
    return _kernel_forward(a, x, h0)


def _k5_launch(a: torch.Tensor, x: torch.Tensor,
               h0: torch.Tensor | None) -> torch.Tensor:
    """One K5 launch (counted) on contiguous f32 CUDA tensors."""
    B, T, D = x.shape
    y = torch.empty((B, T, D), dtype=torch.float32, device=x.device)
    lib = _lib.load("ssm_scan")
    with torch.cuda.device(x.device):
        err = lib.ssm_scan_launch(a.data_ptr(), x.data_ptr(),
                                  None if h0 is None else h0.data_ptr(),
                                  y.data_ptr(), B, T, D, _lib.stream_ptr(x))
    _lib.check(lib, err, "ssm_scan")
    _lib.count_launch("ssm_scan")
    return y


_k5 = torch.library.custom_op("repro_torch::ssm_scan", _k5_launch,
                              mutates_args=(), device_types="cuda")


@_k5.register_fake
def _(a, x, h0):
    return torch.empty(x.shape, dtype=torch.float32, device=x.device)


@register_flop_formula(torch.ops.repro_torch.ssm_scan)
def _k5_flops(a_shape, x_shape, h0_shape, *args, out_shape=None,
              **kwargs) -> int:
    B, T, D = x_shape
    return 2 * B * T * D


def _kernel_forward(a, x, h0):
    """K5 on CUDA tensors (one launch, counted), `ssm_scan_plain` on CPU
    tensors (the route of `_lib.route_of`)."""
    if _lib.route_of(x) == "ref":
        return ssm_scan_plain(a, x, h0)
    launch = _k5 if _lib.seen(x) else _k5_launch
    return launch(
        a.float().contiguous(), x.float().contiguous(),
        None if h0 is None else h0.float().contiguous())


class SsmScanFn(torch.autograd.Function):
    """K5 under autograd. The forward is K5 (its plain version on CPU
    tensors) and saves a, x and h0; the backward recomputes
    `ssm_scan_plain` on the same inputs and differentiates it with
    `torch.autograd.grad`, as `FlashAttentionFn` does for K4. A backward
    kernel (the same recurrence run in reverse) would be speed work."""

    @staticmethod
    def forward(ctx, a, x, h0):
        ctx.save_for_backward(a, x, h0)
        return _kernel_forward(a, x, h0)

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad
        with torch.enable_grad():
            ins = [None if t is None else t.detach().requires_grad_(n)
                   for t, n in zip(saved, need)]
            y = ssm_scan_plain(*ins)
            wrt = [t for t, n in zip(ins, need) if n]
            got = iter(torch.autograd.grad(y, wrt, dy))
        return tuple(next(got) if n else None for n in need)
