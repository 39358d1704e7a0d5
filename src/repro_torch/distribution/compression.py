"""Gradient compression: int8 all-reduce with error feedback.

Distributed-optimization trick for bandwidth-bound data parallelism: each
rank quantizes its local gradient to int8 with a per-block scale, the
all-reduce runs on int8 payloads, and the quantization error is fed back
into the next step's gradient (error-feedback / EF-SGD, Seide et al. 2014;
1-bit Adam lineage).

Where the JAX package reduces over a `shard_map` axis name, the port
reduces over a process group of `torch.distributed` (None: one rank).
`quantize_int8` / `dequantize_int8` are the JAX package's, bit for bit.
"""

from __future__ import annotations

import torch

from ..tree import leaves, tree_map, unflatten
from .collectives import all_reduce, group_size


def _block_scales(x: torch.Tensor, block: int):
    flat = x.reshape(-1)
    n = flat.shape[0]
    npad = -(-n // block) * block - n
    flat = torch.nn.functional.pad(flat, (0, npad))
    blocks = flat.reshape(-1, block)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    return blocks, scale, n


def quantize_int8(x: torch.Tensor, block: int = 256):
    """x -> (int8 blocks (nb, block), f32 scales (nb, 1), orig_len)."""
    blocks, scale, n = _block_scales(x.float(), block)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale, n


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, n: int,
                    shape: tuple) -> torch.Tensor:
    x = (q.float() * scale).reshape(-1)[:n]
    return x.reshape(shape)


def compressed_psum(x: torch.Tensor, group=None,
                    err: torch.Tensor | None = None,
                    block: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 mean over `group` (every rank calls it).

    Returns (mean gradient, new error-feedback residual). Each rank's int8
    payload, widened to int32 and times its scales, is summed over the
    group (as the JAX package's psum of `q.astype(int32) * scale`), and
    divided by the group's size.
    """
    xf = x.float()
    if err is not None:
        xf = xf + err
    q, scale, n = quantize_int8(xf, block)
    local = dequantize_int8(q, scale, n, x.shape)
    new_err = xf - local
    q_sum = all_reduce(q.to(torch.int32) * scale, group)
    n_ranks = float(group_size(group))
    mean = (q_sum.reshape(-1)[:n] / n_ranks).reshape(x.shape)
    return mean, new_err


def compressed_grad_sync(grads, group=None, err_state=None,
                         block: int = 256):
    """Tree-wise error-feedback int8 gradient mean over a DP group."""
    if err_state is None:
        err_state = tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                             grads)
    out = [compressed_psum(g, group, e, block)
           for g, e in zip(leaves(grads), leaves(err_state))]
    synced = unflatten(grads, [o[0] for o in out])
    new_err = unflatten(grads, [o[1] for o in out])
    return synced, new_err
