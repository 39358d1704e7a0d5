"""Train-step builder: microbatched gradient accumulation + AdamW update.

The returned function has the JAX package's dataflow:
    train_step(params, opt_state, batch) -> (params, opt_state, metrics)
with metrics {"loss", "lr", "grad_norm"} as tensors on the params' device.
It is pure, as the JAX step is: the arguments are not modified, and the
new params and state are new tensors.

Microbatching splits the batch as the JAX package does, (B, ...) ->
(B/n, n, ...) with microbatch m the slice [:, m], and accumulates each
microbatch's gradient in float32 before the mean; the JAX package's
`lax.scan` over the microbatches becomes a Python loop.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..models.config import ModelConfig
from ..models.transformer import train_loss
from ..tree import leaves, unflatten
from .optimizer import OptConfig, adamw_update


def _split_micro(batch: dict, n: int) -> dict:
    """(B, ...) -> (B/n, n, ...) on every leaf (the microbatch dim is the
    minor axis of the split, as in the JAX package, where it keeps the
    data-sharded leading dim aligned)."""
    def r(x):
        B = x.shape[0]
        if B % n:
            raise ValueError(f"batch {B} not divisible by {n} microbatches")
        return x.reshape(B // n, n, *x.shape[1:])
    return {k: r(v) for k, v in batch.items()}


def loss_and_grads(loss_fn: Callable, params: Any, batch: dict
                   ) -> tuple[torch.Tensor, list]:
    """(loss, gradient of every params leaf in flattening order)."""
    flat = [p.detach().requires_grad_(True) for p in leaves(params)]
    with torch.enable_grad():
        loss, _ = loss_fn(unflatten(params, flat), batch)
        grads = torch.autograd.grad(loss, flat)
    return loss.detach(), list(grads)


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig,
                    microbatches: int = 1,
                    grad_sync: Callable[[list], list] | None = None,
                    update: Callable | None = None):
    """`grad_sync(grads) -> grads` runs on the flat gradient list before
    the update (data parallelism averages it over the data group there);
    `update(grads, opt_state, params) -> (params, opt_state, metrics)`
    replaces `adamw_update` (ZeRO-1 updates this rank's slices there)."""
    loss_fn = train_loss(cfg)

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, grads = loss_and_grads(loss_fn, params, batch)
        else:
            micro = _split_micro(batch, microbatches)
            gsum = [torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for p in leaves(params)]
            lsum = 0.0
            for m in range(microbatches):
                mb = {k: v[:, m] for k, v in micro.items()}
                loss, g = loss_and_grads(loss_fn, params, mb)
                for a, b in zip(gsum, g):
                    a += b.float()
                lsum = lsum + loss
            grads = [g / microbatches for g in gsum]
            loss = lsum / microbatches
        if grad_sync is not None:
            grads = grad_sync(grads)
        grads = unflatten(params, grads)
        with torch.no_grad():
            if update is None:
                params, opt_state, opt_metrics = adamw_update(
                    opt_cfg, grads, opt_state, params)
            else:
                params, opt_state, opt_metrics = update(grads, opt_state,
                                                        params)
        return params, opt_state, {"loss": loss, **opt_metrics}

    return train_step
