"""GPipe-style pipeline parallelism over a process group.

Layers are split into P contiguous stages, one per rank of a `pipe`
process group; M microbatches stream through the stages with the
canonical (P + M - 1)-step schedule. Each step, every rank applies its
stage to its current microbatch and the activations rotate one stage
forward (send to the next rank, receive from the previous one: the JAX
package's `ppermute`) — the static, compile-time-known communication
pattern of the paper's management core.

Bubble fraction = (P - 1) / (M + P - 1); amortize with M >> P.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..tree import leaves, tree_map
from .collectives import all_reduce, group_size, ring_shift


def pipeline_apply(group, layer_fn: Callable, stage_params, x_micro):
    """Run microbatches through pipeline stages (every rank of `group`
    calls it; None: one rank, one stage).

    layer_fn(params_one_layer, x) -> x        (applied over a stage's
                                               layers in order)
    stage_params: tree with leading dim (P, layers_per_stage, ...); the
                  rank of `group` r applies slice [r].
    x_micro: (M, mb, ...) microbatched input, the same on every rank.
    Returns (M, mb, ...) outputs (as produced by the last stage), on every
    rank: the last stage's outputs summed over the group (the JAX
    package's psum; every other rank contributes zeros).
    """
    import torch.distributed as dist
    Pn = group_size(group)
    rank = 0 if group is None else dist.get_rank(group)
    M = x_micro.shape[0]
    steps = Pn + M - 1
    params = tree_map(lambda a: a[rank], stage_params)
    n_layers = leaves(params)[0].shape[0]

    def stage_apply(h):
        for i in range(n_layers):
            h = layer_fn(tree_map(lambda a: a[i], params), h)
        return h

    buf = torch.zeros(x_micro.shape[1:], dtype=x_micro.dtype,
                      device=x_micro.device)          # current activation
    outs = torch.zeros_like(x_micro)                  # stage-P outputs
    for t in range(steps):
        # stage 0 ingests microbatch t (if in range)
        h = x_micro[min(max(t, 0), M - 1)] if rank == 0 else buf
        y = stage_apply(h) if 0 <= t - rank < M else h
        # last stage emits microbatch (t - P + 1)
        if rank == Pn - 1 and t - Pn + 1 >= 0:
            outs[t - Pn + 1] = y
        # rotate activations one stage forward
        buf = ring_shift(y, group)
    # every rank holds zeros except the last; share results
    return all_reduce(outs, group)


def split_stages(stacked_params, n_stages: int):
    """(L, ...) stacked layer params -> (P, L/P, ...)."""
    def r(a):
        L = a.shape[0]
        if L % n_stages:
            raise ValueError(f"{L} layers not divisible by {n_stages}")
        return a.reshape(n_stages, L // n_stages, *a.shape[1:])
    return tree_map(r, stacked_params)
