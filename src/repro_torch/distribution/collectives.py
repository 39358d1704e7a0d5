"""The few collectives the distribution layer and the training loop use,
over a process group of `torch.distributed`.

gloo takes CUDA tensors for some collectives only, so on a gloo group a
CUDA tensor goes through a CPU copy (two processes that share one card
cannot use NCCL). A group of None means no process group: a one-rank axis,
whose collectives are the identity.
"""

from __future__ import annotations

import torch


def _staged(x: torch.Tensor, group) -> bool:
    import torch.distributed as dist
    return x.is_cuda and dist.get_backend(group) == "gloo"


def group_size(group) -> int:
    if group is None:
        return 1
    import torch.distributed as dist
    return dist.get_world_size(group)


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The sum (op "sum") or mean (op "mean") of `x` over `group`, as a
    new tensor on x's device."""
    n = group_size(group)
    if n == 1:
        return x.clone()
    import torch.distributed as dist
    buf = x.detach().cpu() if _staged(x, group) else x.detach().clone()
    dist.all_reduce(buf, group=group)
    if op == "mean":
        buf = buf / n
    return buf.to(x.device)


def all_gather_cat(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's `x` of `group`, concatenated on `dim` in rank order."""
    n = group_size(group)
    if n == 1:
        return x
    import torch.distributed as dist
    src = (x.detach().cpu() if _staged(x, group) else x.detach()).contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim).to(x.device)


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """Send `x` to the next rank of `group` and return what the previous
    rank sent (the JAX package's `ppermute` with i -> i + 1 mod n)."""
    n = group_size(group)
    if n == 1:
        return x
    import torch.distributed as dist
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    src = (x.detach().cpu() if _staged(x, group) else x.detach()).contiguous()
    got = torch.empty_like(src)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, src, nxt, group),
        dist.P2POp(dist.irecv, got, prv, group)])
    for r in reqs:
        r.wait()
    return got.to(x.device)
