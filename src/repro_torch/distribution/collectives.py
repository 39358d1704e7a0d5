"""The few collectives the distribution layer, the tensor-parallel layers
and the training loop use, over a process group of `torch.distributed`.

gloo takes CUDA tensors for some collectives only, so on a gloo group a
CUDA tensor goes through a CPU copy (two processes that share one card
cannot use NCCL). A group of None means no process group: a one-rank axis,
whose collectives are the identity.

The functions are plain (no autograd). The Megatron-style operators at the
end are their autograd twins, for a value every rank of `group` computes
alike (replicated) around a product whose weight is cut over the group:

  * `enter`      identity forward, all-reduce backward (the input of a
                 column-parallel product: each rank's part of the gradient
                 is summed);
  * `reduce`     all-reduce forward, identity backward (the output of a
                 row-parallel product);
  * `gather`     all-gather forward, own slice backward;
  * `split`      own slice forward, all-gather backward (a replicated
                 tensor or param used on this rank's slice only);
  * `gather_rs`  all-gather forward, reduce-scatter backward (a param cut
                 over data, gathered where it is used: the gradient of the
                 whole leaf is summed over the data ranks and each keeps
                 its slice).
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
    """The sum (op "sum"), mean (op "mean") or maximum (op "max") of `x`
    over `group`, as a new tensor on x's device."""
    n = group_size(group)
    if n == 1:
        return x.clone()
    import torch.distributed as dist
    buf = x.detach().cpu() if _staged(x, group) else x.detach().clone()
    dist.all_reduce(buf, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=group)
    if op == "mean":
        buf = buf / n
    return buf.to(x.device)


def all_gather_cat(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's `x` of `group`, concatenated on `dim` in rank order."""
    n = group_size(group)
    if n == 1:
        return x
    import torch.distributed as dist
    src = (x.detach().cpu() if _staged(x, group) else x.detach())
    src = src.movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous().to(x.device)


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


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum of `x` over `group`, cut on `dim` into as many slices as the
    group has ranks: this rank's slice."""
    n = group_size(group)
    if n == 1:
        return x.clone()
    import torch.distributed as dist
    src = (x.detach().cpu() if _staged(x, group) else x.detach())
    src = src.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous().to(x.device)


def all_to_all(x: torch.Tensor, split_dim: int, cat_dim: int,
               group) -> torch.Tensor:
    """`x` cut on `split_dim` into as many pieces as `group` has ranks,
    piece j sent to rank j; the pieces this rank receives, concatenated
    on `cat_dim` in rank order (a re-cut: `cat_dim` was cut over the
    group, `split_dim` is now)."""
    n = group_size(group)
    if n == 1:
        return x
    import torch.distributed as dist
    src = (x.detach().cpu() if _staged(x, group) else x.detach())
    k = src.shape[split_dim] // n
    send = src.unflatten(split_dim, (n, k)).movedim(split_dim, 0) \
        .contiguous()
    got = torch.empty_like(send)
    dist.all_to_all_single(got, send, group=group)
    return torch.cat(got.unbind(0), dim=cat_dim).to(x.device)


def group_rank(group) -> int:
    if group is None:
        return 0
    import torch.distributed as dist
    return dist.get_rank(group)


def _slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = group_size(group)
    k = x.shape[dim] // n
    return x.narrow(dim, group_rank(group) * k, k)


# -- autograd operators ------------------------------------------------------

class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.dim, ctx.group).contiguous(), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _slice(x, dim, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, ctx.dim, ctx.group), None, None


class _GatherRS(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.group), None, None


def enter(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _Enter.apply(x, group)


def reduce(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _Reduce.apply(x, group)


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _Gather.apply(x, dim, group)


def split(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _Split.apply(x, dim, group)


def gather_rs(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _GatherRS.apply(x, dim, group)
