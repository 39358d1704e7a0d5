"""Mixture-of-Experts layer (Mixtral 8x top-2, Arctic 128e top-2 + dense
residual), with the JAX package's two dispatch strategies:

  * "onehot" — GShard-style dense dispatch/combine einsums over a
    (tokens, experts, capacity) one-hot: every tensor shape is static;
  * "sorted" — a stable argsort of the (token, k) expert ids into an
    (E, C) slot grid (scatter/gather): the same static shapes, far smaller
    intermediates.

Capacity is per batch row (C from the row's own S tokens), so rows never
couple: a decode step of B rows routes each row's one token as the JAX
package's vmapped batch-1 step does. Overflow tokens are dropped (their
combine weight is 0, so they fall back to the residual path). The router
runs in float32 whatever the model dtype. Plain torch, as the JAX package's
module is plain JAX; the expert products are batched matmuls.

On a model axis above 1 (`distribution/tensor_parallel.py`) the router
stays replicated and the experts are cut as `param_pspec` cuts them:
over their hidden width F (each rank's experts give partial products) or
over the experts (each rank runs its own experts' slots); the combine is
then summed over `model`. Experts cut over data are gathered whole when
the layer starts (`layer_whole`).

Order-sensitive details kept from the JAX package: `top_k` returns ties
lowest expert id first (a stable descending sort here), the slot order
within an expert is a stable argsort, and segment starts are a left
`searchsorted`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distribution.tensor_parallel import cut, model_axis
from .config import ModelConfig
from .layers import normal_init


def moe_init(generator, cfg: ModelConfig, dtype, device=None):
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {"router": normal_init(generator, (D, E), torch.float32,
                                  scale=0.01, device=device),
            "wi": normal_init(generator, (E, D, Fd), dtype, device=device),
            "wg": normal_init(generator, (E, D, Fd), dtype, device=device),
            "wo": normal_init(generator, (E, Fd, D), dtype, device=device)}


def _one_hot(x, n: int):
    """`F.one_hot` as one comparison: the same ops whatever the tensor
    (F.one_hot first checks the ids' range on real tensors only, which
    would make a step's op stream differ from its fake twin's)."""
    return x[..., None] == torch.arange(n, device=x.device)


def _capacity(T: int, cfg: ModelConfig) -> int:
    c = int(T * cfg.top_k / cfg.num_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


def _top_k(probs, k: int):
    """`jax.lax.top_k` on the last axis: the k largest, ties lowest index
    first."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router(p, x, cfg: ModelConfig):
    """x (..., T, D) -> gate probs (..., T, k), expert ids (..., T, k), aux
    losses (...,) (Switch load-balance + 1e-3 router z-loss, per row)."""
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gate, idx = _top_k(probs, cfg.top_k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    E = cfg.num_experts
    me = probs.mean(dim=-2)
    fe = _one_hot(idx[..., 0], E).float().mean(dim=-2)
    aux = E * torch.sum(me * fe, dim=-1)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2, dim=-1)
    return gate, idx, aux + 1e-3 * z


def _expert_mlp(p, xe):
    """xe (B, E, C, D) -> (B, E, C, D), one batched product per expert over
    its B x C slots (einsum folds the batch into the rows: a broadcasting
    `matmul` would copy every expert's weights once per batch row)."""
    h = torch.einsum("becd,edf->becf", xe, p["wi"])
    g = torch.einsum("becd,edf->becf", xe, p["wg"])
    return torch.einsum("becf,efd->becd", F.silu(h) * g, p["wo"])


def moe_apply_onehot(p, x, cfg: ModelConfig):
    """x (T, D) -> (T, D), aux: the one-hot dispatch of one row."""
    y, aux = moe_apply_onehot_batched(p, x[None], cfg)
    return y[0], aux


def moe_apply_onehot_batched(p, x, cfg: ModelConfig):
    """x (B, S, D) -> (B, S, D), mean aux: `moe_apply_onehot` on every
    row (the JAX package's `vmap`)."""
    B, T, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    C = _capacity(T, cfg)
    gate, idx, aux = _router(p, x, cfg)

    # slot assignment: position of each (token, k) within its expert
    flat_e = idx.reshape(B, T * K)
    eo = _one_hot(flat_e, E).to(torch.int32)                 # (B, T*K, E)
    pos = torch.cumsum(eo, dim=1) * eo - 1
    slot = pos.amax(dim=2)                                    # (B, T*K)
    keep = (slot < C) & (slot >= 0)
    disp = (_one_hot(flat_e, E).to(x.dtype)[..., :, None]
            * _one_hot(torch.where(keep, slot, 0), C).to(x.dtype)
            [..., None, :]
            * keep[..., None, None].to(x.dtype))              # (B,T*K,E,C)
    disp = disp.reshape(B, T, K, E, C)
    comb = disp * gate[..., None, None].to(x.dtype)

    xe = torch.einsum("btkec,btd->becd", disp, x)
    ax, e0, e1 = _expert_cut(p, cfg)
    if ax is None:
        ye = _expert_mlp(p, xe)
        y = torch.einsum("btkec,becd->btd", comb, ye)
        return y, aux.mean()
    ye = _expert_mlp(p, ax.enter(xe)[:, e0:e1])
    y = torch.einsum("btkec,becd->btd", ax.enter(comb)[:, :, :, e0:e1], ye)
    return ax.reduce(y), aux.mean()


def _expert_cut(p, cfg: ModelConfig):
    """(model axis, first and end expert of this rank) when the experts
    are cut over `model` (over E, or over F: then every expert, each
    giving a partial product), or (None, 0, E) when they are whole."""
    ax = model_axis()
    E = cfg.num_experts
    wi = p["wi"]
    if not cut(wi, -3, E) and not cut(wi, -1, cfg.d_ff):
        return None, 0, E
    e_loc = wi.shape[-3]
    e0 = ax.index * e_loc if cut(wi, -3, E) else 0
    return ax, e0, e0 + e_loc


def moe_apply_sorted(p, x, cfg: ModelConfig):
    """x (T, D) -> (T, D), aux: the sorted dispatch of one row."""
    y, aux = moe_apply_sorted_batched(p, x[None], cfg)
    return y[0], aux


def moe_apply_sorted_batched(p, x, cfg: ModelConfig):
    """Sorted dispatch, every batch row routing its own S tokens into its
    own (E, C) slot grid; all scatters and gathers index the batch row
    explicitly."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    C = _capacity(S, cfg)
    dev = x.device

    gate, idx, aux = _router(p, x, cfg)
    flat_e = idx.reshape(B, S * K)
    order = torch.argsort(flat_e, dim=1, stable=True)
    se = torch.gather(flat_e, 1, order)                       # (B, S*K)
    tok = order // K
    experts = torch.arange(E, device=dev).expand(B, E).contiguous()
    seg_start = torch.searchsorted(se, experts, right=False)
    slot = torch.arange(S * K, device=dev)[None, :] - torch.gather(
        seg_start, 1, se)
    keep = slot < C
    slot_c = torch.where(keep, slot, torch.zeros_like(slot))

    b_iota = torch.arange(B, device=dev)[:, None].expand(B, S * K)
    xt = torch.gather(x, 1, tok[..., None].expand(B, S * K, D))
    xt = xt * keep[..., None].to(x.dtype)
    buf = torch.zeros((B, E, C, D), dtype=x.dtype, device=dev)
    buf.index_put_((b_iota, se, slot_c), xt, accumulate=True)

    gflat = torch.gather(gate.reshape(B, S * K), 1, order).to(x.dtype)
    ax, e0, e1 = _expert_cut(p, cfg)
    if ax is None:
        ye = _expert_mlp(p, buf)                              # (B, E, C, D)
        yt = ye[b_iota, se, slot_c] * keep[..., None].to(x.dtype)
    else:
        ye = _expert_mlp(p, ax.enter(buf)[:, e0:e1])
        mine = keep & (se >= e0) & (se < e1)
        yt = ye[b_iota, torch.clamp(se - e0, 0, e1 - e0 - 1), slot_c] \
            * mine[..., None].to(x.dtype)
        gflat = ax.enter(gflat)
    y = torch.zeros((B, S, D), dtype=x.dtype, device=dev)
    y.index_put_((b_iota, tok), yt * gflat[..., None], accumulate=True)
    return (y, aux.mean()) if ax is None else (ax.reduce(y), aux.mean())


def moe_apply(p, x, cfg: ModelConfig):
    """x (B, S, D) -> (B, S, D), plus the aux loss. (The JAX package's
    `_dp_constraint`, a batch-dim layout hint for GSPMD, has no
    counterpart: under explicit data parallelism each rank holds only its
    own batch rows.)"""
    if cfg.moe_dispatch == "sorted":
        return moe_apply_sorted_batched(p, x, cfg)
    return moe_apply_onehot_batched(p, x, cfg)
