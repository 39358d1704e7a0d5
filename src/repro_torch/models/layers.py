"""Elementary layers: norms, MLPs, initializers. Pure functions over nested
dicts of tensors, as in the JAX package (params are plain nested dicts so
the converter from the JAX package's params is a tree map).

On a model axis above 1 the MLP is Megatron's (wi/wg column-parallel, wo
row-parallel) and the embedding is cut over the vocab
(`distribution/tensor_parallel.py`); each is the plain computation when
its weight is whole.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distribution.tensor_parallel import col, cut, model_axis, row


def normal_init(generator: torch.Generator, shape, dtype, scale: float = 0.02,
                device=None):
    """N(0, scale^2) in float32 from `generator`, cast to `dtype`. The
    numbers differ from the JAX package's `jax.random` draws for the same
    seed; tests carry the JAX package's params across instead."""
    device = generator.device if device is None else device
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=device)
    return (w * scale).to(dtype)


# -- norms ---------------------------------------------------------------------

def rmsnorm_init(d, dtype, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x, eps=1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def layernorm_init(d, dtype, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p, x, eps=1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def make_norm(kind: str):
    if kind == "rmsnorm":
        return rmsnorm_init, rmsnorm
    return layernorm_init, layernorm


# -- MLPs ----------------------------------------------------------------------

def mlp_init(generator, d, f, act: str, dtype, device=None):
    if act == "swiglu":
        return {"wi": normal_init(generator, (d, f), dtype, device=device),
                "wg": normal_init(generator, (d, f), dtype, device=device),
                "wo": normal_init(generator, (f, d), dtype, device=device)}
    return {"wi": normal_init(generator, (d, f), dtype, device=device),
            "wo": normal_init(generator, (f, d), dtype, device=device)}


def mlp_apply(p, x, act: str, d_ff: int):
    """The MLP on x; `d_ff` (the whole hidden width) says whether wi/wg
    and wo hold this rank's slices of it."""
    ax = model_axis()
    h = col(x, p["wi"], d_ff, ax)
    if act == "swiglu":
        h = F.silu(h) * col(x, p["wg"], d_ff, ax)
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h, approximate="tanh")
    return row(h, p["wo"], d_ff, ax)


# -- embedding / unembedding ----------------------------------------------------

def embed_init(generator, vocab, d, dtype, device=None):
    return {"table": normal_init(generator, (vocab, d), dtype, device=device)}


def embed_apply(p, tokens, vocab: int):
    """Rows of the table; with the table cut over the vocab (`vocab` is
    the whole size), each rank looks up the tokens of its rows and the
    lookups are summed over `model`."""
    table = p["table"]
    if not cut(table, 0, vocab):
        return table[tokens]
    ax = model_axis()
    ids = tokens - ax.index * table.shape[0]
    mine = (ids >= 0) & (ids < table.shape[0])
    rows = table[torch.where(mine, ids, torch.zeros_like(ids))]
    return ax.reduce(rows * mine[..., None].to(rows.dtype))


def unembed_logits(p_embed, p_head, x, tie: bool):
    """x (..., D) -> logits (..., V)."""
    if tie:
        return x @ p_embed["table"].T
    return x @ p_head["w"]
