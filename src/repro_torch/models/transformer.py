"""Model assembly for every architecture family (dense, moe, hybrid, RWKV
`ssm`, encdec).

Every family exposes the JAX package's surface:
    init_params(cfg, generator, device) -> params (layers stacked on L)
    prefill_step(cfg)(params, batch, cache) -> (last_logits, cache)
    decode_step(cfg)(params, cache, tokens) -> (logits, cache)
(the last two in `models/serve.py`). Parameters are the JAX package's
nested dict of tensors with the layers stacked on a leading L axis, so the
JAX package's params carry across leaf by leaf (`params_from_numpy`).
Layers run in a Python loop over that axis (the JAX package's `lax.scan`).

Not ported yet: the training surface (`train_loss`, `chunked_xent`), which
raises `NotImplementedError` naming its ROADMAP.md item.
"""

from __future__ import annotations

from typing import Any

import torch

from .attention import attend, attn_init, attn_out, qkv_proj
from .config import ModelConfig
from .layers import (embed_apply, embed_init, make_norm, mlp_apply, mlp_init,
                     normal_init)
from .moe import moe_apply, moe_init
from .rwkv import rwkv_channel_mix, rwkv_init, rwkv_time_mix
from .ssm import ssm_apply, ssm_init

Params = Any

FAMILIES = ("dense", "moe", "hybrid", "ssm", "encdec")
_TRAINING = ("training (train_loss, chunked_xent) waits for its port "
             "(ROADMAP.md, queue 1, item 15)")


def check_family(cfg: ModelConfig) -> None:
    """Raise for a family no architecture of this port has."""
    if cfg.family not in FAMILIES:
        raise ValueError(cfg.family)


def layer(tree, i: int):
    """Layer `i` of a tree of stacked (L, ...) tensors."""
    return {k: (layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def _slabs(tree, n: int):
    """Empty (n, ...) tensors shaped like the leaves of `tree`."""
    return {k: (_slabs(v, n) if isinstance(v, dict) else
                torch.empty((n,) + tuple(v.shape), dtype=v.dtype,
                            device=v.device))
            for k, v in tree.items()}


def _put(slabs, tree, i: int) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            _put(slabs[k], v, i)
        else:
            slabs[k][i] = v


# -- per-family layer definitions ---------------------------------------------

def _block_init(generator, cfg: ModelConfig, kind: str, device=None):
    dt = cfg.torch_dtype
    norm_init, _ = make_norm(cfg.norm)
    if kind == "dense":
        return {"ln1": norm_init(cfg.d_model, dt, device),
                "attn": attn_init(generator, cfg, dt, device),
                "ln2": norm_init(cfg.d_model, dt, device),
                "mlp": mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.act, dt,
                                device)}
    if kind == "moe":
        p = {"ln1": norm_init(cfg.d_model, dt, device),
             "attn": attn_init(generator, cfg, dt, device),
             "ln2": norm_init(cfg.d_model, dt, device),
             "moe": moe_init(generator, cfg, dt, device)}
        if cfg.dense_residual_ff:
            p["dense_mlp"] = mlp_init(generator, cfg.d_model,
                                      cfg.dense_residual_ff, cfg.act, dt,
                                      device)
        return p
    if kind == "ssm":
        return {"ln1": norm_init(cfg.d_model, dt, device),
                "ssm": ssm_init(generator, cfg, dt, device)}
    if kind == "rwkv":
        return {"ln1": norm_init(cfg.d_model, dt, device),
                "ln2": norm_init(cfg.d_model, dt, device),
                "mix": rwkv_init(generator, cfg, dt, device)}
    if kind == "enc":
        return _block_init(generator, cfg, "dense", device)
    if kind == "dec":
        return {"ln1": norm_init(cfg.d_model, dt, device),
                "attn": attn_init(generator, cfg, dt, device),
                "lnx": norm_init(cfg.d_model, dt, device),
                "xattn": attn_init(generator, cfg, dt, device),
                "ln2": norm_init(cfg.d_model, dt, device),
                "mlp": mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.act, dt,
                                device)}
    raise ValueError(kind)


def _stack_init(generator, cfg: ModelConfig, kind: str, n: int, device):
    """`n` blocks stacked on a leading axis, drawn one at a time into
    preallocated slabs: the peak is the stack plus one block (8 layers of
    mixtral-8x22b in bf16 are 41 GB)."""
    block = _block_init(generator, cfg, kind, device)
    slabs = _slabs(block, n)
    for i in range(n):
        if i:
            block = _block_init(generator, cfg, kind, device)
        _put(slabs, block, i)
    return slabs


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device="cuda") -> Params:
    """Random parameters, drawn from `generator` (default: a generator on
    `device` seeded with 0) on `device` ("cuda" by default; "cpu" on
    request). The draws differ from the JAX package's for the same seed;
    tests carry the JAX package's own params across instead."""
    check_family(cfg)
    from ..core.compiled import resolve_device
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    dt = cfg.torch_dtype
    norm_init, _ = make_norm(cfg.norm)
    p: dict = {"embed": embed_init(generator, cfg.vocab_size, cfg.d_model,
                                   dt, dev),
               "final_norm": norm_init(cfg.d_model, dt, dev)}
    if not cfg.tie_embeddings:
        p["lm_head"] = {"w": normal_init(generator, (cfg.d_model,
                                                     cfg.vocab_size), dt,
                                         device=dev)}
    if cfg.family == "hybrid":
        p["layers"] = _stack_init(generator, cfg, "ssm", cfg.num_layers, dev)
        p["shared_attn"] = _block_init(generator, cfg, "dense", dev)
    elif cfg.family == "encdec":
        p["enc_layers"] = _stack_init(generator, cfg, "enc", cfg.enc_layers,
                                      dev)
        p["dec_layers"] = _stack_init(generator, cfg, "dec", cfg.dec_layers,
                                      dev)
        p["enc_final_norm"] = norm_init(cfg.d_model, dt, dev)
    else:
        kind = {"dense": "dense", "moe": "moe", "ssm": "rwkv"}[cfg.family]
        p["layers"] = _stack_init(generator, cfg, kind, cfg.num_layers, dev)
    return p


# -- block application ----------------------------------------------------------

def _dense_block(pl_, x, cfg: ModelConfig, positions, window):
    _, norm = make_norm(cfg.norm)
    h = norm(pl_["ln1"], x, cfg.norm_eps)
    q, k, v = qkv_proj(pl_["attn"], h, cfg, positions)
    o = attend(q, k, v, causal=True, window=window)
    x = x + attn_out(pl_["attn"], o, cfg)
    h = norm(pl_["ln2"], x, cfg.norm_eps)
    return x + mlp_apply(pl_["mlp"], h, cfg.act)


def _moe_block(pl_, x, cfg: ModelConfig, positions):
    _, norm = make_norm(cfg.norm)
    h = norm(pl_["ln1"], x, cfg.norm_eps)
    q, k, v = qkv_proj(pl_["attn"], h, cfg, positions)
    o = attend(q, k, v, causal=True, window=cfg.sliding_window)
    x = x + attn_out(pl_["attn"], o, cfg)
    h = norm(pl_["ln2"], x, cfg.norm_eps)
    y, aux = moe_apply(pl_["moe"], h, cfg)
    if cfg.dense_residual_ff:
        y = y + mlp_apply(pl_["dense_mlp"], h, cfg.act)
    return x + y, aux


def _rwkv_block(pl_, x, cfg: ModelConfig, state=None, last_tm=None,
                last_cm=None):
    """One RWKV layer, from a carried WKV state and last tokens if given.
    Returns the hidden states and the layer's (state, last_tm, last_cm)."""
    _, norm = make_norm(cfg.norm)
    h = norm(pl_["ln1"], x, cfg.norm_eps)
    y, (s_fin, last_tm) = rwkv_time_mix(pl_["mix"], h, cfg, state=state,
                                        last=last_tm)
    x = x + y
    h = norm(pl_["ln2"], x, cfg.norm_eps)
    y, last_cm = rwkv_channel_mix(pl_["mix"], h, cfg, last=last_cm)
    return x + y, (s_fin, last_tm, last_cm)


def _ssm_block(pl_, x, cfg: ModelConfig):
    _, norm = make_norm(cfg.norm)
    h = norm(pl_["ln1"], x, cfg.norm_eps)
    y, _ = ssm_apply(pl_["ssm"], h, cfg)
    return x + y


def forward_hidden(cfg: ModelConfig, params: Params, x, positions):
    """x (B,S,D) embedded input -> final hidden states (B,S,D), aux loss
    (the routers' summed over layers for moe, 0 otherwise). The decoder-only
    families; encdec runs `encode` and `decode_trunk`."""
    check_family(cfg)
    if cfg.family == "dense":
        for i in range(cfg.num_layers):
            x = _dense_block(layer(params["layers"], i), x, cfg, positions,
                             cfg.sliding_window)
        return x, 0.0
    if cfg.family == "moe":
        aux = 0.0
        for i in range(cfg.num_layers):
            x, a = _moe_block(layer(params["layers"], i), x, cfg, positions)
            aux = aux + a
        return x, aux
    if cfg.family == "ssm":
        for i in range(cfg.num_layers):
            x, _ = _rwkv_block(layer(params["layers"], i), x, cfg)
        return x, 0.0
    if cfg.family != "hybrid":
        raise ValueError(cfg.family)
    period = max(1, cfg.attn_every)
    for i in range(cfg.num_layers):
        x = _ssm_block(layer(params["layers"], i), x, cfg)
        if i % period == period - 1:
            x = _dense_block(params["shared_attn"], x, cfg, positions, None)
    return x, 0.0


def encode(cfg: ModelConfig, params: Params, x_enc, positions):
    """Bidirectional encoder trunk (encdec family)."""
    _, norm = make_norm(cfg.norm)
    for i in range(cfg.enc_layers):
        pl_ = layer(params["enc_layers"], i)
        z = norm(pl_["ln1"], x_enc, cfg.norm_eps)
        q, k, v = qkv_proj(pl_["attn"], z, cfg, positions)
        o = attend(q, k, v, causal=False)
        x_enc = x_enc + attn_out(pl_["attn"], o, cfg)
        z = norm(pl_["ln2"], x_enc, cfg.norm_eps)
        x_enc = x_enc + mlp_apply(pl_["mlp"], z, cfg.act)
    return norm(params["enc_final_norm"], x_enc, cfg.norm_eps)


def decode_trunk(cfg: ModelConfig, params: Params, x_dec, enc_out,
                 positions, enc_positions):
    """Causal decoder with cross-attention (encdec family)."""
    for i in range(cfg.dec_layers):
        pl_ = layer(params["dec_layers"], i)
        x_dec, _ = _dec_block(pl_, x_dec, enc_out, cfg, positions,
                              enc_positions)
    return x_dec


def _dec_block(pl_, h, enc_out, cfg: ModelConfig, positions, enc_positions):
    """One decoder layer over a whole sequence: causal self-attention,
    cross-attention to `enc_out`, MLP. Returns the hidden states and the
    layer's (k, v, kx, vx) for the decode caches."""
    _, norm = make_norm(cfg.norm)
    z = norm(pl_["ln1"], h, cfg.norm_eps)
    q, k, v = qkv_proj(pl_["attn"], z, cfg, positions)
    o = attend(q, k, v, causal=True)
    h = h + attn_out(pl_["attn"], o, cfg)
    z = norm(pl_["lnx"], h, cfg.norm_eps)
    qx, _, _ = qkv_proj(pl_["xattn"], z, cfg, positions)
    _, kx, vx = qkv_proj(pl_["xattn"], enc_out, cfg, enc_positions)
    ox = attend(qx, kx, vx, causal=False)
    h = h + attn_out(pl_["xattn"], ox, cfg)
    z = norm(pl_["ln2"], h, cfg.norm_eps)
    return h + mlp_apply(pl_["mlp"], z, cfg.act), (k, v, kx, vx)


def train_loss(cfg: ModelConfig):
    """The JAX package's training loss: not ported yet."""
    raise NotImplementedError(f"{cfg.name}: {_TRAINING}")


def chunked_xent(cfg: ModelConfig, params: Params, hidden, labels,
                 chunk: int = 512):
    """The JAX package's vocab-chunked cross-entropy: not ported yet."""
    raise NotImplementedError(f"{cfg.name}: {_TRAINING}")


def _unembed_weight(cfg: ModelConfig, params: Params):
    if cfg.tie_embeddings:
        return params["embed"]["table"].T
    return params["lm_head"]["w"]


def _embed_with_frontend(cfg: ModelConfig, params: Params, batch):
    x = embed_apply(params["embed"], batch["tokens"])
    if cfg.frontend is not None and "frontend_embeds" in batch:
        fe = batch["frontend_embeds"].to(x.dtype)
        x = torch.cat([fe, x[:, fe.shape[1]:]], dim=1)
    return x

