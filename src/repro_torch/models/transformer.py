"""Model assembly for the dense and hybrid families.

Every family exposes the JAX package's surface:
    init_params(cfg, generator, device) -> params (layers stacked on L)
    prefill_step(cfg)(params, batch, cache) -> (last_logits, cache)
    decode_step(cfg)(params, cache, tokens) -> (logits, cache)
(the last two in `models/serve.py`). Parameters are the JAX package's
nested dict of tensors with the layers stacked on a leading L axis, so the
JAX package's params carry across leaf by leaf (`params_from_numpy`).
Layers run in a Python loop over that axis (the JAX package's `lax.scan`).

Not ported yet: the `moe`, RWKV (`ssm`) and `encdec` families (each
raises `NotImplementedError` naming its ROADMAP.md item), and the training
surface (`train_loss`, `chunked_xent`), which waits for the training port.
"""

from __future__ import annotations

from typing import Any

import torch

from .attention import attend, attn_init, attn_out, qkv_proj
from .config import ModelConfig
from .layers import (embed_apply, embed_init, make_norm, mlp_apply, mlp_init,
                     normal_init)
from .ssm import ssm_apply, ssm_init

Params = Any

_WAITING = {
    "moe": "the moe family waits for its port (ROADMAP.md, queue 1, item 10)",
    "ssm": "the RWKV family (wkv_chunked) waits for its port (ROADMAP.md, "
           "queue 1, item 11)",
    "encdec": "the encdec family waits for its port (ROADMAP.md, queue 1, "
              "item 12)",
}


def check_family(cfg: ModelConfig) -> None:
    """Raise for a family this port does not run yet."""
    if cfg.family in _WAITING:
        raise NotImplementedError(f"{cfg.name}: {_WAITING[cfg.family]}")
    if cfg.family not in ("dense", "hybrid"):
        raise ValueError(cfg.family)


def layer(tree, i: int):
    """Layer `i` of a tree of stacked (L, ...) tensors."""
    return {k: (layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def _stack(trees: list):
    return {k: (_stack([t[k] for t in trees]) if isinstance(v, dict)
                else torch.stack([t[k] for t in trees]))
            for k, v in trees[0].items()}


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
    if kind == "ssm":
        return {"ln1": norm_init(cfg.d_model, dt, device),
                "ssm": ssm_init(generator, cfg, dt, device)}
    raise ValueError(kind)


def _stack_init(generator, cfg: ModelConfig, kind: str, n: int, device):
    return _stack([_block_init(generator, cfg, kind, device)
                   for _ in range(n)])


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
    if cfg.family == "dense":
        p["layers"] = _stack_init(generator, cfg, "dense", cfg.num_layers,
                                  dev)
    else:
        p["layers"] = _stack_init(generator, cfg, "ssm", cfg.num_layers, dev)
        p["shared_attn"] = _block_init(generator, cfg, "dense", dev)
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


def _ssm_block(pl_, x, cfg: ModelConfig):
    _, norm = make_norm(cfg.norm)
    h = norm(pl_["ln1"], x, cfg.norm_eps)
    y, _ = ssm_apply(pl_["ssm"], h, cfg)
    return x + y


def forward_hidden(cfg: ModelConfig, params: Params, x, positions):
    """x (B,S,D) embedded input -> final hidden states (B,S,D), aux loss
    (0 for these families)."""
    check_family(cfg)
    if cfg.family == "dense":
        for i in range(cfg.num_layers):
            x = _dense_block(layer(params["layers"], i), x, cfg, positions,
                             cfg.sliding_window)
        return x, 0.0
    period = max(1, cfg.attn_every)
    for i in range(cfg.num_layers):
        x = _ssm_block(layer(params["layers"], i), x, cfg)
        if i % period == period - 1:
            x = _dense_block(params["shared_attn"], x, cfg, positions, None)
    return x, 0.0


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

