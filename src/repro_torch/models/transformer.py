"""Model assembly for every architecture family (dense, moe, hybrid, RWKV
`ssm`, encdec).

Every family exposes the JAX package's surface:
    init_params(cfg, generator, device) -> params (layers stacked on L)
    train_loss(cfg)(params, batch) -> (loss, {"xent", "aux"})
    prefill_step(cfg)(params, batch, cache) -> (last_logits, cache)
    decode_step(cfg)(params, cache, tokens) -> (logits, cache)
(the last two in `models/serve.py`). Parameters are the JAX package's
nested dict of tensors with the layers stacked on a leading L axis, so the
JAX package's params carry across leaf by leaf (`params_from_numpy`).
Layers run in a Python loop over that axis (the JAX package's `lax.scan`),
each stacked leaf unbound once per forward, so autograd stacks each leaf's
gradient once. Under autograd `cfg.remat` checkpoints each layer
(`_maybe_remat`).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any

import torch
from torch.utils import checkpoint as _ckpt

from ..distribution.context import current_context, with_mesh_context
from ..distribution.tensor_parallel import (cut, layer_whole, materialize,
                                            model_axis)
from .attention import attend, attn_init, attn_out, local_kv, qkv_proj
from .config import ModelConfig
from .layers import (embed_apply, embed_init, make_norm, mlp_apply, mlp_init,
                     normal_init)
from .moe import moe_apply, moe_init
from .rwkv import rwkv_channel_mix, rwkv_init, rwkv_time_mix
from .ssm import ssm_apply, ssm_init

Params = Any

FAMILIES = ("dense", "moe", "hybrid", "ssm", "encdec")


def check_family(cfg: ModelConfig) -> None:
    """Raise for a family no architecture of this port has."""
    if cfg.family not in FAMILIES:
        raise ValueError(cfg.family)


def layer(tree, i: int):
    """Layer `i` of a tree of stacked (L, ...) tensors."""
    return {k: (layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def layer_of(params, key: str, i: int):
    """Layer `i` of the stacked tree `params[key]`, its data-cut leaves
    gathered whole (`layer_whole`)."""
    return layer_whole(layer(params[key], i), key)


def unstack(tree, n: int) -> list:
    """The `n` layers of a tree of stacked (n, ...) tensors, each leaf
    unbound once (views; under autograd one backward stacks the layers'
    gradients, where indexing would add a full-size gradient per layer)."""
    flat = {k: (unstack(v, n) if isinstance(v, dict) else torch.unbind(v))
            for k, v in tree.items()}
    return [{k: v[i] for k, v in flat.items()} for i in range(n)]


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

_NAME = threading.local()


@contextlib.contextmanager
def checkpoint_name(name: str):
    """Name the values computed inside (the JAX package's
    `checkpoint_name`): the "save_residuals" policy saves what is computed
    under "residual1" and recomputes the rest."""
    prev = getattr(_NAME, "name", None)
    _NAME.name = name
    try:
        yield
    finally:
        _NAME.name = prev


_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default}


def _save_dots(ctx, op, *args, **kwargs):
    """JAX's `checkpoint_dots`: keep matrix products, recompute the rest."""
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _save_residual1(ctx, op, *args, **kwargs):
    """JAX's `save_only_these_names("residual1")`."""
    return (_ckpt.CheckpointPolicy.MUST_SAVE
            if getattr(_NAME, "name", None) == "residual1"
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _maybe_remat(fn, cfg: ModelConfig):
    """`fn` (one layer) under `cfg.remat` when autograd records: "none"
    keeps every activation, "dots" and "save_residuals" keep the matrix
    products or the dense block's post-attention residual and recompute
    the rest in the backward (selective checkpointing), anything else
    ("full") recomputes the whole layer. Without grad mode `fn` runs as
    it is. The recomputation runs in the context of the forward (its mesh
    and layouts: on CUDA autograd recomputes in a thread of its own)."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    mesh, layouts = current_context()
    if mesh is not None:
        inner = fn

        def fn(*a):
            with with_mesh_context(mesh, **layouts):
                return inner(*a)
    policy = {"dots": _save_dots,
              "save_residuals": _save_residual1}.get(cfg.remat)
    if policy is None:
        return lambda *a: _ckpt.checkpoint(fn, *a, use_reentrant=False)
    ctx = lambda: _ckpt.create_selective_checkpoint_contexts(policy)
    return lambda *a: _ckpt.checkpoint(fn, *a, use_reentrant=False,
                                       context_fn=ctx)


def _layer_body(fn, cfg: ModelConfig, key: str = "layers"):
    """`fn(pl_, ...)` over one layer `pl_` of the stacked tree
    `params[key]`, its data-cut leaves gathered inside the layer (under
    remat: in the recomputation again, so only this rank's slices stay
    saved), under `_maybe_remat`."""
    return _maybe_remat(lambda pl_, *a: fn(layer_whole(pl_, key), *a), cfg)


def _dense_block(pl_, x, cfg: ModelConfig, positions, window):
    _, norm = make_norm(cfg.norm)
    h = norm(pl_["ln1"], x, cfg.norm_eps)
    q, k, v = qkv_proj(pl_["attn"], h, cfg, positions)
    o = attend(q, *local_kv(q, k, v, cfg), causal=True, window=window)
    a = attn_out(pl_["attn"], o, cfg)
    # The JAX package pins the residual stream to (dp, None, None) here
    # and below (`constrain_residual`), a layout hint for GSPMD; under
    # explicit data parallelism each rank holds only its own batch rows,
    # so the port has nothing to pin.
    with checkpoint_name("residual1"):
        x = x + a
    h = norm(pl_["ln2"], x, cfg.norm_eps)
    return x + mlp_apply(pl_["mlp"], h, cfg.act, cfg.d_ff)


def _moe_block(pl_, x, cfg: ModelConfig, positions):
    _, norm = make_norm(cfg.norm)
    h = norm(pl_["ln1"], x, cfg.norm_eps)
    q, k, v = qkv_proj(pl_["attn"], h, cfg, positions)
    o = attend(q, *local_kv(q, k, v, cfg), causal=True, window=cfg.sliding_window)
    x = x + attn_out(pl_["attn"], o, cfg)
    h = norm(pl_["ln2"], x, cfg.norm_eps)
    y, aux = moe_apply(pl_["moe"], h, cfg)
    if cfg.dense_residual_ff:
        y = y + mlp_apply(pl_["dense_mlp"], h, cfg.act,
                          cfg.dense_residual_ff)
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
    layers = unstack(params["layers"], cfg.num_layers)
    if cfg.family == "dense":
        body = _layer_body(lambda pl_, h: _dense_block(
            pl_, h, cfg, positions, cfg.sliding_window), cfg)
        for pl_ in layers:
            x = body(pl_, x)
        return x, 0.0
    if cfg.family == "moe":
        body = _layer_body(lambda pl_, h: _moe_block(pl_, h, cfg,
                                                     positions), cfg)
        aux = 0.0
        for pl_ in layers:
            x, a = body(pl_, x)
            aux = aux + a
        return x, aux
    if cfg.family == "ssm":
        body = _layer_body(lambda pl_, h: _rwkv_block(pl_, h, cfg)[0], cfg)
        for pl_ in layers:
            x = body(pl_, x)
        return x, 0.0
    if cfg.family != "hybrid":
        raise ValueError(cfg.family)
    period = max(1, cfg.attn_every)

    def hybrid(pl_, h, shared):
        h = _ssm_block(pl_, h, cfg)
        if shared is not None:
            h = _dense_block(shared, h, cfg, positions, None)
        return h

    body = _layer_body(hybrid, cfg)
    for i, pl_ in enumerate(layers):
        x = body(pl_, x, params["shared_attn"]
                 if i % period == period - 1 else None)
    return x, 0.0


def encode(cfg: ModelConfig, params: Params, x_enc, positions):
    """Bidirectional encoder trunk (encdec family)."""
    _, norm = make_norm(cfg.norm)

    def enc_block(pl_, h):
        z = norm(pl_["ln1"], h, cfg.norm_eps)
        q, k, v = qkv_proj(pl_["attn"], z, cfg, positions)
        o = attend(q, *local_kv(q, k, v, cfg), causal=False)
        h = h + attn_out(pl_["attn"], o, cfg)
        z = norm(pl_["ln2"], h, cfg.norm_eps)
        return h + mlp_apply(pl_["mlp"], z, cfg.act, cfg.d_ff)

    body = _layer_body(enc_block, cfg, "enc_layers")
    for pl_ in unstack(params["enc_layers"], cfg.enc_layers):
        x_enc = body(pl_, x_enc)
    return norm(params["enc_final_norm"], x_enc, cfg.norm_eps)


def decode_trunk(cfg: ModelConfig, params: Params, x_dec, enc_out,
                 positions, enc_positions):
    """Causal decoder with cross-attention (encdec family)."""
    body = _layer_body(lambda pl_, h, enc: _dec_block(
        pl_, h, enc, cfg, positions, enc_positions)[0], cfg, "dec_layers")
    for pl_ in unstack(params["dec_layers"], cfg.dec_layers):
        x_dec = body(pl_, x_dec, enc_out)
    return x_dec


def _dec_block(pl_, h, enc_out, cfg: ModelConfig, positions, enc_positions):
    """One decoder layer over a whole sequence: causal self-attention,
    cross-attention to `enc_out`, MLP. Returns the hidden states and the
    layer's (k, v, kx, vx) for the decode caches."""
    _, norm = make_norm(cfg.norm)
    z = norm(pl_["ln1"], h, cfg.norm_eps)
    q, k, v = qkv_proj(pl_["attn"], z, cfg, positions)
    o = attend(q, *local_kv(q, k, v, cfg), causal=True)
    h = h + attn_out(pl_["attn"], o, cfg)
    z = norm(pl_["lnx"], h, cfg.norm_eps)
    qx, _, _ = qkv_proj(pl_["xattn"], z, cfg, positions)
    _, kx, vx = qkv_proj(pl_["xattn"], enc_out, cfg, enc_positions)
    ox = attend(qx, *local_kv(qx, kx, vx, cfg), causal=False)
    h = h + attn_out(pl_["xattn"], ox, cfg)
    z = norm(pl_["ln2"], h, cfg.norm_eps)
    return h + mlp_apply(pl_["mlp"], z, cfg.act, cfg.d_ff), (k, v, kx, vx)


def _unembed_weight(cfg: ModelConfig, params: Params):
    if cfg.tie_embeddings:
        return params["embed"]["table"].T
    return params["lm_head"]["w"]


def chunked_xent(cfg: ModelConfig, params: Params, hidden, labels,
                 chunk: int = 512):
    """Cross-entropy over the vocab without materializing (B, S, V)
    logits: the sequence in chunks of `chunk` positions (the last padded,
    its labels -1), logits in f32 per chunk, the mean over labels >= 0.
    With the unembedding cut over the vocab on `model`, each rank holds
    its columns of the logits: their maximum, the sum of their exps and
    the label's logit are reduced over the model group."""
    B, S, D = hidden.shape
    W = _unembed_weight(cfg, params)
    ax = model_axis()
    v_loc = W.shape[-1]
    vcut = cut(W, -1, cfg.vocab_size)
    if vcut:
        hidden = ax.enter(hidden)
    c = min(chunk, S)
    tot = cnt = 0.0
    for s0 in range(0, S, c):
        h = hidden[:, s0:s0 + c]
        lab = labels[:, s0:s0 + c]
        logits = (h @ W).float()                                # (B,c,V)
        if not vcut:
            logz = torch.logsumexp(logits, dim=-1)
            ll = torch.gather(logits, -1, torch.clamp(
                lab, min=0)[..., None].long())[..., 0]
        else:
            m = ax.all_reduce(logits.detach().amax(-1, keepdim=True), "max")
            logz = m[..., 0] + torch.log(ax.reduce(
                torch.exp(logits - m).sum(-1)))
            ids = lab.long() - ax.index * v_loc
            mine = (ids >= 0) & (ids < v_loc)
            ll = ax.reduce(torch.gather(logits, -1, torch.where(
                mine, ids, torch.zeros_like(ids))[..., None])[..., 0]
                * mine.float())
        valid = (lab >= 0).float()
        tot = tot + torch.sum((logz - ll) * valid)
        cnt = cnt + valid.sum()
    return tot / torch.clamp(cnt, min=1.0)


def _embed_with_frontend(cfg: ModelConfig, params: Params, batch):
    x = embed_apply(params["embed"], batch["tokens"], cfg.vocab_size)
    if cfg.frontend is not None and "frontend_embeds" in batch:
        fe = batch["frontend_embeds"].to(x.dtype)
        x = torch.cat([fe, x[:, fe.shape[1]:]], dim=1)
    return x


def train_loss(cfg: ModelConfig):
    """Returns loss_fn(params, batch) -> (loss, {"xent", "aux"}): the
    vocab-chunked cross-entropy of the final hidden states plus 0.01 x the
    moe routers' aux loss (0 for the other families)."""
    check_family(cfg)

    def loss_fn(params, batch):
        params = materialize(params)
        tokens = batch["tokens"]
        labels = batch["labels"]
        B, S = tokens.shape
        dev = tokens.device
        positions = torch.arange(S, device=dev)
        if cfg.family == "encdec":
            src = batch["src_tokens"]
            x_enc = embed_apply(params["embed"], src, cfg.vocab_size)
            if cfg.frontend is not None and "frontend_embeds" in batch:
                fe = batch["frontend_embeds"].to(x_enc.dtype)
                x_enc = torch.cat([fe, x_enc[:, fe.shape[1]:]], dim=1)
            enc_pos = torch.arange(src.shape[1], device=dev)
            enc_out = encode(cfg, params, x_enc, enc_pos)
            x = embed_apply(params["embed"], tokens, cfg.vocab_size)
            h = decode_trunk(cfg, params, x, enc_out, positions, enc_pos)
            aux = 0.0
        else:
            x = _embed_with_frontend(cfg, params, batch)
            h, aux = forward_hidden(cfg, params, x, positions)
        _, norm = make_norm(cfg.norm)
        h = norm(params["final_norm"], h, cfg.norm_eps)
        xent = chunked_xent(cfg, params, h, labels)
        loss = xent + 0.01 * aux
        return loss, {"xent": xent, "aux": aux}

    return loss_fn
