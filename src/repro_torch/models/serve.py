"""Serving paths: prefill (fill KV/state caches, return last-token logits)
and decode (one token against a fixed-size cache) for every family.

Caches are the JAX package's: stacked on the layer dim, with a fixed
`max_len`, so a decode step has static shapes (the property the paper's
static scheduling requires; `repro_torch.core` computes WCET bounds for
exactly this step). The hybrid family runs in groups of `attn_every`
Mamba2 layers plus one application of the shared attention block, whose
KV cache has one slab per application, then the tail of
`num_layers % attn_every` Mamba2 layers. The moe family shares the dense
family's attention and caches (the int8 KV cache included), with the
routed experts in place of the MLP. The RWKV family (`ssm`) keeps a float32
WKV state and the last token of each mix per layer. The encdec family
encodes `batch["src_tokens"]` at prefill and keeps each decoder layer's
cross-attention keys and values (`xk`, `xv`, of length `enc_len`) beside
its self-attention cache.

Per-row positions: `cache["pos"]` is a scalar (every row at one position,
as after `prefill_step`) or a `(B,)` tensor (continuous batching, each
slot at its own position). The decode step batches natively over rows
where the JAX package vmaps a batch-1 step: RoPE angles, the cache write
and the attention mask are per row. A write index past the cache is
clamped to `max_len - 1`, as `jax.lax.dynamic_update_slice` clamps its
start index (an idle slot's position keeps growing). Steps are functional:
the caller's cache is not modified.

On a mesh (`with_mesh_context(mesh, params=..., cache=...)`) each rank
runs on its slices of the params and of the cache as `param_shardings`
and `cache_shardings` cut them; a cache whose positions are cut over
ranks (kv heads that do not divide over `model`) is written by the rank
that holds the position and attended with the softmax reduced over the
cut (the float cache, the int8 cache with its scales); encdec's
cross-attention keys and values cut on positions are gathered whole for
K4, as GSPMD gathers a kernel's operands.
"""

from __future__ import annotations

import torch

from .attention import (attn_out, attend, decode_attend, decode_attend_cut,
                        decode_attend_int8, decode_attend_int8_cut, local_kv,
                        qkv_proj, quantize_kv)
from ..distribution.tensor_parallel import (cache_seq_axis, col_whole,
                                            materialize, model_axis)
from .config import ModelConfig
from .layers import embed_apply, make_norm, mlp_apply
from .moe import moe_apply
from .ssm import ssm_apply
from .transformer import (_dec_block, _embed_with_frontend, _rwkv_block,
                          _unembed_weight, check_family, encode, layer_of)


def _hybrid_groups(cfg: ModelConfig) -> tuple[int, int, int]:
    period = max(1, cfg.attn_every)
    return period, cfg.num_layers // period, cfg.num_layers % period


# -- cache construction ----------------------------------------------------------

def cache_spec(cfg: ModelConfig, batch: int, max_len: int,
               enc_len: int = 0) -> dict:
    """{leaf: (shape, dtype)} of the decode cache."""
    check_family(cfg)
    dt = cfg.torch_dtype
    L, Hkv, hd, D = cfg.num_layers, cfg.num_kv_heads, cfg.hd, cfg.d_model
    if cfg.family in ("dense", "moe"):
        if cfg.kv_cache_dtype == "int8":
            return {"k": ((L, batch, Hkv, max_len, hd), torch.int8),
                    "v": ((L, batch, Hkv, max_len, hd), torch.int8),
                    "k_scale": ((L, batch, Hkv, max_len), torch.float32),
                    "v_scale": ((L, batch, Hkv, max_len), torch.float32),
                    "pos": ((), torch.int32)}
        return {"k": ((L, batch, Hkv, max_len, hd), dt),
                "v": ((L, batch, Hkv, max_len, hd), dt),
                "pos": ((), torch.int32)}
    if cfg.family == "ssm":
        H = cfg.num_heads if cfg.num_heads > 0 else D // 64
        dk = D // H
        return {"wkv": ((L, batch, H, dk, dk), torch.float32),
                "last_tm": ((L, batch, 1, D), dt),
                "last_cm": ((L, batch, 1, D), dt),
                "pos": ((), torch.int32)}
    if cfg.family == "encdec":
        Ld = cfg.dec_layers
        return {"k": ((Ld, batch, Hkv, max_len, hd), dt),
                "v": ((Ld, batch, Hkv, max_len, hd), dt),
                "xk": ((Ld, batch, Hkv, enc_len, hd), dt),
                "xv": ((Ld, batch, Hkv, enc_len, hd), dt),
                "pos": ((), torch.int32)}
    Din, N = 2 * D, cfg.ssm_state
    _, napp, _ = _hybrid_groups(cfg)
    return {"ssm_state": ((L, batch, Din, N), torch.float32),
            "conv": ((L, batch, cfg.ssm_conv - 1, Din), dt),
            "k": ((max(1, napp), batch, Hkv, max_len, hd), dt),
            "v": ((max(1, napp), batch, Hkv, max_len, hd), dt),
            "pos": ((), torch.int32)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               enc_len: int = 0, device="cuda") -> dict:
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in cache_spec(cfg, batch, max_len,
                                              enc_len).items()}


def _last_logits(cfg, params, h):
    _, norm = make_norm(cfg.norm)
    h = norm(params["final_norm"], h[:, -1:], cfg.norm_eps)
    return col_whole(h, _unembed_weight(cfg, params), cfg.vocab_size,
                     model_axis()).float()


def _place(cache_slab, fresh, name="k"):
    """Write the S prefilled positions into a (possibly longer) slab: the
    position axis is dim 3 of the (L, B, H, max_len[, hd]) slabs. When
    the cache layout cuts the positions of leaf `name` over ranks, this
    rank's slab holds positions [i * n, (i + 1) * n) of the whole."""
    out = cache_slab.clone()
    n = cache_slab.shape[3]
    lo = cache_seq_axis(name).index * n
    part = fresh[:, :, :, lo:lo + n]
    out[:, :, :, :part.shape[3]] = part.to(cache_slab.dtype)
    return out


def _positions(fresh, name):
    """This rank's positions (dim 3) of a whole cache leaf `name`."""
    return cache_seq_axis(name).local(fresh, 3)


def _rwkv_cache(states, pos, dt) -> dict:
    """The RWKV cache from each layer's (WKV state, last_tm, last_cm)."""
    wkv, ltm, lcm = zip(*states)
    return {"wkv": torch.stack(wkv),
            "last_tm": torch.stack(ltm).to(dt),
            "last_cm": torch.stack(lcm).to(dt), "pos": pos}


def _ffn(cfg: ModelConfig, pl_, h):
    """The second half of a dense or moe layer: norm, then the MLP or the
    routed experts (plus arctic's always-on dense MLP)."""
    _, norm = make_norm(cfg.norm)
    z = norm(pl_["ln2"], h, cfg.norm_eps)
    if cfg.family == "dense":
        return h + mlp_apply(pl_["mlp"], z, cfg.act, cfg.d_ff)
    y, _ = moe_apply(pl_["moe"], z, cfg)
    if cfg.dense_residual_ff:
        y = y + mlp_apply(pl_["dense_mlp"], z, cfg.act,
                          cfg.dense_residual_ff)
    return h + y


# -- prefill ----------------------------------------------------------------------

def prefill_step(cfg: ModelConfig):
    """(params, batch, cache) -> (last_logits (B,1,V) f32, filled cache)."""
    check_family(cfg)
    _, norm = make_norm(cfg.norm)
    dt = cfg.torch_dtype

    def fn(params, batch, cache):
        params = materialize(params)
        tokens = batch["tokens"]
        B, S = tokens.shape
        positions = torch.arange(S, device=tokens.device)
        pos = torch.tensor(S - 1, dtype=torch.int32, device=tokens.device)

        if cfg.family in ("dense", "moe"):
            x = _embed_with_frontend(cfg, params, batch)
            ks, vs = [], []
            for i in range(cfg.num_layers):
                pl_ = layer_of(params, "layers", i)
                z = norm(pl_["ln1"], x, cfg.norm_eps)
                q, k, v = qkv_proj(pl_["attn"], z, cfg, positions)
                o = attend(q, *local_kv(q, k, v, cfg), causal=True,
                           window=cfg.sliding_window)
                x = x + attn_out(pl_["attn"], o, cfg)
                x = _ffn(cfg, pl_, x)
                ks.append(k)
                vs.append(v)
            k_all, v_all = torch.stack(ks), torch.stack(vs)
            if cfg.kv_cache_dtype == "int8":
                kq, ksc = quantize_kv(k_all)
                vq, vsc = quantize_kv(v_all)
                new_cache = {"k": _place(cache["k"], kq),
                             "v": _place(cache["v"], vq, "v"),
                             "k_scale": _place(cache["k_scale"], ksc,
                                               "k_scale"),
                             "v_scale": _place(cache["v_scale"], vsc,
                                               "v_scale"),
                             "pos": pos}
            else:
                new_cache = {"k": _place(cache["k"], k_all.to(dt)),
                             "v": _place(cache["v"], v_all.to(dt), "v"),
                             "pos": pos}
            return _last_logits(cfg, params, x), new_cache

        if cfg.family == "ssm":
            x = embed_apply(params["embed"], tokens, cfg.vocab_size)
            states = []
            for i in range(cfg.num_layers):
                x, st = _rwkv_block(layer_of(params, "layers", i), x, cfg)
                states.append(st)
            return _last_logits(cfg, params, x), _rwkv_cache(states, pos, dt)

        if cfg.family == "encdec":
            src = batch["src_tokens"]
            x_enc = embed_apply(params["embed"], src, cfg.vocab_size)
            if cfg.frontend is not None and "frontend_embeds" in batch:
                fe = batch["frontend_embeds"].to(x_enc.dtype)
                x_enc = torch.cat([fe, x_enc[:, fe.shape[1]:]], dim=1)
            enc_pos = torch.arange(src.shape[1], device=src.device)
            enc_out = encode(cfg, params, x_enc, enc_pos)
            x = embed_apply(params["embed"], tokens, cfg.vocab_size)
            ks, vs, kxs, vxs = [], [], [], []
            for i in range(cfg.dec_layers):
                x, (k, v, kx, vx) = _dec_block(
                    layer_of(params, "dec_layers", i), x, enc_out, cfg,
                    positions, enc_pos)
                ks.append(k.to(dt))
                vs.append(v.to(dt))
                kxs.append(kx.to(dt))
                vxs.append(vx.to(dt))
            new_cache = {"k": _place(cache["k"], torch.stack(ks)),
                         "v": _place(cache["v"], torch.stack(vs), "v"),
                         "xk": _positions(torch.stack(kxs), "xk"),
                         "xv": _positions(torch.stack(vxs), "xv"),
                         "pos": pos}
            return _last_logits(cfg, params, x), new_cache

        x = embed_apply(params["embed"], tokens, cfg.vocab_size)
        shared = params["shared_attn"]
        period, G, R = _hybrid_groups(cfg)
        st, cc, ks, vs = [], [], [], []

        def ssm_once(h, i):
            pl_ = layer_of(params, "layers", i)
            z = norm(pl_["ln1"], h, cfg.norm_eps)
            y, (s_new, c_new) = ssm_apply(pl_["ssm"], z, cfg)
            st.append(s_new)
            cc.append(c_new.to(dt))
            return h + y

        for grp in range(G):
            for i in range(grp * period, (grp + 1) * period):
                x = ssm_once(x, i)
            z = norm(shared["ln1"], x, cfg.norm_eps)
            q, k, v = qkv_proj(shared["attn"], z, cfg, positions)
            o = attend(q, *local_kv(q, k, v, cfg), causal=True)
            x = x + attn_out(shared["attn"], o, cfg)
            z = norm(shared["ln2"], x, cfg.norm_eps)
            x = x + mlp_apply(shared["mlp"], z, cfg.act, cfg.d_ff)
            ks.append(k.to(dt))
            vs.append(v.to(dt))
        for i in range(G * period, G * period + R):
            x = ssm_once(x, i)
        new_cache = {"ssm_state": torch.stack(st), "conv": torch.stack(cc),
                     "k": _place(cache["k"], torch.stack(ks)) if ks
                     else cache["k"].clone(),
                     "v": _place(cache["v"], torch.stack(vs), "v") if vs
                     else cache["v"].clone(),
                     "pos": pos}
        return _last_logits(cfg, params, x), new_cache

    return fn


# -- decode -----------------------------------------------------------------------

def _write_rows(slab, fresh, idx, seq=None):
    """slab (B, H, Smax, ...) with row b's position idx[b] set to fresh
    (B, H, ...), in place (the slab is the step's own copy). A slab of a
    cache whose positions are cut over `seq` holds positions [i * Smax,
    (i + 1) * Smax): it takes the rows whose position falls there."""
    B, n = slab.shape[0], slab.shape[2]
    rows = torch.arange(B, device=slab.device)
    if seq is None or seq.n == 1:
        slab[rows, :, idx] = fresh.to(slab.dtype)
        return
    j = idx - seq.index * n
    mine = (j >= 0) & (j < n)
    j = torch.clamp(j, 0, n - 1)
    keep = slab[rows, :, j]
    mine = mine.reshape((B,) + (1,) * (keep.dim() - 1))
    slab[rows, :, j] = torch.where(mine, fresh.to(slab.dtype), keep)


def _heads(q, seq, cfg: ModelConfig, *pairs):
    """The q heads and (k, v)-like pairs of cache slabs that this rank
    attends: over a cache whose positions are cut over `seq`, all q heads
    (gathered when cut) against its own slabs; else its q heads against
    their kv heads of each pair (`local_kv`)."""
    if seq.n > 1:
        if q.shape[1] != cfg.num_heads:
            q = model_axis().gather(q, 1)
        return q, [x for pair in pairs for x in pair]
    return q, [x for pair in pairs for x in local_kv(q, *pair, cfg)]


def decode_step(cfg: ModelConfig):
    """(params, cache, tokens (B,1)) -> (logits (B,1,V) f32, cache).

    Each row's new token sits at cache["pos"] + 1 (scalar or per row).

    On a mesh it serves every layout that `cache_shardings` gives the
    caches: float and int8 KV caches (with their scales) cut on heads
    (each rank attends its q heads' kv heads; `local_kv` takes a part of
    a GQA group), cut on positions over `model` or over data and `model`
    (every rank attends all q heads against its positions, the softmax
    reduced over the cut), or whole; encdec's `xk`/`xv` cut on heads,
    or on positions (gathered whole for K4's cross attention), or whole;
    rows cut over data; and the state caches (WKV, SSM, conv) cut on
    heads or channels or whole.
    """
    check_family(cfg)
    _, norm = make_norm(cfg.norm)

    def _attn_step(pl_, h, k_l, v_l, pos, idx, window):
        """One-token attention against this layer's cache slab (written in
        place: k_l / v_l are this step's copies). Over a cache whose
        positions are cut, every rank takes all q heads and the softmax
        is reduced over the cut (`decode_attend_cut`)."""
        z = norm(pl_["ln1"], h, cfg.norm_eps)
        q, k, v = qkv_proj(pl_["attn"], z, cfg, pos.reshape(-1, 1, 1))
        seq = cache_seq_axis("k")
        _write_rows(k_l, k[:, :, 0], idx, seq)
        _write_rows(v_l, v[:, :, 0], idx, seq)
        q, (k_a, v_a) = _heads(q, seq, cfg, (k_l, v_l))
        if seq.n > 1:
            o = decode_attend_cut(q, k_a, v_a, pos, seq, window=window)
        else:
            o = decode_attend(q, k_a, v_a, pos, window=window)
        return h + attn_out(pl_["attn"], o, cfg)

    def _attn_step_int8(pl_, h, k_l, ks_l, v_l, vs_l, pos, idx, window):
        """`_attn_step` over an int8 cache and its scales: the new row is
        quantized once and written, with its scales, by the rank that
        holds its position; a cut cache is attended with
        `decode_attend_int8_cut`."""
        z = norm(pl_["ln1"], h, cfg.norm_eps)
        q, k, v = qkv_proj(pl_["attn"], z, cfg, pos.reshape(-1, 1, 1))
        seq = cache_seq_axis("k")
        kq, ksc = quantize_kv(k)
        vq, vsc = quantize_kv(v)
        _write_rows(k_l, kq[:, :, 0], idx, seq)
        _write_rows(v_l, vq[:, :, 0], idx, seq)
        _write_rows(ks_l, ksc[:, :, 0], idx, seq)
        _write_rows(vs_l, vsc[:, :, 0], idx, seq)
        q, (k_a, v_a, ks_a, vs_a) = _heads(q, seq, cfg, (k_l, v_l),
                                           (ks_l, vs_l))
        if seq.n > 1:
            o = decode_attend_int8_cut(q, k_a, ks_a, v_a, vs_a, pos, seq,
                                       window=window)
        else:
            o = decode_attend_int8(q, k_a, ks_a, v_a, vs_a, pos,
                                   window=window)
        return h + attn_out(pl_["attn"], o, cfg)

    def fn(params, cache, tokens):
        params = materialize(params)
        B = tokens.shape[0]
        pos = (cache["pos"] + 1).to(torch.int32)
        x = embed_apply(params["embed"], tokens, cfg.vocab_size)

        if cfg.family == "ssm":
            states = []
            for i in range(cfg.num_layers):
                x, st = _rwkv_block(layer_of(params, "layers", i), x, cfg,
                                    cache["wkv"][i], cache["last_tm"][i],
                                    cache["last_cm"][i])
                states.append(st)
            return _last_logits(cfg, params, x), \
                _rwkv_cache(states, pos, cache["last_tm"].dtype)

        # the cache write index: per row, clamped into the cache like the
        # start index of jax.lax.dynamic_update_slice
        smax = cache["k"].shape[3] * cache_seq_axis("k").n
        idx = torch.clamp(pos.reshape(-1), 0, smax - 1).expand(B)

        if cfg.family in ("dense", "moe"):
            new = {k: v.clone() for k, v in cache.items() if k != "pos"}
            for i in range(cfg.num_layers):
                pl_ = layer_of(params, "layers", i)
                if cfg.kv_cache_dtype == "int8":
                    x = _attn_step_int8(pl_, x, new["k"][i], new["k_scale"][i],
                                        new["v"][i], new["v_scale"][i], pos,
                                        idx, cfg.sliding_window)
                else:
                    x = _attn_step(pl_, x, new["k"][i], new["v"][i], pos, idx,
                                   cfg.sliding_window)
                x = _ffn(cfg, pl_, x)
            return _last_logits(cfg, params, x), {**new, "pos": pos}

        if cfg.family == "encdec":
            k_new, v_new = cache["k"].clone(), cache["v"].clone()
            xseq = cache_seq_axis("xk")
            for i in range(cfg.dec_layers):
                pl_ = layer_of(params, "dec_layers", i)
                x = _attn_step(pl_, x, k_new[i], v_new[i], pos, idx, None)
                z = norm(pl_["lnx"], x, cfg.norm_eps)
                qx, _, _ = qkv_proj(pl_["xattn"], z, cfg,
                                    pos.reshape(-1, 1, 1))
                # encoder positions cut over ranks are gathered whole
                xk = xseq.all_gather(cache["xk"][i], 2)
                xv = xseq.all_gather(cache["xv"][i], 2)
                ox = attend(qx, *local_kv(qx, xk, xv, cfg), causal=False)
                x = x + attn_out(pl_["xattn"], ox, cfg)
                z = norm(pl_["ln2"], x, cfg.norm_eps)
                x = x + mlp_apply(pl_["mlp"], z, cfg.act, cfg.d_ff)
            return _last_logits(cfg, params, x), \
                {"k": k_new, "v": v_new, "xk": cache["xk"],
                 "xv": cache["xv"], "pos": pos}

        shared = params["shared_attn"]
        period, G, R = _hybrid_groups(cfg)
        k_new, v_new = cache["k"].clone(), cache["v"].clone()
        st, cc = [], []

        def ssm_once(h, i):
            pl_ = layer_of(params, "layers", i)
            z = norm(pl_["ln1"], h, cfg.norm_eps)
            c_in = cache["conv"][i]
            y, (s_new, c_new) = ssm_apply(
                pl_["ssm"], z, cfg, state=cache["ssm_state"][i],
                conv_cache=c_in.to(z.dtype))
            st.append(s_new)
            cc.append(c_new.to(c_in.dtype))
            return h + y

        for grp in range(G):
            for i in range(grp * period, (grp + 1) * period):
                x = ssm_once(x, i)
            x = _attn_step({"ln1": shared["ln1"], "attn": shared["attn"]},
                           x, k_new[grp], v_new[grp], pos, idx, None)
            z = norm(shared["ln2"], x, cfg.norm_eps)
            x = x + mlp_apply(shared["mlp"], z, cfg.act, cfg.d_ff)
        for i in range(G * period, G * period + R):
            x = ssm_once(x, i)
        return _last_logits(cfg, params, x), \
            {"ssm_state": torch.stack(st), "conv": torch.stack(cc),
             "k": k_new, "v": v_new, "pos": pos}

    return fn
