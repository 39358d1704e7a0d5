"""LM serving steps as operator graphs for the predictable-inference
compiler — the bridge between the paper's pipeline (partition -> map ->
schedule -> WCET) and the assigned LM architectures.

A decode step has fixed dataflow (static shapes, capacity-bounded MoE), so
it is exactly the class of workload the paper's compiler handles: we emit
its GEMMs/elementwise ops as a Graph, push it through repro_torch.core.analyze,
and get a per-token WCET bound. int8 weights/activations (the paper's
quantization target; Zve32x ≙ MXU int8 path).

MoE worst case: all top_k routes hit distinct experts at full capacity —
the static schedule must cover the worst case for the bound to be sound.
"""

from __future__ import annotations

from .graph import Graph, OpNode, eltwise, linear, requant
from ..models.config import ModelConfig


def _proj(g: Graph, name: str, x: str, n_out: int) -> str:
    y = linear(g, name, x, n_out)
    return requant(g, f"{name}.rq", y)


def lm_decode_graph(cfg: ModelConfig, batch: int, cache_len: int,
                    layers: int | None = None) -> Graph:
    """One decode step (batch tokens, cache of cache_len) as a Graph.

    layers=None -> all layers; a smaller value builds a truncated graph
    (per-layer structure identical) for tractable schedule construction on
    the very deep archs; scale analytically by num_layers/layers.
    """
    L = layers if layers is not None else cfg.num_layers
    D, Hq, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    S_att = min(cache_len, cfg.sliding_window) if cfg.sliding_window \
        else cache_len
    g = Graph(f"{cfg.name}.decode.b{batch}.s{cache_len}"
              + (f".l{L}" if layers is not None else ""))
    x = "tokens_embed"
    g.add_tensor(x, (batch, D), "int8", is_input=True)

    for i in range(L):
        p = f"l{i}"
        if cfg.family == "ssm":                        # rwkv6 block
            _proj(g, f"{p}.wr", x, D)
            k = _proj(g, f"{p}.wk", x, D)
            _proj(g, f"{p}.wv", x, D)
            _proj(g, f"{p}.wg", x, D)
            _proj(g, f"{p}.wdecay", x, D)
            # wkv state update + readout: per head (dk x dv) MAC
            wkv = linear(g, f"{p}.wkv_update", k, D)   # k^T v outer + read
            wkv = requant(g, f"{p}.wkv_update.rq", wkv)
            o = _proj(g, f"{p}.wo", wkv, D)
            x = eltwise(g, f"{p}.res1", "add", [x, o])
            kk = _proj(g, f"{p}.ck", x, cfg.d_ff)
            cm = _proj(g, f"{p}.cv", kk, D)
            x = eltwise(g, f"{p}.res2", "add", [x, cm])
            continue

        if cfg.family == "hybrid":                     # mamba2 block
            din = 2 * D
            xz = _proj(g, f"{p}.in_proj", x, 2 * din)
            # conv + state update + gate folded into one update GEMM bound
            upd = linear(g, f"{p}.ssm_update", xz, din)
            upd = requant(g, f"{p}.ssm_update.rq", upd)
            o = _proj(g, f"{p}.out_proj", upd, D)
            x = eltwise(g, f"{p}.res", "add", [x, o])
            if cfg.attn_every and (i % cfg.attn_every) == cfg.attn_every - 1:
                x = _attn_block(g, cfg, f"{p}.shared", x, batch, S_att,
                                dense_ff=cfg.d_ff)
            continue

        x = _attn_block(g, cfg, p, x, batch, S_att, dense_ff=None)

        # FFN
        if cfg.family == "moe":
            cap = max(8, int(batch * cfg.top_k / cfg.num_experts
                             * cfg.capacity_factor) + 1)
            for e in range(cfg.num_experts):
                pe = f"{p}.e{e}"
                h1 = linear(g, f"{pe}.wi", _cap_view(g, pe, x, cap, D),
                            cfg.d_ff)
                h1 = requant(g, f"{pe}.wi.rq", h1)
                h2 = linear(g, f"{pe}.wo", h1, D)
                h2 = requant(g, f"{pe}.wo.rq", h2)
                x = eltwise(g, f"{pe}.comb", "add",
                            [x, _uncap_view(g, pe, h2, batch, D)])
            if cfg.dense_residual_ff:
                h = _proj(g, f"{p}.dres.wi", x, cfg.dense_residual_ff)
                h = _proj(g, f"{p}.dres.wo", h, D)
                x = eltwise(g, f"{p}.dres.add", "add", [x, h])
        else:
            h = _proj(g, f"{p}.ffn.wi", x, cfg.d_ff)
            if cfg.act == "swiglu":
                hg = _proj(g, f"{p}.ffn.wg", x, cfg.d_ff)
                h = eltwise(g, f"{p}.ffn.gate", "mul", [h, hg])
            h = _proj(g, f"{p}.ffn.wo", h, D)
            x = eltwise(g, f"{p}.ffn.add", "add", [x, h])

    y = linear(g, "lm_head", x, cfg.vocab_size)
    g.mark_output(y)
    g.validate()
    return g


def _cap_view(g: Graph, p: str, x: str, cap: int, D: int) -> str:
    """Capacity-bounded expert input (worst-case cap tokens)."""
    y = f"{p}.capin.out"
    g.add_tensor(y, (cap, D), "int8")
    g.add_op(OpNode(f"{p}.capin", "requant", [x], [y]))
    return y


def _uncap_view(g: Graph, p: str, x: str, batch: int, D: int) -> str:
    y = f"{p}.uncap.out"
    g.add_tensor(y, (batch, D), "int8")
    g.add_op(OpNode(f"{p}.uncap", "requant", [x], [y]))
    return y


def _attn_block(g: Graph, cfg: ModelConfig, p: str, x: str, batch: int,
                S_att: int, dense_ff: int | None) -> str:
    D, Hq, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = _proj(g, f"{p}.wq", x, Hq * hd)
    k = _proj(g, f"{p}.wk", x, Hkv * hd)
    v = _proj(g, f"{p}.wv", x, Hkv * hd)
    # scores: (batch*Hq, hd) @ (hd, S) and probs @ (S, hd), as one GEMM
    # pair bound per step (the cache-read matmuls)
    qr = f"{p}.qr.out"
    g.add_tensor(qr, (batch * Hq, hd), "int8")
    g.add_op(OpNode(f"{p}.qr", "requant", [q], [qr]))
    s = linear(g, f"{p}.scores", qr, S_att)
    s8 = requant(g, f"{p}.scores.rq", s)
    o = linear(g, f"{p}.pv", s8, hd)
    o8 = requant(g, f"{p}.pv.rq", o)
    om = f"{p}.omerge.out"
    g.add_tensor(om, (batch, Hq * hd), "int8")
    g.add_op(OpNode(f"{p}.omerge", "requant", [o8], [om]))
    oo = _proj(g, f"{p}.wo", om, D)
    x = eltwise(g, f"{p}.res1", "add", [x, oo])
    if dense_ff:
        h = _proj(g, f"{p}.ffn.wi", x, dense_ff)
        h = _proj(g, f"{p}.ffn.wo", h, D)
        x = eltwise(g, f"{p}.ffn.add", "add", [x, h])
    return x
