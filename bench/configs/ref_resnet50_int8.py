"""Plain numpy reference of the int8 ResNet-50 v1 that the benchmark serves.

He et al., arXiv:1512.03385, Table 1 (50-layer), deployed in int8: every
conv and the classifier multiply int8 by int8 into int32; a conv's int32
result is requantized to int8 by a float32 multiply and a round half to
even, clamped to [-128, 127] (the folded batch norm's scale lives in the
multiplier); the residual add saturates to int8; the global average pool
rounds half to even; the classifier's int32 logits are the output.

Layout: activations (H, W, C); a conv weight is (kh * kw * C_in, C_out),
rows in (kh, kw, C_in) order; the stem's max pool has no padding (55 x 55
after it at 224). Names follow the served graph's (`stem.w`,
`s1.b0.c2.rq.mult`, `fc.w`), so one dict of weights feeds both sides.

Products are exact: int8 x int8 sums over K <= 4,608 stay below 2^53, so
they are taken in float64 by BLAS. Imports numpy alone.
"""

from __future__ import annotations

import numpy as np


def layers(h=224, w=224, num_classes=1000, width=1.0,
           blocks=(3, 4, 6, 3)) -> list[dict]:
    """The network as a list of steps over named activations: conv (with
    its requant and optional relu), maxpool, add (+relu), gap, fc."""
    def ch(c):
        return max(8, int(c * width))

    out: list[dict] = []
    shape = {"input": (h, w, 3)}

    def conv(name, src, c_out, k, stride=1, pad=None, relu=True):
        H, W, C = shape[src]
        p = k // 2 if pad is None else pad
        oh, ow = (H + 2 * p - k) // stride + 1, (W + 2 * p - k) // stride + 1
        out.append({"op": "conv", "name": name, "src": src, "dst": name,
                    "H": H, "W": W, "C_in": C, "C_out": c_out, "k": k,
                    "stride": stride, "pad": p, "relu": relu,
                    "oh": oh, "ow": ow})
        shape[name] = (oh, ow, c_out)
        return name

    y = conv("stem", "input", ch(64), 7, stride=2, pad=3)
    H, W, C = shape[y]
    out.append({"op": "maxpool", "src": y, "dst": "stem.pool", "k": 3,
                "stride": 2})
    shape["stem.pool"] = ((H - 3) // 2 + 1, (W - 3) // 2 + 1, C)
    y = "stem.pool"
    for si, (n, mid) in enumerate(zip(blocks, (ch(64), ch(128), ch(256),
                                               ch(512)))):
        for bi in range(n):
            s = 2 if (si > 0 and bi == 0) else 1
            b = f"s{si}.b{bi}"
            z = conv(f"{b}.c1", y, mid, 1)
            z = conv(f"{b}.c2", z, mid, 3, stride=s)
            z = conv(f"{b}.c3", z, mid * 4, 1, relu=False)
            idn = conv(f"{b}.ds", y, mid * 4, 1, stride=s, relu=False) \
                if bi == 0 else y
            out.append({"op": "add", "a": z, "b": idn, "dst": b})
            shape[b] = shape[z]
            y = b
    out.append({"op": "gap", "src": y, "dst": "gap"})
    out.append({"op": "fc", "name": "fc", "src": "gap", "dst": "fc.out",
                "K": shape[y][2], "N": num_classes})
    return out


def weight_specs(net: list[dict]) -> dict[str, tuple]:
    """{name: (shape, kind)}: int8 weights ("w") and float32 per-channel
    requant multipliers ("mult", one per output channel; kind carries the
    conv's K, which sets the multiplier's scale)."""
    out = {}
    for s in net:
        if s["op"] == "conv":
            K = s["k"] * s["k"] * s["C_in"]
            out[f"{s['name']}.w"] = ((K, s["C_out"]), "w")
            out[f"{s['name']}.rq.mult"] = ((s["C_out"],), ("mult", K))
        elif s["op"] == "fc":
            out[f"{s['name']}.w"] = ((s["K"], s["N"]), "w")
    return out


def _im2col(x, k, stride, pad):
    """(B, H, W, C) -> (B * oh * ow, k * k * C), rows in (kh, kw, C)."""
    B, H, W, C = x.shape
    xp = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    oh, ow = (H + 2 * pad - k) // stride + 1, (W + 2 * pad - k) // stride + 1
    win = np.lib.stride_tricks.sliding_window_view(xp, (k, k), axis=(1, 2))
    win = win[:, ::stride, ::stride][:, :oh, :ow]        # (B,oh,ow,C,k,k)
    return win.transpose(0, 1, 2, 4, 5, 3).reshape(B * oh * ow, k * k * C)


def _matmul_i32(a, w):
    """int8 (M, K) @ int8 (K, N) -> exact int32, through float64."""
    return (a.astype(np.float64) @ w.astype(np.float64)).astype(np.int32)


def _requant(acc, mult):
    y = np.round(acc.astype(np.float32) * np.asarray(mult, np.float32))
    return np.clip(y, -128, 127).astype(np.int8)


def forward(net: list[dict], params: dict, frames: np.ndarray,
            weight_bits: int = 8) -> np.ndarray:
    """frames (B, H, W, 3) int8 -> the classifier's int32 logits (B, N).

    `weight_bits` below 8 rounds every weight to that many bits first
    (round half to even onto the grid of 2^(8 - bits)): the control of the
    exact comparison, int4 in place of int8."""
    step = 2 ** (8 - weight_bits)

    def weight(name):
        w = params[name]
        if step == 1:
            return w
        lo, hi = -2 ** (weight_bits - 1), 2 ** (weight_bits - 1) - 1
        return (np.clip(np.round(w.astype(np.float32) / step), lo, hi)
                * step).astype(np.int32)

    B = frames.shape[0]
    vals = {"input": np.asarray(frames, np.int8)}
    for s in net:
        op = s["op"]
        if op == "conv":
            cols = _im2col(vals[s["src"]], s["k"], s["stride"], s["pad"])
            acc = _matmul_i32(cols, weight(f"{s['name']}.w"))
            y = _requant(acc, params[f"{s['name']}.rq.mult"])
            if s["relu"]:
                y = np.maximum(y, 0)
            vals[s["dst"]] = y.reshape(B, s["oh"], s["ow"], s["C_out"])
        elif op == "maxpool":
            x = vals[s["src"]]
            k, st = s["k"], s["stride"]
            oh, ow = (x.shape[1] - k) // st + 1, (x.shape[2] - k) // st + 1
            y = np.full((B, oh, ow, x.shape[3]), -128, np.int8)
            for di in range(k):
                for dj in range(k):
                    y = np.maximum(y, x[:, di:di + oh * st:st,
                                        dj:dj + ow * st:st])
            vals[s["dst"]] = y
        elif op == "add":
            y = vals[s["a"]].astype(np.int32) + vals[s["b"]].astype(np.int32)
            vals[s["dst"]] = np.maximum(np.clip(y, -128, 127), 0).astype(
                np.int8)
        elif op == "gap":
            x = vals[s["src"]]
            n = x.shape[1] * x.shape[2]
            tot = x.astype(np.int64).sum(axis=(1, 2))
            q, r = np.divmod(tot, n)           # floor division, 0 <= r < n
            up = (2 * r > n) | ((2 * r == n) & (q % 2 == 1))
            vals[s["dst"]] = np.clip(q + up, -128, 127).astype(np.int8)
        elif op == "fc":
            vals[s["dst"]] = _matmul_i32(vals[s["src"]],
                                         weight(f"{s['name']}.w"))
        else:
            raise ValueError(op)
    return vals["fc.out"]


def conv_shapes(net: list[dict]) -> list[dict]:
    """Every conv and the classifier as (name, M, K, N) per frame, with
    the attributes a bound needs: the int8 operations and bytes of the
    network are counted from these."""
    out = []
    for s in net:
        if s["op"] == "conv":
            out.append({"name": s["name"], "M": s["oh"] * s["ow"],
                        "K": s["k"] * s["k"] * s["C_in"], "N": s["C_out"],
                        "in_elems": s["H"] * s["W"] * s["C_in"]})
        elif s["op"] == "fc":
            out.append({"name": s["name"], "M": 1, "K": s["K"],
                        "N": s["N"], "in_elems": s["K"]})
    return out
