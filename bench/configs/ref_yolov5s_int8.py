"""Plain torch reference of the int8 YOLOv5s v7.0 detector that the
benchmark serves.

Ultralytics YOLOv5 v7.0, `models/yolov5s.yaml` (depth 0.33, width 0.50)
with `models/common.py` (`Conv`, `Bottleneck`, `C3`, `SPPF`) and
`models/yolo.py` (`Detect`), deployed in int8:

  * `Conv`: an int8 x int8 convolution (padding k // 2; the stem is 6x6,
    stride 2, padding 2) into int32; requantized to int8 by a float32
    multiply and a round half to even, clamped to [-128, 127] (the folded
    batch norm lives in the per-channel multiplier); then SiLU as a table
    of 256 int8, entry q + 128 = clamp(round_half_even(silu(q / 16) x 16)),
    built here in float64 by its own formula.
  * `Bottleneck`: Conv 1x1, Conv 3x3, and where it has a shortcut (the
    backbone's C3s) the input added, saturating to int8, with no activation
    after the add.
  * `C3`: cv1 and cv2 1x1 to half the channels, n Bottlenecks on cv1's
    branch, the two branches concatenated (the bottlenecks' first), cv3 1x1.
  * `SPPF`: cv1 1x1 to half, three 5x5 stride-1 max pools (padding 2),
    the four concatenated, cv2 1x1.
  * The PAN neck: nearest x2 upsamples and concatenations (the upsampled
    or downsampled map first).
  * `Detect`: a 1x1 conv to 3 x (classes + 5) channels at strides 8, 16
    and 32, int32 without requant; channel c of a map is anchor c // row,
    field c % row. The three maps are packed into one (sum H W x 3, row)
    answer, rows in (level, y, x, anchor) order. The sigmoid, the grid and
    anchor decode and NMS are the host's and lie outside the served graph.

Every add and concat is at one int8 scale; convs have no bias. Names
follow the served graph's (`m0.w`, `m2.m0.cv1.rq.mult`, `m24.m1.w`), so one
dict of weights feeds both sides.

Products are taken in float64 by `torch.nn.functional.conv2d` on the CPU,
which is exact: an int8 x int8 sum over K <= 2,304 stays below 2^26. TF32
is off. Frames are computed one at a time, so 16 frames at 640 fit.
Imports torch and numpy alone.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SILU_SCALE = 1.0 / 16        # the int8 scale of every SiLU's input and output


def layers(h=640, w=640, num_classes=80, width=1.0) -> list[dict]:
    """The network as a list of steps over named activations: conv (with
    its requant and SiLU, or neither for a Detect conv), add, cat,
    maxpool, up, pack."""
    def ch(c):
        return max(8, int(c * width))

    out: list[dict] = []
    shape = {"input": (h, w, 3)}

    def conv(name, src, c_out, k, stride=1, pad=None, act=True):
        H, W, C = shape[src]
        p = k // 2 if pad is None else pad
        oh, ow = (H + 2 * p - k) // stride + 1, (W + 2 * p - k) // stride + 1
        out.append({"op": "conv", "name": name, "src": src, "dst": name,
                    "H": H, "W": W, "C_in": C, "C_out": c_out, "k": k,
                    "stride": stride, "pad": p, "act": act,
                    "oh": oh, "ow": ow})
        shape[name] = (oh, ow, c_out)
        return name

    def cat(dst, srcs):
        out.append({"op": "cat", "srcs": srcs, "dst": dst})
        shape[dst] = shape[srcs[0]][:2] + (sum(shape[s][2] for s in srcs),)
        return dst

    def c3(name, src, c_out, n, shortcut):
        c_h = c_out // 2
        y = conv(f"{name}.cv1", src, c_h, 1)
        for i in range(n):
            z = conv(f"{name}.m{i}.cv1", y, c_h, 1)
            z = conv(f"{name}.m{i}.cv2", z, c_h, 3)
            if shortcut:
                out.append({"op": "add", "a": y, "b": z,
                            "dst": f"{name}.m{i}"})
                shape[f"{name}.m{i}"] = shape[z]
                z = f"{name}.m{i}"
            y = z
        y2 = conv(f"{name}.cv2", src, c_h, 1)
        return conv(f"{name}.cv3", cat(f"{name}.cat", [y, y2]), c_out, 1)

    def up(dst, src):
        out.append({"op": "up", "src": src, "dst": dst})
        H, W, C = shape[src]
        shape[dst] = (2 * H, 2 * W, C)
        return dst

    y = conv("m0", "input", ch(32), 6, stride=2, pad=2)
    y = conv("m1", y, ch(64), 3, stride=2)
    y = c3("m2", y, ch(64), 1, True)
    y = conv("m3", y, ch(128), 3, stride=2)
    p3 = c3("m4", y, ch(128), 2, True)
    y = conv("m5", p3, ch(256), 3, stride=2)
    p4 = c3("m6", y, ch(256), 3, True)
    y = conv("m7", p4, ch(512), 3, stride=2)
    y = c3("m8", y, ch(512), 1, True)
    y = conv("m9.cv1", y, ch(512) // 2, 1)
    pools = [y]
    for i in (1, 2, 3):
        out.append({"op": "maxpool", "src": pools[-1], "dst": f"m9.p{i}",
                    "k": 5, "pad": 2})
        shape[f"m9.p{i}"] = shape[y]
        pools.append(f"m9.p{i}")
    y = conv("m9.cv2", cat("m9.cat", pools), ch(512), 1)
    h10 = conv("m10", y, ch(256), 1)
    y = c3("m13", cat("m12", [up("m11", h10), p4]), ch(256), 1, False)
    h14 = conv("m14", y, ch(128), 1)
    o17 = c3("m17", cat("m16", [up("m15", h14), p3]), ch(128), 1, False)
    y = conv("m18", o17, ch(128), 3, stride=2)
    o20 = c3("m20", cat("m19", [y, h14]), ch(256), 1, False)
    y = conv("m21", o20, ch(256), 3, stride=2)
    o23 = c3("m23", cat("m22", [y, h10]), ch(512), 1, False)
    row = num_classes + 5
    maps = [conv(f"m24.m{i}", o, 3 * row, 1, act=False)
            for i, o in enumerate((o17, o20, o23))]
    out.append({"op": "pack", "srcs": maps, "dst": "out", "row": row})
    return out


def weight_specs(net: list[dict]) -> dict[str, tuple]:
    """{name: (shape, kind)}: int8 weights ("w", (k * k * C_in, C_out),
    rows in (kh, kw, C_in) order) and, for every conv but the Detect's,
    float32 per-channel requant multipliers ("mult", one per output
    channel; kind carries half the conv's K, which sets the multiplier's
    scale, 0.03 / sqrt(K / 2)).

    Half K gives each conv a gain of about 1.6 before its SiLU, which
    keeps the int8 activations' spread through the network's depth (a
    standard deviation of 25-50 at every level, 7-30% zeros at 128 x
    128); at the full K the gain of about 1.1 let them shrink to 90-99%
    zeros at P5, where the check would compare little but zeros."""
    out = {}
    for s in net:
        if s["op"] == "conv":
            K = s["k"] * s["k"] * s["C_in"]
            out[f"{s['name']}.w"] = ((K, s["C_out"]), "w")
            if s["act"]:
                out[f"{s['name']}.rq.mult"] = ((s["C_out"],),
                                               ("mult", K // 2))
    return out


def silu_table() -> torch.Tensor:
    """The int8 SiLU at SILU_SCALE in and out, as 256 float64 values."""
    x = torch.arange(-128, 128, dtype=torch.float64) * SILU_SCALE
    y = torch.round(x * torch.sigmoid(x) / SILU_SCALE)
    return torch.clamp(y, -128, 127)


def forward(net: list[dict], params: dict, frames: np.ndarray,
            weight_bits: int = 8) -> np.ndarray:
    """frames (B, H, W, 3) int8 -> each frame's packed Detect output,
    (B, rows x (classes + 5)) int32: the (rows, classes + 5) answer of a
    frame, flattened.

    `weight_bits` below 8 rounds every weight to that many bits first
    (round half to even onto the grid of 2^(8 - bits)): the control of the
    exact comparison, int4 in place of int8."""
    step = 2 ** (8 - weight_bits)
    lo, hi = -2 ** (weight_bits - 1), 2 ** (weight_bits - 1) - 1
    table = silu_table()
    ws, mults = {}, {}
    for s in net:
        if s["op"] != "conv":
            continue
        w = np.asarray(params[f"{s['name']}.w"]).astype(np.float64)
        if step > 1:
            w = np.clip(np.round(w / step), lo, hi) * step
        k = s["k"]
        ws[s["name"]] = torch.from_numpy(w).reshape(
            k, k, s["C_in"], s["C_out"]).permute(3, 2, 0, 1).contiguous()
        if s["act"]:
            mults[s["name"]] = torch.from_numpy(np.asarray(
                params[f"{s['name']}.rq.mult"], np.float32)).view(1, -1, 1, 1)
    answers = []
    for frame in np.asarray(frames, np.int8):
        vals = {"input": torch.from_numpy(frame.astype(np.float64)).permute(
            2, 0, 1)[None]}                           # (1, C, H, W)
        for s in net:
            op = s["op"]
            if op == "conv":
                acc = F.conv2d(vals[s["src"]], ws[s["name"]],
                               stride=s["stride"], padding=s["pad"])
                if s["act"]:
                    q = torch.round(acc.to(torch.float32) * mults[s["name"]])
                    q = torch.clamp(q, -128, 127).to(torch.int64)
                    acc = table[q + 128]
                vals[s["dst"]] = acc
            elif op == "add":
                vals[s["dst"]] = torch.clamp(vals[s["a"]] + vals[s["b"]],
                                             -128, 127)
            elif op == "cat":
                vals[s["dst"]] = torch.cat([vals[t] for t in s["srcs"]], 1)
            elif op == "maxpool":
                vals[s["dst"]] = F.max_pool2d(vals[s["src"]], s["k"], 1,
                                              s["pad"])
            elif op == "up":
                x = vals[s["src"]]
                vals[s["dst"]] = x.repeat_interleave(2, 2).repeat_interleave(
                    2, 3)
            elif op == "pack":
                rows = [vals[t][0].permute(1, 2, 0).reshape(-1, s["row"])
                        for t in s["srcs"]]
                vals[s["dst"]] = torch.cat(rows)
            else:
                raise ValueError(op)
        answers.append(vals["out"].reshape(-1).to(torch.int32).numpy())
    return np.stack(answers)


def conv_shapes(net: list[dict]) -> list[dict]:
    """Every conv as (name, M, K, N) per frame, with the attributes a bound
    needs: the int8 operations and bytes of the network are counted from
    these."""
    return [{"name": s["name"], "M": s["oh"] * s["ow"],
             "K": s["k"] * s["k"] * s["C_in"], "N": s["C_out"],
             "in_elems": s["H"] * s["W"] * s["C_in"]}
            for s in net if s["op"] == "conv"]


def silu_bytes(net: list[dict], batch: int) -> int:
    """The bytes the SiLU tables of one job of `batch` frames move at
    least: each SiLU's int8 input and output once, and its 256-entry
    table once a job."""
    return sum(2 * batch * s["oh"] * s["ow"] * s["C_out"] + 256
               for s in net if s["op"] == "conv" and s["act"])
