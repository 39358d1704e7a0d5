"""CNN graph builders for the paper's own evaluation targets (§IV.A:
"medium-sized convolutional neural networks like ResNet50 or YOLOv5-small"),
plus a tiny CNN for fast tests. All nets are int8 (conv/gemm accumulate in
int32, then requantize), batch=1 per-frame inference — the real-time setting
the paper targets.
"""

from __future__ import annotations

from .graph import (Graph, OpNode, conv2d, eltwise, global_avg_pool, linear,
                    pool2d, requant)


def _conv_block(g: Graph, name: str, x: str, c_out: int, k: int,
                stride: int = 1, relu: bool = True,
                padding: int | None = None) -> str:
    """conv -> requant(+folded BN) -> relu, the standard int8 inference unit."""
    y = conv2d(g, name, x, c_out, k, stride=stride, padding=padding)
    y = requant(g, f"{name}.rq", y)
    if relu:
        y = eltwise(g, f"{name}.relu", "relu", [y])
    return y


def concat(g: Graph, name: str, xs: list[str]) -> str:
    shapes = [g.tensors[t].shape for t in xs]
    c = sum(s[-1] for s in shapes)
    out_shape = shapes[0][:-1] + (c,)
    y = f"{name}.out"
    g.add_tensor(y, out_shape, g.tensors[xs[0]].dtype)
    g.add_op(OpNode(name, "concat", list(xs), [y]))
    return y


def small_cnn(h: int = 32, w: int = 32, c: int = 3,
              num_classes: int = 10) -> Graph:
    """Tiny int8 CNN used by unit/property tests (fast to schedule/replay)."""
    g = Graph("small_cnn")
    x = "input"
    g.add_tensor(x, (h, w, c), "int8", is_input=True)
    y = _conv_block(g, "conv1", x, 16, 3, stride=1)
    y = pool2d(g, "pool1", "maxpool", y, 2, 2)
    y = _conv_block(g, "conv2", y, 32, 3, stride=1)
    y = pool2d(g, "pool2", "maxpool", y, 2, 2)
    y = global_avg_pool(g, "gap", y)
    y = linear(g, "fc", y, num_classes)
    g.mark_output(y)
    g.validate()
    return g


def _bottleneck(g: Graph, name: str, x: str, c_mid: int, c_out: int,
                stride: int = 1, downsample: bool = False) -> str:
    """ResNet v1 bottleneck: 1x1 -> 3x3 -> 1x1(+4x), residual int8 add."""
    idn = x
    y = _conv_block(g, f"{name}.c1", x, c_mid, 1)
    y = _conv_block(g, f"{name}.c2", y, c_mid, 3, stride=stride)
    y = _conv_block(g, f"{name}.c3", y, c_out, 1, relu=False)
    if downsample:
        idn = _conv_block(g, f"{name}.ds", x, c_out, 1, stride=stride,
                          relu=False)
    y = eltwise(g, f"{name}.add", "add", [y, idn])
    return eltwise(g, f"{name}.relu", "relu", [y])


def resnet50(h: int = 224, w: int = 224, num_classes: int = 1000,
             width: float = 1.0, blocks: tuple = (3, 4, 6, 3)) -> Graph:
    """Standard ResNet50 (int8). `width`/`blocks` allow reduced smoke configs."""
    g = Graph(f"resnet50_{h}x{w}" + ("" if width == 1.0 else f"_w{width}"))
    x = "input"
    g.add_tensor(x, (h, w, 3), "int8", is_input=True)

    def ch(c):
        return max(8, int(c * width))

    y = _conv_block(g, "stem", x, ch(64), 7, stride=2, padding=3)
    y = pool2d(g, "stem.pool", "maxpool", y, 3, 2)
    mids = (ch(64), ch(128), ch(256), ch(512))
    for si, (n_blocks, c_mid) in enumerate(zip(blocks, mids)):
        c_out = c_mid * 4
        for bi in range(n_blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            y = _bottleneck(g, f"s{si}.b{bi}", y, c_mid, c_out,
                            stride=stride, downsample=(bi == 0))
    y = global_avg_pool(g, "gap", y)
    y = linear(g, "fc", y, num_classes)
    g.mark_output(y)
    g.validate()
    return g


def _c3(g: Graph, name: str, x: str, c_out: int, n: int) -> str:
    """YOLOv5 C3 module (CSP bottleneck with 3 convs)."""
    c_h = max(8, c_out // 2)
    y1 = _conv_block(g, f"{name}.cv1", x, c_h, 1)
    for i in range(n):
        z = _conv_block(g, f"{name}.m{i}.cv1", y1, c_h, 1)
        z = _conv_block(g, f"{name}.m{i}.cv2", z, c_h, 3, relu=False)
        y1 = eltwise(g, f"{name}.m{i}.add", "add", [z, y1])
        y1 = eltwise(g, f"{name}.m{i}.relu", "relu", [y1])
    y2 = _conv_block(g, f"{name}.cv2", x, c_h, 1)
    y = concat(g, f"{name}.cat", [y1, y2])
    return _conv_block(g, f"{name}.cv3", y, c_out, 1)


def yolov5s_backbone(h: int = 640, w: int = 640,
                     width: float = 1.0) -> Graph:
    """YOLOv5-small backbone + SPPF (width 0.5, depth 0.33 of YOLOv5l).

    The detection head's upsample/route layers are out of scope of the
    paper's GEMM-centric deployment discussion; the backbone + SPPF carries
    >85% of the network FLOPs and all layer types the compiler handles
    (conv/bottleneck/CSP/pool/concat). Noted in DESIGN.md.
    """
    g = Graph(f"yolov5s_{h}x{w}")
    x = "input"
    g.add_tensor(x, (h, w, 3), "int8", is_input=True)

    def ch(c):
        return max(8, int(c * width))

    y = _conv_block(g, "stem", x, ch(32), 6, stride=2, padding=2)
    y = _conv_block(g, "d1", y, ch(64), 3, stride=2)
    y = _c3(g, "c3_1", y, ch(64), 1)
    y = _conv_block(g, "d2", y, ch(128), 3, stride=2)
    y = _c3(g, "c3_2", y, ch(128), 2)
    y = _conv_block(g, "d3", y, ch(256), 3, stride=2)
    y = _c3(g, "c3_3", y, ch(256), 3)
    y = _conv_block(g, "d4", y, ch(512), 3, stride=2)
    y = _c3(g, "c3_4", y, ch(512), 1)
    # SPPF (padded stride-1 maxpools keep spatial dims)
    p1 = pool2d(g, "sppf.p1", "maxpool", y, 5, 1, padding=2)
    p2 = pool2d(g, "sppf.p2", "maxpool", p1, 5, 1, padding=2)
    p3 = pool2d(g, "sppf.p3", "maxpool", p2, 5, 1, padding=2)
    y = concat(g, "sppf.cat", [y, p1, p2, p3])
    y = _conv_block(g, "sppf.cv", y, ch(512), 1)
    g.mark_output(y)
    g.validate()
    return g
