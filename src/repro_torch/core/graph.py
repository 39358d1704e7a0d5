"""Operator-graph IR for the predictable-inference compiler.

This is the JAX-native stand-in for the paper's MLIR pipeline entry point
(onnx-mlir / linalg level): a flat, topologically-ordered list of tensor ops
with static shapes, FLOP/byte metadata, and explicit producer/consumer edges.
Neural networks have fixed, input-independent dataflow (paper §III.B), which
is what makes the static schedule computable — `Graph.validate()` enforces
exactly that property (static shapes, acyclicity, single producer).
"""

from __future__ import annotations

import dataclasses
import math

DTYPE_BYTES = {
    "int8": 1, "uint8": 1, "int16": 2, "int32": 4,
    "bf16": 2, "f16": 2, "f32": 4,
}

# Op kinds with a GEMM lowering (the paper's subtask unit is a GEMM tile).
GEMM_KINDS = ("gemm", "conv2d")


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    name: str
    shape: tuple[int, ...]
    dtype: str = "int8"

    @property
    def nbytes(self) -> int:
        return int(math.prod(self.shape)) * DTYPE_BYTES[self.dtype]

    @property
    def size(self) -> int:
        return int(math.prod(self.shape))


@dataclasses.dataclass
class OpNode:
    """One operator.

    attrs for kind == "gemm":   M, K, N  (activation (M,K) @ weight (K,N))
    attrs for kind == "conv2d": H, W, C_in, C_out, kh, kw, stride, padding
    elementwise/pool/norm ops carry their natural attrs.
    """

    name: str
    kind: str
    inputs: list[str]                    # tensor names (activations first)
    outputs: list[str]
    weights: list[str] = dataclasses.field(default_factory=list)
    attrs: dict = dataclasses.field(default_factory=dict)

    def flops(self, g: "Graph") -> float:
        if self.kind == "gemm":
            a = self.attrs
            return 2.0 * a["M"] * a["K"] * a["N"]
        if self.kind == "conv2d":
            a = self.attrs
            oh, ow = conv_out_hw(a)
            return 2.0 * oh * ow * a["kh"] * a["kw"] * a["C_in"] * a["C_out"]
        # elementwise-ish ops: ~a few ops per output element
        out = g.tensors[self.outputs[0]]
        per = {"relu": 1, "add": 1, "mul": 1, "maxpool": 4, "avgpool": 4,
               "requant": 4, "norm": 8, "softmax": 10, "gap": 2}.get(self.kind, 2)
        return float(per * out.size)

    def is_gemm_like(self) -> bool:
        return self.kind in GEMM_KINDS


def conv_out_hw(a: dict) -> tuple[int, int]:
    s, p = a.get("stride", 1), a.get("padding", 0)
    oh = (a["H"] + 2 * p - a["kh"]) // s + 1
    ow = (a["W"] + 2 * p - a["kw"]) // s + 1
    return oh, ow


class GraphError(ValueError):
    pass


class Graph:
    """Static-dataflow operator graph (the compiler's input)."""

    def __init__(self, name: str = "net"):
        self.name = name
        self.tensors: dict[str, TensorSpec] = {}
        self.ops: list[OpNode] = []
        self.inputs: list[str] = []
        self.outputs: list[str] = []
        self._producer: dict[str, str] = {}   # tensor -> op name

    # -- construction -------------------------------------------------------
    def add_tensor(self, name, shape, dtype="int8", is_input=False) -> TensorSpec:
        if name in self.tensors:
            raise GraphError(f"duplicate tensor {name}")
        t = TensorSpec(name, tuple(int(s) for s in shape), dtype)
        self.tensors[name] = t
        if is_input:
            self.inputs.append(name)
        return t

    def add_op(self, op: OpNode) -> OpNode:
        for t in op.inputs + op.weights:
            if t not in self.tensors:
                raise GraphError(f"{op.name}: unknown input tensor {t}")
        for t in op.outputs:
            if t not in self.tensors:
                raise GraphError(f"{op.name}: unknown output tensor {t}")
            if t in self._producer:
                raise GraphError(f"tensor {t} produced twice")
            self._producer[t] = op.name
        self.ops.append(op)
        return op

    def mark_output(self, name: str):
        self.outputs.append(name)

    # -- queries ------------------------------------------------------------
    def producer_of(self, tensor: str) -> str | None:
        return self._producer.get(tensor)

    def op(self, name: str) -> OpNode:
        for o in self.ops:
            if o.name == name:
                return o
        raise KeyError(name)

    def consumers_of(self, tensor: str) -> list[OpNode]:
        return [o for o in self.ops if tensor in o.inputs]

    def op_deps(self, op: OpNode) -> list[str]:
        """Names of ops whose outputs this op consumes."""
        deps = []
        for t in op.inputs:
            p = self._producer.get(t)
            if p is not None and p not in deps:
                deps.append(p)
        return deps

    def total_flops(self) -> float:
        return sum(op.flops(self) for op in self.ops)

    def total_weight_bytes(self) -> int:
        seen, total = set(), 0
        for op in self.ops:
            for w in op.weights:
                if w not in seen:
                    seen.add(w)
                    total += self.tensors[w].nbytes
        return total

    def validate(self) -> None:
        """Enforce the fixed-dataflow property the paper's schedule needs."""
        seen: set[str] = set(self.inputs)
        for w in {w for op in self.ops for w in op.weights}:
            seen.add(w)
        for op in self.ops:
            for t in op.inputs:
                if t not in seen:
                    raise GraphError(
                        f"{op.name} consumes {t} before it is produced "
                        "(graph not topologically ordered / cyclic)")
            for t in op.outputs:
                seen.add(t)
            for t in op.inputs + op.outputs + op.weights:
                if any(d <= 0 for d in self.tensors[t].shape):
                    raise GraphError(f"{t}: non-static shape")
        for t in self.outputs:
            if t not in seen:
                raise GraphError(f"graph output {t} never produced")

    def __repr__(self):
        return (f"Graph({self.name}: {len(self.ops)} ops, "
                f"{self.total_flops()/1e9:.2f} GFLOP, "
                f"{self.total_weight_bytes()/1e6:.2f} MB weights)")


# -- convenience builders ----------------------------------------------------

def linear(g: Graph, name: str, x: str, out_features: int,
           dtype: str = "int8", acc_dtype: str = "int32") -> str:
    """y = x @ W; x: (M, K)."""
    M, K = g.tensors[x].shape
    w = f"{name}.w"
    y = f"{name}.out"
    g.add_tensor(w, (K, out_features), dtype)
    g.add_tensor(y, (M, out_features), acc_dtype)
    g.add_op(OpNode(name, "gemm", [x], [y], weights=[w],
                    attrs={"M": M, "K": K, "N": out_features}))
    return y


def conv2d(g: Graph, name: str, x: str, c_out: int, k: int,
           stride: int = 1, padding: int | None = None,
           dtype: str = "int8", acc_dtype: str = "int32") -> str:
    """NHWC conv. x: (H, W, C). Batch handled one image at a time (paper
    targets per-frame real-time inference, batch == 1)."""
    H, W, C = g.tensors[x].shape
    p = (k // 2) if padding is None else padding
    a = {"H": H, "W": W, "C_in": C, "C_out": c_out, "kh": k, "kw": k,
         "stride": stride, "padding": p}
    oh, ow = conv_out_hw(a)
    w = f"{name}.w"
    y = f"{name}.out"
    g.add_tensor(w, (k * k * C, c_out), dtype)      # GEMM-layout weights
    g.add_tensor(y, (oh, ow, c_out), acc_dtype)
    g.add_op(OpNode(name, "conv2d", [x], [y], weights=[w], attrs=a))
    return y


def requant(g: Graph, name: str, x: str, dtype: str = "int8") -> str:
    """int32 accumulator -> int8 activation (scale+clamp)."""
    y = f"{name}.out"
    g.add_tensor(y, g.tensors[x].shape, dtype)
    g.add_op(OpNode(name, "requant", [x], [y]))
    return y


def eltwise(g: Graph, name: str, kind: str, xs: list[str],
            dtype: str | None = None) -> str:
    t0 = g.tensors[xs[0]]
    y = f"{name}.out"
    g.add_tensor(y, t0.shape, dtype or t0.dtype)
    g.add_op(OpNode(name, kind, list(xs), [y]))
    return y


def pool2d(g: Graph, name: str, kind: str, x: str, k: int, stride: int,
           padding: int = 0) -> str:
    H, W, C = g.tensors[x].shape
    oh = (H + 2 * padding - k) // stride + 1
    ow = (W + 2 * padding - k) // stride + 1
    y = f"{name}.out"
    g.add_tensor(y, (oh, ow, C), g.tensors[x].dtype)
    g.add_op(OpNode(name, kind, [x], [y],
                    attrs={"k": k, "stride": stride, "padding": padding}))
    return y


def global_avg_pool(g: Graph, name: str, x: str) -> str:
    H, W, C = g.tensors[x].shape
    y = f"{name}.out"
    g.add_tensor(y, (1, C), g.tensors[x].dtype)
    g.add_op(OpNode(name, "gap", [x], [y]))
    return y
