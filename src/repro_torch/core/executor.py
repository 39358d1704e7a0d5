"""Numerical execution of the compiled artifact.

Two paths:

* ``reference_forward`` — whole-graph int8 interpreter (the numerical oracle;
  conv is evaluated as im2col+GEMM with int32 accumulation, exactly the
  semantics the worker cores implement).
* ``execute_schedule`` — replays the static schedule subtask-by-subtask in
  compute-slot time order, each GEMM/conv subtask computing only its tile
  from its (modelled) scratchpad-resident operands. Int arithmetic makes the
  comparison against ``reference_forward`` *bit-exact* — this is the
  correctness proof of the partition/mapping/schedule pipeline.

Numerics are numpy (mutable tile buffers); the CUDA kernel path
(`repro_torch.kernels.gemm_int8`) implements the identical tile computation
for the GPU and is tested against the same oracle.
"""

from __future__ import annotations

import weakref

import numpy as np

from .graph import Graph, OpNode, conv_out_hw
from .partition import Subtask
from .mapping import Mapping
from .schedule import StaticSchedule


# -- primitives ---------------------------------------------------------------

def im2col(x: np.ndarray, kh: int, kw: int, stride: int,
           pad: int) -> np.ndarray:
    """(H, W, C) -> (oh*ow, kh*kw*C); zero padding (symmetric zero-point).

    Vectorized with ``sliding_window_view`` (one strided view + one copy);
    bit-identical to ``im2col_reference``, the original per-pixel loop.
    """
    H, W, C = x.shape
    xp = np.pad(x, ((pad, pad), (pad, pad), (0, 0)))
    oh = (H + 2 * pad - kh) // stride + 1
    ow = (W + 2 * pad - kw) // stride + 1
    # (Hp-kh+1, Wp-kw+1, C, kh, kw) -> stride -> (oh, ow, C, kh, kw)
    win = np.lib.stride_tricks.sliding_window_view(xp, (kh, kw), axis=(0, 1))
    win = win[::stride, ::stride]
    # row layout must match the loop: patch raveled as (kh, kw, C)
    return np.ascontiguousarray(
        win.transpose(0, 1, 3, 4, 2).reshape(oh * ow, kh * kw * C))


def im2col_reference(x: np.ndarray, kh: int, kw: int, stride: int,
                     pad: int) -> np.ndarray:
    """Per-pixel loop formulation — the semantic oracle for ``im2col``."""
    H, W, C = x.shape
    xp = np.pad(x, ((pad, pad), (pad, pad), (0, 0)))
    oh = (H + 2 * pad - kh) // stride + 1
    ow = (W + 2 * pad - kw) // stride + 1
    cols = np.empty((oh * ow, kh * kw * C), dtype=x.dtype)
    idx = 0
    for i in range(oh):
        for j in range(ow):
            patch = xp[i * stride:i * stride + kh,
                       j * stride:j * stride + kw, :]
            cols[idx] = patch.reshape(-1)
            idx += 1
    return cols


def _im2col_band(x: np.ndarray, a: dict, m0: int, m1: int,
                 im2col_fn) -> np.ndarray:
    """im2col rows [m0, m1) computed from the tile's own input band.

    The schedule guarantees only that the rows a tile *loads* are current
    when its compute slot starts — producer tiles for other rows may still
    be pending (double-buffered prefetch interleaves ops across cores). So
    the replay must never expand more of the input than the tile's band:
    caching a whole-op im2col at first touch snapshots unwritten rows and
    corrupts later tiles (latent in the seed replay; exposed at >= 16 cores).
    """
    kh, kw, s, p = a["kh"], a["kw"], a["stride"], a["padding"]
    oh, ow = conv_out_hw(a)
    r0, r1 = m0 // ow, (m1 - 1) // ow + 1      # output row band
    i0, i1 = r0 * s, (r1 - 1) * s + kh         # input rows (padded coords)
    xp = np.pad(x, ((p, p), (p, p), (0, 0)))[i0:i1]
    cols = im2col_fn(xp, kh, kw, s, 0)         # band is already padded
    return cols[m0 - r0 * ow: m1 - r0 * ow]


def _requant_np(acc: np.ndarray, mult) -> np.ndarray:
    # float32 multiply + round-half-even: bit-identical to jnp.round in
    # quantize.requantize, the kernel epilogues, and the compiled JAX
    # executor (repro_torch.core.compiled) — the requant numerics are defined once.
    y = np.round(acc.astype(np.float32) * np.asarray(mult, np.float32))
    return np.clip(y, -128, 127).astype(np.int8)


def _sat_add(a: np.ndarray, b: np.ndarray, dtype) -> np.ndarray:
    s = a.astype(np.int32) + b.astype(np.int32)
    if np.dtype(dtype) == np.int8:
        return np.clip(s, -128, 127).astype(np.int8)
    return s.astype(dtype)


def _maxpool(x: np.ndarray, k: int, s: int, p: int) -> np.ndarray:
    fill = np.iinfo(x.dtype).min if np.issubdtype(x.dtype, np.integer) \
        else -np.inf
    xp = np.pad(x, ((p, p), (p, p), (0, 0)), constant_values=fill)
    H, W, C = xp.shape
    oh, ow = (H - k) // s + 1, (W - k) // s + 1
    out = np.full((oh, ow, C), fill, dtype=x.dtype)
    for di in range(k):
        for dj in range(k):
            out = np.maximum(out, xp[di:di + oh * s:s, dj:dj + ow * s:s, :])
    return out


def _avgpool(x: np.ndarray, k: int, s: int, p: int) -> np.ndarray:
    xp = np.pad(x, ((p, p), (p, p), (0, 0))).astype(np.int32)
    H, W, C = xp.shape
    oh, ow = (H - k) // s + 1, (W - k) // s + 1
    acc = np.zeros((oh, ow, C), dtype=np.int32)
    for di in range(k):
        for dj in range(k):
            acc += xp[di:di + oh * s:s, dj:dj + ow * s:s, :]
    out = np.round(acc / (k * k))
    return np.clip(out, -128, 127).astype(x.dtype)


_NP_DT = {"int8": np.int8, "int32": np.int32, "f32": np.float32,
          "bf16": np.float32, "int16": np.int16, "uint8": np.uint8}


def init_params(g: Graph, seed: int = 0) -> dict[str, np.ndarray]:
    """Random int8 weights + range-preserving requant multipliers."""
    rng = np.random.default_rng(seed)
    params: dict[str, np.ndarray] = {}
    for op in g.ops:
        for w in op.weights:
            spec = g.tensors[w]
            params[w] = rng.integers(-64, 64, size=spec.shape,
                                     endpoint=False).astype(np.int8)
        if op.kind == "requant":
            prod = g.producer_of(op.inputs[0])
            K = 1
            if prod is not None:
                pop = g.op(prod)
                if pop.kind == "gemm":
                    K = pop.attrs["K"]
                elif pop.kind == "conv2d":
                    K = pop.attrs["kh"] * pop.attrs["kw"] * pop.attrs["C_in"]
            params[f"{op.name}.mult"] = np.float32(0.03 / np.sqrt(K))
    return params


def params_from_reference(g: Graph, params: dict) -> dict[str, np.ndarray]:
    """Carry a parameter dict made by the JAX package (or any numpy source)
    across to the port: every weight and requant multiplier the graph
    needs, checked by name, shape and dtype, as fresh numpy arrays.

    Weights must be int8 of the weight tensor's shape; a multiplier
    ``"{op}.mult"`` must be float32, a scalar or one value per output
    channel. A missing, extra or mistyped entry raises ValueError.
    """
    expected: dict[str, tuple] = {}
    for op in g.ops:
        for w in op.weights:
            expected[w] = ("weight", g.tensors[w].shape)
        if op.kind == "requant":
            n = g.tensors[op.outputs[0]].shape[-1]
            expected[f"{op.name}.mult"] = ("mult", n)
    missing = sorted(set(expected) - set(params))
    extra = sorted(set(params) - set(expected))
    if missing or extra:
        raise ValueError(f"{g.name}: params do not match the graph "
                         f"(missing {missing}, unexpected {extra})")
    out: dict[str, np.ndarray] = {}
    for name, (kind, spec) in expected.items():
        v = np.asarray(params[name])
        if kind == "weight":
            if v.dtype != np.int8 or v.shape != tuple(spec):
                raise ValueError(f"{name}: expected int8 {tuple(spec)}, got "
                                 f"{v.dtype} {v.shape}")
        elif v.dtype != np.float32 or v.shape not in ((), (1,), (spec,)):
            raise ValueError(f"{name}: expected a float32 scalar or ({spec},)"
                             f", got {v.dtype} {v.shape}")
        out[name] = v.copy()
    return out


def _eval_op(op: OpNode, g: Graph, params: dict,
             vals: dict[str, np.ndarray]) -> np.ndarray:
    k = op.kind
    if k == "gemm":
        x = vals[op.inputs[0]].reshape(op.attrs["M"], op.attrs["K"])
        w = params[op.weights[0]]
        return (x.astype(np.int32) @ w.astype(np.int32)).astype(
            _NP_DT[g.tensors[op.outputs[0]].dtype])
    if k == "conv2d":
        a = op.attrs
        cols = im2col(vals[op.inputs[0]], a["kh"], a["kw"], a["stride"],
                      a["padding"])
        w = params[op.weights[0]]
        acc = cols.astype(np.int32) @ w.astype(np.int32)
        oh, ow = conv_out_hw(a)
        return acc.reshape(oh, ow, a["C_out"])
    if k == "requant":
        return _requant_np(vals[op.inputs[0]], params[f"{op.name}.mult"])
    if k == "relu":
        x = vals[op.inputs[0]]
        return np.maximum(x, 0)
    if k == "add":
        return _sat_add(vals[op.inputs[0]], vals[op.inputs[1]],
                        _NP_DT[g.tensors[op.outputs[0]].dtype])
    if k == "maxpool":
        a = op.attrs
        return _maxpool(vals[op.inputs[0]], a["k"], a["stride"],
                        a.get("padding", 0))
    if k == "avgpool":
        a = op.attrs
        return _avgpool(vals[op.inputs[0]], a["k"], a["stride"],
                        a.get("padding", 0))
    if k == "gap":
        x = vals[op.inputs[0]].astype(np.int32)
        m = np.round(x.mean(axis=(0, 1), keepdims=False))
        out = np.clip(m, -128, 127).astype(np.int8).reshape(1, -1)
        return out
    if k == "concat":
        return np.concatenate([vals[t] for t in op.inputs], axis=-1)
    raise NotImplementedError(f"op kind {k}")


def reference_forward(g: Graph, params: dict,
                      inputs: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    vals = dict(inputs)
    for op in g.ops:
        vals[op.outputs[0]] = _eval_op(op, g, params, vals)
    return vals


# -- schedule replay ----------------------------------------------------------

class ScheduleReplayer:
    """Tile-by-tile schedule interpreter with the per-call setup hoisted.

    Construction resolves, once, everything the seed ``execute_schedule``
    redid on every invocation: the compute-slot time ordering and the
    sid -> subtask / op-name -> op indirections. ``run`` then replays the
    pre-resolved (subtask, op) stream — repeated replays (serving loops,
    benchmarks) pay zero setup cost.

    This is the numerical *oracle*: semantics are identical to the seed
    interpreter, and `repro_torch.core.compiled` is validated against it (and
    against ``reference_forward``) bit-exactly.
    """

    def __init__(self, g: Graph, subtasks: list[Subtask], mapping: Mapping,
                 sched: StaticSchedule, im2col_fn=None):
        self.g = g
        self._src_key = (id(g), id(subtasks))
        self.im2col = im2col_fn or im2col
        by_id = {st.sid: st for st in subtasks}
        ops = {op.name: op for op in g.ops}
        order = sorted(sched.compute, key=lambda s: (s.start, s.sid))
        self.slots: list[tuple[Subtask, OpNode]] = [
            (by_id[s.sid], ops[by_id[s.sid].op_name]) for s in order]

    def run(self, params: dict,
            inputs: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        g = self.g
        bufs: dict[str, np.ndarray] = {}
        for name, spec in g.tensors.items():
            if name in inputs:
                bufs[name] = np.asarray(inputs[name], dtype=_NP_DT[spec.dtype])
            elif name in params:
                bufs[name] = params[name]
            else:
                bufs[name] = np.zeros(spec.shape, dtype=_NP_DT[spec.dtype])
        for st, op in self.slots:
            t = st.tile
            if st.kind == "gemm":
                m0, m1, n0, n1 = t["m0"], t["m1"], t["n0"], t["n1"]
                x = bufs[op.inputs[0]].reshape(op.attrs["M"], op.attrs["K"])
                w = bufs[op.weights[0]]
                acc = x[m0:m1].astype(np.int32) @ w[:, n0:n1].astype(np.int32)
                y = bufs[op.outputs[0]]
                y.reshape(op.attrs["M"], op.attrs["N"])[m0:m1, n0:n1] = acc
            elif st.kind == "conv2d":
                a = op.attrs
                m0, m1, n0, n1 = t["m0"], t["m1"], t["n0"], t["n1"]
                # expand only this tile's band: rows outside it may not have
                # been produced yet (see _im2col_band)
                cols = _im2col_band(bufs[op.inputs[0]], a, m0, m1,
                                    self.im2col)
                w = bufs[op.weights[0]]
                acc = cols.astype(np.int32) @ w[:, n0:n1].astype(np.int32)
                oh, ow = conv_out_hw(a)
                y = bufs[op.outputs[0]].reshape(oh * ow, a["C_out"])
                y[m0:m1, n0:n1] = acc
            elif st.kind in ("requant", "relu", "add"):
                r0, r1 = t["r0"], t["r1"]
                if st.kind == "requant":
                    bufs[op.outputs[0]][r0:r1] = _requant_np(
                        bufs[op.inputs[0]][r0:r1], params[f"{op.name}.mult"])
                elif st.kind == "relu":
                    bufs[op.outputs[0]][r0:r1] = np.maximum(
                        bufs[op.inputs[0]][r0:r1], 0)
                else:
                    bufs[op.outputs[0]][r0:r1] = _sat_add(
                        bufs[op.inputs[0]][r0:r1], bufs[op.inputs[1]][r0:r1],
                        bufs[op.outputs[0]].dtype)
            else:
                # windowed / global ops: evaluate on current buffers and keep
                # only this tile's rows — a whole-op cache at first touch
                # would snapshot rows other cores haven't produced yet
                vals = {tn: bufs[tn] for tn in op.inputs}
                full = _eval_op(op, g, params, vals)
                r0, r1 = t["r0"], t["r1"]
                bufs[op.outputs[0]][r0:r1] = full[r0:r1]
        return bufs


# One replayer per schedule object; schedules are long-lived in serving and
# benchmarks, so repeated execute_schedule calls skip all setup.
_REPLAYERS: "weakref.WeakKeyDictionary[StaticSchedule, ScheduleReplayer]" = \
    weakref.WeakKeyDictionary()


def execute_schedule(g: Graph, params: dict, inputs: dict[str, np.ndarray],
                     subtasks: list[Subtask], mapping: Mapping,
                     sched: StaticSchedule) -> dict[str, np.ndarray]:
    """Replay subtasks in schedule order, computing tile-by-tile."""
    rp = _REPLAYERS.get(sched)
    if rp is None or rp._src_key != (id(g), id(subtasks)):
        rp = ScheduleReplayer(g, subtasks, mapping, sched)
        _REPLAYERS[sched] = rp
    return rp.run(params, inputs)


def _execute_schedule_unprepared(
        g: Graph, params: dict, inputs: dict[str, np.ndarray],
        subtasks: list[Subtask], mapping: Mapping,
        sched: StaticSchedule) -> dict[str, np.ndarray]:
    """Seed-equivalent replay: per-call setup + loop im2col (benchmarks use
    this as the 'before' baseline; not part of the public API)."""
    return ScheduleReplayer(g, subtasks, mapping, sched,
                            im2col_fn=im2col_reference).run(params, inputs)
