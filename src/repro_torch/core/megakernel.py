"""Fused per-core megakernel pass over the kernel program plan.

The per-op kernel backend (`compiled.kernel_batched`) issues one launch per
gemm/conv batch -- dozens of launches per inference, each re-streaming its
operands. The paper's machine does the opposite: every core executes its
whole statically scheduled instruction stream out of local scratchpad. This
pass mirrors that structure on the compiled program:

  1. **Segmentation** (`plan_segments`, the JAX package's planner as it is):
     walk `_kernel_plan`'s steps in program order and greedily pack them
     into contiguous *segments* whose summed working set -- streamed
     operands counted twice on a dual-ported scratchpad plus the int32
     accumulator and output tile -- fits the modeled machine's scratchpad
     (`hw.scratchpad_bytes`). Each segment is assigned a core round-robin.
  2. **Emission**: every fused segment becomes ONE launch of K3
     (`csrc/megakernel.cu`), a step interpreter that replays the segment's
     steps in order over the whole batch, with the requant epilogues fused
     as the per-op plan decided. A single gemm/conv whose working set alone
     exceeds the scratchpad runs on K1/K2 (one launch); fallback-only steps
     that fit in no segment run as plain torch between launches.
  3. **Launch invariant**: the planner re-packs with a doubled budget until
     the program emits at most `num_cores` kernels (`max_kernels` override
     in `BackendOptions`). The kernel wrappers count their launches
     (`kernels.launch_counts`), so the invariant is checked on real
     launches (plain-version calls on the CPU).

The plan is the modeled machine's: on the H100 a fused segment's footprint
(1 MiB and up) does not fit a block's shared memory, so K3 tiles each step
across the grid and keeps the segment's intermediates in a device
workspace; the sanitizer's SPM rules still check the planned footprint.

Bit-exactness: every emission path uses the package's single requant
definition and exact int8 contractions, so the megakernel is bit-identical
to `run_numpy` / `reference_forward` on every supported graph.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from . import compiled as C
from .graph import conv_out_hw
from ..kernels import _lib
from ..kernels.gemm_int8 import dot_i32_exact, requant_epilogue
from ..kernels.ref import im2col_patches

_ITEM_BYTES = {"int8": 1, "uint8": 1, "int16": 2, "int32": 4,
               "f32": 4, "bf16": 2}

# fallback capacity when the program carries no hardware model: the paper
# machine's 1 MiB worker scratchpad
_DEFAULT_BUDGET = 1 << 20


@dataclasses.dataclass(frozen=True)
class Segment:
    """A contiguous run of plan steps with one execution strategy.

    kind: "fused"   — one K3 launch replaying all steps in order;
          "tiled"   — one oversized gemm/conv step on K1/K2 (one launch);
          "outside" — one plain-torch step executed between launches (no
                      kernel launch).
    """

    kind: str
    steps: tuple
    core: int = 0

    @property
    def emits_call(self) -> bool:
        return self.kind in ("fused", "tiled")


def _buffer_bytes(prog: C.CompiledProgram, idx: int) -> int:
    _, shape, dtype = prog.buffers[idx]
    n = 1
    for d in shape:
        n *= int(d)
    return n * _ITEM_BYTES[dtype]


def _step_bytes(prog: C.CompiledProgram, step, dual: bool) -> int:
    """Scratchpad residency of one step: streamed operands (inputs +
    weights, double-buffered when the scratchpad is dual-ported) + int32
    accumulator for matmul kinds + the output tile."""
    b = step.batch
    stream = sum(_buffer_bytes(prog, i) for i in b.in_idx)
    if b.w_idx is not None:
        stream += _buffer_bytes(prog, b.w_idx)
    if dual:
        stream *= 2
    acc = 0
    if b.kind in ("gemm", "conv2d"):
        _, shape, _ = prog.buffers[b.out_idx]
        n = 1
        for d in shape:
            n *= int(d)
        acc = 4 * n
    return stream + acc + _buffer_bytes(prog, step.out_idx)


def _pack(prog: C.CompiledProgram, plan, budget: int, dual: bool
          ) -> list[Segment]:
    segments: list[Segment] = []
    cur: list = []
    cur_bytes = 0

    def flush():
        nonlocal cur, cur_bytes
        if cur:
            segments.append(Segment("fused", tuple(cur)))
            cur, cur_bytes = [], 0

    for step in plan:
        if step.mode == "skip":      # requant folded into its producer
            continue
        sb = _step_bytes(prog, step, dual)
        if step.mode == "torch":
            # fallback ops ride inside a fused segment when they fit;
            # otherwise they run as plain torch (no kernel launch)
            if cur and cur_bytes + sb <= budget:
                cur.append(step)
                cur_bytes += sb
            else:
                flush()
                segments.append(Segment("outside", (step,)))
            continue
        if sb > budget:              # oversized gemm/conv: tiled kernel
            flush()
            segments.append(Segment("tiled", (step,)))
            continue
        if cur_bytes + sb <= budget:
            cur.append(step)
            cur_bytes += sb
        else:
            flush()
            cur, cur_bytes = [step], sb
    flush()
    return segments


def plan_segments(prog: C.CompiledProgram, *, budget: int | None = None,
                  max_kernels: int | None = None) -> list[Segment]:
    """Partition the kernel plan into <= `max_kernels` kernel-emitting
    segments (default: the program's core count).

    `budget` overrides the scratchpad capacity the packing uses
    (`BackendOptions.scratchpad_budget`); when the pack exceeds the kernel
    cap the budget doubles and packing reruns — larger segments, fewer
    launches — until the per-core invariant holds.
    """
    plan = C._kernel_plan(prog)
    hw = prog.hw
    cap = max_kernels if max_kernels is not None else max(1, prog.num_cores)
    b = budget if budget is not None else (
        hw.scratchpad_bytes if hw is not None else _DEFAULT_BUDGET)
    dual = hw.dual_ported if hw is not None else True
    while True:
        segments = _pack(prog, plan, b, dual)
        if sum(s.emits_call for s in segments) <= cap:
            break
        b *= 2
    cores = max(1, prog.num_cores)
    out = []
    n_call = 0
    for seg in segments:
        if seg.emits_call:
            out.append(dataclasses.replace(seg, core=n_call % cores))
            n_call += 1
        else:
            out.append(seg)
    return out


def segment_footprint(prog: C.CompiledProgram, seg: Segment,
                      dual: bool = True) -> int:
    """Scratchpad bytes a fused segment keeps resident: the sum of its
    steps' streamed operands, accumulators, and output tiles — exactly
    the quantity `_pack` budgets against. Public so the static analyzer
    (repro_torch.analysis) can check the packing instead of trusting it."""
    return sum(_step_bytes(prog, s, dual) for s in seg.steps)


def segment_io(prog: C.CompiledProgram, seg: Segment
               ) -> tuple[list[int], list[int], list[int]]:
    """Public alias of `_segment_io` for the static analyzer: the
    (streamed-in, weight, written-out) buffer indices of a segment."""
    return _segment_io(prog, seg)


def _segment_io(prog: C.CompiledProgram, seg: Segment
                ) -> tuple[list[int], list[int], list[int]]:
    """(external input idxs, weight idxs, output idxs) of a fused segment.

    Outputs are the produced buffers consumed by a later step outside the
    segment or that are graph outputs."""
    produced = {s.out_idx for s in seg.steps}
    ins: list[int] = []
    wids: list[int] = []
    for s in seg.steps:
        for i in s.batch.in_idx:
            if i not in produced and i not in ins:
                ins.append(i)
        w = s.batch.w_idx
        if w is not None and w not in wids:
            wids.append(w)
    graph_outs = set(prog.graph.outputs)
    consumed_outside: set[int] = set()
    for b in prog.batches:
        if b.op_idx in {s.batch.op_idx for s in seg.steps}:
            continue
        consumed_outside.update(b.in_idx)
    outs = [i for i in sorted(produced)
            if i in consumed_outside or prog.buffers[i][0] in graph_outs]
    return ins, wids, outs


# -- emission: plain version ---------------------------------------------------

def _emit_step(step, local: dict, consts: C.DeviceConsts,
               prog: C.CompiledProgram) -> None:
    """Execute one plan step on batched values (B, ...): local maps buffer
    idx -> tensor. The plain version of one K3 step."""
    b = step.batch
    a = b.attrs
    if step.mode in ("gemm", "conv2d"):
        x = local[b.in_idx[0]]
        B = x.shape[0]
        if step.mode == "gemm":
            cols = x.reshape(B * a["M"], a["K"])
        else:
            cols = im2col_patches(x, a["kh"], a["kw"], a["stride"],
                                  a["padding"])
            cols = cols.reshape(-1, a["kh"] * a["kw"] * a["C_in"])
        acc = dot_i32_exact(cols, consts.weights[b.w_idx])
        if step.mult is not None:
            out = requant_epilogue(acc, consts.mults[step.out_idx])
        else:
            out = acc.to(C._TORCH_DT[prog.buffers[step.out_idx][2]])
        local[step.out_idx] = out.reshape(C._out_shape(prog, step.out_idx,
                                                       B))
    else:                            # "torch": the shared per-op emitters
        local[b.out_idx] = C._torch_op(b, local, prog, consts)


def run_fused_plain(prog: C.CompiledProgram, seg: Segment, vals: list,
                    consts: C.DeviceConsts) -> None:
    """K3's plain version: replay the segment's steps, publish its outputs."""
    ins, _, outs = _segment_io(prog, seg)
    local = {i: vals[i] for i in ins}
    for step in seg.steps:
        _emit_step(step, local, consts, prog)
    for i in outs:
        vals[i] = local[i]


# -- emission: the K3 step table -------------------------------------------------

# Layout of one int64 row of the step table (csrc/megakernel.cu, `Field`).
ROW = 32
MAX_IO = 96
F_KIND, F_BARRIER = 0, 1
F_OUT, F_OUT_DT, F_OUT_BYTES = 2, 3, 4
F_IN0, F_IN0_DT, F_IN0_BYTES = 5, 6, 7
F_IN1, F_IN1_DT, F_IN1_BYTES = 8, 9, 10
F_W, F_MULT, F_MULT_LEN = 11, 12, 13
F_A = 14
KIND = {"gemm": 1, "conv2d": 2, "requant": 3, "relu": 4, "add": 5,
        "maxpool": 6, "avgpool": 7, "gap": 8, "copy_ch": 9}
_DT_CODE = {"int8": 0, "int32": 1}


@dataclasses.dataclass
class SegmentTable:
    """K3's launch data for one (program, segment, device): the step table
    on the device, the segment's external inputs/outputs (their order is the
    I/O slot order), the workspace bytes per sample, and the device tensors
    whose pointers the table holds (kept alive here)."""

    table: torch.Tensor
    n_rows: int
    ins: list[int]
    outs: list[int]
    ws_per_sample: int
    keep: list


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def build_segment_table(prog: C.CompiledProgram, seg: Segment,
                        consts: C.DeviceConsts, device) -> SegmentTable:
    """Lay out a fused segment for K3. Raises ValueError for what K3 does
    not execute (dtypes other than int8/int32, too many external buffers)."""
    ins, _, outs = _segment_io(prog, seg)
    io = {idx: k for k, idx in enumerate(ins + outs)}
    if len(io) > MAX_IO:
        raise ValueError(f"fused segment has {len(io)} external buffers; "
                         f"the megakernel takes at most {MAX_IO}")
    ws: dict[int, int] = {}
    ws_total = 0

    def loc(idx: int) -> int:
        nonlocal ws_total
        if idx in io:
            return -(io[idx] + 1)
        if idx not in ws:
            ws[idx] = ws_total
            ws_total += _round16(_buffer_bytes(prog, idx))
        return ws[idx]

    def dt(idx: int) -> int:
        name, _, dtype = prog.buffers[idx]
        if dtype not in _DT_CODE:
            raise ValueError(f"megakernel: buffer {name!r} has dtype "
                             f"{dtype}; the kernel takes int8 and int32")
        return _DT_CODE[dtype]

    def row(kind: str, out: int, in0: int, in1: int | None = None,
            w=None, mult=None, attrs=(), barrier: bool = True):
        r = [0] * ROW
        r[F_KIND] = KIND[kind]
        r[F_BARRIER] = int(barrier)
        r[F_OUT], r[F_OUT_DT] = loc(out), dt(out)
        r[F_OUT_BYTES] = _buffer_bytes(prog, out)
        r[F_IN0], r[F_IN0_DT] = loc(in0), dt(in0)
        r[F_IN0_BYTES] = _buffer_bytes(prog, in0)
        if in1 is not None:
            r[F_IN1], r[F_IN1_DT] = loc(in1), dt(in1)
            r[F_IN1_BYTES] = _buffer_bytes(prog, in1)
        if w is not None:
            r[F_W] = w.data_ptr()
        if mult is not None:
            r[F_MULT], r[F_MULT_LEN] = mult.data_ptr(), mult.numel()
        for k, v in enumerate(attrs):
            r[F_A + k] = int(v)
        return r

    rows, keep = [], []
    for step in seg.steps:
        b = step.batch
        a = b.attrs
        in_shape = tuple(prog.buffers[b.in_idx[0]][1])
        out_shape = tuple(prog.buffers[b.out_idx][1])
        if step.mode in ("gemm", "conv2d"):
            w = consts.weights[b.w_idx]
            mult = (None if step.mult is None
                    else consts.mults[step.out_idx])
            keep += [w] + ([] if mult is None else [mult])
            if step.mode == "gemm":
                attrs = (a["M"], a["K"], a["N"])
            else:
                oh, ow = conv_out_hw(a)
                attrs = (a["H"], a["W"], a["C_in"], a["C_out"], a["kh"],
                         a["kw"], a["stride"], a["padding"], oh, ow)
            rows.append(row(step.mode, step.out_idx, b.in_idx[0], w=w,
                            mult=mult, attrs=attrs))
        elif b.kind in ("requant", "relu", "add"):
            n_elem = int(np.prod(in_shape))
            mult = consts.mults[b.out_idx] if b.kind == "requant" else None
            keep += [] if mult is None else [mult]
            in1 = b.in_idx[1] if b.kind == "add" else None
            if in1 is not None and tuple(prog.buffers[in1][1]) != in_shape:
                raise ValueError(f"megakernel: add {b.name!r} of shapes "
                                 f"{in_shape} and {prog.buffers[in1][1]}")
            rows.append(row(b.kind, b.out_idx, b.in_idx[0], in1,
                            mult=mult, attrs=(n_elem, in_shape[-1])))
        elif b.kind in ("maxpool", "avgpool"):
            H, W, Cc = in_shape
            rows.append(row(b.kind, b.out_idx, b.in_idx[0], attrs=(
                H, W, Cc, a["k"], a["stride"], a.get("padding", 0),
                out_shape[0], out_shape[1])))
        elif b.kind == "gap":
            rows.append(row("gap", b.out_idx, b.in_idx[0], attrs=in_shape))
        elif b.kind == "concat":
            pix = int(np.prod(out_shape[:-1]))
            off = 0
            for j, i in enumerate(b.in_idx):
                ci = prog.buffers[i][1][-1]
                if dt(i) != dt(b.out_idx):
                    raise ValueError(f"megakernel: concat {b.name!r} mixes "
                                     "dtypes")
                rows.append(row("copy_ch", b.out_idx, i, attrs=(
                    pix, ci, out_shape[-1], off),
                    barrier=j == len(b.in_idx) - 1))
                off += ci
        else:
            raise ValueError(f"megakernel: no step for op kind {b.kind!r}")
    table = torch.tensor(rows, dtype=torch.int64).to(device)
    return SegmentTable(table=table, n_rows=len(rows), ins=ins, outs=outs,
                        ws_per_sample=ws_total, keep=keep)


def _max_grid(device) -> int:
    """Cooperative grid size: at most the co-resident blocks, and at most
    two blocks per SM (more blocks only lengthen every barrier)."""
    lib = _lib.load("megakernel")
    n = ctypes.c_int(0)
    _lib.check(lib, lib.megakernel_max_grid(ctypes.byref(n)),
               "megakernel_max_grid")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(n.value, 2 * sms))


def run_fused(prog: C.CompiledProgram, seg: Segment, vals: list,
              consts: C.DeviceConsts, tab: SegmentTable | None = None
              ) -> None:
    """One fused segment: one K3 launch on CUDA tensors (`tab` from
    `build_segment_table`), its plain version on CPU tensors. Counts one
    launch either way."""
    _lib.count_launch("megakernel")
    ins = tab.ins if tab is not None else _segment_io(prog, seg)[0]
    device = vals[ins[0]].device     # a segment always reads from outside
    if device.type == "cpu":
        run_fused_plain(prog, seg, vals, consts)
        return
    if device.type != "cuda" or tab is None:
        raise ValueError(f"megakernel: no kernel launch on {device} "
                         "without a step table")
    B = vals[ins[0]].shape[0]
    ptrs = []
    for i in tab.ins:
        v = vals[i]
        if (v.device != device or not v.is_contiguous()
                or v.dtype != C._TORCH_DT[prog.buffers[i][2]]
                or tuple(v.shape) != C._out_shape(prog, i, B)):
            raise ValueError(f"megakernel: input {prog.buffers[i][0]!r} is "
                             f"{v.dtype} {tuple(v.shape)} on {v.device}")
        ptrs.append(v.data_ptr())
    outs = []
    for i in tab.outs:
        o = torch.empty(C._out_shape(prog, i, B), device=device,
                        dtype=C._TORCH_DT[prog.buffers[i][2]])
        outs.append(o)
        ptrs.append(o.data_ptr())
    ws = torch.empty(max(16, tab.ws_per_sample * B), dtype=torch.uint8,
                     device=device)
    bar = torch.empty(2, dtype=torch.int32, device=device)
    io = (ctypes.c_int64 * len(ptrs))(*ptrs)
    lib = _lib.load("megakernel")
    grid = prog._device_cache.get(("mk_grid", str(device)))
    if grid is None:
        grid = prog._device_cache[("mk_grid", str(device))] = \
            _max_grid(device)
    err = lib.megakernel_launch(tab.table.data_ptr(), tab.n_rows, io,
                                len(ptrs), ws.data_ptr(), B, bar.data_ptr(),
                                grid, _lib.stream_ptr(ws))
    _lib.check(lib, err, "megakernel")
    for i, o in zip(tab.outs, outs):
        vals[i] = o


def megakernel_batched(prog: C.CompiledProgram, device="cuda", *,
                       budget: int | None = None,
                       max_kernels: int | None = None):
    """The megakernel program over a natively batched leading axis (the
    "cuda" backend's default serving step): {input: (B,...)} -> {output:
    (B,...)}. Built once per (program, device, budget, max_kernels)."""
    dev = C.resolve_device(device)
    key = ("mega", str(dev), budget, max_kernels)
    fn = prog._device_cache.get(key)
    if fn is None:
        segments = plan_segments(prog, budget=budget,
                                 max_kernels=max_kernels)
        consts = C.device_consts(prog, dev)
        tables = {si: build_segment_table(prog, seg, consts, dev)
                  for si, seg in enumerate(segments)
                  if seg.kind == "fused" and dev.type == "cuda"}

        def body(vals):
            for si, seg in enumerate(segments):
                if seg.kind == "fused":
                    run_fused(prog, seg, vals, consts, tables.get(si))
                elif seg.kind == "tiled":
                    C.run_kernel_step(prog, seg.steps[0], vals, consts)
                else:                # "outside": plain torch, no launch
                    b = seg.steps[0].batch
                    vals[b.out_idx] = C._torch_op(b, vals, prog, consts)

        fn = prog._device_cache[key] = C._program_fn(prog, body)
    return fn


def run_megakernel(prog: C.CompiledProgram, inputs: dict,
                   batched: bool = False, device="cuda", **plan) -> dict:
    """Convenience wrapper: numpy in, numpy out (one unbatched sample
    unless `batched`)."""
    dev = C.resolve_device(device)
    fn = megakernel_batched(prog, dev, **plan)
    return C.to_numpy(fn(C.to_device(prog, inputs, dev, batched)), batched)
