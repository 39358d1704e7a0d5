"""Compiled schedule executor: lower a StaticSchedule once, replay it fast.

The interpreter in `repro_torch.core.executor` replays the schedule
subtask-by-subtask through Python dict lookups -- the right *oracle*, but
slow. This module lowers a compiled network `(graph, subtasks, mapping,
schedule)` **once** into a `CompiledProgram`:

  * **per-core instruction streams** -- every compute slot resolved to flat
    buffer indices, tile bounds, and (for requant) the multiplier, in core
    order: the management/worker-core programs the paper's step 7 emits;
  * **fused per-op tile batches** -- each op's tile set, verified at lowering
    time to exactly cover the op's output. Because tiles of one op are
    independent and `Graph.validate()` guarantees topological op order,
    executing each op's whole tile batch as one call in graph order computes
    bit-identical values to any dependency-respecting tile-by-tile replay.

Backends over the lowered program:

  * ``run_numpy``     -- vectorized numpy replay (im2col + one GEMM per op);
    bit-exact vs ``reference_forward`` and the interpreter.
  * ``torch_batched`` -- the whole program as one torch function over a
    natively batched leading axis, on the CPU or a GPU. Its int8 GEMMs and
    convolutions are plain products outside any kernel (float32 with K cut
    at 1024, exact; see `kernels.ref.matmul_i32`), its conv is an unfold
    plus that product. Requant is float32 round-half-even, avgpool/gap use
    integer round-half-even division (`kernels.ref.round_half_even_div`).
  * ``kernel_batched`` -- the per-op kernel path: every gemm/conv batch on
    the hand-written CUDA kernels K1/K2 (`kernels.gemm_int8`,
    `kernels.conv2d_im2col`), with a gemm/conv -> requant chain fused into
    the kernel epilogue whenever the int32 accumulator has no other
    consumer. Other op kinds run as plain torch between launches. On CPU
    tensors the wrappers take the kernels' plain versions.

Programs are cached per graph *signature* (structural hash) so serving
engines compile each distinct network once per process.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict

import numpy as np
import torch

from .graph import Graph, conv_out_hw
from .mapping import Mapping, map_reverse_affinity
from .partition import Partitioner, Subtask
from .schedule import StaticSchedule, compute_schedule
from .executor import (_NP_DT, _avgpool, _maxpool, _requant_np, _sat_add,
                       im2col)
from ..hw import HardwareModel, derive_conv_blocks, derive_gemm_blocks
from ..kernels import ref as kref
from ..kernels.conv2d_im2col import conv2d_int8
from ..kernels.gemm_int8 import gemm_int8

# "bf16" buffers hold float32 values, as in the JAX package's lowering
_TORCH_DT = {"int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
             "int32": torch.int32, "f32": torch.float32,
             "bf16": torch.float32}


class CompileError(ValueError):
    pass


# Op kinds both backends lower; matches the executor oracle's coverage.
SUPPORTED_KINDS = frozenset({"gemm", "conv2d", "requant", "relu", "add",
                             "maxpool", "avgpool", "gap", "concat"})


def supports_graph(g: Graph) -> bool:
    """True iff every op kind has a compiled lowering (e.g. LM decode graphs
    with analysis-only kinds like "mul" are schedulable but not executable —
    same coverage as the interpreter oracle)."""
    return all(op.kind in SUPPORTED_KINDS for op in g.ops)


@dataclasses.dataclass(frozen=True)
class TileInstr:
    """One compute slot, fully pre-resolved (per-core program entry)."""

    sid: int
    core: int
    start: float
    end: float
    op_idx: int                  # position in CompiledProgram.batches
    kind: str
    bounds: tuple[int, ...]      # (m0, m1, n0, n1) | (r0, r1)


@dataclasses.dataclass
class OpBatch:
    """One op's fused tile batch: buffer indices + the full tile set."""

    op_idx: int
    name: str
    kind: str
    in_idx: tuple[int, ...]
    w_idx: int | None
    out_idx: int
    attrs: dict
    mult: np.ndarray | None      # pre-resolved requant multiplier
    tiles: np.ndarray            # (T, 4) gemm/conv | (T, 2) row ops


@dataclasses.dataclass(eq=False)
class CompiledProgram:
    """A StaticSchedule lowered for replay (see module docstring)."""

    graph: Graph
    signature: str
    num_cores: int
    makespan: float
    buffers: list[tuple[str, tuple, str]]   # (name, shape, dtype)
    index: dict[str, int]
    input_idx: dict[str, int]
    output_idx: dict[str, int]
    weights: dict[int, np.ndarray]          # buffer idx -> baked weight
    batches: list[OpBatch]                  # graph (topological) order
    core_streams: list[list[TileInstr]]
    hw: HardwareModel | None = None         # SPM model for the kernel plan
    # device tensors (weights, multipliers, step tables) and built runners,
    # keyed by (what, device): rebuilt lazily, never pickled
    _device_cache: dict = dataclasses.field(default_factory=dict,
                                            repr=False)

    @property
    def num_instructions(self) -> int:
        return sum(len(s) for s in self.core_streams)

    # Programs are serializable (repro_torch.compiler.Deployment.save): the
    # device cache holds device tensors and closures that must not reach a
    # pickle; it is rebuilt lazily on first use after load.
    def __getstate__(self):
        state = self.__dict__.copy()
        state["_device_cache"] = {}
        return state


# -- signatures + cache -------------------------------------------------------

def graph_signature(g: Graph) -> str:
    """Structural hash: identical for structurally identical graphs (the
    program-cache key for serving engines)."""
    h = hashlib.sha256()
    for name, t in g.tensors.items():
        h.update(f"T|{name}|{t.shape}|{t.dtype}\n".encode())
    for op in g.ops:
        h.update(f"O|{op.name}|{op.kind}|{op.inputs}|{op.outputs}|"
                 f"{op.weights}|{sorted(op.attrs.items())}\n".encode())
    h.update(f"I|{g.inputs}|{g.outputs}\n".encode())
    return h.hexdigest()[:16]


# key -> (params, program). The params dict is kept in the entry on
# purpose: it pins the dict alive so its id() (part of the key) can never
# be recycled by a different params dict, which would otherwise make a
# fresh dict at the same address silently hit a stale program with the old
# baked weights.
_PROGRAM_CACHE: "OrderedDict[tuple, tuple[dict, CompiledProgram]]" = \
    OrderedDict()
_PROGRAM_CACHE_CAP = 64          # bounds baked-weight memory in long servers

# Dependent caches (e.g. repro_torch.compiler's deployment cache) register a
# clearer here so `clear_program_cache()` is the single cache-reset entry
# point for the whole compile pipeline.
_CACHE_CLEAR_HOOKS: list = []


def clear_program_cache() -> None:
    """Drop every cached compiled program — and, via registered hooks, any
    dependent cache (the `repro_torch.compile` deployment cache)."""
    _PROGRAM_CACHE.clear()
    for hook in _CACHE_CLEAR_HOOKS:
        hook()


def compile_graph(g: Graph, params: dict, hw: HardwareModel,
                  num_cores: int | None = None, *,
                  use_cache: bool = True) -> CompiledProgram:
    """Full pipeline + lowering: partition -> map -> schedule -> lower.

    Cached (LRU, bounded) on (graph signature, params identity, machine
    fingerprint, cores): a serving engine replaying many jobs of the same
    network compiles it once.
    """
    key = (graph_signature(g), id(params), hw.fingerprint(), num_cores)
    if use_cache:
        hit = _PROGRAM_CACHE.get(key)
        if hit is not None and hit[0] is params:
            _PROGRAM_CACHE.move_to_end(key)
            return hit[1]
    part = Partitioner(hw)
    subtasks = part.partition(g)
    mapping = map_reverse_affinity(subtasks, hw, num_cores)
    sched = compute_schedule(subtasks, mapping, hw)
    prog = lower_program(g, params, subtasks, mapping, sched, hw=hw)
    if use_cache:
        _PROGRAM_CACHE[key] = (params, prog)
        while len(_PROGRAM_CACHE) > _PROGRAM_CACHE_CAP:
            _PROGRAM_CACHE.popitem(last=False)
    return prog


# -- lowering -----------------------------------------------------------------

def _op_rows(g: Graph, op) -> int:
    return g.tensors[op.outputs[0]].shape[0]


def lower_program(g: Graph, params: dict, subtasks: list[Subtask],
                  mapping: Mapping, sched: StaticSchedule,
                  hw: HardwareModel | None = None) -> CompiledProgram:
    """Lower one scheduled network into a CompiledProgram.

    `hw` (optional) records the scratchpad model the kernel plan derives
    its block metadata and the megakernel planner its budget from."""
    index = {name: i for i, name in enumerate(g.tensors)}
    buffers = [(t.name, t.shape, t.dtype) for t in g.tensors.values()]
    op_pos = {op.name: i for i, op in enumerate(g.ops)}
    by_id = {st.sid: st for st in subtasks}

    # per-core instruction streams in slot time order (the emitted program)
    core_streams: list[list[TileInstr]] = [[] for _ in
                                           range(mapping.num_cores)]
    tiles_of: dict[str, list[tuple[int, ...]]] = {op.name: [] for op in g.ops}
    for slot in sorted(sched.compute, key=lambda s: (s.start, s.sid)):
        st = by_id[slot.sid]
        t = st.tile
        if st.kind in ("gemm", "conv2d"):
            bounds = (t["m0"], t["m1"], t["n0"], t["n1"])
        else:
            bounds = (t["r0"], t["r1"])
        tiles_of[st.op_name].append(bounds)
        core_streams[slot.core].append(TileInstr(
            sid=st.sid, core=slot.core, start=slot.start, end=slot.end,
            op_idx=op_pos[st.op_name], kind=st.kind, bounds=bounds))

    batches: list[OpBatch] = []
    weights: dict[int, np.ndarray] = {}
    for op in g.ops:
        tiles = np.array(sorted(tiles_of[op.name]), dtype=np.int64)
        if tiles.size == 0:
            raise CompileError(f"{op.name}: no scheduled subtasks")
        # fused execution is only valid if the tile set covers the output
        if op.kind in ("gemm", "conv2d"):
            if op.kind == "gemm":
                M, N = op.attrs["M"], op.attrs["N"]
            else:
                oh, ow = conv_out_hw(op.attrs)
                M, N = oh * ow, op.attrs["C_out"]
            area = int(((tiles[:, 1] - tiles[:, 0])
                        * (tiles[:, 3] - tiles[:, 2])).sum())
            if area != M * N:
                raise CompileError(
                    f"{op.name}: tiles cover {area} of {M * N} elements")
        else:
            rows = int((tiles[:, 1] - tiles[:, 0]).sum())
            if rows != _op_rows(g, op):
                raise CompileError(
                    f"{op.name}: tiles cover {rows} of "
                    f"{_op_rows(g, op)} rows")
        w_idx = index[op.weights[0]] if op.weights else None
        if w_idx is not None:
            weights[w_idx] = params[op.weights[0]]
        # scalar or per-channel (N,) multiplier — both broadcast in requant
        mult = (np.asarray(params[f"{op.name}.mult"], np.float32)
                if op.kind == "requant" else None)
        batches.append(OpBatch(
            op_idx=op_pos[op.name], name=op.name, kind=op.kind,
            in_idx=tuple(index[t] for t in op.inputs), w_idx=w_idx,
            out_idx=index[op.outputs[0]], attrs=op.attrs, mult=mult,
            tiles=tiles))

    return CompiledProgram(
        graph=g, signature=graph_signature(g),
        num_cores=mapping.num_cores, makespan=sched.makespan,
        buffers=buffers, index=index,
        input_idx={t: index[t] for t in g.inputs},
        output_idx={t: index[t] for t in g.outputs},
        weights=weights, batches=batches, core_streams=core_streams,
        hw=hw)


# -- mesh partitioning --------------------------------------------------------

def partition_streams(prog: CompiledProgram,
                      n_groups: int) -> list[dict[int, np.ndarray]]:
    """Split the per-core instruction streams into `n_groups` contiguous
    core blocks — the mesh-model-axis decomposition the cluster package's
    mesh executor runs (device d of the model axis runs core block d).

    Returns one `{op_idx: tiles}` dict per group, where `tiles` is the
    (T, 4) / (T, 2) bounds array of every tile the group's cores were
    scheduled to run for that op. Because the lowering already verified
    that each op's full tile set exactly covers its output, the union of
    the per-group tile sets is exact and disjoint: summing the groups'
    partial results (an all-reduce over the model axis) reconstructs the
    single-device value bit-for-bit for the integer accumulation paths.
    """
    if n_groups < 1:
        raise CompileError(f"n_groups must be >= 1, got {n_groups}")
    if prog.num_cores % n_groups != 0:
        raise CompileError(
            f"cannot partition {prog.num_cores} core streams into "
            f"{n_groups} mesh groups: group count must divide the "
            f"core count")
    per = prog.num_cores // n_groups
    raw: list[dict[int, list[tuple[int, ...]]]] = [
        {} for _ in range(n_groups)]
    for core, stream in enumerate(prog.core_streams):
        g = core // per
        for ins in stream:
            raw[g].setdefault(ins.op_idx, []).append(ins.bounds)
    return [{op_idx: np.array(sorted(tiles), dtype=np.int64)
             for op_idx, tiles in group.items()}
            for group in raw]


# -- numpy backend ------------------------------------------------------------

_GEMM_CHUNK = 8192               # rows per BLAS call (bounds temp memory)


def gemm_i32_exact(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Bit-exact int8 GEMM through float BLAS.

    numpy routes integer matmul through a slow non-BLAS kernel; float matmul
    hits BLAS. For int8 operands every product is <= 2^14, so partial sums
    stay exactly representable in f32 while K * 2^14 <= 2^24 (K <= 1024) and
    in f64 always (< 2^53) — accumulation order therefore cannot change the
    result, and the round-trip is exact. Falls back to the integer path for
    non-int8 operands.
    """
    if x.dtype != np.int8 or w.dtype != np.int8:
        return x.astype(np.int32) @ w.astype(np.int32)
    K = x.shape[1]
    dt = np.float32 if K <= 1024 else np.float64
    wf = w.astype(dt)
    M = x.shape[0]
    if M <= _GEMM_CHUNK:
        return (x.astype(dt) @ wf).astype(np.int32)
    out = np.empty((M, w.shape[1]), np.int32)
    for m0 in range(0, M, _GEMM_CHUNK):
        m1 = min(M, m0 + _GEMM_CHUNK)
        out[m0:m1] = (x[m0:m1].astype(dt) @ wf).astype(np.int32)
    return out


def run_numpy(prog: CompiledProgram,
              inputs: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Vectorized replay: each op's fused tile batch as one kernel call.

    Bit-exact vs ``reference_forward`` and the schedule interpreter (same
    primitives: sliding-window im2col, int32 GEMM, f32 round-half-even
    requant).
    """
    vals: list = [None] * len(prog.buffers)
    for name, i in prog.input_idx.items():
        vals[i] = np.asarray(inputs[name], dtype=_NP_DT[prog.buffers[i][2]])
    for i, w in prog.weights.items():
        vals[i] = w
    for b in prog.batches:
        a = b.attrs
        if b.kind == "gemm":
            x = vals[b.in_idx[0]].reshape(a["M"], a["K"])
            acc = gemm_i32_exact(x, vals[b.w_idx])
            out = acc.astype(_NP_DT[prog.buffers[b.out_idx][2]])
        elif b.kind == "conv2d":
            cols = im2col(vals[b.in_idx[0]], a["kh"], a["kw"], a["stride"],
                          a["padding"])
            acc = gemm_i32_exact(cols, vals[b.w_idx])
            oh, ow = conv_out_hw(a)
            out = acc.reshape(oh, ow, a["C_out"])
        elif b.kind == "requant":
            out = _requant_np(vals[b.in_idx[0]], b.mult)
        elif b.kind == "relu":
            out = np.maximum(vals[b.in_idx[0]], 0)
        elif b.kind == "add":
            out = _sat_add(vals[b.in_idx[0]], vals[b.in_idx[1]],
                           _NP_DT[prog.buffers[b.out_idx][2]])
        elif b.kind == "maxpool":
            out = _maxpool(vals[b.in_idx[0]], a["k"], a["stride"],
                           a.get("padding", 0))
        elif b.kind == "avgpool":
            out = _avgpool(vals[b.in_idx[0]], a["k"], a["stride"],
                           a.get("padding", 0))
        elif b.kind == "gap":
            x = vals[b.in_idx[0]].astype(np.int32)
            m = np.round(x.mean(axis=(0, 1)))
            out = np.clip(m, -128, 127).astype(np.int8).reshape(1, -1)
        elif b.kind == "concat":
            out = np.concatenate([vals[i] for i in b.in_idx], axis=-1)
        else:
            raise CompileError(f"op kind {b.kind} not lowered")
        vals[b.out_idx] = out
    return {name: vals[i] for name, i in prog.index.items()
            if vals[i] is not None}


# -- devices ------------------------------------------------------------------

def resolve_device(device="cuda") -> torch.device:
    """The torch device a runner executes on. "cuda" (the default of every
    entry point) needs a GPU: without one this raises rather than run on the
    CPU. Pass "cpu" to run the plain versions on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch sees no CUDA "
                "device; pass device='cpu' to run on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} "
                         "(expected 'cuda' or 'cpu')")
    return dev


@dataclasses.dataclass
class DeviceConsts:
    """A program's baked constants on one device: weights by buffer index,
    requant multipliers (f32, 1 or N values) by the requant's output buffer
    index."""

    weights: dict[int, torch.Tensor]
    mults: dict[int, torch.Tensor]


def device_consts(prog: CompiledProgram, device: torch.device
                  ) -> DeviceConsts:
    key = ("consts", str(device))
    consts = prog._device_cache.get(key)
    if consts is None:
        consts = DeviceConsts(
            weights={i: torch.as_tensor(np.ascontiguousarray(w)).to(device)
                     for i, w in prog.weights.items()},
            mults={b.out_idx: torch.as_tensor(
                       np.asarray(b.mult, np.float32).reshape(-1)).to(device)
                   for b in prog.batches if b.kind == "requant"})
        prog._device_cache[key] = consts
    return consts


def to_device(prog: CompiledProgram, inputs: dict, device: torch.device,
              batched: bool = True) -> dict[str, torch.Tensor]:
    """numpy inputs -> device tensors of the buffers' dtypes, with a
    leading batch axis (added when `batched` is False)."""
    out = {}
    for name, i in prog.input_idx.items():
        v = torch.as_tensor(np.asarray(inputs[name],
                                       _NP_DT[prog.buffers[i][2]]))
        v = v.to(device)
        out[name] = v if batched else v[None]
    return out


def to_numpy(out: dict[str, torch.Tensor], batched: bool = True
             ) -> dict[str, np.ndarray]:
    return {k: (v if batched else v[0]).cpu().numpy()
            for k, v in out.items()}


# -- torch backend ------------------------------------------------------------

def _out_shape(prog: CompiledProgram, idx: int, B: int) -> tuple:
    return (B,) + tuple(prog.buffers[idx][1])


def _torch_op(b: OpBatch, vals: list, prog: CompiledProgram,
              consts: DeviceConsts) -> torch.Tensor:
    """One op batch as plain torch over a leading batch axis (B, ...)."""
    a = b.attrs
    x = vals[b.in_idx[0]]
    B = x.shape[0]
    if b.kind == "gemm":
        acc = kref.matmul_i32(x.reshape(B * a["M"], a["K"]),
                              consts.weights[b.w_idx])
        return acc.reshape(_out_shape(prog, b.out_idx, B)).to(
            _TORCH_DT[prog.buffers[b.out_idx][2]])
    if b.kind == "conv2d":
        return kref.conv2d_int8_general(
            x, consts.weights[b.w_idx], a["kh"], a["kw"], a["stride"],
            a["padding"])
    if b.kind == "requant":
        return kref.requant(x, consts.mults[b.out_idx])
    if b.kind == "relu":
        return torch.clamp(x, min=0)
    if b.kind == "add":
        s = x.to(torch.int32) + vals[b.in_idx[1]].to(torch.int32)
        dt = _TORCH_DT[prog.buffers[b.out_idx][2]]
        if dt == torch.int8:
            return torch.clamp(s, -128, 127).to(torch.int8)
        return s.to(dt)
    if b.kind == "maxpool":
        k, s, p = a["k"], a["stride"], a.get("padding", 0)
        fill = torch.iinfo(x.dtype).min
        xp = kref.pad_hw(x, p, fill)
        H, W = xp.shape[1], xp.shape[2]
        oh, ow = (H - k) // s + 1, (W - k) // s + 1
        out = None
        for di in range(k):
            for dj in range(k):
                win = xp[:, di:di + oh * s:s, dj:dj + ow * s:s, :]
                out = win if out is None else torch.maximum(out, win)
        return out.contiguous()
    if b.kind == "avgpool":
        k, s, p = a["k"], a["stride"], a.get("padding", 0)
        xp = kref.pad_hw(x, p, 0).to(torch.int32)
        H, W = xp.shape[1], xp.shape[2]
        oh, ow = (H - k) // s + 1, (W - k) // s + 1
        acc = torch.zeros((B, oh, ow, x.shape[3]), dtype=torch.int32,
                          device=x.device)
        for di in range(k):
            for dj in range(k):
                acc = acc + xp[:, di:di + oh * s:s, dj:dj + ow * s:s, :]
        out = kref.round_half_even_div(acc, k * k)
        return torch.clamp(out, -128, 127).to(x.dtype)
    if b.kind == "gap":
        H, W = x.shape[1], x.shape[2]
        s = x.to(torch.int32).sum(dim=(1, 2))
        m = kref.round_half_even_div(s, H * W)
        return torch.clamp(m, -128, 127).to(torch.int8).reshape(B, 1, -1)
    if b.kind == "concat":
        return torch.cat([vals[i] for i in b.in_idx], dim=-1)
    raise CompileError(f"op kind {b.kind} not lowered")


def _program_fn(prog: CompiledProgram, body):
    """{input: (B, ...)} -> {output: (B, ...)} over `body(vals)`."""
    def run(inputs: dict) -> dict:
        vals: list = [None] * len(prog.buffers)
        for name, i in prog.input_idx.items():
            vals[i] = inputs[name]
        body(vals)
        return {name: vals[i] for name, i in prog.output_idx.items()}
    return run


def torch_batched(prog: CompiledProgram, device="cuda"):
    """The whole program as one torch function over a natively batched
    leading axis: {input: (B,H,W,C)} -> {output: (B, ...)}, on `device`.
    Built once per (program, device)."""
    dev = resolve_device(device)
    key = ("torch", str(dev))
    fn = prog._device_cache.get(key)
    if fn is None:
        consts = device_consts(prog, dev)

        def body(vals):
            for b in prog.batches:
                vals[b.out_idx] = _torch_op(b, vals, prog, consts)

        fn = prog._device_cache[key] = _program_fn(prog, body)
    return fn


def torch_single(prog: CompiledProgram, device="cuda"):
    """Single-sample form of `torch_batched`: {input: (H,W,C)} -> {...}."""
    batched = torch_batched(prog, device)

    def single(inputs: dict) -> dict:
        out = batched({k: v[None] for k, v in inputs.items()})
        return {k: v[0] for k, v in out.items()}
    return single


def run_torch(prog: CompiledProgram, inputs: dict[str, np.ndarray],
              batched: bool = True, device="cuda") -> dict[str, np.ndarray]:
    """Convenience wrapper: numpy in, numpy out (synchronous)."""
    dev = resolve_device(device)
    out = torch_batched(prog, dev)(to_device(prog, inputs, dev, batched))
    return to_numpy(out, batched)


# -- kernel backend (per-op path) ---------------------------------------------

# Op kinds with a kernel lowering; everything else runs as plain torch
# between launches.
KERNEL_KINDS = frozenset({"gemm", "conv2d"})


@dataclasses.dataclass(frozen=True)
class _KernelStep:
    """One op of the kernel-backend program plan.

    mode: "gemm" / "conv2d" (kernel), "torch" (plain torch between
    launches), or "skip" (a requant batch fused into the preceding kernel's
    epilogue). `blocks` is the scratchpad-derived tiling of the modeled
    machine: plan metadata for the sanitizer, not the CUDA tiles.
    """

    mode: str
    batch: OpBatch
    out_idx: int                 # where the result lands (fused: requant out)
    mult: np.ndarray | None      # fused requant multiplier, else None
    blocks: tuple                # (bm, bn, bk) gemm | (rows_t, bn) conv


def _fusable_requant(prog: CompiledProgram, b: OpBatch) -> OpBatch | None:
    """The requant batch to fold into `b`'s kernel epilogue, if legal.

    Legal iff b's int32 output feeds exactly one consumer, that consumer is
    a requant op, and the accumulator is not itself a graph output -- then
    requantization in the epilogue is observationally identical to running
    the requant batch afterwards (the epilogue shares the oracle's
    round-half-even numerics).
    """
    out_name = prog.buffers[b.out_idx][0]
    if out_name in prog.graph.outputs:
        return None
    consumers = prog.graph.consumers_of(out_name)
    if len(consumers) != 1 or consumers[0].kind != "requant":
        return None
    (rq,) = consumers
    for cand in prog.batches:
        if cand.name == rq.name:
            return cand
    return None


def _kernel_plan(prog: CompiledProgram) -> list[_KernelStep]:
    """Decide, once per program, how each fused tile batch lowers onto the
    kernels: kernel vs plain torch, epilogue fusion, and SPM-derived block
    metadata. The same decisions as the JAX package's `_pallas_plan`."""
    plan: list[_KernelStep] = []
    skipped: set[int] = set()
    for b in prog.batches:
        if b.op_idx in skipped:
            plan.append(_KernelStep("skip", b, b.out_idx, None, ()))
            continue
        if b.kind not in KERNEL_KINDS:
            plan.append(_KernelStep("torch", b, b.out_idx, None, ()))
            continue
        rq = _fusable_requant(prog, b)
        out_idx = rq.out_idx if rq is not None else b.out_idx
        mult = rq.mult if rq is not None else None
        out_bytes = 1 if rq is not None else 4
        a = b.attrs
        if b.kind == "gemm":
            blocks = (derive_gemm_blocks(prog.hw, a["M"], a["K"], a["N"],
                                         out_bytes)
                      if prog.hw is not None else (128, 128, 128))
        else:
            blocks = (derive_conv_blocks(prog.hw, a, out_bytes)
                      if prog.hw is not None else (8, 128))
        if rq is not None:
            skipped.add(rq.op_idx)
        plan.append(_KernelStep(b.kind, b, out_idx, mult, blocks))
    return plan


def run_kernel_step(prog: CompiledProgram, step: _KernelStep, vals: list,
                    consts: DeviceConsts) -> None:
    """One gemm/conv plan step on K1/K2, epilogue fused as planned."""
    b = step.batch
    a = b.attrs
    x = vals[b.in_idx[0]]
    B = x.shape[0]
    mult = None if step.mult is None else consts.mults[step.out_idx]
    if step.mode == "gemm":
        out = gemm_int8(x.reshape(B, a["M"], a["K"]),
                        consts.weights[b.w_idx], mult)
        if step.mult is None:
            out = out.to(_TORCH_DT[prog.buffers[step.out_idx][2]])
        vals[step.out_idx] = out.reshape(_out_shape(prog, step.out_idx, B))
    else:
        vals[step.out_idx] = conv2d_int8(
            x, consts.weights[b.w_idx], mult, kh=a["kh"], kw=a["kw"],
            stride=a["stride"], padding=a["padding"])


def kernel_batched(prog: CompiledProgram, device="cuda"):
    """The per-op kernel program over a natively batched leading axis: one
    K1/K2 launch per gemm/conv batch. Built once per (program, device)."""
    dev = resolve_device(device)
    key = ("kernel", str(dev))
    fn = prog._device_cache.get(key)
    if fn is None:
        plan = _kernel_plan(prog)
        consts = device_consts(prog, dev)

        def body(vals):
            for step in plan:
                if step.mode == "skip":
                    continue             # fused into the previous kernel
                if step.mode == "torch":
                    b = step.batch
                    vals[b.out_idx] = _torch_op(b, vals, prog, consts)
                else:
                    run_kernel_step(prog, step, vals, consts)

        fn = prog._device_cache[key] = _program_fn(prog, body)
    return fn


def run_kernels(prog: CompiledProgram, inputs: dict[str, np.ndarray],
                batched: bool = False, device="cuda") -> dict[str, np.ndarray]:
    """Convenience wrapper over the per-op kernel path: numpy in, numpy out.
    Returns the graph outputs (like `run_torch`, unlike `run_numpy` which
    exposes every buffer)."""
    dev = resolve_device(device)
    out = kernel_batched(prog, dev)(to_device(prog, inputs, dev, batched))
    return to_numpy(out, batched)
