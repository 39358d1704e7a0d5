"""Mesh-sharded execution of a CompiledProgram (backend "mesh").

The schedule's per-core instruction streams already say which core computes
which tile of which op. `partition_streams` groups the cores into
contiguous blocks — one block per rank on the mesh's **model** axis — and
this module executes exactly those per-rank tile sets over
`torch.distributed`, one process per rank:

  * every rank materializes the op's operands (inputs are replicated),
    computes ONLY its own tiles into a zero int32 accumulator (K6,
    `kernels.tiled_int8`: one launch per op per rank, on a K-major copy of
    the op's weights made once when the program is built), and an int32
    `all_reduce(SUM)` over the model group reconstructs the full output —
    the analogue of the paper's cores writing disjoint output tiles back to
    shared memory. The tile sets are disjoint and exactly cover the output
    (verified at lowering time), and the gemm/conv paths accumulate in
    int32, so the summed result is **bit-identical** to the single-device
    torch backend — no reduction-order caveats.
  * op kinds without tile-level parallelism (requant, pooling, add, ...)
    are replicated: every rank computes them identically, which keeps the
    values consistent without communication.
  * the **data** axis shards the serving batch: the runner pads a ragged
    batch up to a multiple of the axis size by repeating the last sample,
    runs this rank's shard, gathers the shards back over the data group
    (`all_gather`) and slices the pad off, so every rank returns the whole
    batch.

With no process group initialized, a 1 x 1 mesh runs alone and skips the
collectives; any other shape then raises in `make_host_mesh`. With a group,
the collectives run even on axes of size 1 (through its backend: NCCL or
gloo).

The mesh shape comes from the machine: `HardwareModel.with_mesh(data,
model)` stamps `mesh_shape` into the model (and thus its fingerprint), and
`make_host_mesh` validates it against the world size.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import compiled as _C
from ..core.compiled import CompiledProgram, CompileError, partition_streams
from ..core.graph import conv_out_hw
from ..kernels.tiled_int8 import prepare_weights, tiled_int8
from ..launch.mesh import make_host_mesh


def mesh_axes(prog: CompiledProgram) -> tuple[int, int]:
    """The (data, model) mesh axis sizes the program was compiled for.

    Raises `CompileError` when the program's machine carries no mesh shape
    (i.e. it was compiled for single-device execution) — the backend/machine
    consistency check in `repro_torch.compile` makes this unreachable
    through the public API, but direct callers get the same clear failure.
    """
    hw = prog.hw
    shape = getattr(hw, "mesh_shape", None) if hw is not None else None
    if shape is None:
        raise CompileError(
            "program was compiled for a machine without a mesh shape; "
            "use HardwareModel.with_mesh(data, model) to target the "
            "mesh backend")
    data, model = shape
    return int(data), int(model)


# -- per-rank tile tables -----------------------------------------------------

def _stack_tiles(parts: list[dict[int, np.ndarray]],
                 op_idx: int) -> tuple[np.ndarray, np.ndarray]:
    """Stack one op's per-rank tile sets into a rectangular table.

    Returns `(tiles, mask)` with shapes (n_ranks, T_max, 4) and
    (n_ranks, T_max): rank d's real tiles occupy the first
    `mask[d].sum()` rows; the rest are zero padding the mask disables.
    """
    per = [g.get(op_idx, np.zeros((0, 4), np.int64)) for g in parts]
    t_max = max(max((len(p) for p in per), default=0), 1)
    tiles = np.zeros((len(parts), t_max, 4), np.int64)
    mask = np.zeros((len(parts), t_max), bool)
    for d, p in enumerate(per):
        tiles[d, : len(p)] = p
        mask[d, : len(p)] = True
    return tiles, mask


def _tiled_partial(x: torch.Tensor, w: torch.Tensor, tiles: np.ndarray,
                   mask: np.ndarray, b,
                   wt: torch.Tensor | None = None) -> torch.Tensor:
    """This rank's partial int32 accumulator of op batch `b` (gemm or
    conv2d) over a leading batch axis: the sum of its own tiles' x.w
    products, zero elsewhere, in the op's output shape. `wt`: w as
    `prepare_weights` gives it (on a GPU)."""
    a = b.attrs
    B = x.shape[0]
    if b.kind == "gemm":
        acc = tiled_int8(x.reshape(B, a["M"], 1, a["K"]), w, tiles, mask,
                         wt=wt)
        return acc.reshape(B, a["M"], a["N"])
    oh, ow = conv_out_hw(a)
    acc = tiled_int8(x, w, tiles, mask, kh=a["kh"], kw=a["kw"],
                     stride=a["stride"], padding=a["padding"], wt=wt)
    return acc.reshape(B, oh, ow, a["C_out"])


# -- the per-rank program -----------------------------------------------------

def _mesh_body(prog: CompiledProgram, mesh, device: torch.device):
    """The per-rank batched function: rank (d, m) executes core block m's
    tiles and all-reduces them over its model group; cheap ops replicate."""
    _, model = mesh_axes(prog)
    parts = partition_streams(prog, model)
    consts = _C.device_consts(prog, device)
    tables: dict[int, tuple] = {}
    for b in prog.batches:
        if b.kind in ("gemm", "conv2d"):
            tiles, mask = _stack_tiles(parts, b.op_idx)
            # K6 reads the weights K-major: the copy is made here, once
            # per op, and no call transposes (the CPU path needs none)
            wt = (prepare_weights(consts.weights[b.w_idx])
                  if device.type == "cuda" else None)
            tables[b.op_idx] = (tiles[mesh.model_index],
                                mask[mesh.model_index], wt)

    def run(inputs: dict) -> dict:
        vals: list = [None] * len(prog.buffers)
        for name, i in prog.input_idx.items():
            vals[i] = inputs[name]
        for b in prog.batches:
            if b.kind in ("gemm", "conv2d"):
                tiles, mask, wt = tables[b.op_idx]
                acc = _tiled_partial(vals[b.in_idx[0]],
                                     consts.weights[b.w_idx], tiles, mask,
                                     b, wt)
                if mesh.distributed:
                    torch.distributed.all_reduce(acc,
                                                 group=mesh.model_group)
                vals[b.out_idx] = acc.to(
                    _C._TORCH_DT[prog.buffers[b.out_idx][2]])
            else:
                vals[b.out_idx] = _C._torch_op(b, vals, prog, consts)
        return {name: vals[i] for name, i in prog.output_idx.items()}

    return run


def _mesh_program(prog: CompiledProgram, device):
    """(mesh, batched function) for (prog, device), cached on the program
    (its device cache: dropped on pickle, rebuilt lazily after
    `Deployment.load`)."""
    dev = _C.resolve_device(device)
    data, model = mesh_axes(prog)
    key = ("mesh", (data, model), str(dev))
    if key not in prog._device_cache:
        # partition first: a model axis that does not divide the core count
        # is a program error (CompileError) regardless of how many ranks
        # this run has
        partition_streams(prog, model)
        mesh = make_host_mesh(data=data, model=model)
        prog._device_cache[key] = (mesh, _mesh_body(prog, mesh, dev))
    return dev, prog._device_cache[key]


def _gather(out: dict, mesh) -> dict:
    """Every data rank's shard, concatenated in data order."""
    if not mesh.distributed:
        return out
    full = {}
    for k, v in out.items():
        v = v.contiguous()
        parts = [torch.empty_like(v) for _ in range(mesh.shape["data"])]
        torch.distributed.all_gather(parts, v, group=mesh.data_group)
        full[k] = torch.cat(parts)
    return full


# -- backend runners ----------------------------------------------------------

def mesh_single_runner(prog: CompiledProgram, device="cuda"):
    """Single-sample runner with the uniform serving contract (numpy in,
    numpy out, graph outputs only). Every rank computes the same sample
    (replicated over the data axis)."""
    dev, (_, fn) = _mesh_program(prog, device)

    def run(inputs: dict) -> dict:
        out = fn(_C.to_device(prog, inputs, dev, batched=False))
        return _C.to_numpy(out, batched=False)

    return run


def mesh_batched_runner(prog: CompiledProgram, device="cuda"):
    """Batched runner: shards the leading batch axis over the data axis,
    padding a ragged batch by repeating the last sample (sliced back off),
    so any batch size serves on any data-axis size."""
    dev, (mesh, fn) = _mesh_program(prog, device)
    data, _ = mesh_axes(prog)

    def run(inputs: dict) -> dict:
        b = next(iter(inputs.values())).shape[0]
        pad = (-b) % data
        per = (b + pad) // data
        lo = mesh.data_index * per
        arrs = {}
        for k, v in inputs.items():
            v = np.asarray(v)
            if pad:
                v = np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
            arrs[k] = v[lo:lo + per]
        out = _gather(fn(_C.to_device(prog, arrs, dev)), mesh)
        return {k: v[:b] for k, v in _C.to_numpy(out).items()}

    return run
