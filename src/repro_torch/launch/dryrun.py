"""Production-mesh dry run: every (arch x input-shape) cell's real step on
one rank of the 16 x 16 or 2 x 16 x 16 mesh, costed per device with no
allocation anywhere.

    python -m repro_torch.launch.dryrun --arch smollm-135m \\
        --shape train_4k --mesh single

The JAX package forces 512 host devices and lowers and compiles the
sharded step for them. Here, with no process group initialized, the run
starts a fake one (`torch.testing`'s `FakeStore`, backend "fake": its
collectives move nothing) of 256 or 512 ranks and builds
`make_production_mesh` on it as rank 0. Under `FakeTensorMode` it then
runs that rank's real step on its slices: `train_step` (AdamW, the
microbatches of `microbatches_for`, ZeRO-1 unless --no-zero1),
`prefill_step` or `decode_step`, each in the layouts of
`param_shardings`, `zero1_shardings`, `batch_shardings` and
`cache_shardings`, and counts it with `hlo_count.OpCounter`: FLOPs, bytes
and collective bytes per device, and the live bytes of the storages the
step makes.

--device picks the path costed, and the run never changes it quietly:
"cuda" (the default) the card's path, where attention is K4 and the SSM
scan K5, each a custom op with a fake implementation and a FLOP formula
(`kernels/_lib.py::cost_route` routes the fake tensors there, which are
CPU fakes: autograd cannot record fake CUDA tensors where torch has no
CUDA); "cpu" the plain path, the one the JAX package's host dry run costs.
No card is needed for either.

One JSON record per cell goes to --out (default build/dryrun.jsonl) and
to standard output: the JAX package's keys (`memory` from the fake
storages: arguments, outputs, and temp = the peak of the step's own
storages less its outputs; `code_bytes` is null, as there is no compiled
code; alias 0, as the port's steps do not donate their inputs),
`roofline` (H100 terms, `launch/analysis.py`), `collectives`, `status`
and `reason`, plus `device`. `compile_s` holds the seconds the cell took.
A cell that fails records `error` and the sweep goes on.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import sys
import time
import traceback

import torch

from ..configs import (ARCH_IDS, SHAPES, cell_applicable, get_config,
                       input_specs)
from ..distribution.context import with_mesh_context
from ..distribution.sharding import (batch_shardings, cache_shardings,
                                     param_shardings)
from ..kernels import _lib
from ..models import decode_step, init_params, prefill_step
from ..models.config import ModelConfig
from ..train.loop import layouts, sharded_train_step
from ..train.optimizer import OptConfig
from ..tree import leaves, tree_map
from .analysis import analyze_counted, model_flops_for
from .hlo_count import Cost, OpCounter
from .mesh import make_production_mesh

DEVICES = {"cuda": "cuda", "cpu": "ref"}


@functools.lru_cache(maxsize=4)
def _param_specs(cfg: ModelConfig):
    """Whole param tree as meta tensors (shapes and dtypes of
    `init_params`, drawn under `FakeTensorMode`)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                          device="meta"), p)


def microbatches_for(cfg: ModelConfig, cell, n_dp: int,
                     global_batch: int | None = None) -> int:
    """Microbatch count: <= ~8k tokens per data shard per microbatch,
    subject to (global_batch/mb) % n_dp == 0."""
    gb = global_batch or cell.global_batch
    per_shard = max(1, gb // n_dp)
    target = max(1, (per_shard * cell.seq_len) // 8192)
    while target > 1 and (per_shard % target != 0):
        target -= 1
    return max(1, target)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree)
               if isinstance(t, torch.Tensor))


@dataclasses.dataclass
class Lowered:
    """One rank's step of a cell, counted: its cost, its memory and the
    chips of the mesh."""

    cost: Cost
    memory: dict
    chips: int
    microbatches: int = 1
    by_op: dict = dataclasses.field(default_factory=dict)


def _local(shard, spec, device):
    """A fake tensor of this rank's slice of meta tensor `spec`."""
    return torch.empty(shard.local_shape(spec.shape), dtype=spec.dtype,
                       device=device)


def lower_cell(cfg: ModelConfig, shape: str, mesh, *, zero1: bool = True,
               scale_batch: float = 1.0, device: str = "cuda") -> Lowered:
    """Run and count one cell's step on this rank of `mesh` under
    `FakeTensorMode` (nothing allocated), on the path of `device`."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cell = SHAPES[shape]
    n_dp = mesh.shape["data"] * mesh.shape.get("pod", 1)
    chips = mesh.size
    # FSDP is a training feature: serving steps read every weight each
    # token, so per-step gathers would dominate; disable it for serve
    # cells whenever model-sharded weights fit HBM (as the JAX package)
    if cell.kind != "train" and cfg.fsdp:
        if cfg.param_count() * 2 / mesh.shape["model"] < 15e9:
            cfg = dataclasses.replace(cfg, fsdp=False)
    specs = input_specs(cfg, shape, scale_batch=scale_batch)
    p_specs = _param_specs(cfg)
    mb = 1
    with FakeTensorMode(), _lib.cost_route(DEVICES[device]):
        dev = torch.device("cpu")
        if cell.kind == "train":
            p_shard, o_shard = layouts(cfg, mesh, p_specs, zero1)
            params = tree_map(lambda s, x: _local(s, x, dev), p_shard,
                              p_specs)
            m = o_shard["mu"]
            opt = {"mu": tree_map(lambda s, x: torch.zeros(
                       s.local_shape(x.shape), device=dev), m, p_specs),
                   "nu": tree_map(lambda s, x: torch.zeros(
                       s.local_shape(x.shape), device=dev), m, p_specs),
                   "step": torch.zeros((), dtype=torch.int32, device=dev)}
            b_shard = batch_shardings(cfg, mesh, specs["batch"])
            batch = {k: _local(b_shard[k], v, dev)
                     for k, v in specs["batch"].items()}
            gb = specs["batch"]["tokens"].shape[0]
            mb = microbatches_for(cfg, cell, n_dp, global_batch=gb)
            step = sharded_train_step(cfg, mesh, OptConfig(), p_shard,
                                      o_shard, mb)
            args = (params, opt, batch)
            run = lambda: step(params, opt, batch)
            ctx = {}
        else:
            p_shard = param_shardings(cfg, mesh, p_specs)
            c_shard = cache_shardings(cfg, mesh, specs["cache"])
            params = tree_map(lambda s, x: _local(s, x, dev), p_shard,
                              p_specs)
            cache = {k: _local(c_shard[k], v, dev)
                     for k, v in specs["cache"].items()}
            if cell.kind == "prefill":
                b_shard = batch_shardings(cfg, mesh, specs["batch"])
                batch = {k: _local(b_shard[k], v, dev)
                         for k, v in specs["batch"].items()}
                args = (params, batch, cache)
                fn = prefill_step(cfg)
                run = lambda: fn(params, batch, cache)
            else:
                t_shard = batch_shardings(cfg, mesh,
                                          {"t": specs["tokens"]})["t"]
                tokens = _local(t_shard, specs["tokens"], dev)
                args = (params, cache, tokens)
                fn = decode_step(cfg)
                run = lambda: fn(params, cache, tokens)
            ctx = {"params": p_shard, "cache": c_shard}
        with OpCounter() as counter:
            counter.ignore(args)
            if ctx:
                with torch.no_grad(), with_mesh_context(mesh, **ctx):
                    out = run()
            else:
                out = run()
        out_bytes = _nbytes(out)
    memory = {
        "argument_bytes_per_dev": _nbytes(args),
        "output_bytes_per_dev": out_bytes,
        "temp_bytes_per_dev": max(0, counter.peak_bytes - out_bytes),
        "code_bytes": None,
        "alias_bytes_per_dev": 0,
    }
    return Lowered(counter.cost, memory, chips, mb, counter.by_op)


# -- the fake world -----------------------------------------------------------

_OWN_WORLD: list = []


def fake_world(n: int) -> None:
    """A fake process group of `n` ranks (this process is rank 0), unless
    the default group already has `n` ranks. Replaces one this module
    started at another size; never touches a group it did not start."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        if not _OWN_WORLD:
            return                     # the caller's group: the mesh says
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    _OWN_WORLD[:] = [n]


def run_cell(arch: str, shape: str, *, multi_pod: bool,
             zero1: bool = True, reduced: bool = False,
             scale_batch: float = 1.0, overrides: dict | None = None,
             device: str = "cuda") -> dict:
    cfg = get_config(arch, reduced=reduced)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    cell = SHAPES[shape]
    ok, reason = cell_applicable(cfg, shape)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
           "zero1": zero1, "status": "skipped", "reason": reason,
           "overrides": overrides or {}, "device": device}
    if not ok:
        return rec
    t0 = time.time()
    try:
        fake_world(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod)
        low = lower_cell(cfg, shape, mesh, zero1=zero1,
                         scale_batch=scale_batch, device=device)
        roof = analyze_counted(
            arch, shape, mesh_name, low.cost,
            model_flops_for(cfg, cell, cfg.active_param_count()), low.chips)
        rec.update({
            "status": "ok",
            "compile_s": round(time.time() - t0, 1),
            "memory": low.memory,
            "roofline": roof.row(),
            "collectives": roof.collective_breakdown,
            "microbatches": low.microbatches,
        })
    except Exception as e:  # noqa: BLE001 -- record failures, keep sweeping
        rec.update({"status": "error",
                    "reason": f"{type(e).__name__}: {e}",
                    "trace": traceback.format_exc()[-2000:]})
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    help=f"one of {ARCH_IDS} or 'all'")
    ap.add_argument("--shape", default="all",
                    help=f"one of {list(SHAPES)} or 'all'")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--no-zero1", action="store_true")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--scale-batch", type=float, default=1.0)
    ap.add_argument("--out", default="build/dryrun.jsonl")
    ap.add_argument("--override", action="append", default=[],
                    help="ModelConfig field override, e.g. "
                         "moe_dispatch=sorted or remat=dots")
    ap.add_argument("--device", default="cuda", choices=list(DEVICES),
                    help="the path costed: the card's kernels (cuda) or "
                         "the plain versions (cpu); no card is needed")
    args = ap.parse_args(argv)
    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        if v in ("True", "False"):
            v = v == "True"
        elif v.isdigit():
            v = int(v)
        elif v == "None":
            v = None
        overrides[k] = v

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    n_fail = 0
    with open(args.out, "a") as f:
        for arch in archs:
            for shape in shapes:
                for mp in meshes:
                    rec = run_cell(arch, shape, multi_pod=mp,
                                   zero1=not args.no_zero1,
                                   reduced=args.reduced,
                                   scale_batch=args.scale_batch,
                                   overrides=overrides, device=args.device)
                    line = {k: v for k, v in rec.items() if k != "trace"}
                    print(json.dumps(line), flush=True)
                    if rec["status"] == "error":
                        n_fail += 1
                        print(rec.get("trace", ""), file=sys.stderr)
                    f.write(json.dumps(rec) + "\n")
    if n_fail:
        sys.exit(1)


if __name__ == "__main__":
    main()
