"""The training loop: data -> train_step on a mesh -> checkpoint/fault
handling -> metrics. The same code runs the one-process 1 x 1 mesh (no
process group, no collective) and any (pod x) data x model mesh of a
`HostMesh`, one process per rank:

  * each data rank takes its own rows, `data.batch(step, shard=dp_index,
    n_shards=dp_size)`;
  * each rank holds its slice of every param under `param_shardings`
    (tensor parallelism over `model`, and cfg.fsdp's ZeRO-3 and moe
    experts over `data`) and of every moment under `zero1_shardings`
    (with `zero1`) or `param_shardings`; the layers run on those slices
    with explicit collectives (`distribution/tensor_parallel.py`), as
    GSPMD derives them from the same specs in the JAX package;
  * gradients are averaged over the data-parallel group into the
    moments' layout (reduce-scattered over `data` where ZeRO-1 cuts a
    leaf the param does not), and the loss metric with them; each rank
    updates its slices, clipped by the whole gradient's norm, and the new
    params are brought back to their layout.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable

import torch

from ..core.compiled import resolve_device
from ..data.pipeline import DataConfig, SyntheticTokens
from ..distribution.collectives import all_reduce, reduce_scatter
from ..distribution.context import with_mesh_context
from ..distribution.sharding import (NamedSharding, P, param_shardings,
                                     relayout, zero1_shardings)
from ..models.config import ModelConfig
from ..models.transformer import init_params
from ..tree import leaves, tree_map
from .checkpoint import CheckpointManager
from .fault import StragglerWatchdog, run_with_recovery
from .optimizer import OptConfig, adamw_update, global_norm
from .step import make_train_step


@dataclasses.dataclass
class TrainConfig:
    num_steps: int = 100
    microbatches: int = 1
    zero1: bool = True
    save_every: int = 25
    ckpt_dir: str | None = None
    log_every: int = 10
    seed: int = 0


def build_state(cfg: ModelConfig, mesh, zero1: bool = True, seed: int = 0,
                device="cuda", params=None):
    """This rank's params (from `init_params` with a generator seeded
    `seed`, or the given whole `params`, which are not modified) and
    optimizer state, and the layouts (p_shard, o_shard): trees of
    NamedSharding, params by `param_shardings`, moments by
    `zero1_shardings` with `zero1`, else like the params."""
    dev = resolve_device(device)
    if params is None:
        params = init_params(cfg, torch.Generator(dev).manual_seed(seed),
                             dev)
    else:
        params = tree_map(lambda p: p.detach().to(dev).clone(), params)
    p_shard, o_shard = layouts(cfg, mesh, params, zero1)
    m_shard = o_shard["mu"]
    zeros = lambda s, x: torch.zeros(s.local_shape(x.shape),
                                     dtype=torch.float32, device=dev)
    opt_state = {"mu": tree_map(zeros, m_shard, params),
                 "nu": tree_map(zeros, m_shard, params),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
    params = tree_map(lambda s, x: s.shard(x), p_shard, params)
    return params, opt_state, (p_shard, o_shard)


def layouts(cfg: ModelConfig, mesh, params, zero1: bool = True):
    """(p_shard, o_shard) of whole `params` (tensors, or anything with a
    `.shape`) on `mesh`."""
    p_shard = param_shardings(cfg, mesh, params)
    m_shard = zero1_shardings(cfg, mesh, params) if zero1 else p_shard
    return p_shard, {"mu": m_shard, "nu": m_shard,
                     "step": NamedSharding(mesh, P())}


def _global_norm(grads, shard, mesh) -> torch.Tensor:
    """The whole gradient's norm from this rank's slices: each leaf's sum
    of squares over the ranks that hold the same slice, summed over the
    mesh."""
    if not mesh.distributed:
        return global_norm(grads)
    tot = 0.0
    for g, s in zip(leaves(grads), leaves(shard)):
        held = math.prod(s.axes_size(a) for _, a in s.cuts())
        tot = tot + torch.sum(torch.square(g.float())) * (held / mesh.size)
    return torch.sqrt(all_reduce(tot, mesh.group(tuple(mesh.shape))))


def _sync(mesh, p_shard, m_shard):
    """Gradients (in the params' layout, a flat list) averaged over the
    data-parallel ranks into the moments' layout (the JAX package's
    `grad_shardings`). A leaf cut over data was reduce-scattered by its
    gather's backward; a leaf that ZeRO-1 cuts over data on a dim the
    param keeps whole is reduce-scattered there; the rest is all-reduced
    and cut."""
    n_data = mesh.shape["data"]
    pods = "pod" in mesh.shape
    dp = mesh.data_parallel_group

    def one(g, ps, ms):
        a, b = dict(ps.cuts()), dict(ms.cuts())
        extra = [d for d in b if b[d] == ("data",) and d not in a]
        if ps.data_cuts():
            g = g / n_data
        elif len(extra) == 1 and {d: x for d, x in b.items()
                                  if d != extra[0]} == a:
            g = reduce_scatter(g, extra[0], mesh.group("data")) / n_data
            ps = ms
        else:
            return relayout(all_reduce(g, dp, "mean"), ps, ms)
        if pods:
            g = all_reduce(g, mesh.group("pod"), "mean")
        return relayout(g, ps, ms)

    return lambda gs: [one(g, ps, ms) for g, ps, ms in
                       zip(gs, leaves(p_shard), leaves(m_shard))]


def _sharded_update(opt_cfg: OptConfig, mesh, p_shard, m_shard):
    """AdamW on this rank's slices in the moments' layout (the gradients
    come in it), clipped by the whole gradient's norm; the new params go
    back to their layout."""
    def update(grads, opt_state, params):
        p_m = tree_map(relayout, params, p_shard, m_shard)
        new, opt_state, metrics = adamw_update(
            opt_cfg, grads, opt_state, p_m,
            grad_norm=_global_norm(grads, m_shard, mesh))
        return (tree_map(relayout, new, m_shard, p_shard), opt_state,
                metrics)
    return update


def sharded_train_step(cfg: ModelConfig, mesh, opt_cfg: OptConfig,
                       p_shard, o_shard, microbatches: int = 1):
    """`make_train_step` on this rank's slices: (params, opt_state,
    batch) -> (params, opt_state, metrics), params in `p_shard`'s layout,
    moments in `o_shard`'s, the batch this rank's rows. On the one-rank
    mesh without a process group it is the plain step."""
    if not mesh.distributed:
        step = make_train_step(cfg, opt_cfg, microbatches=microbatches)
    else:
        step = make_train_step(
            cfg, opt_cfg, microbatches=microbatches,
            grad_sync=_sync(mesh, p_shard, o_shard["mu"]),
            update=_sharded_update(opt_cfg, mesh, p_shard, o_shard["mu"]))

    def train_step(params, opt_state, batch):
        with with_mesh_context(mesh, params=p_shard):
            params, opt_state, metrics = step(params, opt_state, batch)
        if mesh.distributed:
            metrics["loss"] = all_reduce(metrics["loss"],
                                         mesh.data_parallel_group, "mean")
        return params, opt_state, metrics

    return train_step


def train(cfg: ModelConfig, mesh, opt_cfg: OptConfig | None = None,
          tc: TrainConfig | None = None,
          data: SyntheticTokens | None = None,
          seq_len: int = 512, global_batch: int = 8,
          hooks: Callable[[int, dict], None] | None = None,
          device="cuda", params=None,
          fail_at: dict[int, Exception] | None = None):
    """End-to-end training entry (used by launch/train.py). `params`
    starts from given params instead of `init_params`; `fail_at` injects
    failures into `run_with_recovery` (with a checkpoint directory).
    Returns ((params, opt_state), {"losses", "history", "stragglers"});
    with zero1 the moments in the state are this rank's slices."""
    tc = tc or TrainConfig()
    opt_cfg = opt_cfg or OptConfig(total_steps=tc.num_steps)
    data = data or SyntheticTokens(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq_len,
        global_batch=global_batch, seed=tc.seed))
    dev = resolve_device(device)

    params, opt_state, (p_shard, o_shard) = build_state(
        cfg, mesh, zero1=tc.zero1, seed=tc.seed, device=dev, params=params)
    step_fn = sharded_train_step(cfg, mesh, opt_cfg, p_shard, o_shard,
                                 tc.microbatches)

    losses: list[float] = []
    watchdog = StragglerWatchdog()
    ckpt = (CheckpointManager(tc.ckpt_dir, layout=(p_shard, o_shard))
            if tc.ckpt_dir else None)

    def one_step(state, step):
        params, opt_state = state
        batch = {k: torch.as_tensor(v).to(dev) for k, v in data.batch(
            step, shard=mesh.dp_index, n_shards=mesh.dp_size).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if hooks:
            hooks(step, metrics)
        if step % tc.log_every == 0 and mesh.rank == 0:
            print(f"step {step:5d}  loss {loss:.4f}  "
                  f"lr {float(metrics['lr']):.2e}", flush=True)
        return params, opt_state

    state = (params, opt_state)
    if ckpt is not None:
        state, history = run_with_recovery(
            one_step, state, tc.num_steps, ckpt,
            save_every=tc.save_every, watchdog=watchdog, fail_at=fail_at)
    else:
        history = {"restarts": 0, "stragglers": 0,
                   "completed": tc.num_steps}
        for s in range(tc.num_steps):
            t0 = time.perf_counter()
            state = one_step(state, s)
            watchdog.observe(s, time.perf_counter() - t0)
    return state, {"losses": losses, "history": history,
                   "stragglers": [dataclasses.asdict(r)
                                  for r in watchdog.reports]}
