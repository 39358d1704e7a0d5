"""Training loop driver: data -> train_step on a data-parallel mesh ->
checkpoint/fault handling -> metrics. The same code runs the one-process
1 x 1 mesh (no process group, no collective) and data parallelism over the
data (and pod) axis of a `HostMesh`, one process per rank:

  * each data rank takes its own rows, `data.batch(step, shard=dp_index,
    n_shards=dp_size)`;
  * gradients are averaged over the data-parallel group, and the loss
    metric with them;
  * params stay whole on every rank; with `zero1` the AdamW moments are
    cut over `data` on the dim `zero1_shardings` picks, each rank updates
    its slice of every leaf (clipped by the whole gradient's norm) and the
    new params are all-gathered; without it every rank updates whole
    leaves, identically.

Where the JAX package lets GSPMD derive tensor parallelism from the param
specs, a model axis above 1 here raises `NotImplementedError` (ROADMAP.md
item 19), as do the param cuts over `data` that the JAX package also
makes (cfg.fsdp's ZeRO-3, moe experts over data): the port keeps params
whole on each data rank.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from ..core.compiled import resolve_device
from ..data.pipeline import DataConfig, SyntheticTokens
from ..distribution.collectives import all_reduce
from ..distribution.context import with_mesh_context
from ..distribution.sharding import (NamedSharding, P, replicated,
                                     zero1_shardings)
from ..models.config import ModelConfig
from ..models.transformer import init_params
from ..tree import tree_map
from .checkpoint import CheckpointManager
from .fault import StragglerWatchdog, run_with_recovery
from .optimizer import OptConfig, adamw_update, global_norm, init_opt_state
from .step import make_train_step

TENSOR_PARALLEL = ("tensor-parallel training (a model axis above 1, or "
                   "params cut over data) waits for its port (ROADMAP.md, "
                   "item 19)")


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
    """Params (from `init_params` with a generator seeded `seed`, or the
    given `params`, which are not modified) and optimizer state on this
    rank, and the layouts (p_shard, o_shard): trees of NamedSharding,
    params whole, moments cut over data with `zero1`."""
    if mesh.shape["model"] > 1 or (cfg.fsdp and mesh.shape["data"] > 1):
        raise NotImplementedError(TENSOR_PARALLEL)
    dev = resolve_device(device)
    if params is None:
        params = init_params(cfg, torch.Generator(dev).manual_seed(seed),
                             dev)
    else:
        params = tree_map(lambda p: p.detach().to(dev).clone(), params)
    p_shard = replicated(mesh, params)
    m_shard = (zero1_shardings(cfg, mesh, params) if zero1
               else replicated(mesh, params))
    o_shard = {"mu": m_shard, "nu": m_shard,
               "step": NamedSharding(mesh, P())}
    full = init_opt_state(params)
    opt_state = {"mu": tree_map(lambda s, x: s.shard(x), m_shard,
                                full["mu"]),
                 "nu": tree_map(lambda s, x: s.shard(x), m_shard,
                                full["nu"]),
                 "step": full["step"]}
    return params, opt_state, (p_shard, o_shard)


def _sharded_update(opt_cfg: OptConfig, m_shard):
    """AdamW on this rank's slices (`m_shard`, ZeRO-1), the new params
    all-gathered whole."""
    def update(grads, opt_state, params):
        gnorm = global_norm(grads)
        cut = lambda s, x: s.shard(x)
        p_loc, opt_state, metrics = adamw_update(
            opt_cfg, tree_map(cut, m_shard, grads), opt_state,
            tree_map(cut, m_shard, params), grad_norm=gnorm)
        return (tree_map(lambda s, x: s.gather(x), m_shard, p_loc),
                opt_state, metrics)
    return update


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
    group = mesh.data_parallel_group if mesh.distributed else None
    sync = lambda gs: [all_reduce(g, group, "mean") for g in gs]
    step_fn = make_train_step(
        cfg, opt_cfg, microbatches=tc.microbatches,
        grad_sync=sync if group is not None else None,
        update=_sharded_update(opt_cfg, o_shard["mu"]) if tc.zero1 else None)

    losses: list[float] = []
    watchdog = StragglerWatchdog()
    ckpt = (CheckpointManager(tc.ckpt_dir, layout=(p_shard, o_shard))
            if tc.ckpt_dir else None)

    def one_step(state, step):
        params, opt_state = state
        batch = {k: torch.as_tensor(v).to(dev) for k, v in data.batch(
            step, shard=mesh.dp_index, n_shards=mesh.dp_size).items()}
        with with_mesh_context(mesh):
            params, opt_state, metrics = step_fn(params, opt_state, batch)
        if group is not None:
            metrics["loss"] = all_reduce(metrics["loss"], group, "mean")
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
