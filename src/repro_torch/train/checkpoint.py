"""Sharded, atomic, async checkpointing (no external deps), in the JAX
package's on-disk format, so that a checkpoint written by either package
restores in the other.

Layout:  <dir>/step_<N>/
            manifest.json          tree paths + shapes/dtypes + step
            shard_0.npz            flat arrays a0, a1, ... in the trees'
                                   flattening order (`repro_torch.tree`:
                                   dict keys sorted, as jax.tree_util)
         <dir>/LATEST              committed pointer (atomic rename)

Fault-tolerance contract:
  * a checkpoint directory becomes visible only after its manifest and all
    shards are fully written (write to tmp dir + atomic os.replace);
  * LATEST is updated last -> a crash mid-save never corrupts the restore
    path;
  * async mode hands the host copy to a worker thread so the train loop
    continues; `wait()` joins before the next save or exit.

bfloat16 (and the float8 types) are stored as float32, as the JAX package
stores them (np.savez cannot hold them), and cast back on restore: a
lossless round trip.

Several ranks: a `layout` (a tree of `distribution.NamedSharding`, shaped
like the saved trees) says how each leaf is split over the ranks. `save`
then gathers every leaf whole on every rank (a collective: all ranks call
it), rank 0 writes at once (not in a thread), and a barrier ends the save,
so every rank reads the same LATEST after it; `restore` keeps this rank's
slice of each leaf.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from ..tree import flatten_with_path, leaves, path_str, unflatten

# the types numpy has no counterpart of: stored as float32
_WIDEN = (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2)


def _to_host(x) -> np.ndarray:
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    x = x.detach()
    if x.dtype in _WIDEN:
        x = x.float()
    return x.cpu().numpy()


def _from_host(a: np.ndarray, like) -> Any:
    if not isinstance(like, torch.Tensor):
        return type(like)(a) if np.ndim(a) == 0 else a
    t = torch.from_numpy(np.array(a, order="C"))
    return t.to(device=like.device, dtype=like.dtype)


def _distributed() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


class CheckpointManager:
    def __init__(self, directory: str, async_save: bool = True,
                 keep: int = 3, layout: Any = None):
        self.dir = directory
        self.async_save = async_save
        self.keep = keep
        self.layout = layout
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    def _collective(self) -> bool:
        """Several ranks save one checkpoint together."""
        return self.layout is not None and _distributed()

    # -- save -----------------------------------------------------------------
    def save(self, step: int, tree: Any):
        self.wait()
        flat = flatten_with_path(tree)
        paths = [path_str(p) for p, _ in flat]
        xs = [x for _, x in flat]
        if self.layout is not None:
            xs = [s.gather(x) for s, x in zip(leaves(self.layout), xs)]
        # device -> host copy happens synchronously (consistent snapshot)
        host = [_to_host(x) for x in xs]

        def _write():
            tmp = os.path.join(self.dir, f".tmp_step_{step}")
            final = os.path.join(self.dir, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "shard_0.npz"),
                     **{f"a{i}": a for i, a in enumerate(host)})
            manifest = {
                "step": step,
                "paths": paths,
                "shapes": [list(a.shape) for a in host],
                "dtypes": [str(a.dtype) for a in host],
                "num_shards": 1,
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            latest_tmp = os.path.join(self.dir, ".LATEST.tmp")
            with open(latest_tmp, "w") as f:
                f.write(str(step))
            os.replace(latest_tmp, os.path.join(self.dir, "LATEST"))
            self._gc()

        if self._collective():
            import torch.distributed as dist
            if dist.get_rank() == 0:
                _write()
            dist.barrier()
        elif self.async_save:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # -- restore ----------------------------------------------------------------
    def latest_step(self) -> int | None:
        p = os.path.join(self.dir, "LATEST")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return int(f.read().strip())

    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_"):
                if os.path.exists(os.path.join(self.dir, d,
                                               "manifest.json")):
                    out.append(int(d.split("_")[1]))
        return sorted(out)

    def restore(self, like: Any, step: int | None = None,
                shardings: Any = None) -> tuple[Any, int]:
        """Restore into the structure of `like` (dtypes and devices of its
        leaves); `shardings` (a tree of `NamedSharding`, default this
        manager's layout) keeps this rank's slice of each leaf -- the
        elastic-rescale path: a checkpoint written on one mesh restores
        onto any other."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        final = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(final, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(final, "shard_0.npz")) as data:
            host = [data[f"a{i}"] for i in range(len(manifest["paths"]))]
        flat = leaves(like)
        if len(flat) != len(host):
            raise ValueError(f"checkpoint has {len(host)} leaves, expected "
                             f"{len(flat)}")
        shardings = self.layout if shardings is None else shardings
        if shardings is not None:
            out = [s.shard(_from_host(h, l)) for h, l, s in
                   zip(host, flat, leaves(shardings))]
        else:
            out = [_from_host(h, l) for h, l in zip(host, flat)]
        return unflatten(like, out), step
