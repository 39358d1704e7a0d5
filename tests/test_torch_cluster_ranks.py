"""The mesh backend across processes: one CPU process per rank over gloo.

The JAX package proves its mesh on 8 forced XLA CPU devices
(`tests/test_cluster.py::test_mesh_bit_exact_vs_jax_multi_device`, skipped
unless the suite runs with that flag). Its twin here runs for real: every
rank of a (data, model) mesh is a spawned Python process that joins a gloo
group through a `file://` rendezvous under the test's own directory,
compiles the same network with the same parameters for the mesh backend,
serves a ragged batch of 5 and a single frame, and writes what it got.
Every rank's outputs must equal, bit for bit, the JAX package's
single-device "jax" backend computed here in the parent.

Each worker runs with one thread; each spawn has its own deadline
(`init_process_group(timeout=...)` in the workers, a bounded wait here),
and a worker still running at the deadline is killed.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
DEADLINE_S = 240

_WORKER = r"""
import datetime, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, data, model, mode, d = sys.argv[1:7]
rank, world, data, model = int(rank), int(world), int(data), int(model)
dist.init_process_group("gloo", init_method=f"file://{d}/rendezvous",
                        world_size=world, rank=rank,
                        timeout=datetime.timedelta(seconds=120))
from repro_torch.launch.mesh import make_host_mesh
out = {}
if mode == "mesh":
    try:
        make_host_mesh(data=3, model=1)
        out["refused"] = np.array(False)
    except ValueError as e:
        out["refused"] = np.array("data=3" in str(e) and str(world) in str(e))
    mesh = make_host_mesh(data=data, model=model)
    out["size"] = np.array(mesh.size)
    out["coords"] = np.array([mesh.data_index, mesh.model_index])
else:
    import repro_torch
    from repro_torch.core import cnn
    from repro_torch.hw import scaled_paper_machine
    arrs = np.load(f"{d}/inputs.npz")
    params = {k[2:]: arrs[k] for k in arrs.files if k.startswith("p:")}
    dep = repro_torch.compile(
        cnn.small_cnn(), scaled_paper_machine(4).with_mesh(data, model),
        backend="mesh", params=params, num_cores=4, device="cpu")
    for k, v in dep.run({"input": arrs["batch"]}, batched=True).items():
        out["b:" + k] = v
    for k, v in dep.run({"input": arrs["frame"]}).items():
        out["s:" + k] = v
np.savez(f"{d}/rank{rank}.npz", **out)
dist.barrier()
dist.destroy_process_group()
"""


def _spawn(tmp_path, world, data, model, mode):
    """Run `world` worker processes; return each rank's saved arrays."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(world), str(data),
         str(model), mode, str(tmp_path)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=DEADLINE_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * world, logs
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


def _frame(seed=0, shape=(32, 32, 3)):
    return np.random.default_rng(seed).integers(
        -64, 64, size=shape).astype(np.int8)


@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (2, 4), (8, 1)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_mesh_bit_exact_vs_jax_multi_device(shape, tmp_path):
    """Acceptance: on every mesh shape each rank's result is bit-exact vs
    the JAX package's single-device jax backend, for a ragged batch (5
    frames) and for a single frame."""
    import repro
    from repro.core import cnn, init_params
    from repro.hw import scaled_paper_machine

    data, model = shape
    g = cnn.small_cnn()
    params = init_params(g, seed=3)
    jax_dep = repro.compile(g, scaled_paper_machine(4), backend="jax",
                            params=params, num_cores=4)
    xb = np.stack([_frame(20 + i) for i in range(5)])     # ragged vs data
    x = _frame(30)
    ref = jax_dep.run({"input": xb}, batched=True)
    ref1 = jax_dep.run({"input": x})
    np.savez(tmp_path / "inputs.npz", batch=xb, frame=x,
             **{"p:" + k: np.asarray(v) for k, v in params.items()})
    ranks = _spawn(tmp_path, data * model, data, model, "run")
    for got in ranks:
        for t in g.outputs:
            assert np.array_equal(np.asarray(ref[t]), got["b:" + t])
            assert np.array_equal(np.asarray(ref1[t]), got["s:" + t])


def test_make_host_mesh_silent_shrink_bug_fixed(tmp_path):
    """On 8 ranks a (3, 1) mesh is refused instead of stranding ranks, and
    a (2, 4) mesh spans all 8, model axis fastest (as the JAX package's
    check on 8 forced devices, which skips without them)."""
    ranks = _spawn(tmp_path, 8, 2, 4, "mesh")
    assert all(bool(r["refused"]) for r in ranks)
    assert all(int(r["size"]) == 8 for r in ranks)
    assert [tuple(r["coords"]) for r in ranks] == [
        (d, m) for d in range(2) for m in range(4)]
