"""Twin of tests/test_distribution.py::test_dryrun_subprocess_mini_pod:
the port's dry run (`repro_torch.launch.dryrun.lower_cell`) on a fake
(2, 2, 2) pod mesh, reduced smollm-135m, mixtral-8x22b and rwkv6-1.6b,
train_4k at scale 8/256, on both costed paths ("cuda": K4 and K5 as
custom ops; "cpu": the plain path).

Each cell runs one rank's real train step under `FakeTensorMode`, which
allocates nothing: its temp bytes are >= 0, its argument bytes per device
equal the JAX package's on the same mesh (the sum of `shard_shape`s of
params, ZeRO-1 moments, step and batch, from a subprocess with 8 forced
host devices), the "cuda" cell reaches K4's fake implementation and
counts no launch, and the "cpu" cell never reaches it.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.launch.dryrun import lower_cell
from repro_torch.launch.mesh import make_host_mesh

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ("smollm-135m", "mixtral-8x22b", "rwkv6-1.6b")

_JAX = r"""
import os, sys, json, functools
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from repro.configs import get_config, input_specs
from repro.distribution.sharding import (batch_shardings, param_shardings,
                                         zero1_shardings)
from repro.launch.mesh import axis_types_kw
from repro.models import init_params
from repro.train.optimizer import init_opt_state
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                     **axis_types_kw(3))
leaves = lambda t: jax.tree.leaves(t, is_leaf=lambda x: hasattr(x, "spec"))
def nbytes(tree, shard):
    return sum(int(np.prod(s.shard_shape(x.shape))) * x.dtype.itemsize
               for x, s in zip(leaves(tree), leaves(shard)))
out = {}
for arch in sys.argv[1:]:
    cfg = get_config(arch, reduced=True)
    p = jax.eval_shape(functools.partial(init_params, cfg),
                       jax.random.PRNGKey(0))
    o = jax.eval_shape(init_opt_state, p)
    b = input_specs(cfg, "train_4k", scale_batch=8 / 256)["batch"]
    z = zero1_shardings(cfg, mesh, p)
    out[arch] = (nbytes(p, param_shardings(cfg, mesh, p))
                 + nbytes(o["mu"], z) + nbytes(o["nu"], z) + 4
                 + nbytes(b, batch_shardings(cfg, mesh, b)))
print("JAX_BYTES" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_argument_bytes():
    r = subprocess.run([sys.executable, "-c", _JAX, *ARCHS],
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    line = [x for x in r.stdout.splitlines() if x.startswith("JAX_BYTES")]
    assert line, r.stderr[-3000:]
    return json.loads(line[0][len("JAX_BYTES"):])


@pytest.fixture(scope="module")
def pod_mesh():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=8)
    try:
        yield make_host_mesh(data=2, model=2, pod=2)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_mini_pod(arch, device, pod_mesh, jax_argument_bytes):
    reset_launch_counts()
    low = lower_cell(get_config(arch, reduced=True), "train_4k", pod_mesh,
                     scale_batch=8 / 256, device=device)
    assert low.chips == 8 and low.memory["temp_bytes_per_dev"] >= 0
    assert low.memory["argument_bytes_per_dev"] == jax_argument_bytes[arch]
    assert low.cost.flops > 0 and low.cost.coll_count > 0
    k4 = "repro_torch.flash_attention"
    if arch == "rwkv6-1.6b":                  # attention-free
        assert k4 not in low.by_op
    else:
        assert (k4 in low.by_op) == (device == "cuda")
    assert launch_counts()["flash_attention"] == 0
    assert sum(launch_counts().values()) == 0
