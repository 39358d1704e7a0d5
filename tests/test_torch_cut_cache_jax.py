"""The port's decode over caches cut on positions against the JAX
package's on the same mesh.

When the kv heads do not divide over `model`, `cache_shardings` cuts the
caches on positions. The JAX package serves such a cache under `jax.jit`
with those shardings (GSPMD derives the collectives); the port attends
each rank's positions of a self-attention cache with the softmax reduced
over the cut, and gathers the cross-attention keys and values whole for
its attention kernel. Two cases:

  * smollm-135m reduced (3 q heads, 1 kv head) with an int8 KV cache on
    the (1, 2) mesh: `k`/`v` and `k_scale`/`v_scale` cut on positions;
  * seamless-m4t-medium reduced (4 heads) on the (1, 3) mesh: the
    cross-attention `xk`/`xv` cut on the 12 encoder positions, and the
    self-attention cache on its 18.

Each runs a prefill of 12 tokens (B 4) and 2 greedy decode steps. The
JAX side runs in a subprocess with 6 forced host devices, from the JAX
package's own `init_params(PRNGKey(0))`, whose params it writes as numpy
for the port (`params_from_numpy`). The port's ranks are spawned CPU
processes over gloo (a `file://` rendezvous under the test's directory).
Every rank's logits and cache (gathered whole) are held to the JAX
package's: the int8 case within the int8 twin's atol 4e-3 x max and rtol
1e-2 (test_torch_models.py: both packages round q and p to bf16, so a
last-bit difference can move one rounding), its int8 leaves within 1;
the encdec case within rtol 1e-4 and atol 1e-5 x max. The greedy tokens
must be equal.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
DEADLINE_S = 240
B, S, STEPS = 4, 12, 2
# name: (arch, config changes, (data, model), cache max_len)
CASES = {"int8kv": ("smollm-135m", {"kv_cache_dtype": "int8"}, (1, 2), 16),
         "encdec": ("seamless-m4t-medium", {}, (1, 3), 18)}
TOL = {"int8kv": dict(rtol=1e-2, atol=4e-3),
       "encdec": dict(rtol=1e-4, atol=1e-5)}


def _tokens(cfg):
    return np.random.default_rng(7).integers(
        1, cfg.vocab_size, (B, S)).astype(np.int32)


# -- the JAX package on 6 forced host devices ----------------------------------

_JAX = r"""
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=6"
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, sys.argv[2])
import test_torch_cut_cache_jax as T
from repro.configs import get_config
from repro.distribution.context import with_mesh_context
from repro.distribution.sharding import (batch_shardings, cache_shardings,
                                         param_shardings)
from repro.launch.mesh import make_host_mesh
from repro.models import decode_step, init_cache, init_params, prefill_step
d = sys.argv[1]
for name, (arch, changes, (data, model), max_len) in T.CASES.items():
    cfg = dataclasses.replace(get_config(arch, reduced=True), **changes)
    mesh = make_host_mesh(data=data, model=model)
    params = init_params(cfg, jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    np.savez(f"{d}/{name}.params.npz", **{
        "/".join(str(k.key) for k in path): np.asarray(x)
        for path, x in flat})
    toks = jnp.asarray(T._tokens(cfg))
    batch = {"tokens": toks}
    if cfg.family == "encdec":
        batch["src_tokens"] = toks
    cache = init_cache(cfg, T.B, max_len, enc_len=T.S)
    ps = param_shardings(cfg, mesh, params)
    cs = cache_shardings(cfg, mesh, cache)
    bs = batch_shardings(cfg, mesh, batch)
    ts = batch_shardings(cfg, mesh, {"t": toks[:, :1]})["t"]
    out = {}
    with with_mesh_context(mesh):
        pre = jax.jit(prefill_step(cfg), in_shardings=(ps, bs, cs),
                      out_shardings=(None, cs))
        dec = jax.jit(decode_step(cfg), in_shardings=(ps, cs, ts),
                      out_shardings=(None, cs))
        logits, cache = pre(params, batch, cache)
        for i in range(T.STEPS):
            out[f"logits{i}"] = np.asarray(logits)
            tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(
                jnp.int32)
            out[f"tokens{i}"] = np.asarray(tok)
            logits, cache = dec(params, cache, tok)
    out[f"logits{T.STEPS}"] = np.asarray(logits)
    for k, v in cache.items():
        out[f"cache/{k}"] = np.asarray(v)
    out["cut"] = np.array(sorted(k for k, s in cs.items()
                                 if len(s.spec) > 3 and s.spec[3] == "model"))
    np.savez(f"{d}/{name}.jax.npz", **out)
print("JAX_OK")
"""


# -- the port's ranks over gloo -----------------------------------------------

_WORKER = r"""
import datetime, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, name, d = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                        sys.argv[4])
sys.path.insert(0, sys.argv[5])
dist.init_process_group("gloo", init_method=f"file://{d}/{name}.rendezvous",
                        world_size=world, rank=rank,
                        timeout=datetime.timedelta(seconds=120))
import test_torch_cut_cache_jax as T
np.savez(f"{d}/{name}.rank{rank}.npz", **T.port_case(name, d))
dist.barrier()
dist.destroy_process_group()
"""


def _unflatten(flat):
    tree = {}
    for path, x in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = x
    return tree


def port_case(name, d):
    """The case's prefill and greedy decode steps on this rank of its
    mesh, from the JAX package's params: {name: array}, gathered whole."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.distribution.context import with_mesh_context
    from repro_torch.distribution.sharding import (batch_shardings,
                                                   cache_shardings,
                                                   param_shardings)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import (decode_step, init_cache,
                                    params_from_numpy, prefill_step)
    from repro_torch.tree import tree_map
    arch, changes, (data, model), max_len = CASES[name]
    cfg = dataclasses.replace(get_config(arch, reduced=True), **changes)
    mesh = make_host_mesh(data=data, model=model)
    whole = params_from_numpy(
        cfg, _unflatten(dict(np.load(f"{d}/{name}.params.npz"))), "cpu")
    toks = torch.as_tensor(_tokens(cfg)).long()
    batch = {"tokens": toks}
    if cfg.family == "encdec":
        batch["src_tokens"] = toks
    cache = init_cache(cfg, B, max_len, enc_len=S, device="cpu")
    ps = param_shardings(cfg, mesh, whole)
    cs = cache_shardings(cfg, mesh, cache)
    bs = batch_shardings(cfg, mesh, batch)
    p_loc = tree_map(lambda s, x: s.shard(x), ps, whole)
    c_loc = {k: cs[k].shard(v) for k, v in cache.items()}
    rows = bs["tokens"]
    out = {}
    with torch.no_grad(), with_mesh_context(mesh, params=ps, cache=cs):
        logits, c_loc = prefill_step(cfg)(
            p_loc, {k: bs[k].shard(v) for k, v in batch.items()}, c_loc)
        for i in range(STEPS):
            out[f"logits{i}"] = rows.gather(logits).numpy()
            tok = rows.gather(torch.argmax(logits[:, -1], -1,
                                           keepdim=True))
            out[f"tokens{i}"] = tok.numpy()
            logits, c_loc = decode_step(cfg)(p_loc, c_loc, rows.shard(tok))
    out[f"logits{STEPS}"] = rows.gather(logits).numpy()
    for k, v in c_loc.items():
        out[f"cache/{k}"] = cs[k].gather(v).numpy()
    out["cut"] = np.array(sorted(k for k, s in cs.items()
                                 if len(s.spec) > 3 and s.spec[3] == "model"))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX side and each case's ranks, started together."""
    d = tmp_path_factory.mktemp("cut_cache")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    jax_run = subprocess.run(
        [sys.executable, "-c", _JAX, str(d), str(ROOT / "tests")], env=env,
        capture_output=True, text=True, timeout=DEADLINE_S)
    assert "JAX_OK" in jax_run.stdout, jax_run.stderr[-3000:]
    procs, logs = [], []
    for name, (_, _, (data, model), _) in CASES.items():
        procs += [(name, subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(r), str(data * model), name,
             str(d), str(ROOT / "tests")], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
            for r in range(data * model)]
    try:
        for _, p in procs:
            logs.append(p.communicate(timeout=DEADLINE_S)[0])
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for _, p in procs] == [0] * len(procs), logs
    return d


@pytest.mark.parametrize("name", list(CASES))
def test_cut_cache_decode_matches_jax(name, runs):
    arch, _, (data, model), _ = CASES[name]
    want = dict(np.load(runs / f"{name}.jax.npz"))
    # both packages cut these leaves on positions (dim 3) over model
    cut = ["k", "k_scale", "v", "v_scale"] if name == "int8kv" \
        else ["k", "v", "xk", "xv"]
    assert list(want["cut"]) == cut
    tol = TOL[name]
    for r in range(data * model):
        got = dict(np.load(runs / f"{name}.rank{r}.npz"))
        assert set(got) == set(want)
        for k, w in want.items():
            g = got[k]
            assert g.shape == w.shape, k
            if k.startswith(("tokens", "cut")):
                assert np.array_equal(g, w), (r, k)
            elif w.dtype == np.int8:
                # quantized from floats that agree to rounding: equal but
                # for values within rounding of a .5
                assert np.abs(g.astype(np.int32) - w.astype(np.int32)
                              ).max() <= 1, (r, k)
            else:
                np.testing.assert_allclose(
                    g.astype(np.float32), w.astype(np.float32),
                    rtol=tol["rtol"],
                    atol=tol["atol"] * float(np.abs(w).max() or 1.0),
                    err_msg=f"rank {r} {k}")
