"""The port's distribution layer against the JAX package's.

Twins of tests/test_distribution.py (all but its dry-run test, which
belongs to the launch tooling), of all 11 tests of
tests/test_sharding_pspecs.py and of test_perf_features.py's FSDP and
elastic-remesh tests. Specs are compared with the JAX package's as tuples,
leaf by leaf. The JAX side that needs several devices runs once, in a
subprocess with 8 forced host devices (as test_distribution.py does); the
port's multi-rank side runs as spawned CPU processes over gloo (one thread
each, a `file://` rendezvous under the test's directory, a bounded wait):

  * `pipeline_apply` on 4 ranks against the sequential reference (atol
    1e-5) and the JAX package's pipeline (atol 1e-6);
  * `compressed_psum` on 2 ranks, equal to the JAX package's shard_map
    psum;
  * data-parallel `train` on 2 ranks, zero1 on and off, against one rank
    at the same global batch (losses within rtol 1e-5; each state leaf
    within rtol 1e-5 and an atol of 1e-5 x its largest magnitude, as the
    gradient is summed in another order), both
    ranks' params equal bit for bit, and the zero1 moments' slices equal
    to DTensor's `distribute_tensor` under `placements`;
  * `elastic_remesh` of the 2-rank zero1 checkpoint onto 1 rank and back
    onto the 2 ranks' slices.
"""

import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as jget_config
from repro.configs import cell_applicable, input_specs
from repro.distribution import sharding as JS
from repro.launch.mesh import axis_types_kw
from repro.models import init_params as jinit_params
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distribution import sharding as S
from repro_torch.distribution.compression import (dequantize_int8,
                                                  quantize_int8)
from repro_torch.distribution.sharding import P
from repro_torch.launch.mesh import HostMesh, make_host_mesh, \
    make_production_mesh
from repro_torch.models.config import ModelConfig
from repro_torch.tree import flatten_with_path, leaves, path_str

ROOT = Path(__file__).resolve().parent.parent
DEADLINE_S = 240

CFG = ModelConfig(name="t", family="dense", num_layers=2, d_model=64,
                  num_heads=8, num_kv_heads=8, d_ff=256, vocab_size=128)


def _mesh(data=1, model=1, pod=0, data_index=0, model_index=0):
    """A HostMesh of the given shape seen from one rank (no groups: the
    specs need only the shape)."""
    shape = ({"pod": pod} if pod else {}) | {"data": data, "model": model}
    n = data * model * (pod or 1)
    return HostMesh(shape=shape, rank=data_index * model + model_index,
                    world=n, data_index=data_index, model_index=model_index)


def _shapes(jtree):
    """The JAX package's abstract tree as plain objects with a shape."""
    return jax.tree.map(lambda s: types.SimpleNamespace(shape=s.shape),
                        jtree)


def _specs(tree):
    """{path: spec tuple} of a port tree of NamedShardings."""
    return {path_str(p): tuple(s.spec) for p, s in flatten_with_path(tree)}


def _jspecs(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: hasattr(x, "spec"))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(s.spec) for path, s in flat}


def _jparams(arch):
    cfg = jget_config(arch)
    return jax.eval_shape(lambda k: jinit_params(cfg, k),
                          jax.random.PRNGKey(0))


# -- the JAX side on 8 forced host devices, once ------------------------------

_JAX8 = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro.configs import ARCH_IDS, get_config
from repro.distribution.compression import compressed_psum
from repro.distribution.pipeline import pipeline_apply, split_stages
from repro.distribution.sharding import (batch_shardings, cache_shardings,
                                         param_shardings, zero1_shardings)
from repro.launch.mesh import axis_types_kw, make_host_mesh
from repro.models import init_params
from repro.models.config import ModelConfig
out_dir = sys.argv[1]

def specs(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: hasattr(x, "spec"))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): list(s.spec) for path, s in flat}

res = {}
CFG = ModelConfig(name="t", family="dense", num_layers=2, d_model=64,
                  num_heads=8, num_kv_heads=8, d_ff=256, vocab_size=128)
mesh = make_host_mesh(data=2, model=4)
sds = lambda s: jax.ShapeDtypeStruct(s, np.float32)
res["batch"] = specs(batch_shardings(CFG, mesh, {
    "tokens": sds((4, 16)), "ragged": sds((3, 16)), "scalar": sds(())}))
res["cache"] = specs(cache_shardings(CFG, mesh, {
    "heads/k": sds((2, 4, 8, 16, 8)), "seq/k": sds((2, 4, 2, 16, 8)),
    "pos": sds(())}))
res["zero1_small"] = specs(zero1_shardings(CFG, mesh, {
    "blocks/mlp/wi": sds((2, 64, 256)), "blocks/ln/scale": sds((65,))}))
x = np.zeros((4, 16), np.float32)
sh = batch_shardings(CFG, mesh, {"x": sds(x.shape)})["x"]
arr = jax.device_put(x, sh)
res["placed"] = sorted({list(s.data.shape).__repr__()
                        for s in arr.addressable_shards})
for shape, name in (((2, 4), "2x4"), ((2, 2, 2), "2x2x2")):
    if len(shape) == 3:
        m = make_host_mesh(data=2, model=2, pod=2)
    else:
        m = make_host_mesh(data=shape[0], model=shape[1])
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        p = jax.eval_shape(lambda k: init_params(cfg, k),
                           jax.random.PRNGKey(0))
        res[f"params/{name}/{arch}"] = specs(param_shardings(cfg, m, p))
        res[f"zero1/{name}/{arch}"] = specs(zero1_shardings(cfg, m, p))

pmesh = jax.make_mesh((4,), ("pipe",), **axis_types_kw(1))
inp = np.load(os.path.join(out_dir, "pipe_in.npz"))
layer_fn = lambda w, x: jnp.tanh(x @ w)
pipe = pipeline_apply(pmesh, layer_fn, split_stages(jnp.asarray(inp["Ws"]), 4),
                      jnp.asarray(inp["xs"]))
cmesh = jax.make_mesh((2,), ("dp",), **axis_types_kw(1))
xs = jnp.asarray(inp["grads"])                   # (2, n): one row per rank
fn = shard_map(lambda x: compressed_psum(x[0], "dp", block=128),
               mesh=cmesh, in_specs=P("dp"), out_specs=(P(), P("dp")),
               check_rep=False)
mean, err = fn(xs)
np.savez(os.path.join(out_dir, "jax8.npz"), pipe=np.asarray(pipe),
         mean=np.asarray(mean), err=np.asarray(err))
with open(os.path.join(out_dir, "jax8.json"), "w") as f:
    json.dump(res, f)
print("JAX8_OK")
"""


def _pipe_inputs():
    rng = np.random.default_rng(0)
    L, D, M, mb = 8, 16, 6, 4
    return {"Ws": (rng.standard_normal((L, D, D)) * 0.1).astype(np.float32),
            "xs": rng.standard_normal((M, mb, D)).astype(np.float32),
            "grads": (rng.standard_normal((2, 1000)) * 3).astype(np.float32)}


@pytest.fixture(scope="module")
def jax8(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax8")
    np.savez(d / "pipe_in.npz", **_pipe_inputs())
    r = subprocess.run([sys.executable, "-c", _JAX8, str(d)],
                       capture_output=True, text=True, timeout=DEADLINE_S,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert "JAX8_OK" in r.stdout, r.stderr[-3000:]
    return (json.loads((d / "jax8.json").read_text()),
            dict(np.load(d / "jax8.npz")))


def _as_tuples(spec):
    return tuple(tuple(e) if isinstance(e, list) else e for e in spec)


# -- the port's ranks over gloo ------------------------------------------------

_WORKER = r"""
import datetime, json, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, mode, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
dist.init_process_group("gloo", init_method=f"file://{d}/rendezvous",
                        world_size=world, rank=rank,
                        timeout=datetime.timedelta(seconds=120))
out = {}
if mode == "pipe":
    from repro_torch.distribution.pipeline import pipeline_apply, split_stages
    inp = np.load(f"{d}/pipe_in.npz")
    out["pipe"] = pipeline_apply(
        dist.group.WORLD, lambda w, x: torch.tanh(x @ w),
        split_stages(torch.as_tensor(inp["Ws"]), world),
        torch.as_tensor(inp["xs"])).numpy()
elif mode == "psum":
    from repro_torch.distribution.compression import compressed_psum
    g = torch.as_tensor(np.load(f"{d}/pipe_in.npz")["grads"][rank])
    mean, err = compressed_psum(g, dist.group.WORLD, block=128)
    out["mean"], out["err"] = mean.numpy(), err.numpy()
else:
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.distribution.sharding import (device_mesh, placements,
                                                   zero1_shardings)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.loop import TrainConfig, train
    from repro_torch.tree import leaves
    from torch.distributed.tensor import distribute_tensor
    cfg = get_config("smollm-135m", reduced=True)
    mesh = make_host_mesh(data=world, model=1)
    for zero1 in (True, False):
        (params, opt), m = train(
            cfg, mesh, tc=TrainConfig(num_steps=3, zero1=zero1,
                                      save_every=3, log_every=1000,
                                      ckpt_dir=f"{d}/ckpt{int(zero1)}"),
            seq_len=16, global_batch=4, device="cpu")
        tag = f"z{int(zero1)}"
        out[tag + ":losses"] = np.array(m["losses"])
        for i, p in enumerate(leaves(params)):
            out[f"{tag}:p{i}"] = p.numpy()
        for i, p in enumerate(leaves(opt["mu"])):
            out[f"{tag}:mu{i}"] = p.numpy()
    # the zero1 slices are DTensor's shards under the same placements
    dm = device_mesh(mesh, "cpu")
    full = {k: torch.arange(float(np.prod(v.shape))).reshape(v.shape)
            for k, v in {"embed": torch.empty(512, 192),
                         "ln": torch.empty(3, 192)}.items()}
    for k, s in zero1_shardings(cfg, mesh, full).items():
        dt = distribute_tensor(full[k], dm, placements(s.spec,
                                                       dm.mesh_dim_names))
        out[f"dtensor:{k}"] = np.array(
            torch.equal(dt.to_local(), s.shard(full[k])))
np.savez(f"{d}/rank{rank}.npz", **out)
dist.barrier()
dist.destroy_process_group()
"""


def _spawn(d, world, mode):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(world), mode, str(d)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
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
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def dp_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp")
    return d, _spawn(d, 2, "train")


# -- twins of tests/test_distribution.py ---------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_shardings_cover_every_leaf(arch):
    """Every param leaf gets a spec whose sharded dims divide evenly, the
    JAX package's spec for every leaf."""
    cfg = get_config(arch)
    jcfg = jget_config(arch)
    jtree = _jparams(arch)
    tp = 16
    n_sharded = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        ps = "/".join(str(getattr(p, "key", p)) for p in path)
        spec = S.param_pspec(ps, leaf.shape, cfg, tp)
        assert tuple(spec) == tuple(JS.param_pspec(ps, leaf.shape, jcfg, tp))
        assert tuple(S.param_pspec(ps, leaf.shape, cfg, tp, n_data=16)) == \
            tuple(JS.param_pspec(ps, leaf.shape, jcfg, tp, n_data=16))
        assert len(spec) <= len(leaf.shape), (ps, spec, leaf.shape)
        for dim, ax in zip(leaf.shape, tuple(spec)):
            if ax == "model":
                assert dim % tp == 0
                n_sharded += 1
    assert n_sharded >= 4, f"{arch}: almost nothing sharded"


# the cells the JAX package's test runs (it skips the inapplicable ones by
# design; the decision reads only the configs)
CACHE_CELLS = [(a, s) for a in ("smollm-135m", "mixtral-8x22b", "rwkv6-1.6b",
                                "zamba2-1.2b")
               for s in ("decode_32k", "long_500k")
               if cell_applicable(jget_config(a), s)[0]]


@pytest.mark.parametrize("arch,shape", CACHE_CELLS)
def test_cache_shardings_valid(arch, shape):
    jcfg = jget_config(arch)
    specs = input_specs(jcfg, shape)["cache"]
    jmesh = jax.make_mesh((1, 1), ("data", "model"), **axis_types_kw(2))
    want = _jspecs(JS.cache_shardings(jcfg, jmesh, specs))
    got = S.cache_shardings(get_config(arch), _mesh(), _shapes(specs))
    assert all(isinstance(s, S.NamedSharding) for s in leaves(got))
    assert _specs(got) == want


def test_zero1_adds_data_axis():
    cfg = get_config("qwen1.5-110b")
    jtree = _jparams("qwen1.5-110b")
    z = S.zero1_shardings(cfg, _mesh(), _shapes(jtree))
    found_data = sum(any(a == "data" for a in S._flat_axes(s.spec))
                     for s in leaves(z))
    assert found_data > 10, "ZeRO-1 did not shard moments over data"
    jmesh = jax.make_mesh((1, 1), ("data", "model"), **axis_types_kw(2))
    assert _specs(z) == _jspecs(JS.zero1_shardings(
        jget_config("qwen1.5-110b"), jmesh, jtree))


def test_pipeline_matches_sequential(tmp_path, jax8):
    inp = _pipe_inputs()
    np.savez(tmp_path / "pipe_in.npz", **inp)
    ranks = _spawn(tmp_path, 4, "pipe")
    ref = torch.as_tensor(inp["xs"])
    for w in torch.as_tensor(inp["Ws"]):
        ref = torch.tanh(ref @ w)
    for got in ranks:
        np.testing.assert_allclose(got["pipe"], ref.numpy(), atol=1e-5)
        np.testing.assert_allclose(got["pipe"], jax8[1]["pipe"], atol=1e-6)


def test_compressed_psum_error_feedback():
    """int8 EF-psum: single-step error bounded; the payload is the JAX
    package's bit for bit."""
    from repro.distribution.compression import (
        dequantize_int8 as jdequantize, quantize_int8 as jquantize)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(1000).astype(np.float32) * 3
    q, s, n = quantize_int8(torch.as_tensor(x), block=128)
    back = dequantize_int8(q, s, n, x.shape)
    err = np.abs(back.numpy() - x)
    assert err.max() < np.abs(x).max() / 127 + 1e-6
    jq, js, jn = jquantize(jnp.asarray(x), block=128)
    assert n == jn and q.dtype == torch.int8
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy(), np.asarray(js))
    assert np.array_equal(back.numpy(), np.asarray(jdequantize(
        jq, js, jn, x.shape)))


def test_compressed_psum_two_ranks(tmp_path, jax8):
    np.savez(tmp_path / "pipe_in.npz", **_pipe_inputs())
    ranks = _spawn(tmp_path, 2, "psum")
    want = jax8[1]
    for r, got in enumerate(ranks):
        assert np.array_equal(got["mean"], want["mean"])
        assert np.array_equal(got["err"], want["err"][r * 1000:
                                                      (r + 1) * 1000])


# -- twins of tests/test_sharding_pspecs.py --------------------------------------

def test_param_pspec_column_parallel():
    assert S.param_pspec("blocks/attn/wq", (2, 64, 64), CFG, tp=4) \
        == P(None, None, "model")
    assert S.param_pspec("blocks/mlp/wi", (2, 64, 256), CFG, tp=4) \
        == P(None, None, "model")
    assert tuple(S.param_pspec("blocks/attn/wq", (2, 64, 64), CFG, 4)) == \
        tuple(JP(None, None, "model"))


def test_param_pspec_row_parallel():
    assert S.param_pspec("blocks/attn/wo", (2, 64, 64), CFG, tp=4) \
        == P(None, "model", None)
    assert S.param_pspec("blocks/mlp/wo", (2, 256, 64), CFG, tp=4) \
        == P(None, "model", None)


def test_param_pspec_embeddings_shard_vocab():
    assert S.param_pspec("embed/table", (128, 64), CFG, tp=4) \
        == P("model", None)
    assert S.param_pspec("lm_head/w", (64, 128), CFG, tp=4) \
        == P(None, "model")


def test_param_pspec_replicates_norms_and_non_divisible():
    assert S.param_pspec("blocks/ln/scale", (64,), CFG, tp=4) == P()
    # output dim 10 is not divisible by tp=4: replicate, never misshard
    assert S.param_pspec("blocks/attn/wq", (2, 64, 10), CFG, tp=4) == P()


def _sds(shape):
    return types.SimpleNamespace(shape=shape)


def test_batch_shardings_on_mesh(jax8):
    sh = S.batch_shardings(CFG, _mesh(2, 4), {
        "tokens": _sds((4, 16)), "ragged": _sds((3, 16)),
        "scalar": _sds(())})
    assert sh["tokens"].spec == P(("data",), None)
    # batch 3 does not divide data=2: replicated, not crashed
    assert sh["ragged"].spec == P()
    assert sh["scalar"].spec == P()
    assert _specs(sh) == {k: _as_tuples(v)
                          for k, v in jax8[0]["batch"].items()}


def test_cache_shardings_heads_over_model(jax8):
    sh = S.cache_shardings(CFG, _mesh(2, 4),
                           {"heads/k": _sds((2, 4, 8, 16, 8))})
    assert sh["heads/k"].spec == P(None, ("data",), "model", None, None)
    assert tuple(sh["heads/k"].spec) == _as_tuples(
        jax8[0]["cache"]["heads/k"])


def test_cache_shardings_sequence_fallback(jax8):
    # 2 kv heads do not divide model=4: the sequence dim shards instead
    sh = S.cache_shardings(CFG, _mesh(2, 4),
                           {"seq/k": _sds((2, 4, 2, 16, 8))})
    assert sh["seq/k"].spec == P(None, ("data",), None, "model", None)
    assert tuple(sh["seq/k"].spec) == _as_tuples(jax8[0]["cache"]["seq/k"])


def test_cache_shardings_scalar_pos_replicated(jax8):
    sh = S.cache_shardings(CFG, _mesh(2, 4), {"pos": _sds(())})
    assert sh["pos"].spec == P()
    assert tuple(sh["pos"].spec) == _as_tuples(jax8[0]["cache"]["pos"])


def test_zero1_adds_data_on_first_free_dim(jax8):
    sh = S.zero1_shardings(CFG, _mesh(2, 4),
                           {"blocks/mlp/wi": _sds((2, 64, 256))})
    # param spec is (None, None, model); ZeRO-1 grabs dim 0 (2 % 2 == 0)
    assert sh["blocks/mlp/wi"].spec == P("data", None, "model")
    assert tuple(sh["blocks/mlp/wi"].spec) == _as_tuples(
        jax8[0]["zero1_small"]["blocks/mlp/wi"])


def test_zero1_keeps_param_spec_when_nothing_free(jax8):
    # every dim is either sharded or not data-divisible: unchanged
    sh = S.zero1_shardings(CFG, _mesh(2, 4),
                           {"blocks/ln/scale": _sds((65,))})
    assert sh["blocks/ln/scale"].spec == P(None)
    assert tuple(sh["blocks/ln/scale"].spec) == _as_tuples(
        jax8[0]["zero1_small"]["blocks/ln/scale"])


def test_shardings_place_real_arrays(jax8):
    """The specs are usable, not just well-formed: each data rank's slice
    of a (4, 16) batch is (2, 16), the two slices tile it, and DTensor's
    placements name the same cut."""
    x = torch.arange(64.0).reshape(4, 16)
    got = []
    for d in range(2):
        sh = S.batch_shardings(CFG, _mesh(2, 4, data_index=d),
                               {"x": _sds(tuple(x.shape))})["x"]
        got.append(sh.shard(x))
    assert {tuple(g.shape) for g in got} == {(2, 16)}
    assert jax8[0]["placed"] == ["[2, 16]"]
    assert torch.equal(torch.cat(got), x)
    from torch.distributed.tensor import Replicate, Shard
    assert S.placements(sh.spec, ("data", "model")) == (Shard(0),
                                                        Replicate())


@pytest.mark.parametrize("mesh_name", ["2x4", "2x2x2"])
def test_param_and_zero1_specs_match_jax_on_every_arch(mesh_name, jax8):
    """param_shardings and zero1_shardings of every arch's full-size
    params on the (2, 4) and (2, 2, 2) meshes: the JAX package's specs,
    leaf for leaf."""
    mesh = _mesh(2, 4) if mesh_name == "2x4" else _mesh(2, 2, pod=2)
    for arch in ARCH_IDS:
        tree = _shapes(_jparams(arch))
        cfg = get_config(arch)
        for kind, fn in (("params", S.param_shardings),
                         ("zero1", S.zero1_shardings)):
            want = {k: _as_tuples(v) for k, v in
                    jax8[0][f"{kind}/{mesh_name}/{arch}"].items()}
            assert _specs(fn(cfg, mesh, tree)) == want, (kind, arch)


def test_production_mesh_refuses_a_small_world():
    with pytest.raises(ValueError, match="256 ranks; the world has 1"):
        make_production_mesh()
    with pytest.raises(ValueError, match="512 ranks; the world has 1"):
        make_production_mesh(multi_pod=True)


# -- twins of tests/test_perf_features.py:88,119 ----------------------------------

def test_fsdp_shardings_shard_over_data():
    cfg = get_config("qwen1.5-110b")          # fsdp=True default
    assert cfg.fsdp
    jtree = _jparams("qwen1.5-110b")
    sh = S.param_shardings(cfg, _mesh(), _shapes(jtree))
    n_data = sum(any(a == "data" for a in S._flat_axes(s.spec))
                 for s in leaves(sh))
    assert n_data >= 5, "FSDP did not shard large leaves over data"
    jmesh = jax.make_mesh((1, 1), ("data", "model"), **axis_types_kw(2))
    assert _specs(sh) == _jspecs(JS.param_shardings(
        jget_config("qwen1.5-110b"), jmesh, jtree))


def test_elastic_remesh_roundtrip(tmp_path):
    """Checkpoint written under one sharding restores under another."""
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.fault import elastic_remesh
    tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8)}
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, tree)

    def make_shardings(like):
        return {"w": S.NamedSharding(_mesh(), P("data", None))}

    restored, step = elastic_remesh(mgr, tree, make_shardings)
    assert step == 1
    assert torch.equal(restored["w"], tree["w"])
    # onto the second of two data ranks: its half
    restored, _ = elastic_remesh(mgr, tree, lambda like: {
        "w": S.NamedSharding(_mesh(2, 1, data_index=1), P("data", None))})
    assert torch.equal(restored["w"], tree["w"][4:])


# -- data parallelism on 2 gloo ranks ----------------------------------------------

class _Global:
    """The 2-rank run's global batch for a one-rank run: both shards of
    the same step, in rank order."""

    def __init__(self, ds, n):
        self.ds, self.n = ds, n

    def batch(self, step, shard=0, n_shards=1):
        parts = [self.ds.batch(step, i, self.n) for i in range(self.n)]
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("zero1", [True, False], ids=["zero1", "no_zero1"])
def test_data_parallel_train_matches_one_rank(zero1, dp_ranks):
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.train.loop import TrainConfig, train
    _, ranks = dp_ranks
    cfg = get_config("smollm-135m", reduced=True)
    data = _Global(SyntheticTokens(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=16, global_batch=4, seed=0)), 2)
    (params, opt), m = train(
        cfg, make_host_mesh(1, 1),
        tc=TrainConfig(num_steps=3, zero1=zero1, log_every=1000),
        data=data, device="cpu")
    tag = f"z{int(zero1)}"
    for r in ranks:
        np.testing.assert_allclose(r[tag + ":losses"], m["losses"],
                                   rtol=1e-5)
        for i, p in enumerate(leaves(params)):
            # both ranks hold the same params, bit for bit
            assert np.array_equal(r[f"{tag}:p{i}"], ranks[0][f"{tag}:p{i}"])
            _close(r[f"{tag}:p{i}"], p.numpy())
    for i, mu in enumerate(leaves(opt["mu"])):
        got = [r[f"{tag}:mu{i}"] for r in ranks]
        if zero1 and got[0].shape != tuple(mu.shape):
            dim = next(d for d, (a, b) in enumerate(zip(got[0].shape,
                                                        mu.shape)) if a != b)
            got = [np.concatenate(got, dim)]
        _close(got[0], mu.numpy())
    if zero1:
        assert all(bool(r["dtensor:embed"]) and bool(r["dtensor:ln"])
                   for r in ranks)


def test_elastic_remesh_from_two_ranks(dp_ranks):
    """The 2-rank zero1 run's checkpoint (written once, gathered by rank
    0) restores onto the 1 x 1 mesh whole and onto each of the two data
    ranks as that rank's slices of the moments."""
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.fault import elastic_remesh
    from repro_torch.train.loop import build_state
    d, ranks = dp_ranks
    cfg = get_config("smollm-135m", reduced=True)
    mgr = CheckpointManager(str(d / "ckpt1"))
    assert mgr.latest_step() == 2
    params, opt, (p1, o1) = build_state(cfg, make_host_mesh(1, 1),
                                        device="cpu")
    (rp, ro), step = elastic_remesh(mgr, (params, opt),
                                    lambda like: (p1, o1))
    assert step == 2 and int(ro["step"]) == 3
    for i, p in enumerate(leaves(rp)):
        assert np.array_equal(p.numpy(), ranks[0][f"z1:p{i}"])
    for r in range(2):
        mesh = _mesh(2, 1, data_index=r)
        p2, o2, (ps, os_) = build_state(cfg, mesh, device="cpu")
        (_, ro2), _ = elastic_remesh(mgr, (p2, o2), lambda like: (ps, os_))
        for i, mu in enumerate(leaves(ro2["mu"])):
            assert np.array_equal(mu.numpy(), ranks[r][f"z1:mu{i}"])
