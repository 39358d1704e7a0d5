"""Tensor parallelism (a model axis above 1) and params cut over data, on
spawned CPU ranks over gloo, against one rank with everything whole.

One world per mesh, (1, 2) and (2, 2), runs every case in one spawn: for
each family (dense smollm-135m, whose 3 q heads and 1 kv head do not
divide over 2; moe mixtral-8x22b with cfg.fsdp, its vocab widened to
8192 so that the embedding and head reach ZeRO-3's 2**20-element floor,
and its experts cut over data on the (2, 2) mesh; RWKV rwkv6-1.6b; hybrid
zamba2-1.2b; encdec seamless-m4t-medium, also with cfg.fsdp under full
remat, its layers gathered one at a time; all reduced, float32) a ZeRO-1
train step (params and moments after the step, gathered whole) and a
prefill plus 2 greedy decode steps (logits and the cache, gathered whole).
The cut caches and the paths only the dry run counted have cases too:

  * `smollm-135m+int8kv`: the int8 KV cache and its scales cut on
    positions (1 kv head over 2 ranks);
  * `smollm-135m+int8kv+gqa`: 6 q heads in groups of 2 over 3 kv heads,
    a cache of 15 positions that stays whole, each rank holding one and a
    half groups of q heads;
  * `seamless-m4t-medium+3heads`: d_model 96 in 3 heads, so the
    cross-attention keys and values are cut on the 12 encoder positions;
  * `mixtral-8x22b+sorted` and `arctic-480b` (its dense residual MLP):
    the sorted dispatch under cfg.fsdp, vocab 8192;
  * qwen1.5-110b (QKV bias), pixtral-12b with and without the vision
    stub's `frontend_embeds`, internlm2-20b and minicpm-2b.

The 4-rank world also runs smollm and `smollm-135m+int8kv` on a (pod 2,
data 1, model 2) mesh. Each rank's result is held to the one-rank run
computed here within rtol 1e-4 and an atol of 1e-5 x the leaf's largest
magnitude; in the int8 cases what the int8 decode computes (the decode
steps' logits and the cache's float leaves) is held within the int8
twin's rtol 1e-2 and atol 4e-3 x max (test_torch_models.py), since that
decode rounds q and p to bf16 and a last-bit difference in the softmax's
sum, whose order the cut changes, can move one bf16 rounding; their int8
leaves may differ by 1 where a scaled value lands within rounding of a
.5, and the train step and the prefill's logits keep the float limit.
Every case's greedy tokens equal the one rank's. The step's AdamW
takes eps 1e-3: its first step maps a gradient g to about g / (|g| +
eps), so at the default 1e-8 a gradient that is 0 in exact arithmetic
(a key bias's, by the softmax's shift invariance) or a few 1e-9 (rows of
the tied table that no token of the batch uses) turns the summation
order's rounding, which any data-parallel run changes too, into a large
part of a step; the moments, which hold the gradients themselves, are
compared at the same tolerance. The (1, 2) world also writes a
checkpoint that one rank restores here, and restores one written here
onto its slices.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.distribution.context import with_mesh_context
from repro_torch.distribution.sharding import (NamedSharding, P,
                                               batch_shardings,
                                               cache_shardings)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import decode_step, init_cache, prefill_step
from repro_torch.models.transformer import init_params
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.loop import build_state, sharded_train_step
from repro_torch.train.optimizer import OptConfig
from repro_torch.tree import flatten_with_path, leaves, path_str, tree_map

ROOT = Path(__file__).resolve().parent.parent
DEADLINE_S = 240
ARCHS = ("smollm-135m", "mixtral-8x22b", "rwkv6-1.6b", "zamba2-1.2b",
         "seamless-m4t-medium", "seamless-m4t-medium+fsdp",
         "smollm-135m+int8kv", "smollm-135m+int8kv+gqa",
         "seamless-m4t-medium+3heads", "mixtral-8x22b+sorted",
         "arctic-480b", "qwen1.5-110b", "pixtral-12b",
         "pixtral-12b+frontend", "internlm2-20b", "minicpm-2b")
# the cases run on the (1, 2, 2) pod mesh of the 4-rank world as well
POD_ARCHS = ("smollm-135m", "smollm-135m+int8kv")
B, S_TRAIN, S_PRE, MAX_LEN = 4, 16, 12, 16
OPT = OptConfig(total_steps=10, warmup_steps=1, eps=1e-3)


def _cfg(arch):
    cfg = get_config(arch.split("+")[0], reduced=True)
    if arch in ("mixtral-8x22b", "mixtral-8x22b+sorted", "arctic-480b"):
        cfg = dataclasses.replace(cfg, fsdp=True, vocab_size=8192)
    if arch in ("mixtral-8x22b+sorted", "arctic-480b"):
        cfg = dataclasses.replace(cfg, moe_dispatch="sorted")
    if arch == "seamless-m4t-medium+fsdp":
        # ZeRO-3 gathered per layer under full remat: d_ff 4096 takes the
        # MLPs past the 2**20-element floor; over 2 data ranks the 2
        # encoder layers are cut on their layer dim, the 3 decoder layers
        # on d_model
        cfg = dataclasses.replace(cfg, fsdp=True, d_ff=4096, dec_layers=3,
                                  remat="full")
    if arch == "seamless-m4t-medium+3heads":
        # 3 heads do not divide over 2: xk/xv (and k/v) cut on positions
        cfg = dataclasses.replace(cfg, d_model=96, num_heads=3,
                                  num_kv_heads=3)
    if "+int8kv" in arch:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    if arch.endswith("+gqa"):
        # 6 q heads in groups of 2 over 3 kv heads: each of 2 model ranks
        # holds 3 q heads, one and a half groups
        cfg = dataclasses.replace(cfg, num_heads=6, num_kv_heads=3)
    return cfg


def _max_len(arch):
    # positions that do not divide over 2 leave the cache whole: the
    # "+gqa" case then reads part of a GQA group over a whole cache
    return 15 if arch.endswith("+gqa") else MAX_LEN


def _batch(cfg, S, train, frontend=False):
    rng = np.random.default_rng(1)
    t = lambda: torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)))
    batch = {"tokens": t()}
    if train:
        batch["labels"] = t()
    if cfg.family == "encdec":
        batch["src_tokens"] = t()
    if frontend:
        # the vision stub's embeddings in place of the first tokens'
        batch["frontend_embeds"] = torch.as_tensor(rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32))
    return batch


def _np(tree, prefix):
    return {f"{prefix}/{path_str(p)}": x.detach().float().numpy()
            for p, x in flatten_with_path(tree)}


def run_case(arch, mesh):
    """One case's train step and serving steps on `mesh` (this rank's
    slices), every result gathered whole: {name: array} (int8 cache
    leaves kept int8)."""
    cfg = _cfg(arch)
    frontend = arch.endswith("+frontend")
    whole = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    out = {}
    params, opt, (ps, os_) = build_state(cfg, mesh, params=whole,
                                         device="cpu")
    step = sharded_train_step(cfg, mesh, OPT, ps, os_)
    batch = _batch(cfg, S_TRAIN, True, frontend)
    bs = batch_shardings(cfg, mesh, batch)
    params, opt, m = step(params, opt,
                          {k: bs[k].shard(v) for k, v in batch.items()})
    out["loss"] = np.array(float(m["loss"]))
    out.update(_np(tree_map(lambda s, x: s.gather(x), ps, params), "p"))
    out.update(_np(tree_map(lambda s, x: s.gather(x), os_["mu"],
                            opt["mu"]), "mu"))

    batch = _batch(cfg, S_PRE, False, frontend)
    bs = batch_shardings(cfg, mesh, batch)
    cache = init_cache(cfg, B, _max_len(arch), enc_len=S_PRE, device="cpu")
    cs = cache_shardings(cfg, mesh, cache)
    rows = bs["tokens"]
    p_loc = tree_map(lambda s, x: s.shard(x), ps, whole)
    c_loc = {k: cs[k].shard(v) for k, v in cache.items()}
    with torch.no_grad(), with_mesh_context(mesh, params=ps, cache=cs):
        logits, c_loc = prefill_step(cfg)(
            p_loc, {k: bs[k].shard(v) for k, v in batch.items()}, c_loc)
        for i in range(2):
            lg = NamedSharding(mesh, P(rows.spec[0] if rows.spec else None))
            out[f"logits{i}"] = lg.gather(logits).numpy()
            tok = torch.argmax(logits[:, -1], -1, keepdim=True)
            logits, c_loc = decode_step(cfg)(p_loc, c_loc, tok)
    out["logits2"] = lg.gather(logits).numpy()
    for k, v in c_loc.items():
        v = cs[k].gather(v)
        out[f"cache/{k}"] = (v if v.dtype == torch.int8 else v.float()).numpy()
    return out


def remat_case(mesh):
    """Gradients of smollm with remat "full" when autograd runs the
    backward outside the caller's mesh context (as on CUDA, where it runs
    in a thread of its own): the largest difference from the gradients
    taken inside it, over their largest magnitude."""
    from repro_torch.models.transformer import train_loss
    from repro_torch.distribution.sharding import param_shardings
    from repro_torch.tree import unflatten
    cfg = dataclasses.replace(_cfg("smollm-135m"), remat="full")
    whole = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ps = param_shardings(cfg, mesh, whole)
    flat = [s.shard(x).requires_grad_(True)
            for s, x in zip(leaves(ps), leaves(whole))]
    batch = _batch(cfg, S_TRAIN, True)
    bs = batch_shardings(cfg, mesh, batch)
    local = {k: bs[k].shard(v) for k, v in batch.items()}
    with with_mesh_context(mesh, params=ps):
        loss, _ = train_loss(cfg)(unflatten(whole, flat), local)
        inside = torch.autograd.grad(loss, flat)
        loss, _ = train_loss(cfg)(unflatten(whole, flat), local)
    outside = torch.autograd.grad(loss, flat)
    return max(float((a - b).abs().max() / (b.abs().max() + 1e-30))
               for a, b in zip(outside, inside))


# (src, dst) spec pairs of a (4, 4, 8, 6) leaf: a re-cut of one axis
# (all-to-all), cuts only one side has, an axis moving between dims, and
# the 2-D experts' gradient into ZeRO-1's moment layout
RELAYOUTS = [(("data", None, None, None), (None, "data", None, None)),
             ((None, None, None, "model"), (None, "model", None, None)),
             (("data", None, None, "model"), (None, "model", "data", None)),
             ((None, "data", None, "model"), (None, "model", "data", None)),
             ((None, None, None, None), ("data", None, "model", None)),
             (("data", "model", None, None), (None, None, None, None)),
             (((("data", "model")), None, None, None),
              (None, None, ("data", "model"), None))]


def relayout_case(mesh):
    """`relayout` of this rank's slices against cutting the whole leaf
    under the destination spec, for every pair of RELAYOUTS."""
    from repro_torch.distribution.sharding import relayout
    x = torch.arange(4 * 4 * 8 * 6, dtype=torch.float32).reshape(4, 4, 8, 6)
    ok = True
    for a, b in RELAYOUTS:
        src, dst = NamedSharding(mesh, P(*a)), NamedSharding(mesh, P(*b))
        ok &= torch.equal(relayout(src.shard(x), src, dst), dst.shard(x))
    return ok


def _one_rank(arch):
    return run_case(arch, make_host_mesh(1, 1))


_WORKER = r"""
import datetime, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, data, d = (int(sys.argv[1]), int(sys.argv[2]),
                        int(sys.argv[3]), sys.argv[4])
sys.path.insert(0, sys.argv[5])
dist.init_process_group("gloo", init_method=f"file://{d}/rendezvous",
                        world_size=world, rank=rank,
                        timeout=datetime.timedelta(seconds=120))
import test_torch_tensor_parallel as T
from repro_torch.launch.mesh import make_host_mesh
mesh = make_host_mesh(data=data, model=world // data)
for arch in T.ARCHS:
    np.savez(f"{d}/{arch}.rank{rank}.npz", **T.run_case(arch, mesh))
np.savez(f"{d}/remat.rank{rank}.npz", err=np.array(T.remat_case(mesh)))
np.savez(f"{d}/relayout.rank{rank}.npz", ok=np.array(T.relayout_case(mesh)))
if data == 1:
    T.checkpoint_case(mesh, d)
else:
    pod = make_host_mesh(data=1, model=2, pod=world // 2)
    for arch in T.POD_ARCHS:
        np.savez(f"{d}/pod.{arch}.rank{rank}.npz", **T.run_case(arch, pod))
dist.barrier()
dist.destroy_process_group()
"""


def checkpoint_case(mesh, d):
    """Write the smollm state on this mesh (each rank its slices, the
    whole leaf on disk) and restore the one written by one rank."""
    cfg = _cfg("smollm-135m")
    whole = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    params, opt, layout = build_state(cfg, mesh, params=whole,
                                      device="cpu")
    CheckpointManager(f"{d}/ckpt_ranks", layout=layout).save(
        5, (params, opt))
    (rp, ro), step = CheckpointManager(
        f"{d}/ckpt_one", layout=layout).restore((params, opt))
    ok = step == 7 and all(
        torch.equal(a, s.shard(b)) for a, s, b in
        zip(leaves(rp), leaves(layout[0]), leaves(whole)))
    np.savez(f"{d}/ckpt.rank{mesh.rank}.npz", ok=np.array(ok))


def _spawn(d, world, data):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(world), str(data),
         str(d), str(ROOT / "tests")],
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
    return d


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = {}
    for name, (world, data) in {"1x2": (2, 1), "2x2": (4, 2)}.items():
        d = tmp_path_factory.mktemp(name)
        if data == 1:
            # the one-rank checkpoint the ranks restore
            cfg = _cfg("smollm-135m")
            whole = init_params(cfg, torch.Generator().manual_seed(3),
                                "cpu")
            params, opt, _ = build_state(cfg, make_host_mesh(1, 1),
                                         params=whole, device="cpu")
            CheckpointManager(str(d / "ckpt_one"), async_save=False).save(
                7, (params, opt))
        out[name] = (_spawn(d, world, data), world)
    return out


@pytest.fixture(scope="module")
def one_rank():
    return {arch: _one_rank(arch) for arch in ARCHS}


def _close(got, want, key, arch, name):
    if want.dtype == np.int8:
        # int8 caches quantize floats that agree to float32 rounding:
        # equal but for values whose scaled float lands within rounding
        # of a .5
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)
                      ).max() <= 1, name
        return
    # the int8 decode's limit for what it computes (it rounds q and p to
    # bf16); the float limit for the train step and the prefill
    int8_decode = "+int8kv" in arch and key.startswith(
        ("logits1", "logits2", "cache/"))
    rtol, atol = (1e-2, 4e-3) if int8_decode else (1e-4, 1e-5)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * float(np.abs(want).max() or 1.0),
                               err_msg=name)


def _check_ranks(d, world, arch, want, prefix=""):
    for r in range(world):
        got = dict(np.load(d / f"{prefix}{arch}.rank{r}.npz"))
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], k, arch, f"rank {r} {k}")
        # the greedy tokens are the one rank's
        for i in range(3):
            assert np.array_equal(got[f"logits{i}"].argmax(-1),
                                  want[f"logits{i}"].argmax(-1))


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_steps_match_one_rank(arch, mesh, worlds, one_rank):
    d, world = worlds[mesh]
    _check_ranks(d, world, arch, one_rank[arch])


@pytest.mark.parametrize("arch", POD_ARCHS)
def test_pod_mesh_matches_one_rank(arch, worlds, one_rank):
    """The (pod 2, data 1, model 2) mesh of the 4-rank world: rows cut
    over pod x data, the caches' positions over `model`."""
    d, world = worlds["2x2"]
    _check_ranks(d, world, arch, one_rank[arch], "pod.")


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_remat_recomputes_in_the_mesh_context(mesh, worlds):
    """A checkpointed layer's recomputation runs its collectives however
    autograd schedules it: backward outside the caller's context gives
    the gradients of backward inside it."""
    d, world = worlds[mesh]
    for r in range(world):
        assert float(np.load(d / f"remat.rank{r}.npz")["err"]) < 1e-6


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_relayout_matches_cutting_the_whole_leaf(mesh, worlds):
    """Moving a slice between layouts (all-to-all, cuts, gathers in the
    order that never holds more than a slice) gives the destination's
    slice of the whole leaf."""
    d, world = worlds[mesh]
    for r in range(world):
        assert bool(np.load(d / f"relayout.rank{r}.npz")["ok"])


def test_checkpoint_between_two_ranks_and_one(worlds, tmp_path):
    """The (1, 2) world's checkpoint (whole leaves on disk) restores on
    one rank as the state it was cut from, and the one-rank checkpoint
    restored onto each rank's slices (checked in the ranks)."""
    d, world = worlds["1x2"]
    assert all(bool(np.load(d / f"ckpt.rank{r}.npz")["ok"])
               for r in range(world))
    cfg = _cfg("smollm-135m")
    whole = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    params, opt, _ = build_state(cfg, make_host_mesh(1, 1), params=whole,
                                 device="cpu")
    (rp, ro), step = CheckpointManager(str(d / "ckpt_ranks")).restore(
        (params, opt))
    assert step == 5
    for a, b in zip(leaves((rp, ro)), leaves((params, opt))):
        assert torch.equal(a, b)


def test_build_state_cuts_params_over_model_and_data():
    """`build_state` places params by `param_shardings` on any mesh: the
    model axis cuts the projections, cfg.fsdp and the 2-D experts cut over
    data (a mesh without a process group, as each rank sees it)."""
    from repro_torch.launch.mesh import HostMesh
    cfg = _cfg("mixtral-8x22b")
    whole = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    mesh = HostMesh(shape={"data": 2, "model": 2}, rank=3, world=4,
                    data_index=1, model_index=1)
    params, opt, (ps, _) = build_state(cfg, mesh, params=whole,
                                       device="cpu")
    L, E, D, F = whole["layers"]["moe"]["wi"].shape
    assert params["layers"]["moe"]["wi"].shape == (L, E // 2, D, F // 2)
    assert torch.equal(params["layers"]["moe"]["wi"],
                       whole["layers"]["moe"]["wi"][:, 2:, :, F // 2:])
    V = cfg.vocab_size
    assert params["embed"]["table"].shape == (V // 2, D // 2)
    assert params["layers"]["attn"]["wq"].shape[-1] * 2 == \
        whole["layers"]["attn"]["wq"].shape[-1]


def test_zero3_gathers_one_layer_at_a_time():
    """Under cfg.fsdp the leaves of the stacked layers are gathered where
    their layer runs: `materialize` leaves them as this rank's slices
    (save those cut on their layer dim, whose layers lie on different
    ranks), and `layer_whole` gives one layer whole."""
    from repro_torch.distribution.sharding import param_shardings
    from repro_torch.distribution.tensor_parallel import (layer_whole,
                                                          materialize)
    from repro_torch.launch.mesh import HostMesh
    from repro_torch.models.transformer import layer
    cfg = _cfg("seamless-m4t-medium+fsdp")
    whole = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    mesh = HostMesh(shape={"data": 2, "model": 1}, rank=1, world=2,
                    data_index=1, model_index=0)
    ps = param_shardings(cfg, mesh, whole)
    assert ps["enc_layers"]["mlp"]["wi"].data_cuts() == [(0, ("data",))]
    assert ps["dec_layers"]["mlp"]["wi"].data_cuts() == [(1, ("data",))]
    local = tree_map(lambda s, x: s.shard(x), ps, whole)
    calls = []
    import repro_torch.distribution.collectives as C
    real = C.gather_rs
    C.gather_rs = lambda x, dim, group: calls.append((tuple(x.shape), dim)) \
        or torch.cat([x, x], dim)
    try:
        with with_mesh_context(mesh, params=ps):
            m = materialize(local)
            pl_ = layer_whole(layer(m["dec_layers"], 0), "dec_layers")
    finally:
        C.gather_rs = real
    L, D, F = whole["dec_layers"]["mlp"]["wi"].shape
    # the encoder's layer-cut leaves whole at the start, the decoder's not
    assert m["enc_layers"]["mlp"]["wi"].shape == \
        whole["enc_layers"]["mlp"]["wi"].shape
    assert m["dec_layers"]["mlp"]["wi"].shape == (L, D // 2, F)
    assert pl_["mlp"]["wi"].shape == (D, F)
    assert ((D // 2, F), 0) in calls
