"""Twins of tests/test_train.py for the port's training substrate, and the
port held against the JAX package on the same inputs:

  * `schedule_lr` for all three schedules (rtol 1e-6: float32 on both
    sides, transcendental functions from two libraries);
  * `adamw_update` on the same params, grads and moments (float32 rtol
    1e-6; bf16 params equal after the cast back);
  * checkpoints: one written by the JAX package's `CheckpointManager`
    restores in the port, and one written by the port restores in the JAX
    package, every array bit-equal, bf16 included;
  * `SyntheticTokens` batches identical to the JAX package's.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticTokens as JSyntheticTokens
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro.train.optimizer import OptConfig as JOptConfig
from repro.train.optimizer import adamw_update as jadamw_update
from repro.train.optimizer import schedule_lr as jschedule_lr
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.models import init_params
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault import (InjectedFailure, StragglerWatchdog,
                                     run_with_recovery)
from repro_torch.train.optimizer import (OptConfig, adamw_update,
                                         init_opt_state, schedule_lr)
from repro_torch.train.step import make_train_step
from repro_torch.tree import leaves


def _init(cfg, seed=0):
    return init_params(cfg, torch.Generator().manual_seed(seed), "cpu")


# -- optimizer -------------------------------------------------------------------

def test_schedules():
    cfg = OptConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                    schedule="cosine", min_lr_ratio=0.1)
    lrs = [float(schedule_lr(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in range(100)]
    assert lrs[0] < lrs[9] <= 1e-3 + 1e-9           # warmup
    assert lrs[99] < lrs[50]                        # decay
    assert lrs[99] >= 0.1 * 1e-3 - 1e-9

    wsd = OptConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                    schedule="wsd", wsd_decay_frac=0.1)
    lrs = [float(schedule_lr(wsd, torch.tensor(s, dtype=torch.int32)))
           for s in range(100)]
    # stable plateau between warmup and decay start
    plateau = lrs[15:85]
    assert max(plateau) - min(plateau) < 1e-9
    assert lrs[-1] < 0.2 * 1e-3                     # decayed tail


@pytest.mark.parametrize("schedule", ["cosine", "wsd", "const"])
def test_schedule_lr_matches_jax(schedule):
    kw = dict(lr=1e-3, warmup_steps=7, total_steps=60, schedule=schedule,
              wsd_decay_frac=0.2, min_lr_ratio=0.05)
    for s in range(70):
        got = float(schedule_lr(OptConfig(**kw),
                                torch.tensor(s, dtype=torch.int32)))
        want = float(jschedule_lr(JOptConfig(**kw), jnp.int32(s)))
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=str(s))


def test_adamw_reduces_loss_quadratic():
    opt_cfg = OptConfig(lr=0.05, warmup_steps=1, total_steps=200,
                        weight_decay=0.0)
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros((3, 1))}

    def loss(p):
        return torch.sum((p["w"][:, 0] - target) ** 2)

    state = init_opt_state(params)
    for _ in range(150):
        w = params["w"].detach().requires_grad_(True)
        g = torch.autograd.grad(loss({"w": w}), w)[0]
        params, state, _ = adamw_update(opt_cfg, {"w": g}, state, params)
    assert float(loss(params)) < 1e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(dtype):
    """The same params, grads and moments through both updates, three
    steps on, with a clipping norm (the grads' norm is above grad_clip):
    float32 within rtol 1e-6, bf16 params equal."""
    rng = np.random.default_rng(5)
    shapes = {"b": (7,), "w": (6, 5), "z": {"k": (2, 3, 4)}}

    def draw(scale):
        def one(s):
            return (rng.standard_normal(s) * scale).astype(np.float32)
        return {k: (one(v) if isinstance(v, tuple) else
                    {kk: one(vv) for kk, vv in v.items()})
                for k, v in shapes.items()}

    p, g, mu, nu = draw(1.0), draw(3.0), draw(0.1), draw(0.1)
    nu = jax.tree.map(np.abs, nu)
    kw = dict(lr=2e-3, warmup_steps=2, total_steps=20, weight_decay=0.1,
              grad_clip=1.0)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jp = jax.tree.map(lambda x: jnp.asarray(x, jdt), p)
    jstate = {"mu": jax.tree.map(jnp.asarray, mu),
              "nu": jax.tree.map(jnp.asarray, nu), "step": jnp.int32(3)}
    jnew, jst, jm = jadamw_update(JOptConfig(**kw),
                                  jax.tree.map(jnp.asarray, g), jstate, jp)

    def tt(tree, dt=torch.float32):
        return jax.tree.map(lambda x: torch.as_tensor(x).to(dt), tree)
    new, st, m = adamw_update(
        OptConfig(**kw), tt(g),
        {"mu": tt(mu), "nu": tt(nu),
         "step": torch.tensor(3, dtype=torch.int32)}, tt(p, tdt))
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
    for a, b in zip(leaves(new), jax.tree.leaves(jnew)):
        assert a.dtype == tdt
        got = a.float().numpy()
        want = np.asarray(b, np.float32)
        if dtype == "bfloat16":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    for part in ("mu", "nu"):
        for a, b in zip(leaves(st[part]), jax.tree.leaves(jst[part])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-12)
    assert int(st["step"]) == int(jst["step"]) == 4


def test_microbatch_equivalence():
    """Grad accumulation must match the single-batch gradient step."""
    cfg = get_config("smollm-135m", reduced=True)
    params = _init(cfg)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                    (4, 16))),
             "labels": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                    (4, 16)))}
    opt_cfg = OptConfig(total_steps=10)
    s1 = make_train_step(cfg, opt_cfg, microbatches=1)
    s4 = make_train_step(cfg, opt_cfg, microbatches=4)
    p1, _, m1 = s1(params, init_opt_state(params), batch)
    p4, _, m4 = s4(params, init_opt_state(params), batch)
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 1e-3
    d = max(float((a - b).abs().max())
            for a, b in zip(leaves(p1), leaves(p4)))
    assert d < 5e-3, f"microbatched update diverged: {d}"


# -- checkpointing -----------------------------------------------------------------

def _tree():
    return {"a": torch.arange(12).reshape(3, 4).float(),
            "b": {"c": (torch.arange(5) * 0.37 - 1).to(torch.bfloat16),
                  "step": torch.tensor(7, dtype=torch.int32)}}


def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(3, tree)
    mgr.wait()
    like = {"a": torch.zeros(3, 4), "b": {"c": torch.zeros(5, dtype=torch.
                                                           bfloat16),
                                          "step": torch.tensor(0, dtype=torch.
                                                               int32)}}
    restored, step = mgr.restore(like)
    assert step == 3
    for a, b in zip(leaves(tree), leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_gc_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False, keep=2)
    tree = {"x": torch.ones((2,))}
    for s in (1, 5, 9):
        mgr.save(s, tree)
    assert mgr.latest_step() == 9
    assert mgr.all_steps() == [5, 9]


def test_checkpoint_written_by_jax_restores_in_port(tmp_path):
    jtree = {"a": jnp.arange(12).reshape(3, 4).astype(jnp.float32),
             "b": {"c": (jnp.arange(5) * 0.37 - 1).astype(jnp.bfloat16),
                   "step": jnp.int32(7)},
             "z": (jnp.ones((2, 2), jnp.bfloat16), jnp.arange(3))}
    JCheckpointManager(str(tmp_path), async_save=False).save(4, jtree)
    like = {"a": torch.zeros(3, 4),
            "b": {"c": torch.zeros(5, dtype=torch.bfloat16),
                  "step": torch.tensor(0, dtype=torch.int32)},
            "z": (torch.zeros(2, 2, dtype=torch.bfloat16),
                  torch.zeros(3, dtype=torch.int32))}
    got, step = CheckpointManager(str(tmp_path)).restore(like)
    assert step == 4
    for a, b in zip(leaves(got), jax.tree.leaves(jtree)):
        want = np.asarray(b.astype(jnp.float32) if b.dtype == jnp.bfloat16
                          else b)
        assert np.array_equal(a.float().numpy() if a.dtype == torch.bfloat16
                              else a.numpy(), want)
        assert str(a.dtype).endswith(str(b.dtype))


def test_checkpoint_written_by_port_restores_in_jax(tmp_path):
    tree = _tree()
    CheckpointManager(str(tmp_path), async_save=False).save(2, tree)
    manifest = json.loads((tmp_path / "step_2" / "manifest.json")
                          .read_text())
    assert manifest["paths"] == ["a", "b/c", "b/step"]
    assert manifest["dtypes"] == ["float32", "float32", "int32"]
    jlike = {"a": jnp.zeros((3, 4)),
             "b": {"c": jnp.zeros((5,), jnp.bfloat16),
                   "step": jnp.int32(0)}}
    got, step = JCheckpointManager(str(tmp_path)).restore(jlike)
    assert step == 2 and got["b"]["c"].dtype == jnp.bfloat16
    for a, b in zip(leaves(tree), jax.tree.leaves(got)):
        assert np.array_equal(a.float().numpy(), np.asarray(b, np.float32))


def test_recovery_from_injected_failures(tmp_path):
    """Crash at steps 4 and 7; loop must resume from checkpoints and
    produce the exact same final state as a failure-free run."""
    def step_fn(state, step):
        return state + step

    ckpt = CheckpointManager(str(tmp_path / "a"), async_save=False)
    final, hist = run_with_recovery(
        step_fn, torch.tensor(0.0), 10, ckpt, save_every=2,
        fail_at={4: InjectedFailure("node lost"),
                 7: InjectedFailure("node lost")})
    assert hist["restarts"] == 2
    assert float(final) == sum(range(10))

    ckpt2 = CheckpointManager(str(tmp_path / "b"), async_save=False)
    clean, _ = run_with_recovery(step_fn, torch.tensor(0.0), 10, ckpt2,
                                 save_every=2)
    assert float(final) == float(clean)


def test_straggler_watchdog():
    wd = StragglerWatchdog(margin=2.0, warmup=3)
    for s in range(5):
        assert not wd.observe(s, 0.1)
    assert wd.observe(5, 0.5)          # 5x median
    assert len(wd.reports) == 1
    assert wd.reports[0].duration_s == 0.5


# -- data pipeline ------------------------------------------------------------------

def test_data_determinism_and_sharding():
    cfg = DataConfig(vocab_size=1000, seq_len=32, global_batch=8, seed=3)
    ds = SyntheticTokens(cfg)
    b1 = ds.batch(5)
    b2 = ds.batch(5)
    assert np.array_equal(b1["tokens"], b2["tokens"])      # deterministic
    assert not np.array_equal(b1["tokens"], ds.batch(6)["tokens"])
    # labels are next-token shifted
    assert np.array_equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    # shards partition the work deterministically
    s0 = ds.batch(5, shard=0, n_shards=2)
    s1 = ds.batch(5, shard=1, n_shards=2)
    assert s0["tokens"].shape == (4, 32)
    assert not np.array_equal(s0["tokens"], s1["tokens"])


def test_synthetic_tokens_match_jax():
    kw = dict(vocab_size=777, seq_len=24, global_batch=6, seed=11)
    ds, jds = SyntheticTokens(DataConfig(**kw)), JSyntheticTokens(
        JDataConfig(**kw))
    for step, shard, n in ((0, 0, 1), (9, 0, 1), (4, 1, 2), (4, 2, 3)):
        got, want = ds.batch(step, shard, n), jds.batch(step, shard, n)
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k])


def test_e2e_training_reduces_loss(tmp_path):
    """Short end-to-end run on the reduced smollm: loss must drop."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.loop import TrainConfig, train
    cfg = get_config("smollm-135m", reduced=True)
    mesh = make_host_mesh(data=1, model=1)
    state, metrics = train(
        cfg, mesh,
        tc=TrainConfig(num_steps=30, log_every=1000,
                       ckpt_dir=str(tmp_path)),
        seq_len=64, global_batch=8, device="cpu")
    losses = metrics["losses"]
    assert losses[-1] < losses[0] - 0.3, \
        f"no learning: {losses[0]:.3f} -> {losses[-1]:.3f}"


def test_recovery_waits_for_an_async_save(tmp_path, monkeypatch):
    """A failure right after an async save: the port lets the save land
    and restarts from it, replaying nothing. The JAX package reads LATEST
    before the slow write (1 s) lands, finds none, replays from step 0 and,
    keeping the failed run's state, ends 3 too high (the two reference
    faults kept in ROADMAP.md)."""
    import time

    import repro.train.checkpoint as JC
    import repro_torch.train.checkpoint as TC
    from repro.train.fault import InjectedFailure as JInjected
    from repro.train.fault import run_with_recovery as jrun
    for mod in (TC, JC):
        slow = mod.np.savez

        def savez(*a, _slow=slow, **kw):
            time.sleep(1.0)
            return _slow(*a, **kw)
        monkeypatch.setattr(mod.np, "savez", savez)
    got, hist = run_with_recovery(
        lambda s, i: s + i, torch.tensor(0.0), 6,
        CheckpointManager(str(tmp_path / "t"), async_save=True),
        save_every=3, fail_at={3: InjectedFailure("node lost")})
    assert float(got) == sum(range(6))
    assert hist == {"restarts": 1, "stragglers": 0, "completed": 6}
    jgot, jhist = jrun(
        lambda s, i: s + i, jnp.float32(0), 6,
        JCheckpointManager(str(tmp_path / "j"), async_save=True),
        save_every=3, fail_at={3: JInjected("node lost")})
    assert jhist["completed"] == 9          # steps 0-2 run twice
    assert float(jgot) == sum(range(6)) + sum(range(3))


def test_recovery_without_a_checkpoint_restarts_from_the_initial_state(
        tmp_path):
    """A failure before the first save replays from step 0 and from the
    state the loop started with."""
    got, hist = run_with_recovery(
        lambda s, i: s + i + 1, torch.tensor(0.0), 6,
        CheckpointManager(str(tmp_path), async_save=False), save_every=4,
        fail_at={2: InjectedFailure("node lost")})
    assert hist["restarts"] == 1 and hist["completed"] == 8
    assert float(got) == sum(range(1, 7))


def test_train_cli_on_cpu(tmp_path, capsys):
    """`python -m repro_torch.launch.train ... --device cpu` trains the
    reduced smollm, writes its checkpoints and metrics; the default
    device needs a GPU and raises without one."""
    from repro_torch.launch.train import main
    out = tmp_path / "m.json"
    _, m = main(["--arch", "smollm-135m", "--reduced", "--steps", "4",
                 "--batch", "4", "--seq", "16", "--ckpt",
                 str(tmp_path / "ck"), "--out", str(out), "--device",
                 "cpu"])
    rec = json.loads(out.read_text())
    assert rec["losses"] == m["losses"] and len(rec["losses"]) == 4
    assert rec["history"]["completed"] == 4
    assert CheckpointManager(str(tmp_path / "ck")).latest_step() == 3
    assert "done: loss" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--arch", "smollm-135m", "--reduced", "--steps", "1"])
