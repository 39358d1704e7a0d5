"""The port's training path against the JAX package's, on the CPU.

For every assigned architecture at REDUCED scale, as float32 copies, with
the JAX package's params carried across (the twin of
`tests/test_models_smoke.py::test_arch_smoke_forward_and_train_step`):
  * `train_loss` within rtol 1e-5, and every gradient leaf within rtol
    1e-4, atol 1e-5 (float32 sums in another order);
  * one `make_train_step` with `microbatches=2` (loss, updated params and
    moments within the same tolerances, the step counter equal).
Beside them: the `save_residuals` remat smoke (the twin of
`test_perf_features.py::test_save_residuals_remat_smoke`), every remat
policy giving the "none" gradients exactly, and five steps of `train` on
the 1 x 1 mesh from carried-across params (losses within rtol 1e-4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.models.transformer import train_loss as jtrain_loss
from repro.train.optimizer import OptConfig as JOptConfig
from repro.train.optimizer import init_opt_state as jinit_opt_state
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import (opt_state_from_numpy, params_from_numpy,
                                train_loss)
from repro_torch.models import transformer as T
from repro_torch.train.loop import TrainConfig, train
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.step import loss_and_grads, make_train_step
from repro_torch.tree import leaves

LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _cfgs(arch, **kw):
    """(JAX config, port config): REDUCED, float32, with `kw` replaced."""
    return (dataclasses.replace(jget_config(arch, reduced=True),
                                dtype="float32", **kw),
            dataclasses.replace(get_config(arch, reduced=True),
                                dtype="float32", **kw))


def _batch(cfg, B, S, seed):
    """The JAX smoke test's batch (tokens, labels, encdec source, frontend
    embeddings), as numpy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
             "labels": rng.integers(0, cfg.vocab_size, (B, S))}
    if cfg.family == "encdec":
        batch["src_tokens"] = rng.integers(0, cfg.vocab_size, (B, S))
        if cfg.frontend is not None:
            batch["frontend_embeds"] = rng.standard_normal(
                (B, S, cfg.d_model)).astype(np.float32)
    elif cfg.frontend is not None and cfg.frontend_tokens:
        n = min(cfg.frontend_tokens, S // 2)
        batch["frontend_embeds"] = rng.standard_normal(
            (B, n, cfg.d_model)).astype(np.float32)
    return batch


def _both(jcfg, cfg, seed=0):
    jp = jinit_params(jcfg, jax.random.PRNGKey(seed))
    return jp, params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")


def _close_trees(got, want, **tol):
    g, w = leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   np.asarray(b, np.float32), **tol)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_loss_and_grads_match_jax(arch):
    jcfg, cfg = _cfgs(arch)
    jp, params = _both(jcfg, cfg)
    nb = _batch(cfg, 2, 16, seed=7)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        jtrain_loss(jcfg), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in nb.items()})
    batch = {k: torch.as_tensor(v) for k, v in nb.items()}
    loss, grads = loss_and_grads(train_loss(cfg), params, batch)
    assert torch.isfinite(loss)
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    _close_trees(grads, jg, **GRAD_TOL)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_microbatched_train_step_matches_jax(arch):
    jcfg, cfg = _cfgs(arch)
    jp, params = _both(jcfg, cfg)
    nb = _batch(cfg, 2, 16, seed=7)
    jp2, jo2, jmet = jax.jit(jmake_train_step(
        jcfg, JOptConfig(total_steps=10), microbatches=2))(
            jp, jinit_opt_state(jp), {k: jnp.asarray(v)
                                      for k, v in nb.items()})
    step = make_train_step(cfg, OptConfig(total_steps=10), microbatches=2)
    before = [t.clone() for t in leaves(params)]
    p2, o2, met = step(params, init_opt_state(params),
                       {k: torch.as_tensor(v) for k, v in nb.items()})
    # pure: the arguments are untouched
    assert all(torch.equal(a, b) for a, b in zip(before, leaves(params)))
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-4)
    np.testing.assert_allclose(float(met["lr"]), float(jmet["lr"]),
                               rtol=1e-6)
    _close_trees(p2, jp2, **GRAD_TOL)
    _close_trees(o2["mu"], jo2["mu"], **GRAD_TOL)
    _close_trees(o2["nu"], jo2["nu"], rtol=1e-4, atol=1e-9)
    assert int(o2["step"]) == int(jo2["step"]) == 1
    assert leaves(p2)[0].dtype == leaves(params)[0].dtype


def test_save_residuals_remat_smoke():
    jcfg, cfg = _cfgs("smollm-135m", remat="save_residuals")
    jp, params = _both(jcfg, cfg)
    nb = _batch(cfg, 2, 16, seed=0)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        jtrain_loss(jcfg), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in nb.items()})
    loss, grads = loss_and_grads(
        train_loss(cfg), params, {k: torch.as_tensor(v)
                                  for k, v in nb.items()})
    assert np.isfinite(float(loss))
    assert all(torch.isfinite(g).all() for g in grads)
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    _close_trees(grads, jg, **GRAD_TOL)


@pytest.mark.parametrize("arch", ["smollm-135m", "zamba2-1.2b",
                                  "mixtral-8x22b", "rwkv6-1.6b",
                                  "seamless-m4t-medium"])
@pytest.mark.parametrize("remat", ["full", "dots", "save_residuals"])
def test_remat_policies_keep_the_gradients(arch, remat, monkeypatch):
    """Every family under every remat policy: the "none" loss and
    gradients exactly; the selective policies save what they name
    ("save_residuals": one value per dense block, "dots": matrix
    products only)."""
    _, cfg0 = _cfgs(arch, remat="none")
    cfg = dataclasses.replace(cfg0, remat=remat)
    params = T.init_params(cfg0, torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg0, 2, 16,
                                                      seed=3).items()}
    want_l, want_g = loss_and_grads(train_loss(cfg0), params, batch)
    saved = []
    for name in ("_save_dots", "_save_residual1"):
        orig = getattr(T, name)

        def spy(ctx, op, *a, _orig=orig, **kw):
            decision = _orig(ctx, op, *a, **kw)
            if decision == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE \
                    and not ctx.is_recompute:
                saved.append(op)
            return decision
        monkeypatch.setattr(T, name, spy)
    got_l, got_g = loss_and_grads(train_loss(cfg), params, batch)
    assert torch.equal(got_l, want_l)
    assert all(torch.equal(a, b) for a, b in zip(got_g, want_g))
    if remat == "save_residuals":
        dense = {"dense": cfg.num_layers, "hybrid": cfg.num_layers
                 // max(1, cfg.attn_every)}.get(cfg.family, 0)
        assert len(saved) == dense
        assert all(op == torch.ops.aten.add.Tensor for op in saved)
    elif remat == "dots":
        assert saved and set(saved) <= T._DOTS
    else:
        assert saved == []


def test_train_five_steps_matches_jax(tmp_path):
    """`train` on the 1 x 1 mesh, from the params the JAX package's
    `train` initializes (PRNGKey(0)), with a checkpoint directory: the
    same five losses within rtol 1e-4."""
    from repro.launch.mesh import make_host_mesh as jmake_host_mesh
    from repro.train.loop import TrainConfig as JTrainConfig
    from repro.train.loop import train as jtrain
    jcfg, cfg = _cfgs("smollm-135m")
    _, jm = jtrain(jcfg, jmake_host_mesh(1, 1),
                   tc=JTrainConfig(num_steps=5, log_every=1000,
                                   ckpt_dir=str(tmp_path / "jax")),
                   seq_len=32, global_batch=4)
    _, params = _both(jcfg, cfg, seed=0)
    _, m = train(cfg, make_host_mesh(1, 1),
                 tc=TrainConfig(num_steps=5, log_every=1000,
                                ckpt_dir=str(tmp_path / "torch")),
                 seq_len=32, global_batch=4, device="cpu", params=params)
    np.testing.assert_allclose(m["losses"], jm["losses"], rtol=1e-4)
    assert m["history"] == jm["history"]


def test_opt_state_carries_across():
    """`opt_state_from_numpy` makes the port's state from the JAX
    package's: f32 moments and the int32 step, values equal."""
    jcfg, cfg = _cfgs("smollm-135m")
    jp, _ = _both(jcfg, cfg)
    jo = jinit_opt_state(jp)
    jo = {"mu": jax.tree.map(lambda x: x + 0.5, jo["mu"]),
          "nu": jo["nu"], "step": jnp.int32(3)}
    o = opt_state_from_numpy(jax.tree.map(np.asarray, jo), "cpu")
    assert o["step"].dtype == torch.int32 and int(o["step"]) == 3
    _close_trees(o["mu"], jo["mu"], rtol=0, atol=0)
    assert all(t.dtype == torch.float32 for t in leaves(o["nu"]))
