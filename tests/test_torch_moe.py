"""The port's MoE layer (`repro_torch.models.moe`) against the JAX
package's: mirrors of tests/test_perf_features.py's sorted-dispatch tests,
arctic's dense residual at capacity 1.25, and the router's tie order.

Weights go across from the JAX package's `moe_init` (numpy leaves); inputs
are seeded numpy. Tolerance atol/rtol 1e-4 in float32 unless stated.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import ModelConfig as JConfig
from repro.models import init_params as jinit_params
from repro.models.moe import _router as jrouter
from repro.models.moe import moe_apply as jmoe_apply
from repro.models.moe import moe_apply_onehot as jmoe_apply_onehot
from repro.models.moe import moe_apply_sorted as jmoe_apply_sorted
from repro.models.moe import moe_apply_sorted_batched as jmoe_sorted_batched
from repro.models.moe import moe_init as jmoe_init
from repro_torch.models import ModelConfig, params_from_numpy
from repro_torch.models.moe import (_capacity, _router, moe_apply,
                                    moe_apply_onehot, moe_apply_sorted,
                                    moe_apply_sorted_batched)
from repro_torch.models.transformer import _moe_block, layer

TOL = dict(atol=1e-4, rtol=1e-4)


def _moe(jcfg, seed=0):
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    jp = jmoe_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return cfg, jp, params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                      "cpu")


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_sorted_batched_moe_equals_onehot():
    """Twin of test_perf_features.py::test_sorted_batched_moe_equals_onehot
    (capacity 8x: nothing dropped, so both dispatches compute the same
    function), and each equals the JAX package's."""
    jcfg = JConfig(name="m", family="moe", num_layers=1, d_model=32,
                   num_heads=4, num_kv_heads=4, d_ff=64, vocab_size=64,
                   num_experts=4, top_k=2, capacity_factor=8.0,
                   dtype="float32")
    cfg, jp, tp = _moe(jcfg)
    x = _x((3, 24, 32))
    rows = [moe_apply_onehot(tp, torch.as_tensor(r), cfg) for r in x]
    y1 = torch.stack([y for y, _ in rows])
    a1 = torch.stack([a for _, a in rows]).mean()
    y2, a2 = moe_apply_sorted_batched(tp, torch.as_tensor(x), cfg)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=1e-5)
    np.testing.assert_allclose(float(a1), float(a2), **TOL)
    jy, ja = jmoe_sorted_batched(jp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(y2.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(a2), float(ja), **TOL)
    jy1, _ = jax.vmap(lambda r: jmoe_apply_onehot(jp, r, jcfg))(
        jnp.asarray(x))
    np.testing.assert_allclose(y1.numpy(), np.asarray(jy1), **TOL)


@pytest.mark.parametrize("top_k,capacity_factor", [(1, 0.5), (2, 0.25)])
def test_sorted_moe_drops_overflow_tokens(top_k, capacity_factor):
    """Twin of test_perf_features.py::test_sorted_moe_drops_overflow_tokens:
    a tight capacity drops tokens (exactly those the JAX package drops, in
    both dispatches) and corrupts no other."""
    jcfg = JConfig(name="m", family="moe", num_layers=1, d_model=16,
                   num_heads=2, num_kv_heads=2, d_ff=32, vocab_size=64,
                   num_experts=2, top_k=top_k,
                   capacity_factor=capacity_factor, dtype="float32")
    cfg, jp, tp = _moe(jcfg)
    x = _x((2, 32, 16))
    assert _capacity(32, cfg) == 8 < 32 * top_k // 2      # overflow
    y, aux = moe_apply_sorted_batched(tp, torch.as_tensor(x), cfg)
    assert torch.isfinite(y).all() and torch.isfinite(aux)
    jy, _ = jmoe_sorted_batched(jp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    # a token past the capacity of every expert it chose gets nothing:
    # exact zeros, at the same tokens in both packages
    dropped = (y.abs().sum(-1) == 0).numpy()
    assert dropped.any() and not dropped.all()
    assert np.array_equal(dropped, np.abs(np.asarray(jy)).sum(-1) == 0)
    for r in range(2):
        yo, _ = moe_apply_onehot(tp, torch.as_tensor(x[r]), cfg)
        np.testing.assert_allclose(yo.numpy(), y[r].numpy(), **TOL)
        ys, _ = moe_apply_sorted(tp, torch.as_tensor(x[r]), cfg)
        jys, _ = jmoe_apply_sorted(jp, jnp.asarray(x[r]), jcfg)
        np.testing.assert_allclose(ys.numpy(), np.asarray(jys), **TOL)


@pytest.mark.parametrize("dispatch", ["onehot", "sorted"])
def test_arctic_dense_residual_block_matches_jax(dispatch):
    """arctic-480b REDUCED (dense residual MLP beside the experts,
    capacity 1.25, so some tokens overflow at S = 24) through a whole moe
    block, and `moe_apply` alone, against the JAX package's."""
    from repro.models.transformer import _moe_block as j_moe_block
    jcfg = dataclasses.replace(jget_config("arctic-480b", reduced=True),
                               moe_dispatch=dispatch)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    assert cfg.dense_residual_ff and cfg.capacity_factor == 1.25
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    x = _x((2, 24, cfg.d_model)) * 0.5
    jl = jax.tree.map(lambda a: a[0], jp["layers"])
    tl = layer(tp["layers"], 0)
    jy, jaux = j_moe_block(jl, jnp.asarray(x), jcfg, jnp.arange(24))
    ty, taux = _moe_block(tl, torch.as_tensor(x), cfg, torch.arange(24))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    my, maux = moe_apply(tl["moe"], torch.as_tensor(x), cfg)
    jmy, jmaux = jmoe_apply(jl["moe"], jnp.asarray(x), jcfg)
    np.testing.assert_allclose(my.numpy(), np.asarray(jmy), **TOL)
    assert tl["moe"]["router"].dtype == torch.float32


def test_router_ties_take_the_lowest_expert_first():
    """Equal router probabilities: `jax.lax.top_k` returns the lower expert
    id first; so does the port, and the slot order follows."""
    jcfg = JConfig(name="m", family="moe", num_layers=1, d_model=8,
                   num_heads=2, num_kv_heads=2, d_ff=16, vocab_size=64,
                   num_experts=6, top_k=2, dtype="float32")
    cfg, jp, tp = _moe(jcfg)
    # a router whose columns 1, 3 and 4 are equal: every token ties
    # between three experts, and experts 0, 2, 5 never win
    w = np.zeros((8, 6), np.float32)
    w[:, [1, 3, 4]] = np.abs(_x((8, 1), seed=5)) + 0.1
    jp = {**jp, "router": jnp.asarray(w)}
    tp = {**tp, "router": torch.as_tensor(w)}
    x = np.abs(_x((5, 8), seed=6))
    jg, ji, _ = jrouter(jp, jnp.asarray(x), jcfg)
    tg, ti, _ = _router(tp, torch.as_tensor(x), cfg)
    assert ti.tolist() == np.asarray(ji).tolist() == [[1, 3]] * 5
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)
    xb = x[None].repeat(2, 0)
    jy, _ = jmoe_sorted_batched(jp, jnp.asarray(xb), jcfg)
    ty, _ = moe_apply_sorted_batched(tp, torch.as_tensor(xb), cfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
