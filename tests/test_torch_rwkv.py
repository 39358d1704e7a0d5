"""The port's RWKV-6 blocks (`repro_torch.models.rwkv`) against the JAX
package's: the chunked WKV form against the token-by-token recurrence (a
twin of tests/test_kernels.py::test_wkv_chunked_matches_sequential), and
against the JAX package's `wkv_chunked` at lengths that are no multiple of
the chunk, with and without a carried state; then the time- and
channel-mix with decode continuity.

Inputs are seeded numpy; weights go across from the JAX package's
`rwkv_init`. Tolerance atol/rtol 1e-4 in float32 against the JAX package;
the recurrence twin keeps the reference test's 2e-3 against float64.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models.rwkv import rwkv_channel_mix as jchannel_mix
from repro.models.rwkv import rwkv_init as jrwkv_init
from repro.models.rwkv import rwkv_time_mix as jtime_mix
from repro.models.rwkv import wkv_chunked as jwkv_chunked
from repro_torch.models import ModelConfig, params_from_numpy
from repro_torch.models.rwkv import (rwkv_channel_mix, rwkv_time_mix,
                                     wkv_chunked)

TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(rng, B, H, T, dk, dv):
    r = rng.standard_normal((B, H, T, dk)).astype(np.float32)
    k = rng.standard_normal((B, H, T, dk)).astype(np.float32)
    v = rng.standard_normal((B, H, T, dv)).astype(np.float32)
    w = (rng.random((B, H, T, dk)) * 0.5 + 0.5).astype(np.float32)
    u = rng.standard_normal((H, dk)).astype(np.float32)
    return r, k, v, w, u


def test_wkv_chunked_matches_sequential():
    """RWKV6 chunked WKV == step-by-step recurrence."""
    rng = np.random.default_rng(0)
    B, H, T, dk, dv = 2, 3, 50, 8, 8
    r, k, v, w, u = _inputs(rng, B, H, T, dk, dv)
    y, S_fin = wkv_chunked(*map(torch.as_tensor, (r, k, v, w, u)), chunk=16)
    S = np.zeros((B, H, dk, dv), np.float64)
    ys = np.zeros((B, H, T, dv), np.float64)
    for t in range(T):
        kv = np.einsum("bhk,bhv->bhkv", k[:, :, t], v[:, :, t])
        ys[:, :, t] = np.einsum(
            "bhk,bhkv->bhv", r[:, :, t],
            S + u[None, :, :, None] * kv)
        S = w[:, :, t][..., None] * S + kv
    np.testing.assert_allclose(y.numpy(), ys, atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(S_fin.numpy(), S, atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("T", [1, 45, 70])
def test_wkv_chunked_matches_jax(T, with_state):
    """The default chunk of 32 at T = 1 (a decode step), 45 and 70 (a
    padded last chunk), from zeros or a carried float32 state."""
    rng = np.random.default_rng(T)
    B, H, dk, dv = 2, 3, 16, 16
    r, k, v, w, u = _inputs(rng, B, H, T, dk, dv)
    # decays near 1, as the Finch block makes them, and near 0.5
    w[:, 0] = 1.0 - w[:, 0] * 1e-3
    state = rng.standard_normal((B, H, dk, dv)).astype(np.float32) \
        if with_state else None
    jy, jS = jwkv_chunked(*map(jnp.asarray, (r, k, v, w, u)),
                          state=None if state is None else jnp.asarray(state))
    ty, tS = wkv_chunked(*map(torch.as_tensor, (r, k, v, w, u)),
                         state=None if state is None
                         else torch.as_tensor(state))
    assert ty.dtype == tS.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tS.numpy(), np.asarray(jS), **TOL)


def test_time_and_channel_mix_match_jax_with_decode_continuity():
    """rwkv6-1.6b REDUCED: the mixes over 20 tokens, then over 3 more
    carrying the WKV state and the last tokens, equal the JAX package's
    and the 23-token prefill's tail."""
    jcfg = jget_config("rwkv6-1.6b", reduced=True)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    jp = jrwkv_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(1).standard_normal(
        (2, 23, cfg.d_model)).astype(np.float32)
    jy, (jS, jlast) = jtime_mix(jp, jnp.asarray(x[:, :20]), jcfg)
    ty, (tS, tlast) = rwkv_time_mix(tp, torch.as_tensor(x[:, :20]), cfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tS.numpy(), np.asarray(jS), **TOL)
    jy2, _ = jtime_mix(jp, jnp.asarray(x[:, 20:]), jcfg, state=jS,
                       last=jlast)
    ty2, _ = rwkv_time_mix(tp, torch.as_tensor(x[:, 20:]), cfg, state=tS,
                           last=tlast)
    np.testing.assert_allclose(ty2.numpy(), np.asarray(jy2), **TOL)
    full, _ = rwkv_time_mix(tp, torch.as_tensor(x), cfg)
    np.testing.assert_allclose(ty2.numpy(), full[:, 20:].numpy(), **TOL)
    jc, jl = jchannel_mix(jp, jnp.asarray(x[:, 20:]), jcfg,
                          last=jnp.asarray(x[:, 19:20]))
    tc, tl = rwkv_channel_mix(tp, torch.as_tensor(x[:, 20:]), cfg,
                              last=torch.as_tensor(x[:, 19:20]))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    assert torch.equal(tl, torch.as_tensor(x[:, 22:23]))
    assert tp["u"].dtype == tp["w_bias"].dtype == torch.float32
