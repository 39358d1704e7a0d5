"""The port's LM kernels (K4 flash attention, K5 gated scan) against the JAX
package's Pallas kernels.

On the CPU the wrappers take their plain torch versions; those are held
against `flash_attention_pallas` / `ssm_scan_pallas` in Pallas interpret
mode and against the JAX package's oracles, on the same inputs made from
numpy seeds, at the tolerances of the JAX package's own kernel tests
(attention atol 3e-5 / rtol 1e-4, scan atol 1e-4 / rtol 1e-4: float32
sums in another order). The model-level dispatch (`attend`, `ssm_apply`)
is mirrored too. The `cuda`-marked test launches both kernels through
`attend` and `ssm_apply` on a GPU and skips without one.
"""

import importlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.ssm_scan import ssm_scan_pallas
from repro_torch.kernels import (flash_attention, flash_attention_plain,
                                 launch_counts, ops, ref,
                                 reset_launch_counts, ssm_scan,
                                 ssm_scan_plain)

ATTN_TOL = dict(atol=3e-5, rtol=1e-4)
# K4 in a 16-bit type against float32 math on the same rounded inputs: the
# output is rounded to the type (a kernel's value a hair off the plain
# version's can round one ulp apart: 2^-6 bf16, 2^-9 f16 at |out| < 4,
# rtol covers larger outputs) and the kernel rounds P to the type before
# P V (relative 2^-9 bf16, 2^-12 f16)
ATTN_TOL16 = {torch.bfloat16: dict(atol=2e-2, rtol=1e-2),
              torch.float16: dict(atol=4e-3, rtol=2e-3)}
SCAN_TOL = dict(atol=1e-4, rtol=1e-4)
FA = importlib.import_module("repro_torch.kernels.flash_attention")


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _qkv(seed, B, Hq, Hkv, Sq, Skv, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, Sq, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32))


# -- K4 -----------------------------------------------------------------------

# the parameter sets of tests/test_kernels.py: the sweep (window, no scale)
# and the block-shape cases (each with scale None and 0.25)
ATTN_CASES = [
    ((1, 4, 4, 64, 64, 32), True, None, (32, 32), (None,)),
    ((2, 8, 2, 100, 100, 64), True, None, (32, 32), (None,)),
    ((2, 8, 2, 100, 100, 64), True, 37, (32, 32), (None,)),
    ((1, 4, 1, 33, 77, 16), True, None, (32, 32), (None,)),
    ((2, 4, 4, 64, 64, 32), False, None, (32, 32), (None,)),
    ((2, 8, 2, 1, 100, 64), True, None, (32, 32), (None,)),
    ((1, 4, 4, 64, 64, 32), True, None, (16, 16), (None, 0.25)),
    ((2, 8, 2, 100, 100, 64), True, None, (32, 64), (None, 0.25)),
    ((1, 4, 1, 33, 77, 16), True, None, (8, 32), (None, 0.25)),
    ((2, 8, 2, 1, 100, 64), True, None, (128, 32), (None, 0.25)),
]


@pytest.mark.parametrize("shape,causal,window,blocks,scales", ATTN_CASES)
def test_flash_attention_plain_matches_pallas(shape, causal, window, blocks,
                                              scales, monkeypatch):
    q, k, v = _qkv(sum(shape), *shape)
    plain = mock.Mock(wraps=FA.flash_attention_plain)
    monkeypatch.setattr(FA, "flash_attention_plain", plain)
    for scale in scales:
        want = np.asarray(flash_attention_pallas(
            q, k, v, causal=causal, window=window, scale=scale, bq=blocks[0],
            bk=blocks[1], interpret=True))
        oracle = np.asarray(jref.flash_attention(q, k, v, causal=causal,
                                                 window=window, scale=scale))
        reset_launch_counts()
        plain.reset_mock()
        got = flash_attention(_t(q), _t(k), _t(v), causal=causal,
                              window=window, scale=scale).numpy()
        # a CPU tensor takes the plain version, which is no kernel launch
        assert plain.call_count == 1
        assert launch_counts()["flash_attention"] == 0
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_allclose(got, want, **ATTN_TOL)
        np.testing.assert_allclose(got, oracle, **ATTN_TOL)
        np.testing.assert_allclose(
            ref.flash_attention(_t(q), _t(k), _t(v), causal, window,
                                scale).numpy(), oracle, **ATTN_TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape,causal,window,blocks,scales",
                         ATTN_CASES[:6])
def test_flash_attention_16bit_matches_pallas(shape, causal, window, blocks,
                                              scales, dtype):
    """The 16-bit route (tensor cores on the card; here the plain version)
    keeps the dtype and agrees with the Pallas kernel run in float32 on the
    same rounded inputs, at the tolerance chip_smoke.py holds the kernel
    to."""
    q, k, v = (_t(a).to(dtype) for a in _qkv(sum(shape), *shape))
    want = np.asarray(flash_attention_pallas(
        *(t.float().numpy() for t in (q, k, v)), causal=causal,
        window=window, bq=blocks[0], bk=blocks[1], interpret=True))
    got = flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(), want,
                               **ATTN_TOL16[dtype])


def test_blockwise_attention_matches_oracle():
    from repro_torch.models.attention import attention_blockwise
    q, k, v = _qkv(3, 2, 4, 2, 200, 200, 32)
    for window in (None, 50):
        out = attention_blockwise(_t(q), _t(k), _t(v), causal=True,
                                  window=window, q_chunk=64, kv_chunk=48)
        expect = jref.flash_attention(q, k, v, causal=True, window=window)
        np.testing.assert_allclose(out.numpy(), np.asarray(expect),
                                   **ATTN_TOL)


def test_flash_attention_keeps_dtype_and_refuses_bad_operands():
    q, k, v = (_t(a).to(torch.bfloat16)
               for a in _qkv(5, 1, 4, 2, 9, 9, 8))
    out = flash_attention(q, k, v)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    want = flash_attention_plain(q.float(), k.float(), v.float())
    assert (out.float() - want).abs().max() < 2e-2
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :, :, :4], v[:, :, :, :4])
    with pytest.raises(ValueError):                  # Hq % Hkv != 0
        flash_attention(q[:, :3], k, v)
    with pytest.raises(TypeError):
        flash_attention(q, k.float(), v)


# -- K5 -----------------------------------------------------------------------

SCAN_CASES = [(1, 16, 8, 4), (2, 100, 32, 16), (2, 128, 64, 128),
              (3, 33, 16, 8)]
CARRY_CASES = [(1, 16, 8, 4), (2, 100, 32, 16), (3, 33, 16, 8),
               (2, 37, 8, 128)]


def _ax(seed, B, T, D):
    rng = np.random.default_rng(seed)
    return ((rng.random((B, T, D)) * 0.9 + 0.05).astype(np.float32),
            rng.standard_normal((B, T, D)).astype(np.float32),
            rng.standard_normal((B, D)).astype(np.float32))


@pytest.mark.parametrize("B,T,D,ct", SCAN_CASES)
def test_ssm_scan_plain_matches_pallas(B, T, D, ct):
    a, x, _ = _ax(B * T + D, B, T, D)
    seq = np.asarray(jref.ssm_scan_sequential(a, x))
    pall = np.asarray(ssm_scan_pallas(a, x, ct=ct, interpret=True))
    got = ssm_scan(_t(a), _t(x)).numpy()
    np.testing.assert_allclose(got, pall, **SCAN_TOL)
    np.testing.assert_allclose(got, seq, **SCAN_TOL)
    np.testing.assert_allclose(ref.ssm_scan(_t(a), _t(x)).numpy(), seq,
                               **SCAN_TOL)
    np.testing.assert_allclose(ref.ssm_scan_sequential(_t(a), _t(x)).numpy(),
                               seq, **SCAN_TOL)


@pytest.mark.parametrize("B,T,D,ct", CARRY_CASES)
def test_ssm_scan_h0_carry_and_resume(B, T, D, ct):
    """h0 seeds the carry (the decode path), and scanning [0:t) then
    resuming from its last state equals one scan over [0:T)."""
    a, x, h0 = _ax(B + T * D, B, T, D)
    seq = np.asarray(jref.ssm_scan_sequential(a, x, h0))
    pall = np.asarray(ssm_scan_pallas(a, x, h0, ct=ct, interpret=True))
    got = ssm_scan(_t(a), _t(x), _t(h0)).numpy()
    np.testing.assert_allclose(got, pall, **SCAN_TOL)
    np.testing.assert_allclose(got, seq, **SCAN_TOL)
    np.testing.assert_allclose(ref.ssm_scan(_t(a), _t(x), _t(h0)).numpy(),
                               seq, **SCAN_TOL)
    t = T // 2
    y1 = ssm_scan(_t(a[:, :t]), _t(x[:, :t]), _t(h0))
    y2 = ssm_scan(_t(a[:, t:]), _t(x[:, t:]), y1[:, -1])
    np.testing.assert_allclose(y2.numpy(), seq[:, t:], **SCAN_TOL)


def test_ssm_scan_plain_is_the_stepwise_recurrence():
    """The plain version walks T in order with one multiply and one add
    per step, the kernel's arithmetic: equal bit for bit to a numpy loop."""
    a, x, h0 = _ax(7, 2, 9, 6)
    h = h0.copy()
    want = np.empty_like(x)
    for t in range(9):
        h = a[:, t] * h + x[:, t]
        want[:, t] = h
    assert np.array_equal(ssm_scan_plain(_t(a), _t(x), _t(h0)).numpy(), want)
    with pytest.raises(ValueError):
        ssm_scan(_t(a), _t(x[:, :3]))
    with pytest.raises(ValueError):
        ssm_scan(_t(a), _t(x), _t(h0[:, :2]))


# -- dispatch from the model code ----------------------------------------------

def test_resolve_backend_drives_model_attend(monkeypatch):
    """`models.attention.attend` routes through `ops.resolve_backend`: a
    CPU tensor resolves to "ref" (the oracle path, no kernel launch), and
    the oracle path matches the JAX package's `attend` and K4's plain
    version."""
    from repro.models.attention import attend as jattend
    from repro_torch.models.attention import attend
    q, k, v = _qkv(11, 1, 4, 2, 48, 48, 16)
    assert ops.resolve_backend(_t(q)) == "ref"
    with pytest.raises(ValueError):
        ops.resolve_backend(_t(q).to("meta"))
    assert jops.resolve_backend() == "ref"
    k4 = mock.Mock(wraps=ops.flash_attention)
    monkeypatch.setattr(ops, "flash_attention", k4)
    out = attend(_t(q), _t(k), _t(v), causal=True).numpy()
    assert k4.call_count == 0
    np.testing.assert_allclose(out, np.asarray(jattend(q, k, v, causal=True)),
                               **ATTN_TOL)
    np.testing.assert_allclose(
        out, ops.flash_attention(_t(q), _t(k), _t(v), causal=True).numpy(),
        **ATTN_TOL)
    long_out = attend(_t(q), _t(k), _t(v), causal=True,
                      blockwise_threshold=16).numpy()
    np.testing.assert_allclose(long_out, out, **ATTN_TOL)


def test_ssm_block_decode_uses_dispatch(monkeypatch):
    """`models.ssm` decode goes through `ops.ssm_scan` (one call per
    block, the plain version on the CPU, no kernel launch) and matches the JAX package's
    block with the same params, on its ref and interpret backends."""
    from repro.models.config import ModelConfig as JConfig
    from repro.models.ssm import ssm_apply as jssm_apply
    from repro.models.ssm import ssm_init as jssm_init
    from repro_torch.models import params_from_numpy
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.ssm import ssm_apply
    kw = dict(name="t", family="ssm", num_layers=1, d_model=16, num_heads=2,
              num_kv_heads=2, d_ff=32, vocab_size=32, ssm_state=4)
    cfg, jcfg = ModelConfig(**kw), JConfig(**kw)
    jp = jssm_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    p = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, 16)).astype(np.float32)
    state = rng.standard_normal((2, 32, 4)).astype(np.float32)
    y_ref, (s_ref, c_ref) = jssm_apply(jp, jnp.asarray(x), jcfg,
                                       state=jnp.asarray(state))
    jops.set_default_backend("interpret")
    try:
        y_int, _ = jssm_apply(jp, jnp.asarray(x), jcfg,
                              state=jnp.asarray(state))
    finally:
        jops.set_default_backend("auto")
    k5 = mock.Mock(wraps=ops.ssm_scan)
    monkeypatch.setattr(ops, "ssm_scan", k5)
    reset_launch_counts()
    y, (s_new, c_new) = ssm_apply(p, _t(x), cfg, state=_t(state))
    assert k5.call_count == 1
    assert launch_counts()["ssm_scan"] == 0
    for got, want in ((y, y_ref), (y, y_int), (s_new, s_ref),
                      (c_new, c_ref)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN_TOL)


@pytest.mark.cuda
def test_cuda_lm_kernels_through_the_model_code():
    """On a GPU: `attend` launches K4 and `ssm_apply` with a state launches
    K5; both agree with their plain versions, K4 also in bf16 and f16
    (chip_smoke.py covers the full-size shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc)")
    from repro_torch.models.attention import attend
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.ssm import ssm_apply, ssm_init
    dev = torch.device("cuda")
    q, k, v = (_t(a).to(dev) for a in _qkv(2, 2, 8, 2, 100, 100, 64))
    reset_launch_counts()
    out = attend(q, k, v, causal=True, window=37)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == 1
    torch.testing.assert_close(
        out, flash_attention_plain(q, k, v, True, 37), **ATTN_TOL)
    for dt, tol in ATTN_TOL16.items():        # the tensor-core route
        q16, k16, v16 = (t.to(dt) for t in (q, k, v))
        torch.testing.assert_close(
            flash_attention(q16, k16, v16, causal=True, window=37).float(),
            flash_attention_plain(q16, k16, v16, True, 37).float(), **tol)
    cfg = ModelConfig(name="t", family="hybrid", num_layers=1, d_model=64,
                      num_heads=2, num_kv_heads=2, d_ff=32, vocab_size=32,
                      ssm_state=8, dtype="float32")
    p = ssm_init(torch.Generator(dev).manual_seed(0), cfg, torch.float32,
                 device=dev)
    x = torch.randn(3, 1, 64, device=dev)
    state = torch.randn(3, 128, 8, device=dev)
    y, (s_new, _) = ssm_apply(p, x, cfg, state=state)
    torch.cuda.synchronize()
    assert launch_counts()["ssm_scan"] == 1
    pc = {k_: t.cpu() for k_, t in p.items()}
    y_cpu, (s_cpu, _) = ssm_apply(pc, x.cpu(), cfg, state=state.cpu())
    torch.testing.assert_close(s_new.cpu(), s_cpu, **SCAN_TOL)
    torch.testing.assert_close(y.cpu(), y_cpu, **SCAN_TOL)
