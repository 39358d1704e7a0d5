"""The port's int8 quantization against the JAX package's: a twin of each
test of `tests/test_quantize.py`.

Both packages get the same numpy inputs (the port's `quantize.requantize`
gets torch tensors made from them, never `jnp` arrays) and their results
are compared exactly.
"""

import jax.numpy as jnp
import numpy as np
import torch

import repro.core as R
import repro.core.executor as RE
import repro.core.quantize as RQ
import repro_torch.core as T
import repro_torch.core.executor as TE
import repro_torch.core.quantize as TQ


def test_weight_quant_per_channel(rng):
    w = rng.standard_normal((64, 32)).astype(np.float32)
    w[:, 3] *= 40.0
    rq, rscale = RQ.quantize_weight(w)
    qw, scale = TQ.quantize_weight(w)
    assert qw.dtype == np.int8
    assert np.array_equal(qw, rq) and np.array_equal(scale, rscale)
    back = TQ.dequantize(qw, scale[None, :])
    assert np.array_equal(back, RQ.dequantize(rq, rscale[None, :]))
    rel = np.abs(back - w).max(axis=0) / np.abs(w).max(axis=0)
    assert rel.max() < 0.02


def test_activation_quant(rng):
    x = rng.standard_normal((1000,)).astype(np.float32)
    s = TQ.quantize_activation_scale(x)
    assert s == RQ.quantize_activation_scale(x)
    q = TQ.quantize_tensor(x, s)
    assert np.array_equal(q, RQ.quantize_tensor(x, s))
    db = TQ.sqnr_db(x, TQ.dequantize(q, s))
    assert db == RQ.sqnr_db(x, RQ.dequantize(q, s)) and db > 30.0


def test_requant_np_matches_jnp(rng):
    """The port's requantize (on torch tensors made from the numpy arrays)
    against the numpy executor's and the JAX package's jnp requantize, on
    the same int32 accumulators."""
    acc = rng.integers(-2**20, 2**20, (64, 32)).astype(np.int32)
    mult = (rng.random(32) * 1e-3).astype(np.float32)
    a = TE._requant_np(acc, mult[None, :])
    assert np.array_equal(a, RE._requant_np(acc, mult[None, :]))
    ref = np.asarray(RQ.requantize(jnp.asarray(acc), jnp.asarray(mult)))
    got = TQ.requantize(torch.as_tensor(acc), torch.as_tensor(mult))
    assert np.array_equal(a, ref)
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), ref)


def test_quantparams_fixed_point():
    for scale in (0.5, 0.037, 1e-4, 3.7):
        qp = TQ.QuantParams.from_scale(scale)
        rqp = RQ.QuantParams.from_scale(scale)
        assert (qp.multiplier, qp.shift) == (rqp.multiplier, rqp.shift)
        assert qp.scale() == rqp.scale()
        assert abs(qp.scale() - scale) / scale < 1e-6


def test_quantized_cnn_sqnr(rng):
    x = rng.integers(-64, 64, (32, 32, 3)).astype(np.int8)
    g = T.cnn.small_cnn()
    out = T.reference_forward(g, T.init_params(g, seed=0), {"input": x})
    rg = R.cnn.small_cnn()
    ref = R.reference_forward(rg, R.init_params(rg, seed=0), {"input": x})
    y = out[g.outputs[0]]
    assert np.array_equal(y, ref[rg.outputs[0]])
    y = y.astype(np.float64)
    assert np.abs(y).max() > 0
    assert len(np.unique(y)) > 3
